"""Initial-sample generation: annealed EM soft clustering + refinement.

Behavioral counterpart of the reference's ``SbayesInitializer``
(sbayes/sampling/initializers.py:31-320):
  1. annealed EM over clusters + confounder groups (optionally geo-aware),
  2. discretization with a per-cluster min-size guarantee and a
     truncated-normal total size,
  3. prior source draw -> full Gibbs source step,
  4. two rounds of deterministic ML cluster steps with a weight
     re-estimation in between,
  5. best-of-``attempts`` by likelihood.

Everything is jittable; attempts can be vmapped.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import ndtr, ndtri

from sbayes_tpu.model.math import HIGHEST, normalize, normalize_weights, sample_categorical_onehot
from sbayes_tpu.sampling.conditionals import Conditionals
from sbayes_tpu.sampling.operators import OperatorFactory
from sbayes_tpu.sampling.state import ChainState


def _truncnorm_sample(key, mid, lower, upper, scale):
    """Truncated normal draw via inverse-CDF (matches scipy.stats.truncnorm)."""
    a = (lower - mid) / scale
    b = (upper - mid) / scale
    u = jax.random.uniform(key, (), minval=ndtr(a), maxval=ndtr(b))
    return mid + scale * ndtri(u)


class Initializer:
    def __init__(
        self,
        cond: Conditionals,
        initial_size: int,
        attempts: int,
        initial_cluster_steps: bool = True,
        n_em_steps: int = 50,
        method: str = "em",
    ):
        self.cond = cond
        self.consts = cond.consts
        self.initial_size = int(initial_size)
        self.attempts = int(attempts)
        self.initial_cluster_steps = bool(initial_cluster_steps)
        self.n_em_steps = int(n_em_steps)
        self.method = str(method)

        self.factory = OperatorFactory(cond)
        self.full_source_op = self.factory.make_gibbs_sample_source("all", max_size=10**9)
        self.ml_step = self.factory.make_ml_cluster_step(consider_geo=True)

        # Static group-availability rows: K cluster rows (everywhere) + the
        # actual confounder groups. Built with jnp so construction also
        # works inside a trace (consts hold device arrays).
        c = self.consts
        rows = [jnp.ones((c.K, c.N), bool)]
        for i_c in range(len(c.conf_names)):
            ng = int(c.n_groups[i_c])
            rows.append(jnp.asarray(c.groups)[i_c, :ng] > 0)
        self.groups_available = jnp.concatenate(rows, axis=0)  # (G_all, N)
        self.n_em_groups = int(self.groups_available.shape[0])

    # ------------------------------------------------------------------

    def generate_clusters_em(self, key):
        """Annealed EM soft clustering (reference: initializers.py:93-169)."""
        c = self.consts
        feats = jnp.asarray(c.features)
        valid = ~jnp.asarray(c.na)
        N, K = c.N, c.K
        G = self.n_em_groups
        avail = jnp.asarray(self.groups_available)

        k_size, k_z = jax.random.split(key)
        total_size = _truncnorm_sample(
            k_size,
            mid=float(K * self.initial_size),
            lower=float(K * c.min_size),
            upper=float(min(N, K * c.max_size)),
            scale=float(max(20.0, K * self.initial_size - K * c.min_size)),
        )
        total_size = jnp.clip(jnp.round(total_size).astype(jnp.int32), K * c.min_size, N)

        prior_counts = 0.5 * jnp.asarray(c.applicable, feats.dtype)
        z0 = jax.random.uniform(k_z, (G, N)) * avail
        z0 = z0 / jnp.maximum(z0.sum(0, keepdims=True), 1e-35)

        geo_on = c.geo.prior_type == "cost_based"
        cost = jnp.asarray(c.cost_matrix)

        def group_lls_slice(z, feats_t, valid_t, prior_counts_t):
            """(G, N) log-lh of each object under each group's EM effect on
            one F-slice (NA observations count as 'any state')."""
            feats_filled = jnp.where(valid_t[:, :, None], feats_t, 1.0)
            state_counts = jnp.einsum("gn,nfs->gfs", z.astype(feats_t.dtype), feats_t,
                                      preferred_element_type=jnp.float32, precision=HIGHEST)
            p = normalize(state_counts + prior_counts_t, axis=-1)
            pointwise_ll = jnp.log(
                jnp.maximum(jnp.einsum("gfs,nfs->gnf", p.astype(feats_filled.dtype),
                                       feats_filled,
                                       preferred_element_type=jnp.float32, precision=HIGHEST), 1e-35)
            )
            return pointwise_ll.sum(-1)

        fc = c.feature_chunk

        def group_lls_of(z):
            if fc is None or fc >= c.F:
                return group_lls_slice(z, feats, valid, prior_counts)
            from sbayes_tpu.model.math import feature_tile

            def tile_body(i):
                return group_lls_slice(
                    z,
                    feature_tile(feats, i, fc, axis=1),
                    feature_tile(valid, i, fc, axis=1),
                    feature_tile(prior_counts, i, fc, axis=0),
                )

            return lax.map(tile_body, jnp.arange(c.F // fc)).sum(0)

        def em_step(i_step, z):
            group_lls = group_lls_of(z)  # (G, N)

            if geo_on:
                z_peaky = jax.nn.softmax(N * z, axis=1)
                avg_dist = jnp.matmul(z_peaky, cost, precision=HIGHEST)
                log_geo = -avg_dist / c.geo.scale / 2.0
                mean_cluster_geo = jax.scipy.special.logsumexp(log_geo[:K]) - jnp.log(
                    float(log_geo[:K].size)
                )
                log_geo = log_geo.at[K:].set(mean_cluster_geo)
            else:
                log_geo = 0.0

            temperature = (self.n_em_steps / (1.0 + i_step)) ** 3
            lh = log_geo + group_lls / temperature
            lh = jnp.where(avail, lh, -jnp.inf)
            return jax.nn.softmax(lh, axis=0)

        z = lax.fori_loop(0, self.n_em_steps, em_step, z0)
        return self._discretize_fuzzy_clusters(z, total_size)

    def generate_clusters_seed_points(self, key):
        """Legacy 'seed point' initial clusters: one random object per
        cluster (reference: initialize_clusters, initializers.py:336-351).
        The subsequent ML cluster steps grow them to min_size+."""
        c = self.consts
        seeds = jax.random.permutation(key, c.N)[: c.K]          # distinct
        return jnp.zeros((c.K, c.N), bool).at[jnp.arange(c.K), seeds].set(True)

    def generate_clusters_random_growth(self, key):
        """Legacy random-growth initial clusters: grow each cluster from a
        random free seed through adjacency-constrained random grow steps up
        to ``initial_size`` (reference: grow_random_clusters +
        grow_cluster_of_size_k, initializers.py:353-442). Divergence from
        the reference's host-side retry loop: a cluster that runs out of
        free neighbours simply stops growing (stays smaller) instead of
        restarting the whole initialization — inside jit a data-dependent
        restart is not expressible, and the best-of-attempts selection
        already covers unfavourable seeds."""
        c = self.consts
        adj = jnp.asarray(c.adjacency).astype(jnp.float32)
        N, K = c.N, c.K
        clusters = jnp.zeros((K, N), bool)
        occupied = jnp.zeros(N, bool)

        for i_c in range(K):
            k_c = jax.random.fold_in(key, i_c)
            k_seed, k_grow = jax.random.split(k_c)
            free = ~occupied
            logits = jnp.where(free, 0.0, -jnp.inf)
            seed = jax.random.categorical(k_seed, logits)
            cluster = jnp.zeros(N, bool).at[seed].set(True)
            occupied = occupied.at[seed].set(True)

            def body(j, carry):
                cluster, occupied = carry
                neigh = (jnp.matmul(adj, cluster.astype(jnp.float32), precision=HIGHEST) > 0) & ~occupied
                can_grow = jnp.any(neigh)
                lg = jnp.where(neigh, 0.0, -jnp.inf)
                pick = jax.random.categorical(jax.random.fold_in(k_grow, j),
                                              jnp.where(can_grow, lg, 0.0))
                cluster = cluster.at[pick].set(cluster[pick] | can_grow)
                occupied = occupied.at[pick].set(occupied[pick] | can_grow)
                return cluster, occupied

            cluster, occupied = lax.fori_loop(0, self.initial_size - 1, body,
                                              (cluster, occupied))
            clusters = clusters.at[i_c].set(cluster)
        return clusters

    def generate_initial_clusters(self, key):
        if self.method == "seed_points":
            return self.generate_clusters_seed_points(key)
        if self.method == "random_growth":
            return self.generate_clusters_random_growth(key)
        return self.generate_clusters_em(key)

    def _discretize_fuzzy_clusters(self, z, total_size):
        """Discretize soft assignments with a min-size guarantee
        (reference: initializers.py:186-209)."""
        c = self.consts
        K, N = c.K, c.N
        fuzzy = z[:K]

        # Guarantee min_size top objects for each cluster in turn
        for i_c in range(K):
            _, best_ids = lax.top_k(fuzzy[i_c], c.min_size)
            col_mask = jnp.zeros(N, bool).at[best_ids].set(True)
            fuzzy = jnp.where(col_mask[None, :], 0.0, fuzzy)
            fuzzy = fuzzy.at[i_c].set(jnp.where(col_mask, 1.0, fuzzy[i_c]))

        best = jnp.argmax(fuzzy, axis=0)
        best_value = jnp.max(fuzzy, axis=0)
        sorted_vals = jnp.sort(best_value)
        threshold = sorted_vals[jnp.maximum(N - total_size, 0)]
        best = jnp.where(best_value < threshold, K, best)
        clusters = jax.nn.one_hot(best, K + 1, dtype=bool).T  # (K+1, N)
        return clusters[:K]

    # ------------------------------------------------------------------

    def generate_sample_attempt(self, key) -> ChainState:
        c = self.consts
        cond = self.cond
        na = jnp.asarray(c.na)
        keys = jax.random.split(key, 8)

        clusters = self.generate_initial_clusters(keys[0])
        weights = jnp.full((c.F, c.C), 1.0 / c.C, jnp.float32)

        # Source from prior
        hc = cond.post.has_components(clusters)
        w_normed = normalize_weights(weights, hc)
        source = sample_categorical_onehot(keys[1], w_normed) & ~na[:, :, None]
        if c.source_packed:
            from sbayes_tpu.model.math import pack_source

            source = pack_source(source)

        state = ChainState(
            clusters=clusters,
            weights=weights,
            source=source,
            log_lh=jnp.float32(-jnp.inf),
            log_prior=jnp.float32(-jnp.inf),
            prior_parts=jnp.full((4,), -jnp.inf, jnp.float32),
        )

        # One full Gibbs source step
        state = self.full_source_op(keys[2], state).state

        if self.initial_cluster_steps:
            # ML cluster steps per cluster
            for i_c in range(c.K):
                state = self.ml_step(jax.random.fold_in(keys[3], i_c), state, i_c)

            # Re-estimate weights from source ratios (initializers.py:299-305)
            from sbayes_tpu.model.math import source_comp

            hc = cond.post.has_components(state.clusters).astype(jnp.float32)
            s_counts = jnp.stack(
                [source_comp(state.source, i, jnp.float32).sum(0)
                 for i in range(c.C)], axis=-1)                       # (F, C)
            s_ratio = s_counts / jnp.maximum(hc.sum(0, keepdims=True), 1e-35)
            state = state._replace(weights=normalize(1.0 + s_ratio, axis=-1))

            # Another full source draw and cluster refinement round
            state = self.full_source_op(keys[4], state).state
            for i_c in range(c.K):
                state = self.ml_step(jax.random.fold_in(keys[5], i_c), state, i_c)

        return state

    def generate_sample(self, key) -> ChainState:
        """Best-of-``attempts`` initial sample by likelihood
        (reference: initializers.py:211-238). Attempts are vmapped."""
        keys = jax.random.split(key, self.attempts)

        def one(k):
            state = self.generate_sample_attempt(k)
            lh = self.cond.post.log_likelihood(state)
            return state, lh

        states, lhs = jax.vmap(one)(keys)
        best = jnp.argmax(lhs)
        return jax.tree.map(lambda x: x[best], states)
