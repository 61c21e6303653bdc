"""The full posterior as pure jittable functions over a flat state PyTree.

This is the "forward pass" of the framework: one fused full recompute of
  * sufficient-statistic feature counts (matrix-product einsums),
  * collapsed Dirichlet-categorical likelihood per mixture component
    (reference: sbayes/model/likelihood.py:47-101),
  * all priors: cluster size, geo (MST over the cost matrix), weights
    Dirichlet, and source (reference: sbayes/model/prior.py:74-88).

Everything here closes over :class:`ModelConstants` and is differentiable-
free pure JAX, safe to call inside ``jit``/``vmap``/``shard_map``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammaln

from sbayes_tpu.model.constants import ModelConstants
from sbayes_tpu.model.math import (
    HIGHEST,
    dirichlet_categorical_logpdf,
    dirichlet_logpdf,
    compute_feature_counts,
    log_expit,
    normalize_weights,
    source_comp,
    source_is_packed,
    source_pick,
)
from sbayes_tpu.ops.mst import cluster_mst_edge_costs


class PosteriorParts(NamedTuple):
    """Decomposition of the posterior (columns of the stats file)."""

    log_lh: jnp.ndarray            # scalar
    size_prior: jnp.ndarray        # scalar
    geo_prior: jnp.ndarray         # scalar (sum over clusters)
    weights_prior: jnp.ndarray     # scalar
    source_prior: jnp.ndarray      # scalar

    @property
    def log_prior(self):
        return self.size_prior + self.geo_prior + self.weights_prior + self.source_prior

    def prior_vector(self):
        """(4,) [size, geo, weights, source] — ChainState.prior_parts order."""
        return jnp.stack([self.size_prior, self.geo_prior, self.weights_prior, self.source_prior])


class Posterior:
    """Pure functions evaluating likelihood and priors for a model."""

    def __init__(self, consts: ModelConstants, sample_from_prior: bool = False):
        self.consts = consts
        self.sample_from_prior = sample_from_prior

    # ---------------- mixture components ----------------

    def feature_counts(self, clusters, source):
        """(K,F,S) cluster counts and (C-1,Gmax,F,S) confounder counts."""
        c = self.consts
        return compute_feature_counts(clusters, source, jnp.asarray(c.features),
                                      jnp.asarray(c.groups), f_chunk=c.feature_chunk)

    def log_likelihood_from_counts(self, cluster_counts, conf_counts):
        c = self.consts
        lh_cl = dirichlet_categorical_logpdf(cluster_counts, jnp.asarray(c.conc_cluster)[None]).sum()
        lh_conf = dirichlet_categorical_logpdf(conf_counts, jnp.asarray(c.conc_conf)).sum()
        return lh_cl + lh_conf

    def log_likelihood_per_feature(self, cluster_counts, conf_counts):
        """Per-(row, feature) collapsed log-likelihood terms — the exact-MH
        building block: evaluating these for a candidate AND the current
        counts and summing the elementwise DIFFERENCE makes unchanged
        entries cancel exactly in f32 (identical inputs -> identical
        floats), so the MH ratio sees only the true change instead of the
        ulp(|log_lh|) quantization of differencing two ~1e7-magnitude
        totals (the f64 reference never faced this; util.py:1373-1394)."""
        c = self.consts
        lh_cl = dirichlet_categorical_logpdf(
            cluster_counts, jnp.asarray(c.conc_cluster)[None])      # (K, F)
        lh_conf = dirichlet_categorical_logpdf(
            conf_counts, jnp.asarray(c.conc_conf))                  # (C-1, G, F)
        return lh_cl, lh_conf

    def log_likelihood_diff_from_counts(self, counts_new, counts_old):
        """Exact ``log_likelihood_from_counts(new) - (old)``, lane-packed.

        Same telescoping exactness as differencing two
        ``log_likelihood_per_feature`` evaluations — the gammaln argument
        stacks are built identically for both states, so unchanged count
        cells produce bitwise-identical terms whose elementwise difference
        is exactly 0 — but without the per-feature form's small minor
        S(=n_states) axis, which pads every gammaln to the vector width.
        Here every gammaln argument (count cells of both tensors AND the
        per-(group, feature) totals) is flattened into ONE dense (X,)
        stack per state, evaluated lane-packed, subtracted, and reduced
        with a static sign vector (+1 cells, −1 totals; the gammaln(a) /
        gammaln(sum_a) constants cancel in the difference and are never
        computed)."""
        c = self.consts
        cl_new, conf_new = counts_new
        cl_old, conf_old = counts_old
        a_cl = jnp.asarray(c.conc_cluster)[None]          # (1, F, S)
        a_conf = jnp.asarray(c.conc_conf)                  # (C-1, G, F, S)

        def stack(cl, conf):
            cells_cl = jnp.where(a_cl > 0, cl + a_cl, 1.0)
            cells_conf = jnp.where(a_conf > 0, conf + a_conf, 1.0)
            tot_cl = cl.sum(-1) + a_cl.sum(-1)             # (K, F)
            tot_conf = conf.sum(-1) + a_conf.sum(-1)       # (C-1, G, F)
            return jnp.concatenate([
                cells_cl.reshape(-1), cells_conf.reshape(-1),
                tot_cl.reshape(-1), tot_conf.reshape(-1)])

        n_cells = cl_new.size + conf_new.size
        n_tot = cl_new.size // cl_new.shape[-1] + conf_new.size // conf_new.shape[-1]
        sign = jnp.concatenate([jnp.ones(n_cells, jnp.float32),
                                jnp.full((n_tot,), -1.0, jnp.float32)])
        d = gammaln(stack(cl_new, conf_new)) - gammaln(stack(cl_old, conf_old))
        return jnp.dot(sign, d, preferred_element_type=jnp.float32, precision=HIGHEST)

    def log_likelihood(self, state):
        cl_counts, conf_counts = self.feature_counts(state.clusters, state.source)
        return self.log_likelihood_from_counts(cl_counts, conf_counts)

    # ---------------- weights ----------------

    def has_components(self, clusters):
        """(N, C) availability of each mixture component at each object."""
        c = self.consts
        hc0 = jnp.any(clusters, axis=0)
        return jnp.concatenate([hc0[:, None], jnp.asarray(c.hc_conf)], axis=1)

    def normalized_weights(self, weights, clusters):
        return normalize_weights(weights, self.has_components(clusters))

    # ---------------- availability-pattern source counts ----------------

    def source_patterns(self, clusters):
        """(N,) int32 availability-pattern id of each object: the static
        confounder pattern + the dynamic any-cluster bit (encoding per
        ModelConstants.static_pat / pat_bits)."""
        c = self.consts
        n_static = c.pat_bits.shape[0] // 2
        hc0 = jnp.any(clusters, axis=0)
        return jnp.asarray(c.static_pat) + hc0.astype(jnp.int32) * n_static

    def pattern_counts(self, clusters, source):
        """(P, F, C) source counts per availability pattern — the exact
        sufficient statistic of the weights likelihood (see
        operators.make_gibbs_sample_weights). Full recompute: one
        matmul streaming the source tensor (bf16 operands are exact for
        0/1 values, f32 accumulate); the sampling loop instead maintains
        ChainState.pat_counts by delta updates and only calls this from
        fill_state / the periodic exact refresh."""
        c = self.consts
        P = int(c.pat_bits.shape[0])
        pat_oh = jax.nn.one_hot(self.source_patterns(clusters), P,
                                dtype=jnp.bfloat16)                  # (N, P)

        def slice_fn(source_t):
            f = source_t.shape[1]
            if source_is_packed(source_t):
                # per-component (P, N) @ (N, f) mask matmuls: C x fewer
                # streamed bytes than expanding the one-hot form
                return jnp.stack([
                    jnp.dot(pat_oh.T,
                            source_comp(source_t, i, jnp.bfloat16),
                            preferred_element_type=jnp.float32)
                    for i in range(c.C)
                ], axis=-1)
            m = jnp.dot(
                pat_oh.T,
                source_t.reshape(source_t.shape[0], f * c.C).astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            )
            return m.reshape(P, f, c.C)

        fc = c.feature_chunk
        if fc is None or fc >= c.F:
            return slice_fn(source)
        from sbayes_tpu.model.math import feature_tile

        cnt_t = jax.lax.map(
            lambda i: slice_fn(feature_tile(source, i, fc, axis=1)),
            jnp.arange(c.F // fc),
        )  # (T, P, fc, C)
        return jnp.moveaxis(cnt_t, 0, 1).reshape(P, c.F, c.C)

    # ---------------- priors ----------------

    def size_prior(self, clusters):
        """Cluster-size prior (reference: prior.py:629-698)."""
        c = self.consts
        dtype = jnp.float32  # lgamma wants full f32 even with bf16 features
        sizes = clusters.sum(axis=-1).astype(dtype)
        if c.size_prior_type == "uniform_area":
            return jnp.zeros((), dtype)
        if c.size_prior_type == "uniform_size":
            n = jnp.asarray(c.N, dtype)
            rest = n - sizes.sum()
            log_multinom = gammaln(n + 1.0) - gammaln(sizes + 1.0).sum() - gammaln(rest + 1.0)
            return -log_multinom
        if c.size_prior_type == "quadratic":
            return -jnp.sum(jnp.log(sizes**2))
        raise ValueError(f"Unknown size prior type {c.size_prior_type}")

    # ---------------- geo prior ----------------
    #
    # The skeleton aggregate of each cluster is pure function of its
    # membership mask, so it can be CARRIED in the chain state
    # (ChainState.geo_agg, (K, 3) = [total, n_edges, max_edge]) and
    # re-derived only for the cluster(s) an operator actually changed —
    # one masked-Prim MST per step instead of K (eval) + 2 (proposal
    # weighting). The carried triple is exact: it is recomputed (not
    # delta-updated) for the changed cluster, matching the reference's
    # per-changed-cluster recompute (prior.py:769-805) with the
    # unchanged clusters' values cached — the compile-time analogue of
    # the reference's per-cluster geo-prior cache.

    @property
    def carry_geo(self) -> bool:
        """Whether states should carry per-cluster skeleton aggregates."""
        return self.consts.geo.prior_type != "uniform"

    def _mst_engine(self) -> str:
        """MST kernel choice (read at trace time).

        'prim' — masked early-exit Prim (ops/mst.py): minimal FLOPs, but
        sequential depth = cluster size, and under vmap the while_loop runs
        to the BATCH-MAX size (one big cluster serializes every chain).
        'boruvka' — log-depth contraction (ops/boruvka.py): fixed
        ceil(log2 N) rounds of dense (N, N) reductions regardless of batch
        composition. 'prim_mm' — Prim with the row select as a one-hot
        matmul. Env SBAYES_TPU_MST=prim|prim_mm|boruvka|auto; auto picks a
        Prim form by N (the choice is still to be measured on the GPU,
        ROADMAP Speed 3)."""
        import os

        eng = os.environ.get("SBAYES_TPU_MST", "auto")
        if eng != "auto":
            return eng
        # prim_mm re-reads the whole (N, N) cost matrix per iteration
        # through its matmul row-select; past ~2k objects the gather form's
        # O(B·N) per-iteration traffic is smaller.
        return "prim_mm" if self.consts.N <= 2048 else "prim"

    def _mst_triple(self, cost, mask):
        """(total, n_edges, max_edge) of one cluster's MST (engine-switched)."""
        eng = self._mst_engine()
        if eng == "boruvka":
            from sbayes_tpu.ops.boruvka import cluster_mst_stats

            return cluster_mst_stats(cost, mask)
        if eng == "prim_mm":
            from sbayes_tpu.ops.mst import cluster_mst_stats_prim

            return cluster_mst_stats_prim(cost, mask)
        edges, count = cluster_mst_edge_costs(cost, mask)
        return edges.sum(), count.astype(cost.dtype), edges.max()

    def _geo_cost_matrix(self):
        c = self.consts
        cost = jnp.asarray(c.cost_matrix)
        if c.geo.prior_type == "simulated":
            cost = cost * (0.020838 / c.geo.mean_edge_length)
        return cost

    def skeleton_triple(self, mask):
        """(3,) [total, n_edges, max_edge] of one cluster's skeleton."""
        c = self.consts
        g = c.geo
        cost = self._geo_cost_matrix()
        dtype = cost.dtype
        skeleton = "mst" if g.prior_type == "simulated" else g.skeleton
        if skeleton == "mst":
            total, count, max_e = self._mst_triple(cost, mask)
            return jnp.stack([total, count.astype(dtype), max_e])
        if skeleton == "complete_graph":
            outer = (mask[:, None] & mask[None, :]).astype(dtype)
            total = (cost * outer).sum()
            n_edges = outer.sum()
            max_e = jnp.where(outer > 0, cost, -jnp.inf).max()
            return jnp.stack([total, n_edges, jnp.maximum(max_e, 0.0)])
        if skeleton == "delaunay":
            total, n_edges, max_e = _delaunay_cluster_aggregate(
                mask, np.asarray(c.locations), np.asarray(c.cost_matrix))
            return jnp.stack([total, n_edges, max_e])
        raise ValueError(f"Unsupported skeleton for carried geo: {skeleton}")

    def geo_agg_of(self, clusters):
        """(K, 3) carried skeleton aggregates, or None when not carried."""
        if not self.carry_geo:
            return None
        return jax.vmap(self.skeleton_triple)(clusters)

    def _aggregate_of_triple(self, triple):
        g = self.consts.geo
        total, n_edges, max_e = triple[..., 0], triple[..., 1], triple[..., 2]
        if g.aggregation == "sum":
            return total
        if g.aggregation == "mean":
            return total / jnp.maximum(n_edges, 1.0)
        if g.aggregation == "max":
            return jnp.maximum(max_e, 0.0)
        raise ValueError(f"Unknown aggregation {g.aggregation}")

    def geo_prior_from_agg(self, clusters, geo_agg):
        """(K,) geo-prior log-probs from carried aggregates (same math as
        :meth:`geo_prior_per_cluster` without the skeleton recompute)."""
        g = self.consts.geo
        if g.prior_type == "cost_based":
            return self._geo_probability_function(self._aggregate_of_triple(geo_agg))
        if g.prior_type == "simulated":
            n = clusters.sum(-1).astype(geo_agg.dtype)
            return _simulated_sigmoid(geo_agg[:, 0], n)
        raise ValueError(f"Unknown geo prior type {g.prior_type}")

    def _geo_probability_function(self, agg_cost):
        g = self.consts.geo
        if g.probability_function == "exponential":
            return -agg_cost / g.scale
        if g.probability_function == "sigmoid":
            x0 = g.inflection_point
            s = g.scale
            return log_expit(-(agg_cost - x0) / s) - log_expit(x0 / s)
        raise ValueError(f"Unknown probability_function {g.probability_function}")

    def _skeleton_aggregate(self, mask):
        """Aggregate cost along the configured skeleton of one cluster."""
        c = self.consts
        g = c.geo
        cost = jnp.asarray(c.cost_matrix)
        dtype = cost.dtype
        if g.skeleton == "mst":
            total, n_edges, max_e = self._mst_triple(cost, mask)
        elif g.skeleton == "complete_graph":
            # Aggregate over the full (m, m) submatrix incl. the diagonal,
            # matching reference np aggregation over cost_mat[c][:, c].
            outer = (mask[:, None] & mask[None, :]).astype(dtype)
            total = (cost * outer).sum()
            n_edges = outer.sum()
            max_e = jnp.where(outer > 0, cost, -jnp.inf).max()
        elif g.skeleton == "delaunay":
            # Exact reference semantics (prior.py:807-821): recompute the
            # Delaunay graph of the CLUSTER's OWN points (the dual of the
            # per-cluster Voronoi-Rook contiguity) per evaluation. The
            # triangulation is data-dependent geometry — evaluated host-side
            # via pure_callback with static (3,) outputs. Only configs with
            # skeleton=delaunay pay the host round-trip.
            total, n_edges, max_e = _delaunay_cluster_aggregate(
                mask, np.asarray(self.consts.locations),
                np.asarray(self.consts.cost_matrix))
        elif g.skeleton == "diameter":
            raise NotImplementedError("skeleton=diameter is not implemented (matches reference).")
        else:
            raise ValueError(f"Unknown skeleton {g.skeleton}")

        if g.aggregation == "sum":
            return total
        if g.aggregation == "mean":
            return total / jnp.maximum(n_edges, 1).astype(dtype)
        if g.aggregation == "max":
            return jnp.maximum(max_e, 0.0)
        raise ValueError(f"Unknown aggregation {g.aggregation}")

    def geo_prior_per_cluster(self, clusters):
        """(K,) geo-prior log-probabilities (reference: prior.py:769-805)."""
        c = self.consts
        g = c.geo
        dtype = jnp.asarray(c.cost_matrix).dtype
        if g.prior_type == "uniform":
            return jnp.zeros((c.K,), dtype)
        if g.prior_type == "cost_based":
            agg = jax.vmap(self._skeleton_aggregate)(clusters)
            return self._geo_probability_function(agg)
        if g.prior_type == "simulated":
            cost = jnp.asarray(c.cost_matrix) * (0.020838 / g.mean_edge_length)

            def one(mask):
                total, _count, _max_e = self._mst_triple(cost, mask)
                n = mask.sum().astype(dtype)
                return _simulated_sigmoid(total, n)

            return jax.vmap(one)(clusters)
        raise ValueError(f"Unknown geo prior type {g.prior_type}")

    def geo_prior_costs_per_object(self, clusters, i_cluster, geo_agg=None):
        """Delta log-geo-prior of adding each object to cluster ``i_cluster``.

        Reference: prior.py:824-852 ``get_costs_per_object``.
        Returns (N,) array of prob(after) - prob(before).

        ``geo_agg`` may pass the state's carried (K, 3) skeleton
        aggregates, replacing the in-place MST recompute (the reference
        keeps the analogous per-cluster aggregate cached on the sample).
        """
        c = self.consts
        g = c.geo
        cost = jnp.asarray(c.cost_matrix)
        dtype = cost.dtype
        if g.prior_type == "uniform":
            return jnp.zeros((c.N,), dtype)

        cluster = clusters[i_cluster]
        m = cluster.sum().astype(dtype)
        cost_to_cluster = jnp.where(cluster[:, None], cost, jnp.inf).min(axis=0)

        # Carried aggregates are on the simulated-scaled cost matrix for
        # prior_type=simulated; this proposal-weighting path matches the
        # reference's unscaled-MST form, so only cost_based may reuse them.
        if geo_agg is not None and g.prior_type == "cost_based" and g.skeleton == "mst":
            total, count = geo_agg[i_cluster, 0], geo_agg[i_cluster, 1]
            max_edge = geo_agg[i_cluster, 2]
        else:
            total, count, max_edge = self._mst_triple(cost, cluster)
        if g.aggregation == "mean":
            aggr_before = total / jnp.maximum(count, 1).astype(dtype)
            aggr_after = (cost_to_cluster + m * aggr_before) / (1 + m)
        elif g.aggregation == "sum":
            aggr_before = total
            aggr_after = cost_to_cluster + aggr_before
        elif g.aggregation == "max":
            aggr_before = max_edge
            aggr_after = jnp.maximum(cost_to_cluster, aggr_before)
        else:
            raise ValueError(f"Aggregation {g.aggregation} not implemented for costs-per-object.")

        return self._geo_probability_function(aggr_after) - self._geo_probability_function(aggr_before)

    def weights_prior(self, weights):
        """Dirichlet prior on mixture weights (reference: prior.py:522-551)."""
        c = self.consts
        if c.weights_prior_uniform:
            return jnp.zeros((), weights.dtype)
        return self.weights_prior_pointwise(weights).sum()

    def weights_prior_pointwise(self, weights):
        """Per-feature weights prior (reference: prior.py:553-558)."""
        return dirichlet_logpdf(weights, jnp.asarray(self.consts.conc_weights))

    def source_prior(self, clusters, weights, source):
        """log P(source | weights) (reference: prior.py:568-611)."""
        c = self.consts
        hc = self.has_components(clusters)
        na = jnp.asarray(c.na)

        def logp_of(weights_t, source_t, na_t):
            w = normalize_weights(weights_t, hc)
            p = source_pick(w, source_t)
            valid = ~na_t
            return jnp.where(valid, jnp.log(jnp.where(valid, p, 1.0)), 0.0).sum()

        fc = c.feature_chunk
        if fc is None or fc >= c.F:
            return logp_of(weights, source, na)

        from sbayes_tpu.model.math import feature_tile

        def tile_body(i):
            return logp_of(feature_tile(weights, i, fc, axis=0),
                           feature_tile(source, i, fc, axis=1),
                           feature_tile(na, i, fc, axis=1))

        return jax.lax.map(tile_body, jnp.arange(c.F // fc)).sum()

    # ---------------- bundles ----------------

    def parts(self, state, counts=None) -> PosteriorParts:
        """Full posterior decomposition; ``counts`` may pass in the state's
        precomputed sufficient-statistic counts (operators maintain exact
        candidate counts in ChainState.cl_counts/conf_counts)."""
        if self.sample_from_prior:
            log_lh = jnp.zeros((), jnp.float32)
        elif counts is not None:
            log_lh = self.log_likelihood_from_counts(*counts)
        else:
            log_lh = self.log_likelihood(state)
        return PosteriorParts(
            log_lh=log_lh,
            size_prior=self.size_prior(state.clusters),
            geo_prior=self.geo_prior_per_cluster(state.clusters).sum(),
            weights_prior=self.weights_prior(state.weights),
            source_prior=self.source_prior(state.clusters, state.weights, state.source),
        )

    def __call__(self, state):
        """Return (log_lh, log_prior)."""
        p = self.parts(state)
        return p.log_lh, p.log_prior

    def fill_state(self, state):
        """Return the state with log_lh / log_prior / prior_parts AND the
        carried sufficient-statistic counts + geo aggregates filled (the
        invariants every operator maintains incrementally from here on)."""
        counts = self.feature_counts(state.clusters, state.source)
        p = self.parts(state, counts=counts)
        return state._replace(
            log_lh=p.log_lh, log_prior=p.log_prior, prior_parts=p.prior_vector(),
            cl_counts=counts[0], conf_counts=counts[1],
            geo_agg=self.geo_agg_of(state.clusters),
            pat_counts=self.pattern_counts(state.clusters, state.source),
        )


def _delaunay_host(mask, locations, cost):
    """Host-side per-cluster Delaunay skeleton aggregation.

    Mirrors reference prior.py:807-821 (libpysal Voronoi + Rook = the
    Delaunay graph of the cluster's points). Returns (total, n_edges,
    max_edge) over the skeleton's edge costs; degenerate clusters
    (<3 points or collinear) fall back to the complete graph, matching
    the chain every triangulation of such point sets degenerates to.
    """
    import numpy as _np

    mask = _np.asarray(mask)
    idx = _np.flatnonzero(mask)
    m = idx.size
    if m < 2:
        return _np.zeros(3, _np.float32)
    sub_cost = _np.asarray(cost)[_np.ix_(idx, idx)]
    if m == 2:
        e = float(sub_cost[0, 1])
        return _np.asarray([e, 1.0, e], _np.float32)
    try:
        from sbayes_tpu.data.geo import compute_delaunay

        adj = compute_delaunay(_np.asarray(locations)[idx]).toarray() > 0
        _np.fill_diagonal(adj, False)
        iu = _np.triu(adj)
    except Exception:
        iu = _np.triu(_np.ones((m, m), bool), k=1)
    edges = sub_cost[iu]
    if edges.size == 0:
        iu = _np.triu(_np.ones((m, m), bool), k=1)
        edges = sub_cost[iu]
    return _np.asarray([edges.sum(), float(edges.size), edges.max()], _np.float32)


def _delaunay_cluster_aggregate(mask, locations_np, cost_np):
    """jittable wrapper: (N,) bool mask -> (total, n_edges, max_edge)."""
    out = jax.pure_callback(
        lambda mk: _delaunay_host(mk, locations_np, cost_np),
        jax.ShapeDtypeStruct((3,), jnp.float32),
        mask,
        vmap_method="sequential",
    )
    return out[0], out[1], out[2]


def _simulated_sigmoid(total_distance, n):
    """Fitted logistic areality prior (reference: prior.py:900-925)."""
    logn = jnp.log(jnp.maximum(n, 1.0))
    a, b, c, d = -1.62973132061948, 12.7679075267602, -25.4137798184766, 17.237407405487
    intercept = a * logn**3 + b * logn**2 + c * logn + d
    a2, b2, c2, d2 = -31.397363895626, 1.02000702311327, -94.0788824218419, 0.93626444975598
    coeff = a2 * b2 ** (-n) + c2 / jnp.maximum(n, 1.0) + d2
    return log_expit(coeff * total_distance + intercept)
