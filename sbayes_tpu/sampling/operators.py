"""The MCMC operator suite as pure jittable transition functions.

Every operator has the signature ``op(key, state) -> OpResult`` and is a
branch of one ``lax.switch`` inside the step kernel. Sentinel transition
probabilities force acceptance (Gibbs: log_q = -inf, log_q_back = 0) or
rejection (log_q = 0, log_q_back = -inf), consumed by the MH kernel —
reference semantics: sbayes/sampling/operators.py:241-247, mcmc.py:295-298.

Proposal mechanics mirror the reference operator suite exactly (grow/shrink
with boundary corrections, collapsed "Gibbsish" membership posteriors with
the weight-flip marginal trick, cluster-wide Bernoulli resampling with
standstill exclusion, inter-cluster jumps, Gibbs source/weight resampling)
— reference citations on each operator. The heavy math is fused static-
shape linear algebra; probability heating happens in logit space for
numerical robustness.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.scipy.special import betaln

from sbayes_tpu.model.math import (
    HIGHEST,
    compact_indices,
    conditional_effect_mean,
    dirichlet_categorical_delta,
    gather_cols,
    gather_const_rows,
    gather_rows,
    normalize,
    normalize_weights,
    pack_source,
    sample_categorical_onehot,
    source_is_packed,
    source_n_changed,
)
from sbayes_tpu.sampling.conditionals import EPS32, Conditionals
from sbayes_tpu.sampling.state import ChainState

Q_GIBBS = -jnp.inf
Q_BACK_GIBBS = 0.0
Q_REJECT = 0.0
Q_BACK_REJECT = -jnp.inf

TINY = 1e-35


class OpResult(NamedTuple):
    state: ChainState
    log_q: jnp.ndarray
    log_q_back: jnp.ndarray
    step_size: jnp.ndarray  # operator-specific step size (for stats)
    # Exact source-prior delta of the move (None -> the MH kernel streams a
    # full source_prior recompute). Subset moves compute it from their
    # gathered rows in O(m·F); the carried log-prior then updates by +delta
    # (the exact delta also feeds the MH ratio directly — at scale the
    # carried totals' f32 ulp would otherwise quantize the ratio;
    # logged per-sample values are full recomputes via the sample view).
    source_prior_delta: jnp.ndarray = None
    # Exact log-likelihood delta of the move (None -> the MH kernel
    # evaluates log_likelihood_from_counts). Single-object movers compute
    # it in O(F·S) logs via math.dirichlet_categorical_delta.
    ll_delta: jnp.ndarray = None
    # Deferred source-row update ``(obj_idx (m,), new_rows (m, F, C))``:
    # ``state.source`` in the returned state is the UNTOUCHED old buffer
    # and the MH kernel scatters the rows only after the accept decision
    # (one row write instead of a full-buffer scatter + two full-buffer
    # selects — the source tensor is the biggest leaf by far at scale).
    # Padded/rejected entries use index N (out of bounds): XLA drops the
    # writes. Requires source_prior_delta (and carried counts): the
    # kernel must not recompute source-dependent terms from the stale
    # buffer.
    source_rows: tuple = None


def _reject(state, with_delta: bool = False,
            with_ll_delta: bool = False, source_rows=None) -> "OpResult":
    """Forced-reject result; ``with_delta``/``with_ll_delta``/
    ``source_rows`` must match the paired accept branch's OpResult
    structure. Pass the SAME ``source_rows`` object as the accept branch
    (with indices pre-masked to N on rejection): ``_select_result``'s
    tree-select then folds to the identity on the row arrays."""
    z = jnp.float32
    return OpResult(state, jnp.asarray(Q_REJECT, z), jnp.asarray(-jnp.inf, z),
                    jnp.asarray(0.0, z),
                    jnp.asarray(0.0, z) if with_delta else None,
                    jnp.asarray(0.0, z) if with_ll_delta else None,
                    source_rows)


def _select_result(pred, a: OpResult, b: OpResult) -> OpResult:
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def resolve_result_state(res: OpResult):
    """Materialize a deferred source-row write (OpResult.source_rows) into
    the full state — for tests and direct op inspection. The MH kernel
    performs this scatter inline after the accept decision."""
    if res.source_rows is None:
        return res.state
    idx, rows = res.source_rows
    from sbayes_tpu.model.math import scatter_rows

    return res.state._replace(source=scatter_rows(res.state.source, idx, rows))


# Named scope of the membership marginals (the gibbsish proposals' and the
# jump's O(N·F) pass): traces attribute device time to it
# (sbayes_tpu/profiling.py).
MARGINAL_SCOPE = "membership_marginal"


def _masked_categorical(key, p, mask):
    """Draw an index ~ p restricted to ``mask`` (p need not be normalized)."""
    logits = jnp.where(mask, jnp.log(jnp.maximum(p, TINY)), -jnp.inf)
    return jax.random.categorical(key, logits)


def _heat_prob(p, temperature):
    """p**(1/T) / (p**(1/T) + (1-p)**(1/T)) via logits (stable)."""
    logit = jnp.log(jnp.maximum(p, TINY)) - jnp.log(jnp.maximum(1.0 - p, TINY))
    return jax.nn.sigmoid(logit / temperature)


class OperatorFactory:
    """Builds the jittable operator suite for one model + temperature."""

    def __init__(self, cond: Conditionals, p_grow: float = 0.5):
        self.cond = cond
        self.consts = cond.consts
        self.T = cond.T
        self.Tp = cond.Tp
        self.sample_from_prior = cond.sample_from_prior
        self.p_grow = p_grow
        # Static cap on the wide operator's gathered changed set. Small
        # models resample via rows at full width (no truncation); large
        # ones bound the per-step source-resample work at O(cap * F)
        # with symmetric auto-reject beyond the cap (see
        # make_alter_cluster_wide). Env override: SBAYES_TPU_WIDE_ROWS_CAP.
        import os

        N = self.consts.N
        cap_env = os.environ.get("SBAYES_TPU_WIDE_ROWS_CAP")
        if cap_env is not None:
            self.wide_rows_cap = min(N, int(cap_env))
        else:
            self.wide_rows_cap = N if N <= 1024 else max(512, N // 16)

    # ==================================================================
    # Shared cluster-posterior math
    # ==================================================================

    # ------------------------------------------------------------------
    # Cluster-effect proposal library (reference: ClusterEffectProposals,
    # operators.py:1252-1379). 'gibbs' is the default used by the
    # scheduled operators; 'residual' and 'residual_counts' are kept for
    # capability parity (selectable on the wide operator).
    # ------------------------------------------------------------------

    def _posterior_counts(self, prior_counts, feature_counts):
        c = self.consts
        unif = jnp.asarray(c.unif_conc)
        return unif + (prior_counts - unif) / self.Tp + feature_counts / self.T

    def cluster_effect_proposal_gibbs(self, state, cl_counts, conf_counts, i_cluster):
        c = self.consts
        return normalize(
            self._posterior_counts(jnp.asarray(c.conc_cluster), cl_counts[i_cluster]), axis=-1
        )

    def cluster_effect_proposal_residual(self, state, cl_counts, conf_counts, i_cluster):
        c = self.consts
        feats = jnp.asarray(c.features)
        free = (~jnp.any(state.clusters, axis=0)).astype(feats.dtype)
        counts = jnp.einsum("n,nfs->fs", free, feats,
                            preferred_element_type=jnp.float32, precision=HIGHEST)
        return normalize(self._posterior_counts(jnp.asarray(c.conc_cluster), counts), axis=-1)

    def cluster_effect_proposal_residual_counts(self, state, cl_counts, conf_counts, i_cluster):
        """Residual counts above the expected confounder mixture, restricted
        to the objects with above-quantile likelihood contribution
        (reference: operators.py:1299-1340)."""
        c = self.consts
        feats = jnp.asarray(c.features)
        cluster = state.clusters[i_cluster]
        free = (~jnp.any(state.clusters, axis=0)) | cluster
        size = cluster.sum()
        n_free = free.sum()

        exp_conf = self.cond.expected_confounder_features(state.clusters, state.weights, conf_counts)
        residual = jnp.clip(feats - exp_conf, 0.0, None) * free[:, None, None]
        residual_counts = residual.sum(0)
        conc = jnp.asarray(c.conc_cluster)
        p = normalize(self._posterior_counts(conc, residual_counts), axis=-1)

        # keep only objects with above-quantile likelihood contribution
        lh = (p[None] * residual).sum((1, 2))
        q = 1.0 - size / jnp.maximum(n_free, 1)
        lh_masked = jnp.where(free, lh, jnp.nan)
        thresh = jnp.nanquantile(lh_masked, q)
        relevant = free & (lh >= thresh)
        residual_counts = (residual * relevant[:, None, None].astype(feats.dtype)).sum(0)
        return normalize(self._posterior_counts(conc, residual_counts), axis=-1)

    def _log_marginal_with_without(self, state, i_cluster, avail, effect_proposal="gibbs",
                                   counts=None, heat_effect_lh=False):
        """(log_m0, log_m1): (N,) ABSOLUTE log marginal lh of each object
        without/with cluster membership, meaningful at ``avail`` — the
        test-oracle form. Production proposal code wants
        ``_cluster_log_odds`` instead (single log per element)."""
        with jax.named_scope(MARGINAL_SCOPE):
            return self._marginal_impl(state, i_cluster, avail, effect_proposal,
                                       counts, heat_effect_lh, ratio=False)

    def _cluster_log_odds(self, state, i_cluster, avail, effect_proposal="gibbs",
                          counts=None, heat_effect_lh=False):
        """(N,) signed log-odds ``log_m1 - log_m0`` of cluster membership —
        what every proposal feeds into a sigmoid. Computed directly with
        ONE log per (object, feature) element (the ratio form); returning only the difference makes accidental use
        as an absolute marginal a shape error, not silent garbage."""
        with jax.named_scope(MARGINAL_SCOPE):
            return self._marginal_impl(state, i_cluster, avail, effect_proposal,
                                       counts, heat_effect_lh, ratio=True)

    def _marginal_impl(self, state, i_cluster, avail, effect_proposal,
                       counts, heat_effect_lh, ratio):
        """The collapsed membership marginals used by the Gibbsish operators
        (reference: operators.py:1035-1095 ``compute_cluster_posterior``
        and :1420-1472 ``compute_raw_cluster_probs``): replace component-0
        likelihood by the proposal cluster effect, combine with
        renormalized weights for the flipped/unflipped availability
        pattern, and take the product over features — here in log space.

        Feature-separable given the counts: with ``consts.feature_chunk``
        set the body lax.maps over F-tiles (only the 'gibbs' effect
        proposal supports tiling; the residual proposals are full-F).

        ratio=False -> (log_m0, log_m1) absolute marginals;
        ratio=True  -> the (N,) signed log-odds alone."""
        c = self.consts
        cond = self.cond

        if counts is None:
            counts = cond.post.feature_counts(state.clusters, state.source)
        cl_counts, conf_counts = counts

        # Weights with/without cluster membership (weight-flip trick):
        # per-object component availability is F-free, weights are tiled.
        hc = cond.post.has_components(state.clusters)
        hc_flip = hc.at[:, 0].set(~hc[:, 0])
        in_cluster_now = hc[:, 0]

        fc = c.feature_chunk
        chunked = fc is not None and fc < c.F and effect_proposal == "gibbs"

        if not chunked:
            feats = jnp.asarray(c.features)
            na = jnp.asarray(c.na)
            proposal = getattr(self, f"cluster_effect_proposal_{effect_proposal}")
            p_eff = proposal(state, cl_counts, conf_counts, i_cluster)
            conc_cluster_t = jnp.asarray(c.conc_cluster)
            conc_conf_t = jnp.asarray(c.conc_conf)
            weights_t = state.weights
            cl_counts_t, conf_counts_t = cl_counts, conf_counts

        # Per-object confounder effects come from a dense one-hot matmul
        # over the (tiny) group axis instead of a row-gather by group index
        # (ROADMAP Speed 3 re-decides this form on the GPU). Hoisted:
        # F-independent.
        groups_arr = jnp.asarray(c.groups)
        hc_f = hc.astype(jnp.float32)            # (N, C)
        hc_flip_f = hc_flip.astype(jnp.float32)

        def slice_body(p_eff, feats_t, na_t, weights_t, cl_counts_t, conf_counts_t,
                       conc_cluster_t, conc_conf_t):
            """Marginal mixture via the closed form
                lh(n,f) = Σ_c wh[f,c]·avail[n,c]·lh_c[n,f] / Σ_c wh[f,c]·avail[n,c]
            (normalize_weights + heating collapse to this: (w·m)^(1/Tp)
            renormalized equals w^(1/Tp)·m renormalized for 0/1 masks m).
            Only (N, f) temporaries — no (N, f, C) weight tensors, no wasted
            component-0 likelihood (it is replaced by the proposal effect).
            """
            cluster_lh = jnp.einsum("fs,nfs->nf", p_eff, feats_t,
                                    preferred_element_type=jnp.float32, precision=HIGHEST)
            if heat_effect_lh:
                # The wide operator's raw-probs variant heats the component-0
                # likelihood once more before the weight mixture (reference
                # compute_raw_cluster_probs, operators.py:1445 — absent from
                # compute_cluster_posterior, operators.py:1055). No-op at T=1.
                cluster_lh = jnp.maximum(cluster_lh, TINY) ** (1.0 / self.T)
            lh_comps = [jnp.where(na_t, 1.0, cluster_lh)]

            conf_eff = normalize(conf_counts_t + conc_conf_t, axis=-1)  # (C-1,G,f,S)
            for i_c in range(c.C - 1):
                eff_rows = jnp.einsum("gn,gfs->nfs", groups_arr[i_c],
                                      conf_eff[i_c], precision=HIGHEST)  # (N, f, S)
                lh_c = jnp.einsum("nfs,nfs->nf", eff_rows, feats_t,
                                  preferred_element_type=jnp.float32, precision=HIGHEST)
                lh_comps.append(jnp.where(na_t, 1.0, lh_c))

            wh = weights_t ** (1.0 / self.Tp)                           # (f, C)
            z_cur = jnp.einsum("nc,fc->nf", hc_f, wh, precision=HIGHEST)
            z_flip = jnp.einsum("nc,fc->nf", hc_flip_f, wh, precision=HIGHEST)
            s_cur = sum(wh[None, :, ci] * hc_f[:, ci, None] * lh_comps[ci]
                        for ci in range(c.C))
            s_flip = sum(wh[None, :, ci] * hc_flip_f[:, ci, None] * lh_comps[ci]
                         for ci in range(c.C))

            if ratio:
                # signed log-odds with ONE log per (n, f): log(lh_cur /
                # lh_flip) via two O(1)-magnitude quotients; the per-object
                # incl sign distributes over the feature sum.
                r = (s_cur / jnp.maximum(s_flip, TINY)) \
                    * (z_flip / jnp.maximum(z_cur, TINY))
                lr = jnp.log(jnp.maximum(r, TINY)).sum(-1)
                return jnp.where(in_cluster_now, lr, -lr)

            lh_cur = s_cur / jnp.maximum(z_cur, TINY)
            lh_flip = s_flip / jnp.maximum(z_flip, TINY)

            lh_with = jnp.where(in_cluster_now[:, None], lh_cur, lh_flip)
            lh_without = jnp.where(in_cluster_now[:, None], lh_flip, lh_cur)
            log_m1 = jnp.log(jnp.maximum(lh_with, TINY)).sum(-1)
            log_m0 = jnp.log(jnp.maximum(lh_without, TINY)).sum(-1)
            return log_m0, log_m1

        if not chunked:
            out = slice_body(p_eff, feats, na, weights_t, cl_counts_t,
                             conf_counts_t, conc_cluster_t, conc_conf_t)
            if ratio:
                return out / self.T
            return out[0] / self.T, out[1] / self.T

        from sbayes_tpu.model.math import feature_tile

        unif = jnp.asarray(c.unif_conc)
        conc_cluster = jnp.asarray(c.conc_cluster)
        conc_conf = jnp.asarray(c.conc_conf)
        feats_full = jnp.asarray(c.features)
        na_full = jnp.asarray(c.na)

        def tile_body(i):
            conc_cluster_t = feature_tile(conc_cluster, i, fc, axis=0)
            unif_t = feature_tile(unif, i, fc, axis=0)
            cl_counts_t = feature_tile(cl_counts, i, fc, axis=1)
            # 'gibbs' effect proposal on the tile (F-separable)
            p_eff = normalize(
                unif_t + (conc_cluster_t - unif_t) / self.Tp + cl_counts_t[i_cluster] / self.T,
                axis=-1,
            )
            return slice_body(
                p_eff,
                feature_tile(feats_full, i, fc, axis=1),
                feature_tile(na_full, i, fc, axis=1),
                feature_tile(state.weights, i, fc, axis=0),
                cl_counts_t,
                feature_tile(conf_counts, i, fc, axis=2),
                conc_cluster_t,
                feature_tile(conc_conf, i, fc, axis=2),
            )

        parts = jax.lax.map(tile_body, jnp.arange(c.F // fc))
        if ratio:
            return parts.sum(0) / self.T
        m0_t, m1_t = parts
        return m0_t.sum(0) / self.T, m1_t.sum(0) / self.T

    def _cluster_posterior(self, state, i_cluster, avail, consider_geo, geo_scaler=1.0,
                           additive_smoothing=1e-6, gibbsish=True, effect_proposal="gibbs",
                           counts=None, heat_effect_lh=False):
        """(N,) membership probability of each object (meaningful at avail)."""
        if self.sample_from_prior or not gibbsish:
            return jnp.full((self.consts.N,), 0.5, jnp.float32)

        odds = self._cluster_log_odds(
            state, i_cluster, avail, effect_proposal=effect_proposal, counts=counts,
            heat_effect_lh=heat_effect_lh,
        )
        if consider_geo:
            geo = self.cond.post.geo_prior_costs_per_object(
                state.clusters, i_cluster, geo_agg=state.geo_agg)
            odds = odds + geo / self.Tp / geo_scaler

        p = jax.nn.sigmoid(odds)
        if additive_smoothing > 0:
            a = additive_smoothing
            p = (p + a) / (1 + 2 * a)
        return p

    def _occupied(self, clusters):
        return jnp.any(clusters, axis=0)

    def _state_counts(self, state):
        """The carried sufficient-statistic counts of ``state`` (recomputed
        only on counts-less states, e.g. inside the initializer)."""
        if state.cl_counts is None:
            return self.cond.post.feature_counts(state.clusters, state.source)
        return (state.cl_counts, state.conf_counts)

    @staticmethod
    def _put_counts(state, counts):
        """Write the (cl_counts, conf_counts) invariant into a state (no-op
        payload for counts-less initializer states is fine: the structure
        only ever moves from None -> arrays at the op entry)."""
        return state._replace(cl_counts=counts[0], conf_counts=counts[1])

    def _delta_counts(self, counts, obj, clusters_old, clusters_new,
                      src_old_row, src_new_row):
        """Exact O(F·S) sufficient-statistic update for ONE object's
        membership/source change (grow/shrink/jump), plus the exact
        log-likelihood delta of the move. Replaces the full O(N·F·S)
        count einsum AND the full lgamma likelihood recompute for the
        candidate state — exact because the counts are integer-valued f32
        (sums of 0/1 products < 2^24), so lgamma differences collapse to
        logs of the touched entries (math.dirichlet_categorical_delta).

        Args:
            counts: (cl_counts (K,F,S), conf_counts (C-1,G,F,S)) of the OLD
                state.
            obj: the changed object's index.
            src_old_row / src_new_row: (F, C) one-hot source rows of obj.
        Returns:
            (cl_counts_new, conf_counts_new, ll_delta): the candidate
            counts and the scalar log_likelihood(new) - log_likelihood(old).
        """
        c = self.consts
        cl_counts, conf_counts = counts
        feats_o = jnp.asarray(c.features)[obj]  # (F, S)
        dtype = feats_o.dtype

        old0 = feats_o * src_old_row[:, 0].astype(dtype)[:, None]  # (F, S)
        new0 = feats_o * src_new_row[:, 0].astype(dtype)[:, None]
        d_cl = (
            clusters_new[:, obj].astype(jnp.float32)[:, None, None]
            * new0[None].astype(jnp.float32)
            - clusters_old[:, obj].astype(jnp.float32)[:, None, None]
            * old0[None].astype(jnp.float32)
        )                                                           # (K, F, S)
        cl = cl_counts + d_cl

        g_o = jnp.asarray(c.groups)[:, :, obj].astype(jnp.float32)  # (C-1, Gmax)
        oldc = feats_o[None] * src_old_row[:, 1:].T.astype(dtype)[:, :, None]  # (C-1,F,S)
        newc = feats_o[None] * src_new_row[:, 1:].T.astype(dtype)[:, :, None]
        d_conf_row = (newc - oldc).astype(jnp.float32)               # (C-1, F, S)
        conf = conf_counts + g_o[:, :, None, None] * d_conf_row[:, None]

        # Exact log-likelihood delta: only the objects' cluster row(s) and
        # one group row per confounder change — logs of those entries,
        # no lgamma streams (K is tiny, so all K rows are evaluated; rows
        # with d == 0 contribute exactly 0).
        conc_cl = jnp.asarray(c.conc_cluster)                        # (F, S)
        ll_d = dirichlet_categorical_delta(cl_counts, conc_cl[None], d_cl).sum()
        # gather the single touched group row per confounder (g_o is
        # one-hot or all-zero; all-zero -> row/a/d are zero -> delta 0)
        row_old = jnp.einsum("cg,cgfs->cfs", g_o, conf_counts, precision=HIGHEST)
        a_row = jnp.einsum("cg,cgfs->cfs", g_o, jnp.asarray(c.conc_conf), precision=HIGHEST)
        has_g = g_o.sum(-1)[:, None, None]                           # (C-1,1,1)
        ll_d = ll_d + dirichlet_categorical_delta(
            row_old, a_row, d_conf_row * has_g).sum()
        return cl, conf, ll_d

    def _delta_pat(self, pat_counts, obj_idx, valid, hc0_old, hc0_new,
                   old_rows, new_rows):
        """Exact availability-pattern count update (ChainState.pat_counts)
        for the changed source rows at ``obj_idx``: remove each old row at
        its old pattern, add the new row at its new pattern. Exact in f32
        (integer-valued counts; bf16 operands are exact for 0/1 rows).
        ``hc0_old/new``: (m,) any-cluster membership bit of each object
        before/after the move (the only dynamic pattern bit)."""
        if pat_counts is None:
            return None
        c = self.consts
        P = int(c.pat_bits.shape[0])
        n_static = P // 2
        static_m = jnp.asarray(c.static_pat).at[obj_idx].get(mode="clip")
        pat_old = static_m + hc0_old.astype(jnp.int32) * n_static
        pat_new = static_m + hc0_new.astype(jnp.int32) * n_static
        v = valid.astype(jnp.bfloat16)[:, None]
        oh_old = jax.nn.one_hot(pat_old, P, dtype=jnp.bfloat16) * v    # (m, P)
        oh_new = jax.nn.one_hot(pat_new, P, dtype=jnp.bfloat16) * v
        m = obj_idx.shape[0]
        old_f = old_rows.reshape(m, -1).astype(jnp.bfloat16)           # (m, F*C)
        new_f = new_rows.reshape(m, -1).astype(jnp.bfloat16)
        delta = (
            jnp.dot(oh_new.T, new_f, preferred_element_type=jnp.float32)
            - jnp.dot(oh_old.T, old_f, preferred_element_type=jnp.float32)
        )
        return pat_counts + delta.reshape(pat_counts.shape)

    def _update_geo(self, geo_agg, clusters_new, *changed_clusters):
        """Re-derive the carried (K, 3) geo-skeleton aggregates for the
        changed cluster indices only (exact recompute of the changed
        rows; see ChainState.geo_agg). No-op when geo is not carried."""
        if geo_agg is None:
            return None
        for i in changed_clusters:
            geo_agg = geo_agg.at[i].set(self.cond.post.skeleton_triple(clusters_new[i]))
        return geo_agg

    def _grow_candidates(self, clusters, i_cluster, neighbourhood: str):
        """Boolean growth-candidate mask (reference: operators.py:1097-1107)."""
        occ = self._occupied(clusters)
        if neighbourhood == "everywhere":
            return ~occ
        adj = jnp.asarray(self.consts.adjacency).astype(jnp.float32)
        cluster = clusters[i_cluster].astype(jnp.float32)
        reach = jnp.matmul(adj, cluster, precision=HIGHEST)
        if neighbourhood == "twostep":
            reach = jnp.matmul(adj, reach, precision=HIGHEST)
        return (reach > 0) & ~occ

    # ==================================================================
    # AlterCluster: grow/shrink one object (naive and Gibbsish variants)
    # Reference: operators.py:969-1249
    # ==================================================================

    def make_alter_cluster(self, gibbsish: bool, neighbourhood: str, consider_geo: bool) -> Callable:
        cond = self.cond
        consts = self.consts
        K, N = consts.K, consts.N
        min_size, max_size = consts.min_size, consts.max_size
        p_grow = self.p_grow

        def posterior(state, i_cluster, avail, counts=None):
            return self._cluster_posterior(
                state, i_cluster, avail, consider_geo=consider_geo, gibbsish=gibbsish,
                counts=counts,
            )

        def op(key, state):
            # Grow and shrink share ONE implementation with the branch as
            # DATA (jnp.where selections), not as a lax.cond: under vmap a
            # cond lowers to both-branches-execute + select, and the two
            # branches' expensive parts are identical computations — the
            # forward membership marginal does not depend on the candidate
            # mask, and the rows-resample / count-delta / geo-update chain
            # only differs in its (traced) inputs. The cond form paid 4
            # marginal passes + 2 resample/delta chains per step where 2
            # passes + 1 chain suffice. Proposal semantics are unchanged
            # from the reference's grow/shrink pair (operators.py:1113-1235).
            k_c, k_g, k_obj, k_src = jax.random.split(key, 4)
            i_cluster = jax.random.randint(k_c, (), 0, K)
            cluster = state.clusters[i_cluster]
            size = cluster.sum()
            at_min = size == min_size
            at_max = size == max_size
            boundary = at_min | at_max
            do_grow = jnp.where(at_min, True, jnp.where(at_max, False, jax.random.uniform(k_g) < p_grow))

            counts = self._state_counts(state)
            state = self._put_counts(state, counts)

            # Forward marginal (one pass; grow and shrink select from it)
            grow_cand = self._grow_candidates(state.clusters, i_cluster, neighbourhood)
            p_post = _heat_prob(posterior(state, i_cluster, grow_cand, counts), self.T)
            p_vec = jnp.where(
                do_grow,
                jnp.where(grow_cand, p_post, 0.0),
                jnp.where(cluster, 1.0 - p_post, 0.0),
            )
            total = p_vec.sum()
            fwd_mask = jnp.where(do_grow, grow_cand, cluster)
            obj = _masked_categorical(k_obj, p_vec, fwd_mask | ~jnp.any(fwd_mask))
            p_fwd = p_vec / jnp.maximum(total, TINY)
            rejected = jnp.where(
                do_grow,
                (~jnp.any(grow_cand)) | (size >= max_size) | (total <= 0),
                (size <= min_size) | (total <= 0),
            )

            clusters_new = state.clusters.at[i_cluster, obj].set(do_grow)
            rs = cond.gibbs_resample_source_rows(
                k_src, state, clusters_new, obj[None], jnp.ones(1, bool),
                i_cluster, counts)
            src_obj = gather_rows(state.source, obj[None], consts.C)   # (1, F, C)
            cl_new, conf_new, ll_d = self._delta_counts(
                counts, obj, state.clusters, clusters_new,
                src_obj[0], rs.new_rows[0])
            counts_new = (cl_new, conf_new)
            pat_new = self._delta_pat(
                state.pat_counts, obj[None], jnp.ones(1, bool),
                jnp.any(state.clusters[:, obj], axis=0)[None],
                jnp.any(clusters_new[:, obj], axis=0)[None],
                src_obj, rs.new_rows)
            # source stays the OLD buffer: the row write is deferred to the
            # MH kernel via OpResult.source_rows (rs.new_rows).
            state_new = self._put_counts(
                state._replace(
                    clusters=clusters_new,
                    geo_agg=self._update_geo(state.geo_agg, clusters_new, i_cluster),
                    pat_counts=pat_new,
                ), counts_new)

            # Backward marginal (one pass on the selected new state).
            # Grow's reverse is a removal from clusters_new; shrink's is an
            # add over the new state's grow candidates (which must contain
            # the removed object, else reject — reference parity).
            back_grow_cand = self._grow_candidates(clusters_new, i_cluster, neighbourhood)
            rejected = rejected | (~do_grow & ~back_grow_cand[obj])
            p_back = _heat_prob(
                posterior(state_new, i_cluster, clusters_new[i_cluster], counts_new),
                self.T)
            pb_vec = jnp.where(
                do_grow,
                jnp.where(clusters_new[i_cluster], 1.0 - p_back, 0.0),
                jnp.where(back_grow_cand, p_back, 0.0),
            )
            p_bwd = pb_vec / jnp.maximum(pb_vec.sum(), TINY)

            lp_grow = jnp.log(p_grow)
            lp_shrink = jnp.log1p(-p_grow)
            log_q = (jnp.log(jnp.maximum(p_fwd[obj], TINY)) + rs.log_q
                     + jnp.where(do_grow, lp_grow, lp_shrink))
            log_q_back = (jnp.log(jnp.maximum(p_bwd[obj], TINY)) + rs.log_q_back
                          + jnp.where(do_grow, lp_shrink, lp_grow))
            # Deferred row write: index masked to N on rejection (write
            # dropped); both select branches share the SAME rows object so
            # the tree-select folds on it.
            rows = (jnp.where(rejected, N, obj)[None], rs.new_rows)
            res = OpResult(state_new, log_q, log_q_back, jnp.float32(1.0),
                           source_prior_delta=rs.source_prior_delta,
                           ll_delta=ll_d, source_rows=rows)
            res = _select_result(rejected,
                                 _reject(state, with_delta=True, with_ll_delta=True,
                                         source_rows=rows),
                                 res)
            # Boundary correction -log(2) on the backward probability
            corr = jnp.where(boundary & jnp.isfinite(res.log_q_back), -jnp.log(2.0), 0.0)
            return res._replace(log_q_back=res.log_q_back + corr)

        return op

    # ==================================================================
    # AlterClusterWide: resample the full membership vector of one cluster
    # Reference: operators.py:1382-1568
    # ==================================================================

    def _make_wide_cluster_probs(self, consider_geo: bool, w_stay: float,
                                 eps: float, geo_scaler: float,
                                 effect_proposal: str = "gibbs") -> Callable:
        """Per-object Bernoulli proposal probabilities of the wide operator
        (reference: compute_cluster_probs, operators.py:1399-1418):
        posterior mixed with the current cluster, rescaled so the expected
        proposal size matches the current size."""

        def cluster_probs(state, i_cluster, avail, counts=None):
            cluster = state.clusters[i_cluster]
            p_raw = self._cluster_posterior(
                state, i_cluster, avail, consider_geo=consider_geo,
                geo_scaler=geo_scaler, additive_smoothing=0.0,
                effect_proposal=effect_proposal, counts=counts,
                heat_effect_lh=True,
            )
            p_raw = jnp.where(avail, p_raw, 0.0)
            p = (p_raw + EPS32) / jnp.maximum((p_raw + EPS32 * avail).sum(), TINY) * avail
            p_n = (p + eps) / jnp.maximum((p + eps * avail).sum(), TINY)
            stay = cluster.astype(jnp.float32)
            stay_n = stay / jnp.maximum(stay.sum(), TINY)
            p = ((1 - w_stay) * p_n + w_stay * stay_n) * avail

            # Rescale so the expected size matches the current size
            old_size = (cluster & avail).sum().astype(jnp.float32)

            def body(_, carry):
                p, done = carry
                new_exp = p.sum()
                p2 = jnp.clip(p * old_size / jnp.maximum(new_exp, TINY), eps, 1 - eps) * avail
                p2 = jnp.where(done, p, p2)
                done2 = done | (p2.sum() > 0.975 * old_size)
                return p2, done2

            # Unrolled (was lax.fori_loop): 10 fixed iterations of tiny
            # elementwise+reduce ops — straight-line code lets XLA fuse the
            # whole rescale into a handful of thunks instead of paying the
            # while-loop per-iteration overhead twice per wide step (this
            # loop runs in BOTH the forward and backward proposal probs).
            carry = (p, jnp.asarray(False))
            for _ in range(10):
                carry = body(None, carry)
            p = carry[0]
            return jnp.where(avail, p, 0.0)

        return cluster_probs

    def _make_em_cluster_probs(self, consider_geo: bool, w_stay: float,
                               eps: float, n_em_steps: int = 10) -> Callable:
        """Per-object Bernoulli proposal of AlterClusterEM (reference:
        operators.py:1571-1665): soft-EM group responsibilities over
        clusters + confounder groups with annealed temperature
        ``(n_steps/(1+i))^2``, seeded with the Gibbs cluster-effect
        proposal, then the same stay-mixture + expected-size rescale as
        the wide operator. Behavioural parity note: the FIRST rescale
        iteration divides by ``z.sum()`` (= N, the full responsibility
        mass), exactly as the reference does (operators.py:1659-1668)."""
        c = self.consts
        N, K = c.N, c.K

        # (K + total confounder groups, N) availability of each EM group
        ga_rows = [jnp.ones((K, N), bool)]
        groups_b = jnp.asarray(self.consts.groups).astype(bool)      # (C-1, Gmax, N)
        gv_b = jnp.asarray(self.consts.group_valid).astype(bool)     # (C-1, Gmax)
        for i_c in range(c.C - 1):
            ga_rows.append(groups_b[i_c] & gv_b[i_c][:, None])
        ga = jnp.concatenate(ga_rows, axis=0)              # (Gt, N)
        Gt = ga.shape[0]
        prior_counts = 0.5 * jnp.asarray(c.applicable, jnp.float32)  # (F, S)

        def cluster_probs(state, i_cluster, avail, counts=None):
            if self.sample_from_prior:
                return jnp.where(avail, 0.5, 0.0)
            cluster = state.clusters[i_cluster]
            feats = jnp.asarray(c.features).astype(jnp.float32)     # (N, F, S)
            na = jnp.asarray(c.na)
            feats_filled = jnp.where(na[:, :, None], 1.0, feats)

            cl_counts, conf_counts = (counts if counts is not None
                                      else self._state_counts(state))
            p_clust = self.cluster_effect_proposal_gibbs(
                state, cl_counts, conf_counts, i_cluster)            # (F, S)

            z0 = ga.astype(jnp.float32)
            z0 = z0.at[:K].set(state.clusters.astype(jnp.float32))
            z0 = z0.at[i_cluster].set(jnp.where(avail, 1.0, z0[i_cluster]))
            z0 = z0 / jnp.maximum(z0.sum(0, keepdims=True), TINY)

            cost = jnp.asarray(c.cost_matrix)

            def em_step(i_step, z):
                state_counts = jnp.einsum("gn,nfs->gfs", z, feats,
                                          preferred_element_type=jnp.float32, precision=HIGHEST)
                p = normalize(state_counts + prior_counts[None], axis=-1)
                p = lax.cond(i_step == 0,
                             lambda p: p.at[i_cluster].set(p_clust),
                             lambda p: p, p)
                # per-group, per-object log-likelihoods (log-space for
                # stability; the reference's prod over features underflows
                # benignly in float64, we don't have that luxury)
                log_pw = jnp.einsum("gfs,nfs->gn", jnp.log(jnp.maximum(p, TINY)),
                                    feats_filled, preferred_element_type=jnp.float32, precision=HIGHEST)
                if consider_geo:
                    z_peaky = jax.nn.softmax(N * z, axis=1)
                    avg_dist = jnp.matmul(z_peaky, cost, precision=HIGHEST)  # (Gt, N)
                    geo_log = -avg_dist / c.geo.scale / 2.0
                    geo_log = geo_log.at[K:].set(
                        jnp.log(jnp.maximum(jnp.exp(geo_log[:K]).mean(0), TINY)))
                else:
                    geo_log = jnp.zeros((Gt, N), jnp.float32)
                temperature = (n_em_steps / (1.0 + i_step)) ** 2
                log_lh = geo_log + log_pw / temperature
                log_lh = jnp.where(ga, log_lh, -jnp.inf)
                log_lh = log_lh.at[i_cluster].set(
                    jnp.where(avail, log_lh[i_cluster], -jnp.inf))
                return jax.nn.softmax(log_lh, axis=0)

            z = lax.fori_loop(0, n_em_steps, em_step, z0)

            z_cl = jnp.where(avail, z[i_cluster], 0.0)
            z_cl = z_cl / jnp.maximum(z_cl.sum(), TINY)
            z_eps = (z_cl + eps) * avail
            z_eps = z_eps / jnp.maximum(z_eps.sum(), TINY)
            stay = (cluster & avail).astype(jnp.float32)
            stay_n = stay / jnp.maximum(stay.sum(), TINY)
            p = (1 - w_stay) * z_eps + w_stay * stay_n

            old_size = (cluster & avail).sum().astype(jnp.float32)

            def body(_, carry):
                p, prev_exp, done = carry
                p2 = jnp.clip(p * old_size / jnp.maximum(prev_exp, TINY),
                              eps, 1 - eps) * avail
                p2 = jnp.where(done, p, p2)
                new_exp = p2.sum()
                done2 = done | (new_exp > 0.975 * old_size)
                return p2, new_exp, done2

            # first division is by the TOTAL z mass (reference behavior)
            p, _, _ = lax.fori_loop(0, 10, body,
                                    (p, z.sum(), jnp.asarray(False)))
            return jnp.where(avail, p, 0.0)

        return cluster_probs

    def make_alter_cluster_wide(self, consider_geo: bool, w_stay: float = 0.15,
                                eps: float = None, geo_scaler: float = 2.0,
                                effect_proposal: str = "gibbs",
                                em_proposal: bool = False,
                                n_em_steps: int = 10) -> Callable:
        """The whole-membership resampling operator. ``em_proposal=True``
        selects the AlterClusterEM proposal probabilities (reference
        operators.py:1571-1665) instead of the collapsed-posterior wide
        probabilities (reference operators.py:1382-1568); the MH/q-ratio
        machinery is shared, as in the reference's class hierarchy."""
        cond = self.cond
        consts = self.consts
        K, N = consts.K, consts.N
        min_size, max_size = consts.min_size, consts.max_size
        if eps is None:
            eps = 0.01 / consts.N
        if em_proposal:
            cluster_probs = self._make_em_cluster_probs(
                consider_geo, w_stay, eps, n_em_steps)
        else:
            cluster_probs = self._make_wide_cluster_probs(
                consider_geo, w_stay, eps, geo_scaler, effect_proposal
            )

        def op(key, state):
            k_c, k_draw, k_src = jax.random.split(key, 3)
            i_cluster = jax.random.randint(k_c, (), 0, K)
            cluster_old = state.clusters[i_cluster]
            avail = (~self._occupied(state.clusters)) | cluster_old

            counts = self._state_counts(state)
            state = self._put_counts(state, counts)
            p = cluster_probs(state, i_cluster, avail, counts)

            # Redraw until the proposal differs from the current cluster
            def draw(k):
                return (jax.random.uniform(k, (N,)) < p) & avail

            def cond_fn(carry):
                k, c_new, n_draws = carry
                return jnp.all(c_new == (cluster_old & avail)) & (n_draws < 100)

            def body_fn(carry):
                k, _, n_draws = carry
                k1, k2 = jax.random.split(k)
                return k2, draw(k1), n_draws + 1

            k1, k2 = jax.random.split(k_draw)
            _, cluster_draw, _ = lax.while_loop(
                cond_fn, body_fn, (k2, draw(k1), jnp.int32(1)))

            cluster_new = jnp.where(avail, cluster_draw, cluster_old)
            new_size = cluster_new.sum()
            standstill = jnp.all(cluster_new == cluster_old)
            rejected = (new_size < min_size) | (new_size > max_size) | standstill

            q_site = jnp.where(cluster_draw, p, 1.0 - p)
            log_q = jnp.where(avail, jnp.log(jnp.maximum(q_site, TINY)), 0.0).sum()
            ss_site = jnp.where(cluster_old, p, 1.0 - p)
            log_p_ss = jnp.where(avail, jnp.log(jnp.maximum(ss_site, TINY)), 0.0).sum()
            log_q = log_q - jnp.log1p(-jnp.minimum(jnp.exp(log_p_ss), 1 - 1e-7))

            clusters_new = state.clusters.at[i_cluster].set(cluster_new)
            changed = cluster_old != cluster_new
            m = changed.sum()
            # Gathered-rows source resample + count deltas over the changed
            # set (expected-bounded); proposals flipping more than the
            # static cap auto-reject — a symmetric truncation (flip count
            # is identical forward and backward), so plain MH on the
            # restricted proposal stays exact. M >= N disables it.
            M = self.wide_rows_cap
            rejected = rejected | (m > M)
            # fill_value=N (out of bounds): scatter updates at padded
            # entries are dropped by XLA, so duplicate-index write
            # conflicts with real rows cannot occur; gathers clamp and are
            # masked by ``valid``.
            obj_idx = compact_indices(changed, M, N)
            valid = jnp.arange(M) < m
            src_rows_old = gather_rows(state.source, obj_idx, consts.C)
            rs = cond.gibbs_resample_source_rows(
                k_src, state, clusters_new, obj_idx, valid, i_cluster, counts)
            feats_m = gather_const_rows(jnp.asarray(consts.features), obj_idx)
            counts_new = cond.delta_counts_rows_move(
                counts, state.clusters, clusters_new, obj_idx, valid,
                src_rows_old, rs.new_rows, feats_m)
            pat_new = self._delta_pat(
                state.pat_counts, obj_idx, valid,
                jnp.any(gather_cols(state.clusters, obj_idx) > 0.5, axis=0),
                jnp.any(gather_cols(clusters_new, obj_idx) > 0.5, axis=0),
                src_rows_old, rs.new_rows)
            # source stays the OLD buffer: row write deferred to the MH
            # kernel (OpResult.source_rows). The backward cluster_probs
            # below reads only counts/weights/clusters — never source.
            state_new = self._put_counts(
                state._replace(
                    clusters=clusters_new,
                    geo_agg=self._update_geo(state.geo_agg, clusters_new, i_cluster),
                    pat_counts=pat_new,
                ), counts_new)

            p_back = cluster_probs(state_new, i_cluster, avail, counts_new)
            qb_site = jnp.where(cluster_old, p_back, 1.0 - p_back)
            log_q_back = jnp.where(avail, jnp.log(jnp.maximum(qb_site, TINY)), 0.0).sum()
            ssb_site = jnp.where(cluster_new, p_back, 1.0 - p_back)
            log_p_ssb = jnp.where(avail, jnp.log(jnp.maximum(ssb_site, TINY)), 0.0).sum()
            log_q_back = log_q_back - jnp.log1p(-jnp.minimum(jnp.exp(log_p_ssb), 1 - 1e-7))

            rows = (jnp.where(rejected, N, obj_idx), rs.new_rows)
            res = OpResult(
                state_new,
                log_q + rs.log_q,
                log_q_back + rs.log_q_back,
                changed.sum().astype(jnp.float32),
                source_prior_delta=rs.source_prior_delta,
                source_rows=rows,
            )
            res = _select_result(
                rejected, _reject(state, with_delta=True, source_rows=rows), res)
            # keep the flip count visible on rejected proposals too (the MH
            # kernel only accumulates step_size on accepts, so stats are
            # unaffected; probes read it to measure the wide-cap
            # auto-reject rate, m > wide_rows_cap)
            return res._replace(step_size=m.astype(jnp.float32))

        return op

    def make_ml_cluster_step(self, consider_geo: bool = True, w_stay: float = 0.1,
                             eps: float = 1e-6, geo_scaler: float = 2.0) -> Callable:
        """Deterministic maximum-likelihood cluster step for the initializer.

        Thresholds the wide-operator proposal probabilities at the current
        cluster size (reference: AlterClusterWide.ml_step,
        operators.py:1474-1502). Returns ``step(key, state, i_cluster)``.
        """
        cond = self.cond
        consts = self.consts
        cluster_probs = self._make_wide_cluster_probs(consider_geo, w_stay, eps, geo_scaler)

        def ml_step(key, state, i_cluster):
            cluster_old = state.clusters[i_cluster]
            avail = (~self._occupied(state.clusters)) | cluster_old
            p = jnp.where(avail, cluster_probs(state, i_cluster, avail), -jnp.inf)
            size = jnp.clip(cluster_old.sum(), consts.min_size, consts.max_size)
            # threshold at the size-th largest probability
            sorted_p = jnp.sort(p)[::-1]
            thresh = sorted_p[jnp.maximum(size - 1, 0)]
            cluster_new = (p >= thresh) & avail
            ok = (consts.min_size <= cluster_new.sum()) & (cluster_new.sum() <= consts.max_size)
            cluster_new = jnp.where(ok, cluster_new, cluster_old)
            clusters_new = state.clusters.at[i_cluster].set(cluster_new)
            changed = cluster_old != cluster_new
            rs = cond.gibbs_resample_source(key, state, clusters_new, changed, i_cluster)
            state_new = state._replace(
                clusters=clusters_new, source=rs.source,
                geo_agg=self._update_geo(state.geo_agg, clusters_new, i_cluster))
            if state.cl_counts is not None:
                # keep the carried-counts invariant through initializer steps
                state_new = self._put_counts(
                    state_new, cond.post.feature_counts(clusters_new, rs.source))
            if state.pat_counts is not None:
                state_new = state_new._replace(
                    pat_counts=cond.post.pattern_counts(clusters_new, rs.source))
            return state_new

        return ml_step

    # ==================================================================
    # ClusterJump: move one object between two clusters
    # Reference: operators.py:1668-1827
    # ==================================================================

    def make_cluster_jump(self, gibbsish: bool = True) -> Callable:
        cond = self.cond
        consts = self.consts
        K, N = consts.K, consts.N
        na = jnp.asarray(consts.na)

        # Proposal-probability numerics (scale-aware policy, like the
        # source-op sweep): the reference exponentiates both marginals in
        # f32 and floors to EPS (get_jump_lh, operators.py:1679-1722) —
        # at a few hundred features BOTH products underflow, so at scale
        # every jump proposal collapses to uniform 0.5 and the gibbsish
        # marginal work is wasted. At large F we default to the
        # numerically exact log-space form sigmoid((log_jump-log_stay)/T)
        # — a documented divergence that only changes the PROPOSAL (MH
        # corrects it; stationary distribution untouched) and restores an
        # informative jump at scale. Env SBAYES_TPU_JUMP_LOGSPACE=1/0
        # overrides the default (F >= 512).
        import os

        _env = os.environ.get("SBAYES_TPU_JUMP_LOGSPACE")
        logspace = (consts.F >= 512) if _env is None else _env == "1"

        def jump_lh(state, cl_counts, conf_counts, i_src, i_tgt):
            """(N,) probability that each source-cluster member prefers the
            target cluster (reference: get_jump_lh, operators.py:1679-1722).
            Meaningful at members of cluster i_src. Keeps the reference's
            float32-EPS flooring semantics (tiny products become uniform)
            at reference scale; log-space at large F (see above).
            Feature-separable: tiles over F when consts.feature_chunk set."""
            c = consts
            hc = cond.post.has_components(state.clusters)
            hc_f = hc.astype(jnp.float32)
            groups = jnp.asarray(c.groups)

            def slice_logs(feats_t, na_t, weights_t, cl_counts_t, conf_counts_t,
                           conc_cluster_t, unif_t, conc_conf_t):
                """Partial (N,) log-lh sums for stay/jump on one F-slice,
                via the closed-form weight mixture (see
                _log_marginal_with_without) — only (N, f) temporaries."""

                def effect(i):
                    return conditional_effect_mean(
                        prior_counts=conc_cluster_t,
                        feature_counts=cl_counts_t[i],
                        unif_counts=unif_t,
                        prior_temperature=self.Tp,
                        temperature=self.T,
                    )

                p_conf_eff = conditional_effect_mean(
                    prior_counts=conc_conf_t,
                    feature_counts=conf_counts_t,
                    unif_counts=unif_t[None, None],
                    prior_temperature=self.Tp,
                    temperature=self.T,
                )
                wh = weights_t ** (1.0 / self.Tp)                      # (f, C)
                z = jnp.einsum("nc,fc->nf", hc_f, wh, precision=HIGHEST)
                s_conf = jnp.zeros_like(z)
                for i_c in range(c.C - 1):
                    eff_rows = jnp.einsum("gn,gfs->nfs", groups[i_c],
                                          p_conf_eff[i_c], precision=HIGHEST)  # (N, f, S)
                    lh_c = jnp.einsum("nfs,nfs->nf", eff_rows, feats_t,
                                      preferred_element_type=jnp.float32, precision=HIGHEST)
                    s_conf = s_conf + wh[None, :, 1 + i_c] * hc_f[:, 1 + i_c, None] * lh_c

                def log_marginal(p_clust):
                    lh0 = jnp.einsum("fs,nfs->nf", p_clust, feats_t,
                                     preferred_element_type=jnp.float32, precision=HIGHEST)
                    mix = (s_conf + wh[None, :, 0] * hc_f[:, 0, None] * lh0) \
                        / jnp.maximum(z, TINY)
                    return jnp.where(~na_t, jnp.log(jnp.maximum(mix, TINY)), 0.0).sum(-1)

                return log_marginal(effect(i_src)), log_marginal(effect(i_tgt))

            fc = c.feature_chunk
            chunked = fc is not None and fc < c.F
            if not chunked:
                log_stay, log_jump = slice_logs(
                    jnp.asarray(c.features), na, state.weights, cl_counts, conf_counts,
                    jnp.asarray(c.conc_cluster), jnp.asarray(c.unif_conc),
                    jnp.asarray(c.conc_conf),
                )
            else:
                from sbayes_tpu.model.math import feature_tile

                feats_full, na_full = jnp.asarray(c.features), jnp.asarray(c.na)
                conc_cl, unif, conc_cf = (jnp.asarray(c.conc_cluster),
                                          jnp.asarray(c.unif_conc),
                                          jnp.asarray(c.conc_conf))

                def tile_body(i):
                    return slice_logs(
                        feature_tile(feats_full, i, fc, axis=1),
                        feature_tile(na_full, i, fc, axis=1),
                        feature_tile(state.weights, i, fc, axis=0),
                        feature_tile(cl_counts, i, fc, axis=1),
                        feature_tile(conf_counts, i, fc, axis=2),
                        feature_tile(conc_cl, i, fc, axis=0),
                        feature_tile(unif, i, fc, axis=0),
                        feature_tile(conc_cf, i, fc, axis=2),
                    )

                ls_t, lj_t = jax.lax.map(tile_body, jnp.arange(c.F // fc))
                log_stay, log_jump = ls_t.sum(0), lj_t.sum(0)

            if logspace:
                return jax.nn.sigmoid((log_jump - log_stay) / self.T)
            lh_stay = jnp.exp(log_stay / self.T) + EPS32
            lh_jump = jnp.exp(log_jump / self.T) + EPS32
            return lh_jump / (lh_jump + lh_stay)

        def op(key, state):
            k_cl, k_obj, k_src = jax.random.split(key, 3)
            perm = jax.random.permutation(k_cl, K)
            i_src, i_tgt = perm[0], perm[1]
            source_cluster = state.clusters[i_src]
            target_cluster = state.clusters[i_tgt]
            rejected = (source_cluster.sum() <= consts.min_size) | (
                target_cluster.sum() >= consts.max_size
            )

            cl_counts, conf_counts = self._state_counts(state)
            state = self._put_counts(state, (cl_counts, conf_counts))
            if gibbsish and not self.sample_from_prior:
                with jax.named_scope(MARGINAL_SCOPE):
                    pj = jump_lh(state, cl_counts, conf_counts, i_src, i_tgt)
            else:
                pj = jnp.ones(N, jnp.float32)
            pj_vec = jnp.where(source_cluster, pj, 0.0)
            p_jump = pj_vec / jnp.maximum(pj_vec.sum(), TINY)

            obj = _masked_categorical(k_obj, pj_vec, source_cluster)
            clusters_new = state.clusters.at[i_src, obj].set(False).at[i_tgt, obj].set(True)
            rs = cond.gibbs_resample_source_jump_rows(
                k_src, state, clusters_new, obj[None], jnp.ones(1, bool),
                i_cluster_new=i_tgt, i_cluster_old=i_src,
                counts=(cl_counts, conf_counts))
            src_obj = gather_rows(state.source, obj[None], consts.C)   # (1, F, C)
            cl_counts2, conf_counts2, ll_d = self._delta_counts(
                (cl_counts, conf_counts), obj, state.clusters, clusters_new,
                src_obj[0], rs.new_rows[0],
            )
            pat_new = self._delta_pat(
                state.pat_counts, obj[None], jnp.ones(1, bool),
                jnp.any(state.clusters[:, obj], axis=0)[None],
                jnp.any(clusters_new[:, obj], axis=0)[None],
                src_obj, rs.new_rows)
            # source stays the OLD buffer (row write deferred to the MH
            # kernel); the backward jump_lh reads only counts/weights/hc.
            state_new = self._put_counts(
                state._replace(
                    clusters=clusters_new,
                    geo_agg=self._update_geo(state.geo_agg, clusters_new, i_src, i_tgt),
                    pat_counts=pat_new,
                ), (cl_counts2, conf_counts2))
            if gibbsish and not self.sample_from_prior:
                pjb = jump_lh(state_new, cl_counts2, conf_counts2, i_tgt, i_src)
            else:
                pjb = jnp.ones(N, jnp.float32)
            new_tgt = clusters_new[i_tgt]
            pjb_vec = jnp.where(new_tgt, pjb, 0.0)
            p_jump_back = pjb_vec / jnp.maximum(pjb_vec.sum(), TINY)

            log_q = jnp.log(jnp.maximum(p_jump[obj], TINY)) + rs.log_q
            log_q_back = jnp.log(jnp.maximum(p_jump_back[obj], TINY)) + rs.log_q_back
            rows = (jnp.where(rejected, N, obj)[None], rs.new_rows)
            res = OpResult(state_new, log_q, log_q_back, jnp.float32(1.0),
                           source_prior_delta=rs.source_prior_delta,
                           ll_delta=ll_d, source_rows=rows)
            return _select_result(rejected,
                                  _reject(state, with_delta=True, with_ll_delta=True,
                                          source_rows=rows),
                                  res)

        return op

    # ==================================================================
    # GibbsSampleSource
    # Reference: operators.py:423-579
    # ==================================================================

    def make_gibbs_sample_source(self, object_selector: str, max_size: int) -> Callable:
        cond = self.cond
        consts = self.consts
        N, K = consts.N, consts.K
        na = jnp.asarray(consts.na)
        n_conf = len(consts.conf_names)
        min_subset = 10
        if N <= min_subset:
            object_selector = "all"
        k_cap = min(max_size, N)

        # Static group tensor rows: clusters are dynamic, confounder groups static.
        def select_subset_idx(key, state):
            """(obj_idx (k_cap,), valid (k_cap,)) distinct gathered indices.

            Equivalent in distribution to the reference's subset selection
            (operators.py:443-483): a uniform random subset, or one random
            group capped at ``max_size`` members (Gumbel top-k = uniform
            sampling without replacement within the group)."""
            k1, k2, k3 = jax.random.split(key, 3)
            if object_selector == "random_subset":
                idx = jax.random.choice(k1, N, shape=(k_cap,), replace=False)
                return idx, jnp.ones(k_cap, bool)
            # groups: pick one component uniformly, then one group within it.
            comp = jax.random.randint(k1, (), 0, 1 + n_conf)
            all_rows = [state.clusters]
            for i_c in range(n_conf):
                g = jnp.asarray(consts.groups[i_c]) > 0  # (Gmax, N)
                all_rows.append(g)
            # choose a group index within the chosen component
            n_groups_per_comp = jnp.asarray([K] + [int(n) for n in consts.n_groups], jnp.int32)
            g_idx = jax.random.randint(k2, (), 0, 10**9) % n_groups_per_comp[comp]
            # gather the member mask (rows: K cluster rows, then Gmax rows per confounder)
            stacked = jnp.concatenate(all_rows, axis=0)  # (K + n_conf*Gmax, N)
            offsets = jnp.asarray([0] + [K + i * consts.Gmax for i in range(n_conf)], jnp.int32)
            member = stacked[offsets[comp] + g_idx]

            scores = jnp.where(member, jax.random.gumbel(k3, (N,)), -jnp.inf)
            top_vals, top_idx = lax.top_k(scores, k_cap)
            return top_idx, jnp.isfinite(top_vals)

        def posterior_probs(state, counts=None):
            if self.sample_from_prior:
                w = normalize_weights(state.weights, cond.post.has_components(state.clusters))
                return normalize(w ** (1.0 / self.Tp), axis=-1)
            return cond.source_posterior(state.clusters, state.weights, state.source,
                                         counts=counts)

        def op_rows(key, state):
            """Gathered-rows path for the capped selectors: O(m·F) work —
            posterior at the m subset rows only, exact delta-count update,
            no full-tensor streams (the reference's incremental-counts
            behavior, recovered with static-size gathers)."""
            k_sel, k_draw = jax.random.split(key)
            counts_old = self._state_counts(state)
            state = self._put_counts(state, counts_old)
            obj_idx, valid = select_subset_idx(k_sel, state)
            # f32 gathered rows: see Conditionals._resample_engine_rows
            feats_m = gather_const_rows(jnp.asarray(consts.features), obj_idx)
            na_m = gather_const_rows(na, obj_idx) > 0.5
            old_rows = gather_rows(state.source, obj_idx, consts.C)
            hc_conf_m = gather_const_rows(jnp.asarray(consts.hc_conf), obj_idx) > 0.5
            hc0 = jnp.any(gather_cols(state.clusters, obj_idx) > 0.5, axis=0)
            hc_m = jnp.concatenate([hc0[:, None], hc_conf_m], axis=1)

            if self.sample_from_prior:
                w = normalize_weights(state.weights, hc_m) ** (1.0 / self.Tp)
                p = normalize(w, axis=-1)
            else:
                p = cond.source_posterior_rows(state.clusters, state.weights,
                                               counts_old, obj_idx, feats_m, na_m)
            x = sample_categorical_onehot(k_draw, p) & ~na_m[:, :, None]
            new_rows = jnp.where(valid[:, None, None], x, old_rows)

            log_q = cond._rows_logp(p, new_rows, valid, na_m)
            counts_new = cond.delta_counts_rows(counts_old, state.clusters, obj_idx,
                                                valid, old_rows, new_rows, feats_m)
            # clusters unchanged -> patterns unchanged; only rows move
            pat_new = self._delta_pat(state.pat_counts, obj_idx, valid,
                                      hc0, hc0, old_rows, new_rows)
            # source row write deferred to the MH kernel (source_rows);
            # the backward posterior below reads only counts_new.
            state_new = self._put_counts(
                state._replace(pat_counts=pat_new), counts_new)

            if self.sample_from_prior:
                p_back = p
            else:
                p_back = cond.source_posterior_rows(state.clusters, state.weights,
                                                    counts_new, obj_idx, feats_m, na_m)
            log_q_back = cond._rows_logp(p_back, old_rows, valid, na_m)

            # clusters unchanged -> availability unchanged: exact O(m·F)
            # source-prior delta for the MH kernel
            sp_delta = (
                cond.source_prior_rows_logp(state.weights, hc_m, new_rows, valid, na_m)
                - cond.source_prior_rows_logp(state.weights, hc_m, old_rows, valid, na_m)
            )
            step_size = ((new_rows ^ old_rows) & valid[:, None, None]).sum().astype(jnp.float32)
            return OpResult(state_new, log_q, log_q_back, step_size,
                            source_prior_delta=sp_delta,
                            source_rows=(obj_idx, new_rows))

        def op_rows_sweep(key, state):
            """EXACT sequential Gibbs sweep over the gathered subset.

            The reference's GibbsSampleSource draws all subset rows at once
            from the full-counts posterior and force-accepts — an
            approximation whose MH-corrected form (op_rows) collapses to
            ~zero acceptance at large F (the 20-row x 5000-feature q-gap
            concentrates at the 10k x 5k scale point). This variant restores a TRUE Gibbs
            move: objects are resampled one at a time from their exact
            leave-self-out collapsed conditional (cells factor over
            features for a single object), with carried-count deltas
            between sub-steps — forced accept is exact at any scale.
            Reference semantics heritage: calculate_source_posterior
            (operators.py:554-574) scoring + the leave-subset-out counts
            trick of component_likelihood_given_unchanged
            (operators.py:863-928), composed per object.
            """
            k_sel, k_draw = jax.random.split(key)
            counts_old = self._state_counts(state)
            state = self._put_counts(state, counts_old)
            obj_idx, valid = select_subset_idx(k_sel, state)
            feats_m = gather_const_rows(jnp.asarray(consts.features), obj_idx)
            na_m = gather_const_rows(na, obj_idx) > 0.5         # (m, F)
            old_rows = gather_rows(state.source, obj_idx, consts.C)  # (m, F, C)
            hc_conf_m = gather_const_rows(jnp.asarray(consts.hc_conf), obj_idx) > 0.5  # (m, C-1)
            hc0 = jnp.any(gather_cols(state.clusters, obj_idx) > 0.5, axis=0)   # (m,)
            hc_m = jnp.concatenate([hc0[:, None], hc_conf_m], axis=1)
            w_norm = normalize_weights(state.weights, hc_m)     # (m, F, C)
            w_heat = w_norm ** (1.0 / self.Tp)

            k_of = jnp.argmax(gather_cols(state.clusters, obj_idx), axis=0)        # (m,)
            g_of = jnp.stack([
                jnp.argmax(gather_cols(jnp.asarray(consts.groups)[c], obj_idx), axis=0)
                for c in range(n_conf)
            ]) if n_conf else jnp.zeros((0, k_cap), jnp.int32)           # (C-1, m)

            conc_cluster = jnp.asarray(consts.conc_cluster)     # (F, S)
            conc_conf = jnp.asarray(consts.conc_conf)           # (C-1, G, F, S)
            keys_m = jax.random.split(k_draw, k_cap)

            def body(carry, j):
                cl_counts, conf_counts, rows, d_acc = carry
                f_o = feats_m[j]                                # (F, S)
                row_old = rows[j].astype(jnp.float32)           # (F, C)
                v = valid[j].astype(jnp.float32)
                ko = k_of[j]
                in_cl = hc0[j].astype(jnp.float32) * v

                own0 = f_o * row_old[:, 0:1] * in_cl
                eff0 = normalize(cl_counts[ko] - own0 + conc_cluster, axis=-1)
                lh_c = [jnp.einsum("fs,fs->f", eff0, f_o,
                                   preferred_element_type=jnp.float32, precision=HIGHEST)]
                in_gs, gcs = [], []
                for c in range(n_conf):
                    gc = g_of[c, j]
                    in_g = hc_conf_m[j, c].astype(jnp.float32) * v
                    ownc = f_o * row_old[:, 1 + c:2 + c] * in_g
                    effc = normalize(conf_counts[c, gc] - ownc + conc_conf[c, gc],
                                     axis=-1)
                    lh_c.append(jnp.einsum("fs,fs->f", effc, f_o,
                                           preferred_element_type=jnp.float32, precision=HIGHEST))
                    in_gs.append(in_g)
                    gcs.append(gc)
                lh = jnp.stack(lh_c, axis=-1)                   # (F, C)
                lh = jnp.where(na_m[j][:, None], 1.0, lh)
                p = normalize(lh ** (1.0 / self.T) * w_heat[j], axis=-1)

                new_row = sample_categorical_onehot(keys_m[j], p) & ~na_m[j][:, None]
                new_row = jnp.where(valid[j], new_row, rows[j])
                nr = new_row.astype(jnp.float32)

                # Exact collapsed-likelihood delta of this sub-step, free
                # from the predictive values already in hand: moving one
                # object's source at feature f from component c_old to
                # c_new (all else fixed) changes the collapsed Dirichlet-
                # categorical log-lh by exactly
                #   log pred(x_f | c_new, leave-j-out counts)
                #   - log pred(x_f | c_old, leave-j-out counts)
                # (the lgamma telescoping collapses: lgamma(x+1)-lgamma(x)
                # = log x on both the cell and the total). ``lh`` IS that
                # leave-j-out predictive (UNheated, before the 1/T power),
                # so the delta costs two row-selects and a log — the MH
                # kernel then carries log_lh without any lgamma pass for
                # this branch. Unchanged features select identical floats
                # and cancel bitwise.
                sel_new = (lh * nr).sum(-1)                     # (F,)
                sel_old = (lh * row_old).sum(-1)
                ok = (~na_m[j]) & valid[j]
                d_j = jnp.where(
                    ok,
                    jnp.log(jnp.maximum(sel_new, 1e-35))
                    - jnp.log(jnp.maximum(sel_old, 1e-35)),
                    0.0,
                ).sum()

                d0 = f_o * (nr[:, 0:1] - row_old[:, 0:1]) * in_cl
                cl_counts = cl_counts.at[ko].add(d0)
                for c in range(n_conf):
                    dc = f_o * (nr[:, 1 + c:2 + c] - row_old[:, 1 + c:2 + c]) * in_gs[c]
                    conf_counts = conf_counts.at[c, gcs[c]].add(dc)
                rows = rows.at[j].set(new_row)
                return (cl_counts, conf_counts, rows, d_acc + d_j), None

            (cl_new, conf_new, new_rows, ll_delta), _ = lax.scan(
                body,
                (counts_old[0], counts_old[1], old_rows, jnp.zeros((), jnp.float32)),
                jnp.arange(k_cap))
            pat_new = self._delta_pat(state.pat_counts, obj_idx, valid,
                                      hc0, hc0, old_rows, new_rows)
            # source row write deferred to the MH kernel (source_rows).
            state_new = self._put_counts(
                state._replace(pat_counts=pat_new), (cl_new, conf_new))

            sp_delta = (
                cond.source_prior_rows_logp(state.weights, hc_m, new_rows, valid, na_m)
                - cond.source_prior_rows_logp(state.weights, hc_m, old_rows, valid, na_m)
            )
            step_size = ((new_rows ^ old_rows) & valid[:, None, None]).sum().astype(jnp.float32)
            return OpResult(state_new, Q_GIBBS, Q_BACK_GIBBS, step_size,
                            source_prior_delta=sp_delta, ll_delta=ll_delta,
                            source_rows=(obj_idx, new_rows))

        def op_fused(key, state):
            k_draw = key
            counts_old = self._state_counts(state)
            state = self._put_counts(state, counts_old)
            subset = jnp.ones(N, bool)

            p = posterior_probs(state, counts_old)
            x = sample_categorical_onehot(k_draw, p)
            x = x & ~na[:, :, None]
            if source_is_packed(state.source):
                source_new = jnp.where(subset[:, None], pack_source(x), state.source)
            else:
                source_new = jnp.where(subset[:, None, None], x, state.source)

            log_q = cond._masked_source_logp(p, source_new, subset)
            counts_new = cond.post.feature_counts(state.clusters, source_new)
            pat_new = (None if state.pat_counts is None else
                       cond.post.pattern_counts(state.clusters, source_new))
            state_new = self._put_counts(
                state._replace(source=source_new, pat_counts=pat_new), counts_new)
            p_back = posterior_probs(state_new, counts_new)
            log_q_back = cond._masked_source_logp(p_back, state.source, subset)

            step_size = source_n_changed(source_new, state.source)
            return OpResult(state_new, log_q, log_q_back, step_size)

        def op_tiled(key, state):
            """Two tile sweeps: sample forward from the OLD counts, then
            score the backward density from the NEW counts — identical
            math to op_fused with tile-sized intermediates."""
            from sbayes_tpu.model.math import feature_tile

            c = consts
            fc = c.feature_chunk
            n_tiles = c.F // fc
            k_draw = key
            counts_old = self._state_counts(state)
            state = self._put_counts(state, counts_old)
            subset = jnp.ones(N, bool)
            hc = cond.post.has_components(state.clusters)
            feats_full, na_full = jnp.asarray(c.features), jnp.asarray(c.na)
            conc_cl, conc_cf = jnp.asarray(c.conc_cluster), jnp.asarray(c.conc_conf)

            def probs_tile(i, weights_t, cl_counts, conf_counts, na_t):
                if self.sample_from_prior:
                    w = normalize_weights(weights_t, hc)
                    return normalize(w ** (1.0 / self.Tp), axis=-1)
                lh = cond.likelihood_per_component_slice(
                    state.clusters,
                    feature_tile(cl_counts, i, fc, axis=1),
                    feature_tile(conf_counts, i, fc, axis=2),
                    feature_tile(feats_full, i, fc, axis=1),
                    na_t,
                    feature_tile(conc_cl, i, fc, axis=0),
                    feature_tile(conc_cf, i, fc, axis=2),
                )
                w = normalize_weights(weights_t, hc)
                return normalize(lh ** (1.0 / self.T) * w ** (1.0 / self.Tp), axis=-1)

            keys = jax.random.split(k_draw, n_tiles)

            def fwd_tile(args):
                i, k = args
                na_t = feature_tile(na_full, i, fc, axis=1)
                w_t = feature_tile(state.weights, i, fc, axis=0)
                src_t = feature_tile(state.source, i, fc, axis=1)
                p = probs_tile(i, w_t, *counts_old, na_t)
                x = sample_categorical_onehot(k, p) & ~na_t[:, :, None]
                if source_is_packed(src_t):
                    src_new_t = jnp.where(subset[:, None], pack_source(x), src_t)
                else:
                    src_new_t = jnp.where(subset[:, None, None], x, src_t)
                log_q_t = cond._masked_logp_slice(p, src_new_t, subset, na_t)
                return src_new_t, log_q_t

            src_t, lq_t = jax.lax.map(fwd_tile, (jnp.arange(n_tiles), keys))
            out_shape = (c.N, c.F) if src_t.ndim == 3 else (c.N, c.F, c.C)
            source_new = jnp.moveaxis(src_t, 0, 1).reshape(out_shape)
            log_q = lq_t.sum()

            counts_new = cond.post.feature_counts(state.clusters, source_new)
            pat_new = (None if state.pat_counts is None else
                       cond.post.pattern_counts(state.clusters, source_new))
            state_new = self._put_counts(
                state._replace(source=source_new, pat_counts=pat_new), counts_new)

            def back_tile(i):
                na_t = feature_tile(na_full, i, fc, axis=1)
                w_t = feature_tile(state.weights, i, fc, axis=0)
                src_old_t = feature_tile(state.source, i, fc, axis=1)
                p_back = probs_tile(i, w_t, *counts_new, na_t)
                return cond._masked_logp_slice(p_back, src_old_t, subset, na_t)

            log_q_back = jax.lax.map(back_tile, jnp.arange(n_tiles)).sum()

            step_size = source_n_changed(source_new, state.source)
            return OpResult(state_new, log_q, log_q_back, step_size)

        if object_selector != "all":
            # Two engines for the capped selectors:
            #  * op_rows — one-shot MH-corrected draw (reference-shaped,
            #    operators.py:423-579). Healthy acceptance at reference
            #    scale; collapses to ~0 acceptance at large F (the
            #    m x F q-gap concentrates at the 10k x 5k scale point).
            #  * op_rows_sweep — exact sequential leave-self-out Gibbs,
            #    forced accept at any scale, but latency-bound (m
            #    sequential sub-steps), so it only wins where the MH
            #    version stops mixing.
            # Policy: sweep at large F; env SBAYES_TPU_SOURCE_SWEEP=1/0
            # forces either. Prior mode keeps the one-shot path (already
            # exact there: the conditional factors completely).
            import os

            env = os.environ.get("SBAYES_TPU_SOURCE_SWEEP")
            use_sweep = (consts.F >= 512) if env is None else env == "1"
            if self.sample_from_prior or not use_sweep:
                return op_rows
            # statically forced-accept (always returns Q_GIBBS): the MH
            # kernel can skip the exact-d_ll machinery for this branch
            op_rows_sweep.forced_accept = True
            return op_rows_sweep
        fc = consts.feature_chunk
        return op_tiled if (fc is not None and fc < consts.F) else op_fused

    # ==================================================================
    # GibbsSampleWeights: per-feature independent MH on two components
    # Reference: operators.py:582-693
    # ==================================================================

    def make_gibbs_sample_weights(self) -> Callable:
        cond = self.cond
        consts = self.consts
        C = consts.C
        F = consts.F
        conc_w = jnp.asarray(consts.conc_weights)

        # Availability-pattern sufficient statistics: every observation
        # selects exactly ONE component and source is all-zero at NA
        # (prior_sampling.py:61, conditionals.py `& ~na`), so the
        # per-feature source log-lh for ANY weights is a function of
        # cnt[pat, f, c] = #{objects with availability pattern pat whose
        # source picks c at feature f}:
        #
        #   ll(w)[f] = sum_{p,c} cnt[p,f,c]*log w[f,c]
        #            - sum_p (sum_c cnt[p,f,c]) * log(sum_c pat_c*w[f,c])
        #
        # cnt is CARRIED in the chain state (ChainState.pat_counts,
        # delta-updated by every source/cluster-touching operator) — this
        # branch streams NOTHING N-sized; it prices BOTH the old and the
        # proposed weights from the (P, F, C) table. Patterns are the
        # 2 * n_static_confounder_patterns ids of ModelConstants.static_pat
        # (only the any-cluster bit is dynamic); pat_bits maps each pattern
        # to its availability indicator over components.
        pat_bits = jnp.asarray(consts.pat_bits)                  # (P, C)

        def source_lh_by_feature(cnt, weights):
            """(F,) source log-lh from pattern counts (exact reordering
            of the per-object sum: log(w_sel/Z_pat) telescopes)."""
            logw = jnp.log(jnp.maximum(weights, TINY))           # (F, C)
            z = jnp.einsum("pc,fc->pf", pat_bits, weights, precision=HIGHEST)       # (P, F)
            logz = jnp.log(jnp.maximum(z, TINY))
            return (jnp.einsum("pfc,fc->f", cnt, logw, precision=HIGHEST)
                    - jnp.einsum("pf,pf->f", cnt.sum(-1), logz, precision=HIGHEST))

        def pointwise_prior(weights):
            return cond.post.weights_prior_pointwise(weights)

        def op(key, state):
            k_pair, k_beta, k_acc = jax.random.split(key, 3)
            w = state.weights

            # carried sufficient statistic; recompute only on unfilled
            # states (direct op calls in tests / initializer contexts)
            cnt = state.pat_counts                               # (P, F, C)
            if cnt is None:
                cnt = cond.post.pattern_counts(state.clusters, state.source)
            ll_old = source_lh_by_feature(cnt, w)
            lp_old = pointwise_prior(w)

            pair = jax.random.permutation(k_pair, C)
            i1, i2 = pair[0], pair[1]

            # counts over objects with BOTH components available = sum of
            # the patterns whose i1 and i2 bits are set (same indicator
            # sum as the old has_both einsum, reordered)
            both = pat_bits[:, i1] * pat_bits[:, i2]             # (P,)
            counts = jnp.einsum("p,pfc->fc", both, cnt, precision=HIGHEST) + conc_w
            c1 = counts[:, i1] / self.Tp
            c2 = counts[:, i2] / self.Tp

            a_beta, b_beta = 1.0 + c2, 1.0 + c1
            a2 = jax.random.beta(k_beta, a_beta, b_beta)
            a2 = jnp.clip(a2, 1e-7, 1 - 1e-7)

            w02 = w[:, i1] + w[:, i2]
            w_new = w.at[:, i1].set((1 - a2) * w02).at[:, i2].set(a2 * w02)
            w_new = normalize(w_new, axis=-1)

            def beta_logpdf(x, a, b):
                return (a - 1) * jnp.log(x) + (b - 1) * jnp.log1p(-x) - betaln(a, b)

            a2_old = jnp.clip(w[:, i2] / jnp.maximum(w02, TINY), 1e-7, 1 - 1e-7)
            log_q = beta_logpdf(a2, a_beta, b_beta)
            log_q_back = beta_logpdf(a2_old, a_beta, b_beta)

            ll_new = source_lh_by_feature(cnt, w_new)
            lp_new = pointwise_prior(w_new)

            p_accept = jnp.exp((ll_new + lp_new - ll_old - lp_old + log_q_back - log_q) / self.Tp)
            accept = jax.random.uniform(k_acc, (F,)) < p_accept
            weights_final = jnp.where(accept[:, None], w_new, w)

            state_new = state._replace(weights=weights_final)
            # ll_by_feature from the pattern counts IS the per-feature
            # source prior of the weights (same collapsed quantity the
            # kernel's full (N,F,C) recompute streams): hand the exact
            # accepted-feature delta over so the kernel's weights branch
            # touches nothing N-sized.
            sp_delta = jnp.where(accept, ll_new - ll_old, 0.0).sum()
            return OpResult(
                state_new,
                jnp.asarray(Q_GIBBS, jnp.float32),
                jnp.asarray(Q_BACK_GIBBS, jnp.float32),
                accept.mean().astype(jnp.float32),
                source_prior_delta=sp_delta,
            )

        return op

    # ==================================================================
    # AlterWeights: Dirichlet random-walk on two weight components
    # Reference: operators.py:371-413 (kept for capability parity; not in
    # the default schedule)
    # ==================================================================

    def make_alter_weights(self, step_precision: float = 15.0) -> Callable:
        consts = self.consts
        C, F = consts.C, consts.F

        def op(key, state):
            k_f, k_pair, k_dir = jax.random.split(key, 3)
            f_id = jax.random.randint(k_f, (), 0, F)
            pair = jax.random.permutation(k_pair, C)
            i1, i2 = pair[0], pair[1]
            w_curr = jnp.stack([state.weights[f_id, i1], state.weights[f_id, i2]])
            w_sum = w_curr.sum()
            w_t = w_curr / w_sum

            alpha = 1 + step_precision * w_t
            w_new_t = jax.random.dirichlet(k_dir, alpha)
            w_new_t = jnp.clip(w_new_t, 1e-7, 1 - 1e-7)
            w_new_t = w_new_t / w_new_t.sum()

            def dir_logpdf(x, a):
                from sbayes_tpu.model.math import dirichlet_logpdf

                return dirichlet_logpdf(x, a)

            log_q = dir_logpdf(w_new_t, alpha)
            alpha_back = 1 + step_precision * w_new_t
            log_q_back = dir_logpdf(w_t, alpha_back)

            w_new = w_new_t * w_sum
            weights = state.weights.at[f_id, i1].set(w_new[0]).at[f_id, i2].set(w_new[1])
            step_size = jnp.abs(weights - state.weights).sum()
            return OpResult(state._replace(weights=weights), log_q, log_q_back, step_size)

        return op


class OperatorSpec(NamedTuple):
    name: str
    weight: float
    fn: Callable
    changes: str = "clusters"
    parameters: dict = {}
    forced_accept: bool = False
    """``changes``: which state group the operator can modify: 'clusters'
    (may touch everything), 'source' (source array only) or 'weights'
    (weights only). The MH kernel uses this STATICALLY to recompute only
    the posterior terms the branch can change (e.g. weight moves never
    change the collapsed likelihood) — the compile-time analogue of the
    reference's cache DAG. ``forced_accept``: the operator always returns
    the Gibbs sentinel (accepted unconditionally), so the kernel skips
    the exact-MH-delta evaluation for the branch."""


def get_operator_schedule(
    cond: Conditionals,
    operators_config,
    p_grow: float = 0.5,
) -> list[OperatorSpec]:
    """Build the scheduled operator suite with reference weights.

    Reference schedule & weights: operators.py:28-209 — the cluster weight
    splits 0.025/0.025/0.025/0.025/0.6/0.05/0.25 over the naive, Gibbsish,
    wide and jump variants; source weight splits 0.4/0.6 over random-subset
    and per-group resampling; the weights operator takes the full weights
    share. Weights are normalized to 1.
    """
    factory = OperatorFactory(cond, p_grow=p_grow)
    consts = cond.consts
    geo_on = consts.geo.prior_type == "cost_based"
    w_c = operators_config.clusters
    w_w = operators_config.weights
    w_s = operators_config.source

    ops = [
        OperatorSpec("cluster_naive_n1", 0.025 * w_c,
                     factory.make_alter_cluster(gibbsish=False, neighbourhood="direct", consider_geo=False),
                     "clusters", {"neighbours": "direct", "gibbsish": False}),
        OperatorSpec("cluster_naive_n1_geo", 0.025 * w_c,
                     factory.make_alter_cluster(gibbsish=False, neighbourhood="direct", consider_geo=False),
                     "clusters", {"neighbours": "direct", "gibbsish": False}),
        OperatorSpec("cluster_naive_n2_geo", 0.025 * w_c,
                     factory.make_alter_cluster(gibbsish=False, neighbourhood="twostep", consider_geo=False),
                     "clusters", {"neighbours": "twostep", "gibbsish": False}),
        OperatorSpec("cluster_gibbsish", 0.025 * w_c,
                     factory.make_alter_cluster(gibbsish=True, neighbourhood="everywhere", consider_geo=False),
                     "clusters"),
        OperatorSpec("cluster_gibbsish_geo", 0.6 * w_c,
                     factory.make_alter_cluster(gibbsish=True, neighbourhood="everywhere", consider_geo=geo_on),
                     "clusters", {"geo": geo_on}),
        OperatorSpec("gibbsish_sample_cluster_wide_geo", 0.05 * w_c,
                     factory.make_alter_cluster_wide(consider_geo=geo_on),
                     "clusters", {"geo": geo_on, "w_stay": 0.15}),
        OperatorSpec("cluster_jump_gibbsish", 0.25 * w_c if consts.K > 1 else 0.0,
                     factory.make_cluster_jump(gibbsish=True),
                     "clusters"),
        OperatorSpec("gibbs_sample_sources", 0.4 * w_s,
                     factory.make_gibbs_sample_source("random_subset", max_size=20),
                     "source", {"object_selector": "RANDOM_SUBSET", "max_step_size": 20}),
        OperatorSpec("gibbs_sample_sources_groups", 0.6 * w_s,
                     factory.make_gibbs_sample_source("groups", max_size=30),
                     "source", {"object_selector": "GROUPS", "max_step_size": 30}),
        OperatorSpec("gibbs_sample_weights", 1.0 * w_w,
                     factory.make_gibbs_sample_weights(),
                     "weights"),
    ]

    ops = [o for o in ops if o.weight > 0]
    total = sum(o.weight for o in ops)
    return [o._replace(weight=o.weight / total,
                       forced_accept=getattr(o.fn, "forced_accept", False))
            for o in ops]
