"""Collapsed-conditional machinery shared by the Gibbs-flavored operators.

Pure JAX counterparts of reference sbayes/sampling/conditionals.py:
  * per-observation mixture-component likelihoods from posterior-mean
    effects (``likelihood_per_component``, ref:152-223),
  * leave-subset-out component likelihoods for source Gibbs resampling
    (``component_likelihood_given_unchanged``, ref: operators.py:863-928),
  * exact leave-self-out variant for unbiased likelihood logging
    (``likelihood_per_component_exact``, ref:300-367),
  * expected confounder features (ref: operators.py:1342-1379).

All functions are mask-based with static shapes: subsets are boolean
(N,)-masks, so the same compiled kernel serves any subset.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sbayes_tpu.model.constants import ModelConstants
from sbayes_tpu.model.math import (
    HIGHEST,
    conditional_effect_mean,
    gather_cols,
    gather_const_rows,
    gather_rows,
    normalize,
    normalize_weights,
    pack_source,
    sample_categorical_onehot,
    source_comp,
    source_is_packed,
    source_pick,
)
from sbayes_tpu.model.posterior import Posterior

EPS32 = jnp.float32(1.1920929e-07)  # float32 machine epsilon


class SourceResample(NamedTuple):
    # (N, F, C) new source array (mask engine), or the UNCHANGED old
    # array (rows engine: the scatter is deferred — see ``new_rows``).
    source: jnp.ndarray
    log_q: jnp.ndarray        # scalar forward log-probability
    log_q_back: jnp.ndarray   # scalar backward log-probability
    # Exact (unheated) source-prior delta of the move incl. the subset
    # rows' availability change — set by the gathered-rows engine, None on
    # the mask paths (callers then recompute the source prior in full).
    source_prior_delta: jnp.ndarray = None
    # (m, F, C) resampled rows (rows engine only). Callers hand
    # ``(obj_idx, new_rows)`` to OpResult.source_rows so the MH kernel
    # applies ONE row scatter AFTER the accept decision instead of the
    # op materializing a full (N, F, C) copy per proposal — at 10k x 5k
    # the source tensor is 150 MB/chain and the full-buffer
    # scatter+select chain was the per-branch time floor.
    new_rows: jnp.ndarray = None


class Conditionals:
    """Gibbs conditionals for a model at a given MC3 temperature."""

    def __init__(
        self,
        posterior: Posterior,
        temperature: float = 1.0,
        prior_temperature: float = 1.0,
        sample_from_prior: bool = None,
    ):
        self.post = posterior
        self.consts: ModelConstants = posterior.consts
        # Temperatures may be Python floats OR traced jax scalars: the whole
        # operator/kernel stack is built per-trace, so a vmapped per-chain
        # temperature ladder (MC3) compiles to ONE program.
        self.T = temperature
        self.Tp = prior_temperature
        # Default: inherit the posterior's mode. A silent mismatch here
        # (posterior in prior-mode, conditionals in data-mode) froze the
        # production sample_from_prior sampler — the operators proposed
        # data-driven moves while the MH target was the prior.
        if sample_from_prior is None:
            sample_from_prior = posterior.sample_from_prior
        assert sample_from_prior == posterior.sample_from_prior, (
            "Conditionals/Posterior sample_from_prior mismatch"
        )
        self.sample_from_prior = sample_from_prior

    # ------------------------------------------------------------------
    # Component likelihoods
    # ------------------------------------------------------------------

    def likelihood_per_component_slice(self, clusters, cl_counts_t, conf_counts_t,
                                       feats_t, na_t, conc_cluster_t, conc_conf_t):
        """(N, f, C) per-component likelihoods on one feature slice."""
        c = self.consts
        dtype = feats_t.dtype
        cl_eff = normalize(cl_counts_t + conc_cluster_t[None], axis=-1)
        lh0 = jnp.einsum("kn,kfs,nfs->nf", clusters.astype(dtype),
                         cl_eff, feats_t,
                         preferred_element_type=jnp.float32, precision=HIGHEST)

        conf_eff = normalize(conf_counts_t + conc_conf_t, axis=-1)
        lhc = jnp.einsum("cgn,cgfs,nfs->nfc", jnp.asarray(c.groups).astype(dtype),
                         conf_eff, feats_t,
                         preferred_element_type=jnp.float32, precision=HIGHEST)

        lh = jnp.concatenate([lh0[:, :, None], lhc], axis=-1)
        return jnp.where(na_t[:, :, None], 1.0, lh)

    def likelihood_per_component(self, clusters, cl_counts, conf_counts):
        """(N, F, C) likelihood of each observation under each component.

        Effects are the posterior means normalize(counts + prior counts);
        objects outside all clusters get 0 in component 0; NA observations
        get likelihood 1 (reference: conditionals.py:152-223).
        """
        c = self.consts
        return self.likelihood_per_component_slice(
            clusters, cl_counts, conf_counts, jnp.asarray(c.features),
            jnp.asarray(c.na), jnp.asarray(c.conc_cluster), jnp.asarray(c.conc_conf),
        )

    class _FeatureSlice(NamedTuple):
        """Per-feature constants/state restricted to one F-tile (or all of
        F on the fused path — both paths run the same math)."""

        feats: jnp.ndarray         # (N, f, S)
        na: jnp.ndarray            # (N, f)
        source: jnp.ndarray        # (N, f, C)
        weights: jnp.ndarray       # (f, C)
        conc_cluster: jnp.ndarray  # (f, S)
        unif_conc: jnp.ndarray     # (f, S)
        conc_conf: jnp.ndarray     # (C-1, Gmax, f, S)
        conf_counts: jnp.ndarray   # (C-1, Gmax, f, S)

    def _feature_slice(self, source, weights, conf_counts_full, i=None) -> "_FeatureSlice":
        """Build the _FeatureSlice for tile ``i`` (or full F if i is None)."""
        c = self.consts
        arrs = dict(
            feats=(jnp.asarray(c.features), 1),
            na=(jnp.asarray(c.na), 1),
            source=(source, 1),
            weights=(weights, 0),
            conc_cluster=(jnp.asarray(c.conc_cluster), 0),
            unif_conc=(jnp.asarray(c.unif_conc), 0),
            conc_conf=(jnp.asarray(c.conc_conf), 2),
            conf_counts=(conf_counts_full, 2),
        )
        if i is None:
            return Conditionals._FeatureSlice(**{k: a for k, (a, _) in arrs.items()})
        from sbayes_tpu.model.math import feature_tile

        fc = c.feature_chunk
        return Conditionals._FeatureSlice(
            **{k: feature_tile(a, i, fc, axis=ax) for k, (a, ax) in arrs.items()}
        )

    def _conf_counts_of(self, source):
        """(C-1, Gmax, F, S) confounder counts of a source array (per-
        component masked-feature matmuls; no 4-D einsum intermediates)."""
        c = self.consts
        feats = jnp.asarray(c.features)
        dtype = feats.dtype
        groups = jnp.asarray(c.groups).astype(dtype)
        return jnp.stack([
            jnp.einsum("gn,nfs->gfs", groups[i_c],
                       feats * source_comp(source, 1 + i_c, dtype)[:, :, None],
                       preferred_element_type=jnp.float32, precision=HIGHEST)
            for i_c in range(c.C - 1)
        ], axis=0)

    def _clgu_slice(self, clusters, subset, i_cluster, fs: "_FeatureSlice"):
        """component_likelihood_given_unchanged on one feature slice.

        Mirrors reference operators.py:863-928: the cluster effect uses
        counts of cluster members outside ``subset``; each confounder
        effect uses its full counts minus the subset's contribution.
        Only rows in ``subset`` are meaningful to the caller. Returns
        (N, f, C) heated likelihoods.
        """
        c = self.consts
        feats = fs.feats
        dtype = feats.dtype
        sub = subset.astype(dtype)

        # Cluster component: counts from (cluster & ~subset) rows.
        cluster = clusters[i_cluster]
        keep = cluster.astype(dtype) * (1.0 - sub)
        src0 = source_comp(fs.source, 0, dtype)
        cl_counts_keep = jnp.einsum("n,nf,nfs->fs", keep, src0, feats,
                                    preferred_element_type=jnp.float32, precision=HIGHEST)
        cluster_effect = conditional_effect_mean(
            prior_counts=fs.conc_cluster,
            feature_counts=cl_counts_keep,
            unif_counts=fs.unif_conc,
            prior_temperature=self.Tp,
            temperature=self.T,
        )
        lh0 = jnp.einsum("fs,nfs->nf", cluster_effect, feats,
                         preferred_element_type=jnp.float32, precision=HIGHEST)

        # Confounder components: full counts minus subset contribution.
        # Per-component loop (C tiny/static): every pairwise path of the
        # fused "cgn,n,nfc,nfs->cgfs" einsum materializes an O(N·f·S·C)
        # or O(G·N·f) intermediate.
        groups = jnp.asarray(c.groups).astype(dtype)
        changeable = jnp.stack([
            jnp.einsum("gn,nfs->gfs", groups[i_c] * sub[None, :],
                       feats * source_comp(fs.source, 1 + i_c, dtype)[:, :, None],
                       preferred_element_type=jnp.float32, precision=HIGHEST)
            for i_c in range(c.C - 1)
        ], axis=0)
        unchangeable = fs.conf_counts - changeable
        conf_effect = conditional_effect_mean(
            prior_counts=fs.conc_conf,
            feature_counts=unchangeable,
            unif_counts=fs.unif_conc[None, None],
            prior_temperature=self.Tp,
            temperature=self.T,
        )
        lhc = jnp.einsum("cgn,cgfs,nfs->nfc", groups, conf_effect, feats,
                         preferred_element_type=jnp.float32, precision=HIGHEST)

        lh = jnp.concatenate([lh0[:, :, None], lhc], axis=-1)
        lh = jnp.where(fs.na[:, :, None], 1.0, lh)
        return lh ** (1.0 / self.T)

    def component_likelihood_given_unchanged(self, clusters, source, subset, i_cluster,
                                             conf_counts_full=None):
        """(N, F, C) heated component likelihoods with the subset's own
        contribution removed from the effect estimates (full-F wrapper of
        ``_clgu_slice``; the resample paths tile it over F at scale)."""
        c = self.consts
        if conf_counts_full is None:
            conf_counts_full = self._conf_counts_of(source)
        fs = self._feature_slice(source, jnp.zeros((c.F, c.C)), conf_counts_full, i=None)
        return self._clgu_slice(clusters, subset, i_cluster, fs)

    def likelihood_per_component_exact(self, clusters, source):
        """Exact leave-self-out component likelihoods (for lh logging).

        Each observation is scored under effects estimated WITHOUT its own
        contribution (reference: conditionals.py:300-367). Returns (N,F,C).
        Feature-separable given the counts: with ``consts.feature_chunk``
        set, the (N,f,S) per-object effect intermediates stay tile-sized.
        """
        c = self.consts
        feats_full = jnp.asarray(c.features)
        dtype = feats_full.dtype
        cl_counts, conf_counts = self.post.feature_counts(clusters, source)
        member = jnp.any(clusters, axis=0)
        groups = jnp.asarray(c.groups)  # (Cm1, Gmax, N)

        def slice_body(feats, source_t, na_t, cl_counts_t, conf_counts_t,
                       conc_cl_t, conc_conf_t):
            # Cluster component: for object o in cluster k, effect is
            # normalize(counts[k] + conc - own contribution).
            own0 = feats * source_comp(source_t, 0, dtype)[:, :, None]  # (N,f,S)
            base_cl = cl_counts_t + conc_cl_t[None]                     # (K,f,S)
            per_obj_cl = jnp.einsum("kn,kfs->nfs", clusters.astype(jnp.float32),
                                    base_cl, precision=HIGHEST) - (
                member[:, None, None] * own0
            )
            eff0 = per_obj_cl / jnp.maximum(per_obj_cl.sum(-1, keepdims=True), EPS32)
            lh0 = jnp.where(member[:, None],
                            jnp.einsum("nfs,nfs->nf", eff0, feats,
                                       preferred_element_type=jnp.float32, precision=HIGHEST), 0.0)

            # Confounder components
            base_conf = conf_counts_t + conc_conf_t  # (Cm1,Gmax,f,S)
            lhs = [lh0[:, :, None]]
            for i_c in range(groups.shape[0]):
                own = feats * source_comp(source_t, 1 + i_c, dtype)[:, :, None]
                per_obj = jnp.einsum("gn,gfs->nfs", groups[i_c], base_conf[i_c], precision=HIGHEST) - (
                    (groups[i_c].sum(0) > 0)[:, None, None] * own
                )
                in_group = groups[i_c].sum(0) > 0
                eff = per_obj / jnp.maximum(per_obj.sum(-1, keepdims=True), EPS32)
                lh_c = jnp.where(in_group[:, None],
                                 jnp.einsum("nfs,nfs->nf", eff, feats,
                                            preferred_element_type=jnp.float32, precision=HIGHEST), 0.0)
                lhs.append(lh_c[:, :, None])

            lh = jnp.concatenate(lhs, axis=-1)
            return jnp.where(na_t[:, :, None], 1.0, lh)

        fc = c.feature_chunk
        if fc is None or fc >= c.F:
            return slice_body(feats_full, source, jnp.asarray(c.na), cl_counts,
                              conf_counts, jnp.asarray(c.conc_cluster),
                              jnp.asarray(c.conc_conf))

        from sbayes_tpu.model.math import feature_tile

        na_full = jnp.asarray(c.na)
        conc_cl, conc_cf = jnp.asarray(c.conc_cluster), jnp.asarray(c.conc_conf)

        def tile_body(i):
            return slice_body(
                feature_tile(feats_full, i, fc, axis=1),
                feature_tile(source, i, fc, axis=1),
                feature_tile(na_full, i, fc, axis=1),
                feature_tile(cl_counts, i, fc, axis=1),
                feature_tile(conf_counts, i, fc, axis=2),
                feature_tile(conc_cl, i, fc, axis=0),
                feature_tile(conc_cf, i, fc, axis=2),
            )

        lh_t = jax.lax.map(tile_body, jnp.arange(c.F // fc))   # (T, N, f, C)
        return jnp.moveaxis(lh_t, 0, 1).reshape(c.N, c.F, c.C)

    def expected_confounder_features(self, clusters, weights, conf_counts):
        """(N, F, S) expected feature values under the confounder mixture.

        Reference: operators.py:1342-1379 (heated posterior-mean confounder
        effects, weighted by per-object heated normalized weights).
        """
        c = self.consts
        w = normalize_weights(weights, self.post.has_components(clusters))
        w_heated = normalize(w ** (1.0 / self.Tp), axis=-1)
        p_conf = conditional_effect_mean(
            prior_counts=jnp.asarray(c.conc_conf),
            feature_counts=conf_counts,
            unif_counts=jnp.asarray(c.unif_conc)[None, None],
            prior_temperature=self.Tp,
            temperature=self.T,
        )
        return jnp.einsum(
            "cgn,cgfs,nfc->nfs", jnp.asarray(c.groups), p_conf, w_heated[:, :, 1:], precision=HIGHEST
        )

    # ------------------------------------------------------------------
    # Source resampling
    # ------------------------------------------------------------------

    def _masked_source_logp(self, p, source, subset):
        """Sum of log p at the one-hot source entries over (subset, valid)."""
        return self._masked_logp_slice(p, source, subset, jnp.asarray(self.consts.na))

    @staticmethod
    def _masked_logp_slice(p, source, subset, na_t):
        valid = (~na_t) & subset[:, None]
        chosen = source_pick(p, source)
        return jnp.where(valid, jnp.log(jnp.maximum(chosen, 1e-35)), 0.0).sum()

    def _resample_engine(self, key, state_old, clusters_new, subset,
                         i_fwd, i_back, clusters_back, share_lh: bool,
                         heat: bool, hc_back_from_old: bool,
                         conf_counts_full) -> SourceResample:
        """Shared tiled/fused source-resample core.

        The body runs on one _FeatureSlice; with ``feature_chunk`` unset it
        runs once on the full F axis (identical to the round-1 fused math),
        otherwise as a lax.map over F-tiles (everything here is feature-
        separable given the counts).
        """
        c = self.consts
        hc_new = self.post.has_components(clusters_new)
        hc_back = self.post.has_components(state_old.clusters) if hc_back_from_old else hc_new
        sfp = self.sample_from_prior

        if conf_counts_full is None:
            conf_counts_full = self._conf_counts_of(state_old.source)

        def tile_out(fs: "Conditionals._FeatureSlice", k):
            w_f = normalize_weights(fs.weights, hc_new)
            w_b = normalize_weights(fs.weights, hc_back)
            if heat:
                w_f = w_f ** (1.0 / self.Tp)
                w_b = w_b ** (1.0 / self.Tp)
            if sfp:
                p = w_f / jnp.maximum(w_f.sum(-1, keepdims=True), EPS32)
                p_back = w_b / jnp.maximum(w_b.sum(-1, keepdims=True), EPS32)
            else:
                lh_f = self._clgu_slice(clusters_new, subset, i_fwd, fs)
                lh_b = lh_f if share_lh else self._clgu_slice(
                    clusters_back, subset, i_back, fs
                )
                p = normalize(w_f * lh_f, axis=-1)
                p_back = normalize(w_b * lh_b, axis=-1)

            x = sample_categorical_onehot(k, p)
            x = x & ~fs.na[:, :, None]
            if source_is_packed(fs.source):
                source_new_t = jnp.where(subset[:, None], pack_source(x), fs.source)
            else:
                source_new_t = jnp.where(subset[:, None, None], x, fs.source)
            log_q = self._masked_logp_slice(p, source_new_t, subset, fs.na)
            log_q_back = self._masked_logp_slice(p_back, fs.source, subset, fs.na)
            return source_new_t, log_q, log_q_back

        fc = c.feature_chunk
        if fc is None or fc >= c.F:
            fs = self._feature_slice(state_old.source, state_old.weights,
                                     conf_counts_full, i=None)
            source_new, log_q, log_q_back = tile_out(fs, key)
            return SourceResample(source_new, log_q, log_q_back)

        n_tiles = c.F // fc
        keys = jax.random.split(key, n_tiles)

        def tile_body(args):
            i, k = args
            fs = self._feature_slice(state_old.source, state_old.weights,
                                     conf_counts_full, i=i)
            return tile_out(fs, k)

        src_t, lq_t, lqb_t = jax.lax.map(tile_body, (jnp.arange(n_tiles), keys))
        out_shape = ((c.N, c.F) if src_t.ndim == 3 else (c.N, c.F, c.C))
        source_new = jnp.moveaxis(src_t, 0, 1).reshape(out_shape)
        return SourceResample(source_new, lq_t.sum(), lqb_t.sum())

    # ------------------------------------------------------------------
    # Gathered-rows variants: O(m·F) instead of O(N·F)
    # ------------------------------------------------------------------

    def _clgu_rows(self, state_old, obj_idx, valid, i_cluster, counts,
                   feats_m, na_m, src_rows_old):
        """Leave-subset-out component likelihoods for the gathered rows.

        The O(m·F·S) counterpart of ``_clgu_slice``: instead of recomputing
        keep-counts over all N objects, subtract the subset rows' own
        contribution from the carried sufficient-statistic counts of the
        pre-move state (exact — counts are integer-valued f32, and cluster
        membership outside the subset is identical between the old and the
        candidate clusters for every single-cluster-index move).
        Returns (m, F, C) heated likelihoods.
        """
        c = self.consts
        dtype = feats_m.dtype
        cl_counts, conf_counts = counts
        sub = valid.astype(dtype)

        # Cluster component: old members of ``i_cluster`` outside the subset.
        member = gather_cols(state_old.clusters[i_cluster], obj_idx).astype(dtype) * sub  # (m,)
        src0 = src_rows_old[:, :, 0].astype(dtype)                           # (m, F)
        excl0 = jnp.einsum("m,mf,mfs->fs", member, src0, feats_m,
                           preferred_element_type=jnp.float32, precision=HIGHEST)
        cluster_effect = conditional_effect_mean(
            prior_counts=jnp.asarray(c.conc_cluster),
            feature_counts=cl_counts[i_cluster] - excl0,
            unif_counts=jnp.asarray(c.unif_conc),
            prior_temperature=self.Tp,
            temperature=self.T,
        )
        lh0 = jnp.einsum("fs,mfs->mf", cluster_effect.astype(dtype), feats_m,
                         preferred_element_type=jnp.float32, precision=HIGHEST)

        # Confounder components: full counts minus the subset contribution.
        g_m = gather_cols(jnp.asarray(c.groups), obj_idx).astype(dtype)             # (C-1, G, m)
        srcc = src_rows_old[:, :, 1:].astype(dtype)                          # (m, F, C-1)
        import os
        m_, F, S = feats_m.shape
        if os.environ.get("SBAYES_TPU_DC_MM", "1") == "1" and feats_m.shape[0] <= 64:
            # Two-step matmul forms (see delta_counts_rows): integer-exact
            # exclusion counts via (G x m)@(m x F*S) dots, float effect
            # gathers via (m x G)@(G x F*S) dots + VPU reduce — avoids the
            # convolution lowering of the 4-operand einsums.
            excl_l, lhc_l = [], []
            for ci in range(c.C - 1):
                v = (srcc[:, :, ci] * sub[:, None])[:, :, None] * feats_m
                excl_l.append(jnp.dot(g_m[ci], v.reshape(m_, F * S),
                                      preferred_element_type=jnp.float32, precision=HIGHEST
                                      ).reshape(-1, F, S))
            excl = jnp.stack(excl_l, axis=0)
            conf_effect = conditional_effect_mean(
                prior_counts=jnp.asarray(c.conc_conf),
                feature_counts=conf_counts - excl,
                unif_counts=jnp.asarray(c.unif_conc)[None, None],
                prior_temperature=self.Tp,
                temperature=self.T,
            )
            for ci in range(c.C - 1):
                Ec = jnp.dot(g_m[ci].T.astype(dtype),
                             conf_effect[ci].reshape(-1, F * S).astype(dtype),
                             preferred_element_type=jnp.float32, precision=HIGHEST)
                lhc_l.append((Ec.reshape(m_, F, S) * feats_m).sum(-1))
            lhc = jnp.stack(lhc_l, axis=-1)
        else:
            excl = jnp.einsum("cgm,m,mfc,mfs->cgfs", g_m, sub, srcc, feats_m,
                              preferred_element_type=jnp.float32, precision=HIGHEST)
            conf_effect = conditional_effect_mean(
                prior_counts=jnp.asarray(c.conc_conf),
                feature_counts=conf_counts - excl,
                unif_counts=jnp.asarray(c.unif_conc)[None, None],
                prior_temperature=self.Tp,
                temperature=self.T,
            )
            lhc = jnp.einsum("cgm,cgfs,mfs->mfc", g_m, conf_effect.astype(dtype),
                             feats_m, preferred_element_type=jnp.float32, precision=HIGHEST)

        lh = jnp.concatenate([lh0[:, :, None], lhc], axis=-1)
        lh = jnp.where(na_m[:, :, None], 1.0, lh)
        return lh ** (1.0 / self.T)

    @staticmethod
    def _rows_logp(p, rows, valid, na_m):
        """Sum of log p at the one-hot entries over (valid rows, ~NA)."""
        ok = (~na_m) & valid[:, None]
        chosen = (p * rows).sum(-1)
        return jnp.where(ok, jnp.log(jnp.maximum(chosen, 1e-35)), 0.0).sum()

    def source_prior_rows_logp(self, weights, hc_rows, rows, valid, na_m):
        """Unheated source-prior contribution of the gathered rows
        (identical math to Posterior.source_prior restricted to the rows:
        sum over valid, non-NA cells of log(normalized_weights · source))."""
        w = normalize_weights(weights, hc_rows)   # (m, F, C)
        p = (w * rows).sum(-1)
        ok = (~na_m) & valid[:, None]
        return jnp.where(ok, jnp.log(jnp.where(ok, p, 1.0)), 0.0).sum()

    def _resample_engine_rows(self, key, state_old, clusters_new, obj_idx, valid,
                              i_fwd, i_back, share_lh: bool, heat: bool,
                              hc_back_from_old: bool, counts) -> SourceResample:
        """Gathered-rows source-resample core: identical math to
        ``_resample_engine`` on a subset given by DISTINCT indices
        ``obj_idx`` with a validity mask, in O(m·F) work. ``counts`` are
        the carried sufficient-statistic counts of ``state_old``.
        """
        c = self.consts
        # Gathered rows are tiny — compute them in full f32 even when the
        # resident feature tensor is bf16 (better proposal densities at
        # zero streaming cost; the q-ratio cancellation in the MH step is
        # then f32-tight).
        feats_m = gather_const_rows(jnp.asarray(c.features), obj_idx)  # (m, F, S)
        na_m = gather_const_rows(jnp.asarray(c.na), obj_idx) > 0.5       # (m, F)
        src_rows_old = gather_rows(state_old.source, obj_idx,
                                   self.consts.C)  # (m, F, C)

        hc_conf_m = gather_const_rows(jnp.asarray(c.hc_conf), obj_idx) > 0.5  # (m, C-1)
        hc0_new = jnp.any(gather_cols(clusters_new, obj_idx) > 0.5, axis=0)
        hc_new_m = jnp.concatenate([hc0_new[:, None], hc_conf_m], axis=1)
        hc0_old = jnp.any(gather_cols(state_old.clusters, obj_idx) > 0.5, axis=0)
        hc_old_m = jnp.concatenate([hc0_old[:, None], hc_conf_m], axis=1)
        hc_back_m = hc_old_m if hc_back_from_old else hc_new_m

        w_f = normalize_weights(state_old.weights, hc_new_m)   # (m, F, C)
        w_b = normalize_weights(state_old.weights, hc_back_m)
        if heat:
            w_f = w_f ** (1.0 / self.Tp)
            w_b = w_b ** (1.0 / self.Tp)
        if self.sample_from_prior:
            p = w_f / jnp.maximum(w_f.sum(-1, keepdims=True), EPS32)
            p_back = w_b / jnp.maximum(w_b.sum(-1, keepdims=True), EPS32)
        else:
            lh_f = self._clgu_rows(state_old, obj_idx, valid, i_fwd, counts,
                                   feats_m, na_m, src_rows_old)
            lh_b = lh_f if share_lh else self._clgu_rows(
                state_old, obj_idx, valid, i_back, counts,
                feats_m, na_m, src_rows_old)
            p = normalize(w_f * lh_f, axis=-1)
            p_back = normalize(w_b * lh_b, axis=-1)

        x = sample_categorical_onehot(key, p) & ~na_m[:, :, None]
        new_rows = jnp.where(valid[:, None, None], x, src_rows_old)

        log_q = self._rows_logp(p, new_rows, valid, na_m)
        log_q_back = self._rows_logp(p_back, src_rows_old, valid, na_m)
        sp_delta = (
            self.source_prior_rows_logp(state_old.weights, hc_new_m, new_rows,
                                        valid, na_m)
            - self.source_prior_rows_logp(state_old.weights, hc_old_m,
                                          src_rows_old, valid, na_m)
        )
        # Deferred scatter: ``source`` passes the OLD buffer through
        # untouched (the MH kernel's tree-select folds to a no-op on it)
        # and the kernel writes ``new_rows`` at ``obj_idx`` only after the
        # accept decision — see kernel.make_mh_apply_fn.
        return SourceResample(state_old.source, log_q, log_q_back, sp_delta,
                              new_rows=new_rows)

    def gibbs_resample_source_rows(self, key, state_old, clusters_new, obj_idx,
                                   valid, i_cluster, counts) -> SourceResample:
        """Gathered-rows counterpart of ``gibbs_resample_source`` (same
        leave-subset-out semantics, forward/backward shared likelihoods,
        weights heated by 1/Tp, backward weights from the OLD clusters)."""
        return self._resample_engine_rows(
            key, state_old, clusters_new, obj_idx, valid,
            i_fwd=i_cluster, i_back=i_cluster,
            share_lh=True, heat=True, hc_back_from_old=True, counts=counts,
        )

    def gibbs_resample_source_jump_rows(self, key, state_old, clusters_new, obj_idx,
                                        valid, i_cluster_new, i_cluster_old,
                                        counts) -> SourceResample:
        """Gathered-rows counterpart of ``gibbs_resample_source_jump``
        (backward likelihoods from the OLD state with the source cluster,
        unheated weights from the new sample for both directions)."""
        return self._resample_engine_rows(
            key, state_old, clusters_new, obj_idx, valid,
            i_fwd=i_cluster_new, i_back=i_cluster_old,
            share_lh=False, heat=False, hc_back_from_old=False, counts=counts,
        )

    def gibbs_resample_source(self, key, state_old, clusters_new, subset, i_cluster,
                              conf_counts_full=None) -> SourceResample:
        """Resample ``source`` rows in ``subset`` from their collapsed
        conditional, leaving out the subset's own contribution.

        Mirrors reference ClusterOperator.gibbs_sample_source
        (operators.py:796-849): forward and backward densities share the
        component likelihoods (exact for single-cluster-index moves: the
        subset's own contribution is excluded either way), weights are
        heated by 1/Tp, and the backward weights come from the OLD clusters.
        """
        return self._resample_engine(
            key, state_old, clusters_new, subset,
            i_fwd=i_cluster, i_back=i_cluster, clusters_back=clusters_new,
            share_lh=True, heat=True, hc_back_from_old=True,
            conf_counts_full=conf_counts_full,
        )

    def gibbs_resample_source_jump(self, key, state_old, clusters_new, subset,
                                   i_cluster_new, i_cluster_old,
                                   conf_counts_full=None) -> SourceResample:
        """Jump-specific source resample (reference gibbs_sample_source_jump,
        operators.py:1775-1827).

        Differs from ``gibbs_resample_source`` in two reference-exact ways:
        the backward component likelihoods come from the OLD state with the
        *source* cluster (``i_cluster_old``), not from the forward
        likelihoods; and the mixture weights are UNheated (no ``1/Tp``),
        taken from the new sample for both directions
        (reference operators.py:1790 ``w = update_weights(sample_new)``).
        ``conf_counts_full`` may be shared between directions: confounder
        counts depend only on the (unchanged-outside-subset) source array
        and the static groups, not on cluster membership.
        """
        return self._resample_engine(
            key, state_old, clusters_new, subset,
            i_fwd=i_cluster_new, i_back=i_cluster_old,
            clusters_back=state_old.clusters,
            share_lh=False, heat=False, hc_back_from_old=False,
            conf_counts_full=conf_counts_full,
        )

    def source_posterior_rows(self, clusters, weights, counts, obj_idx,
                              feats_m, na_m):
        """(m, F, C) full-counts source posterior at the gathered rows —
        the O(m·F) counterpart of ``source_posterior`` (reference
        GibbsSampleSource.calculate_source_posterior, operators.py:554-574,
        which also scores with the full current counts)."""
        c = self.consts
        cl_counts, conf_counts = counts
        dtype = feats_m.dtype

        cl_eff = normalize(cl_counts + jnp.asarray(c.conc_cluster)[None], axis=-1)
        mem = gather_cols(clusters, obj_idx).astype(dtype)          # (K, m)
        g_m = gather_cols(jnp.asarray(c.groups), obj_idx).astype(dtype)
        conf_eff = normalize(conf_counts + jnp.asarray(c.conc_conf), axis=-1)
        import os
        if os.environ.get("SBAYES_TPU_POST_MM", "1") == "1":
            # Two-step matmul form (see delta_counts_rows): gather each
            # row's effect table with one (m x rows)@(rows x F*S) dot,
            # then an elementwise reduce against feats — avoids the convolution
            # lowering of the 3-operand einsums. Float effects: same math,
            # different summation association (not bitwise vs einsum).
            m_, F, S = feats_m.shape
            E0 = jnp.dot(mem.T, cl_eff.reshape(-1, F * S).astype(dtype),
                         preferred_element_type=jnp.float32, precision=HIGHEST)
            lh0 = (E0.reshape(m_, F, S) * feats_m).sum(-1)
            lhc_l = []
            for ci in range(c.C - 1):
                Ec = jnp.dot(g_m[ci].T, conf_eff[ci].reshape(-1, F * S).astype(dtype),
                             preferred_element_type=jnp.float32, precision=HIGHEST)
                lhc_l.append((Ec.reshape(m_, F, S) * feats_m).sum(-1))
            lhc = jnp.stack(lhc_l, axis=-1)
        else:
            lh0 = jnp.einsum("km,kfs,mfs->mf", mem, cl_eff.astype(dtype), feats_m,
                             preferred_element_type=jnp.float32, precision=HIGHEST)
            lhc = jnp.einsum("cgm,cgfs,mfs->mfc", g_m, conf_eff.astype(dtype),
                             feats_m, preferred_element_type=jnp.float32, precision=HIGHEST)
        lh = jnp.concatenate([lh0[:, :, None], lhc], axis=-1)
        lh = jnp.where(na_m[:, :, None], 1.0, lh)

        hc_conf_m = gather_const_rows(jnp.asarray(c.hc_conf), obj_idx) > 0.5
        hc0 = jnp.any(gather_cols(clusters, obj_idx) > 0.5, axis=0)
        hc_m = jnp.concatenate([hc0[:, None], hc_conf_m], axis=1)
        w = normalize_weights(weights, hc_m)
        sp = lh ** (1.0 / self.T) * w ** (1.0 / self.Tp)
        return normalize(sp, axis=-1)

    def delta_counts_rows(self, counts, clusters, obj_idx, valid,
                          src_old_rows, src_new_rows, feats_m):
        """Exact sufficient-statistic update for a set of changed source
        rows (clusters unchanged): counts + Σ_rows (new − old) contribution."""
        c = self.consts
        cl_counts, conf_counts = counts
        dtype = feats_m.dtype
        sub = valid.astype(dtype)

        d0 = (src_new_rows[:, :, 0].astype(dtype)
              - src_old_rows[:, :, 0].astype(dtype))           # (m, F)
        mem = gather_cols(clusters, obj_idx).astype(dtype) * sub[None, :]
        dc = (src_new_rows[:, :, 1:].astype(dtype)
              - src_old_rows[:, :, 1:].astype(dtype))          # (m, F, C-1)
        g_m = gather_cols(jnp.asarray(c.groups), obj_idx).astype(dtype)
        import os
        if os.environ.get("SBAYES_TPU_DC_MM", "1") == "1" and feats_m.shape[0] <= 64:
            # Two-step matmul form: elementwise (m,F,S) product, then one
            # (rows x m)@(m, F*S) dot per component — avoids XLA's
            # convolution lowering of the 3/4-operand einsums.
            m_, F, S = feats_m.shape
            u = (d0[:, :, None] * feats_m).reshape(m_, F * S)
            delta_cl = jnp.dot(mem, u, preferred_element_type=jnp.float32, precision=HIGHEST
                               ).reshape(-1, F, S)
            dconf = []
            for ci in range(c.C - 1):
                v = (dc[:, :, ci][:, :, None] * feats_m).reshape(m_, F * S)
                dconf.append(jnp.dot(g_m[ci] * sub[None, :], v,
                                     preferred_element_type=jnp.float32, precision=HIGHEST
                                     ).reshape(-1, F, S))
            delta_conf = jnp.stack(dconf, axis=0)
        else:
            delta_cl = jnp.einsum("km,mf,mfs->kfs", mem, d0, feats_m,
                                  preferred_element_type=jnp.float32, precision=HIGHEST)
            delta_conf = jnp.einsum("cgm,m,mfc,mfs->cgfs", g_m, sub, dc, feats_m,
                                    preferred_element_type=jnp.float32, precision=HIGHEST)
        return cl_counts + delta_cl, conf_counts + delta_conf

    def delta_counts_rows_move(self, counts, clusters_old, clusters_new,
                               obj_idx, valid, src_old_rows, src_new_rows,
                               feats_m):
        """Exact sufficient-statistic update for a multi-object cluster
        move: subtract the gathered rows' old contribution (old membership,
        old source) and add their new one (new membership, new source).
        The rows version of ``OperatorFactory._delta_counts``; confounder
        group assignments never change, so their delta involves only the
        source rows."""
        c = self.consts
        cl_counts, conf_counts = counts
        dtype = feats_m.dtype
        sub = valid.astype(dtype)

        old0 = src_old_rows[:, :, 0].astype(dtype)            # (m, F)
        new0 = src_new_rows[:, :, 0].astype(dtype)
        mem_old = gather_cols(clusters_old, obj_idx).astype(dtype) * sub[None, :]  # (K, m)
        mem_new = gather_cols(clusters_new, obj_idx).astype(dtype) * sub[None, :]
        dc = (src_new_rows[:, :, 1:].astype(dtype)
              - src_old_rows[:, :, 1:].astype(dtype))          # (m, F, C-1)
        g_m = gather_cols(jnp.asarray(c.groups), obj_idx).astype(dtype)
        import os
        if os.environ.get("SBAYES_TPU_DC_MM", "1") == "1" and feats_m.shape[0] <= 64:
            # Two-step matmul form (see delta_counts_rows) — integer-exact.
            m_, F, S = feats_m.shape
            u_new = (new0[:, :, None] * feats_m).reshape(m_, F * S)
            u_old = (old0[:, :, None] * feats_m).reshape(m_, F * S)
            delta_cl = (
                jnp.dot(mem_new, u_new, preferred_element_type=jnp.float32, precision=HIGHEST)
                - jnp.dot(mem_old, u_old, preferred_element_type=jnp.float32, precision=HIGHEST)
            ).reshape(-1, F, S)
            dconf = []
            for ci in range(c.C - 1):
                v = (dc[:, :, ci][:, :, None] * feats_m).reshape(m_, F * S)
                dconf.append(jnp.dot(g_m[ci] * sub[None, :], v,
                                     preferred_element_type=jnp.float32, precision=HIGHEST
                                     ).reshape(-1, F, S))
            delta_conf = jnp.stack(dconf, axis=0)
        else:
            delta_cl = (
                jnp.einsum("km,mf,mfs->kfs", mem_new, new0, feats_m,
                           preferred_element_type=jnp.float32, precision=HIGHEST)
                - jnp.einsum("km,mf,mfs->kfs", mem_old, old0, feats_m,
                             preferred_element_type=jnp.float32, precision=HIGHEST)
            )
            delta_conf = jnp.einsum("cgm,m,mfc,mfs->cgfs", g_m, sub, dc, feats_m,
                                    preferred_element_type=jnp.float32, precision=HIGHEST)
        return cl_counts + delta_cl, conf_counts + delta_conf

    def source_posterior(self, clusters, weights, source, counts=None):
        """(N, F, C) posterior over component attributions given everything
        else (reference: GibbsSampleSource.calculate_source_posterior,
        operators.py:554-574). ``counts`` may pass in precomputed
        sufficient-statistic counts of ``source``."""
        if counts is None:
            counts = self.post.feature_counts(clusters, source)
        cl_counts, conf_counts = counts
        lh_pc = self.likelihood_per_component(clusters, cl_counts, conf_counts)
        w = normalize_weights(weights, self.post.has_components(clusters))
        sp = lh_pc ** (1.0 / self.T) * w ** (1.0 / self.Tp)
        return normalize(sp, axis=-1)
