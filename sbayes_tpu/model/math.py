"""Device-side (JAX) math kernels of the collapsed mixture model.

These are the JAX equivalents of the reference's three Numba kernels
and its NumPy likelihood math (reference: sbayes/util.py:1373-1394
``dirichlet_categorical_logpdf``, sbayes/model/likelihood.py:104-199
``compute_component_likelihood``/``normalize_weights``,
sbayes/sampling/counts.py:10-52 sufficient-statistic counts).

Design: everything is a fused full-recompute over static shapes. The
sufficient-statistic counts are einsums that XLA lowers to matrix
products; the Dirichlet-categorical compound log-pdf is a masked lgamma
reduction fused into the same program. A full recompute needs no
incremental cache; the sampling kernel carries the counts and applies
exact deltas between recomputes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammaln


# Every contraction of two float32 operands pins full float32 precision. At
# default precision a GPU may run such dots in TF32 (a 10-bit mantissa),
# which would perturb Gibbs conditionals, MH ratios and carried totals.
# Dots with bfloat16 operands (the one-hot gathers and count matmuls over
# 0/1 values, accumulated in float32) are exact as they are and keep the
# default. tests/test_precision.py walks the compiled programs for any
# float32 dot that lacks this pin.
HIGHEST = jax.lax.Precision.HIGHEST


def normalize(x, axis=-1):
    """Normalize so the given axis sums to 1."""
    return x / jnp.sum(x, axis=axis, keepdims=True)


# ---------------------------------------------------------------------
# Source-tensor representations.
#
# The component attribution of each observation is logically a one-hot
# bool (N, F, C) tensor with ALL-ZERO rows at NA cells (reference:
# sbayes/sampling/state.py:501 ``source``). At scale it is the largest
# chain-state leaf by far (10k x 5k x 3 = 150 MB/chain), so the state can
# instead carry the PACKED form: int8 (N, F) component indices with the
# sentinel ``C`` meaning "NA/no component" (the same sentinel convention
# as the Pallas idx feature layout, constants.py:353-377, and the padded
# row index N of gather/scatter_rows). Every helper below is polymorphic
# on the two forms; ops compute with one-hot ROWS either way (row shapes
# are m-sized, never N-sized).
# ---------------------------------------------------------------------


def source_is_packed(src) -> bool:
    """True for the packed int8 (…, N, F) index form."""
    return src.dtype == jnp.int8


def source_comp(src, i, dtype=None):
    """Component-membership mask ``source[..., i]`` as ``dtype`` (or bool)."""
    m = (src == i) if source_is_packed(src) else src[..., i]
    return m if dtype is None else m.astype(dtype)


def source_onehot(src, n_components: int):
    """Expand to the bool one-hot (…, N, F, C) form (identity if already
    one-hot). The sentinel index C produces an all-zero row."""
    if not source_is_packed(src):
        return src
    return jax.nn.one_hot(src, n_components, dtype=bool)


def pack_source(src_bool):
    """Bool one-hot (…, F, C) -> packed int8 (…, F); all-zero rows (NA)
    map to the sentinel C."""
    c = src_bool.shape[-1]
    idx = jnp.argmax(src_bool, axis=-1)
    return jnp.where(src_bool.any(-1), idx, c).astype(jnp.int8)


def source_pick(p, src):
    """``(p * source_onehot).sum(-1)``: the probability (or weight) each
    observation's chosen component picked from ``p`` (…, N, F, C); 0.0 at
    NA cells. ``p`` may broadcast against the source batch shape."""
    if not source_is_packed(src):
        return (p * src).sum(-1)
    # On-the-fly one-hot multiply-sum, NOT take_along_axis: the gather
    # form forces the (…, C) operand to materialize in a lane-padded
    # tiled layout (C=3 pads to 128 lanes -> 43x memory, OOM at scale);
    # the compare-multiply-reduce fuses exactly like the bool form's
    # (p * source).sum(-1). Sentinel C matches nothing -> 0.0.
    c = p.shape[-1]
    oh = src[..., None] == jnp.arange(c, dtype=src.dtype)
    return (p * oh).sum(-1)


def source_n_changed(a, b):
    """The source-op step-size statistic, reference parity:
    ``count_nonzero(old ^ new)`` of the bool one-hot form (reference
    operators.py:576-579) — i.e. BIT flips, two per reassigned cell. The
    NA mask is a property of the data, so a cell is either one-hot in
    both states (2 flips when changed) or empty in both (0)."""
    if source_is_packed(a):
        return 2.0 * (a != b).sum().astype(jnp.float32)
    return (a ^ b).sum().astype(jnp.float32)


# Row gather/scatter on the per-chain (N, F, C) source tensor.
#
# Under vmap, ``src[idx]`` / ``src.at[idx].set(rows)`` with per-chain
# indices lower to batched gathers/scatters. For small tensors these run
# as one-hot matmuls instead (the form the prim_mm MST engine uses for
# cost-matrix rows); for large tensors the matmul re-reads all N rows, so
# the native gather/in-place scatter stays. The cutover is by total source
# bytes; it was tuned on an earlier accelerator and has not been measured
# on the GPU (ROADMAP Speed 3).
# Preconditions of the matmul forms: indices are DISTINCT (every caller
# draws without replacement / top_k / a single object) and index == N
# means "padded, drop" (the one-hot row is all zero).

_ROWS_MM_MAX_BYTES = 32 * 1024 * 1024  # per-chain bool (N, F, C) size


def _rows_mm(n, f, c):
    import os

    env = os.environ.get("SBAYES_TPU_ROWS_MM")
    if env is not None:
        return env == "1"
    return n * f * c <= _ROWS_MM_MAX_BYTES


def compact_indices(mask, size: int, fill: int):
    """Ascending indices of True in ``mask`` (N,) bool, padded to ``size``
    with ``fill`` — the output contract of
    ``jnp.nonzero(mask, size=size, fill_value=fill)[0]``, computed via an
    argsort instead of nonzero's cumsum+scatter (avoids the vmapped
    batched scatter). Above 4096 objects the sort's log^2(N) passes cost
    more than the scatter, so the nonzero form stays. Both sides of the
    cutover are still to be measured on the GPU (ROADMAP Speed 3)."""
    n = mask.shape[0]
    if n > 4096:
        return jnp.nonzero(mask, size=size, fill_value=fill)[0]
    ar = jnp.arange(n, dtype=jnp.int32)
    order = jnp.argsort(jnp.where(mask, ar, n + ar))
    m = mask.sum()
    return jnp.where(jnp.arange(size) < m, order[:size], fill)


def gather_const_rows(mat, idx):
    """``mat[idx]`` for a 0/1-valued shared constant ``mat`` (N, ...) with
    per-chain row indices ``idx`` (m,) — one-hot matmul when the whole
    matrix is small, native (clamping) gather when re-reading all N rows
    would dominate.

    Exact: one-hot rows carry a single 1, so the f32-accumulated dot
    returns each 0/1 row bitwise. Out-of-range idx -> all-zero row on the
    matmul path vs a clamped junk row on the native path; every caller
    masks padded rows by ``valid``, so the two paths agree at every
    consumed position. Returns f32 (bool matrices: compare > 0.5)."""
    n = mat.shape[0]
    if not _rows_mm(n, int(np.prod(mat.shape[1:])), 1):
        return mat[idx].astype(jnp.float32)
    oh = jax.nn.one_hot(idx, n, dtype=jnp.bfloat16)
    flat = mat.reshape(n, -1).astype(jnp.bfloat16)
    out = jnp.dot(oh, flat, preferred_element_type=jnp.float32)
    return out.reshape(*idx.shape, *mat.shape[1:])


def gather_cols(mat, idx):
    """``mat[..., idx]`` for a 0/1-valued ``mat`` (..., N) with (m,) row
    indices — the minor-axis-gather counterpart of ``gather_const_rows``
    (same threshold; exact for 0/1 values, one nonzero per one-hot row).
    Out-of-range idx -> all-zero column on the matmul path (callers mask
    padded entries by ``valid``). Returns f32."""
    n = mat.shape[-1]
    if not _rows_mm(n, int(np.prod(mat.shape[:-1])), 1):
        return mat[..., idx].astype(jnp.float32)
    oh = jax.nn.one_hot(idx, n, dtype=jnp.bfloat16)   # (m, N)
    return jnp.einsum("...n,mn->...m", mat.astype(jnp.bfloat16), oh,
                      preferred_element_type=jnp.float32)


def gather_rows(src, idx, n_components: int | None = None):
    """``src[idx]`` as bool one-hot rows (m, F, C); idx (m,) int (N = padded,
    yielding an all-zero row).

    Engine-switched for the bool (N, F, C) form: one-hot matmul at
    small sizes (exact: 0/1 operands, <=1 nonzero per one-hot row, f32
    accumulate), native gather (mode='fill') at large. For the PACKED
    int8 (N, F) form (``n_components`` required) the native gather moves
    C× fewer bytes and the padded index fills with the sentinel C, which
    the one-hot expansion maps to the all-zero row."""
    if source_is_packed(src):
        assert n_components is not None, "packed source needs n_components"
        rows = src.at[idx].get(mode="fill", fill_value=n_components)
        return jax.nn.one_hot(rows, n_components, dtype=bool)
    n, f, c = src.shape
    if not _rows_mm(n, f, c):
        return src.at[idx].get(mode="fill", fill_value=False)
    oh = jax.nn.one_hot(idx, n, dtype=jnp.bfloat16)              # (m, N)
    flat = src.reshape(n, f * c).astype(jnp.bfloat16)
    out = jnp.dot(oh, flat, preferred_element_type=jnp.float32)
    return (out > 0.5).reshape(idx.shape[0], f, c)


def scatter_rows(src, idx, rows):
    """``src.at[idx].set(rows, mode='drop')`` for bool src (N, F, C),
    DISTINCT idx (m,) int (N = padded/drop), rows (m, F, C) bool.

    One-hot matmul-add at small sizes (subtract the gathered old
    rows, add the new: exact integer arithmetic in f32), native in-place
    scatter at large. ``rows`` is always the bool one-hot (m, F, C) form;
    with a PACKED destination the rows are packed (argmax + sentinel C
    for all-zero/NA rows) before the int8 in-place scatter."""
    if source_is_packed(src):
        return src.at[idx].set(pack_source(rows), mode="drop")
    n, f, c = src.shape
    if not _rows_mm(n, f, c):
        return src.at[idx].set(rows, mode="drop")
    oh = jax.nn.one_hot(idx, n, dtype=jnp.bfloat16)              # (m, N)
    flat = src.reshape(n, f * c)
    old = jnp.dot(oh, flat.astype(jnp.bfloat16),
                  preferred_element_type=jnp.float32)            # (m, F*C)
    delta = rows.reshape(idx.shape[0], f * c).astype(jnp.float32) - old
    upd = jnp.dot(oh.T.astype(jnp.float32), delta,
                  preferred_element_type=jnp.float32, precision=HIGHEST)  # (N, F*C)
    return ((flat.astype(jnp.float32) + upd) > 0.5).reshape(src.shape)


def dirichlet_categorical_logpdf(counts, a):
    """Collapsed (marginalized) categorical log-likelihood per feature.

    log P(counts | a) for the Dirichlet-categorical compound distribution
    WITHOUT the multinomial coefficient (observations are ordered, matching
    the reference: sbayes/util.py:1373-1394).

    Args:
        counts: (..., n_features, n_states) state counts.
        a: (..., n_features, n_states) Dirichlet concentrations; entries <= 0
           mark non-applicable states and are excluded.
    Returns:
        (..., n_features) log-probabilities.
    """
    n = counts.sum(-1)
    sum_a = a.sum(-1)
    const = gammaln(sum_a) - gammaln(n + sum_a)
    series = jnp.where(a > 0, gammaln(counts + a) - gammaln(a), 0.0).sum(-1)
    return const + series


def dirichlet_categorical_delta(counts, a, d):
    """Exact change of ``dirichlet_categorical_logpdf(counts + d, a).sum()``
    minus ``...(counts, a).sum()`` for unit count moves, without lgammas.

    ``d`` has entries in {-1, 0, +1} with at most one observation moving
    per feature (sum over states per feature in {-1, 0, +1}) — the shape
    of a single object's membership/source change. Uses
    lgamma(c+1) - lgamma(c) = log(c), so the whole delta is a handful of
    logs on the touched entries instead of a full lgamma recompute:

        +1 at (f,s): +log(counts + a)        (value BEFORE the move)
        -1 at (f,s): -log(counts + a - 1)
        n_f += 1:    -log(n_f + sum_a)
        n_f -= 1:    +log(n_f + sum_a - 1)

    Args:
        counts: (..., F, S) counts BEFORE the move.
        a: (..., F, S) concentrations (<= 0 marks non-applicable; ``d``
           must be zero there — one-hot features guarantee it).
        d: (..., F, S) the count change.
    Returns:
        scalar-per-leading-batch (...,): the log-likelihood change.
    """
    up = d > 0
    dn = d < 0
    series = (
        jnp.where(up, jnp.log(jnp.maximum(counts + a, 1e-35)), 0.0)
        - jnp.where(dn, jnp.log(jnp.maximum(counts + a - 1, 1e-35)), 0.0)
    ).sum((-1, -2))
    n = counts.sum(-1)
    sum_a = a.sum(-1)
    dn_f = d.sum(-1)
    const = (
        -jnp.where(dn_f > 0, jnp.log(jnp.maximum(n + sum_a, 1e-35)), 0.0)
        + jnp.where(dn_f < 0, jnp.log(jnp.maximum(n + sum_a - 1, 1e-35)), 0.0)
    ).sum(-1)
    return series + const


def dirichlet_logpdf(x, alpha, where=None):
    """Dirichlet log-density over the last axis.

    Args:
        x: (..., n) probability vectors.
        alpha: (..., n) concentrations; non-applicable entries must have
            alpha <= 0 AND be excluded via `where`.
        where: optional bool mask of applicable entries.
    """
    if where is None:
        where = jnp.ones_like(x, dtype=bool)
    lognorm = jnp.where(where, gammaln(alpha), 0.0).sum(-1) - gammaln(
        jnp.where(where, alpha, 0.0).sum(-1)
    )
    kernel = jnp.where(where, (alpha - 1) * jnp.log(jnp.where(where, x, 1.0)), 0.0).sum(-1)
    return kernel - lognorm


def feature_tile(x, i, f_chunk, axis=1):
    """Slice one F-tile out of an array whose ``axis`` is the feature axis."""
    return jax.lax.dynamic_slice_in_dim(x, i * f_chunk, f_chunk, axis=axis)


def compute_feature_counts(clusters, source, features, conf_groups, f_chunk=None):
    """Sufficient-statistic counts for all mixture components, fully fused.

    The full-recompute counterpart of the incremental counts machinery
    (reference: sbayes/sampling/counts.py:10-95 and state.py FeatureCounts):
    one recompute as matrix-product contractions.

    Args:
        clusters: (K, N) cluster membership (bool or float).
        source: (N, F, C) one-hot component attribution of each observation.
        features: (N, F, S) one-hot observations (float).
        conf_groups: (C-1, Gmax, N) padded static confounder group masks (float).
        f_chunk: optional feature-tile width (must divide F). When set, the
            contraction runs as a lax.map over F-tiles — identical results,
            tile-sized intermediates, bounded compile time at scale.
    Returns:
        cluster_counts: (K, F, S)
        conf_counts: (C-1, Gmax, F, S)
    """
    dtype = features.dtype
    F = features.shape[1]

    def counts_of(feats_t, source_t):
        # One-hot products are exact in any float dtype (0/1 values); the
        # f32 preferred_element_type keeps the count ACCUMULATION exact
        # when features are stored bf16 (bf16 accumulators overflow
        # integer exactness beyond 256).
        #
        # Each component is a masked-features matmul. The per-component
        # Python loop (C is tiny and static) avoids the 3-operand einsum
        # "cgn,nfc,nfs->cgfs", whose every pairwise contraction path
        # materializes an O(N·F·S·C) or O(G·N·F) intermediate — measured
        # ~5x worse HBM traffic at the 10k x 5k shape.
        src0 = source_comp(source_t, 0, dtype)
        fx0 = feats_t * src0[:, :, None]
        cl = jnp.einsum("kn,nfs->kfs", clusters.astype(dtype), fx0,
                        preferred_element_type=jnp.float32, precision=HIGHEST)
        conf_parts = []
        for i_c in range(conf_groups.shape[0]):
            src_c = source_comp(source_t, 1 + i_c, dtype)
            fx_c = feats_t * src_c[:, :, None]
            conf_parts.append(jnp.einsum(
                "gn,nfs->gfs", conf_groups[i_c].astype(dtype), fx_c,
                preferred_element_type=jnp.float32, precision=HIGHEST
            ))
        conf = jnp.stack(conf_parts, axis=0)
        return cl, conf

    if f_chunk is None or f_chunk >= F:
        return counts_of(features, source)

    assert F % f_chunk == 0, f"f_chunk {f_chunk} must divide F {F}"
    n_tiles = F // f_chunk

    def tile_body(i):
        return counts_of(feature_tile(features, i, f_chunk),
                         feature_tile(source, i, f_chunk))

    cl_t, conf_t = jax.lax.map(tile_body, jnp.arange(n_tiles))
    # (T, K, fc, S) -> (K, F, S); (T, C-1, G, fc, S) -> (C-1, G, F, S)
    K, _, S = cl_t.shape[1], cl_t.shape[2], cl_t.shape[3]
    cluster_counts = jnp.moveaxis(cl_t, 0, 1).reshape(K, F, S)
    Cm1, G = conf_t.shape[1], conf_t.shape[2]
    conf_counts = jnp.moveaxis(conf_t, 0, 2).reshape(Cm1, G, F, S)
    return cluster_counts, conf_counts


def normalize_weights(weights, has_components):
    """Per-object renormalized mixture weights.

    Objects only receive weight on components that are available to them
    (reference: sbayes/model/likelihood.py:171-190).

    Args:
        weights: (F, C).
        has_components: (N, C) availability indicator.
    Returns:
        (N, F, C) normalized weights.
    """
    w = weights[None, :, :] * has_components[:, None, :].astype(weights.dtype)
    return w / jnp.sum(w, axis=-1, keepdims=True)


def conditional_effect_mean(prior_counts, feature_counts, unif_counts=None,
                            prior_temperature=None, temperature=None):
    """Posterior-mean categorical effect given counts (collapsed conditional).

    Mirrors reference sbayes/sampling/conditionals.py:105-122 including the
    MC3 heating of prior and likelihood counts.
    """
    if prior_temperature is not None:
        prior_counts = unif_counts + (prior_counts - unif_counts) / prior_temperature
    if temperature is not None:
        feature_counts = feature_counts / temperature
    return normalize(feature_counts + prior_counts, axis=-1)


def heat_binary_probability_logits(logit, temperature):
    """sigmoid(logit/T): binary-probability heating in logit space.

    Equivalent to p**(1/T) / (p**(1/T) + (1-p)**(1/T)) for p = sigmoid(logit)
    (reference: sbayes/util.py:1457-1469), but numerically stable.
    """
    return jax.nn.sigmoid(logit / temperature)


def log_expit(x):
    return jax.nn.log_sigmoid(x)


def log_multinom(n, ks, max_n: int):
    """log of the multinomial coefficient (n choose k1,k2,...), jittable.

    Uses lgamma of integer arguments; ``max_n`` only documents the intended
    range. Reference behavior: sbayes/util.py:1125-1173.
    """
    ks = jnp.asarray(ks)
    rest = n - ks.sum()
    return gammaln(n + 1.0) - gammaln(ks + 1.0).sum() - gammaln(rest + 1.0)


def sample_categorical_onehot(key, p):
    """Sample one-hot draws from (multidimensional) categorical probabilities.

    Device-side equivalent of reference sbayes/preprocessing.py:224-256.

    Args:
        key: PRNG key.
        p: (..., n_states) probabilities (need not be normalized).
    Returns:
        bool (..., n_states) one-hot samples.
    """
    # Inverse-CDF draw: ONE uniform per categorical cell instead of the
    # gumbel-max form's C gumbels (jax.random.categorical): C x fewer
    # random bits and no per-lane log. Exactly
    # categorical(p / p.sum()): u ~ U[0, total) via scaling by the last
    # cumsum entry (so u < cdf[-1] up to one final-ulp rounding, clamped);
    # all-zero rows (NA cells) deterministically yield the last category,
    # which every caller masks out.
    c = p.shape[-1]
    cdf = jnp.cumsum(p, axis=-1)
    u = jax.random.uniform(key, p.shape[:-1], p.dtype) * cdf[..., -1]
    idx = jnp.minimum((u[..., None] >= cdf).sum(-1), c - 1)
    return jax.nn.one_hot(idx, c, dtype=bool)
