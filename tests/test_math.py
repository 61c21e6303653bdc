"""Unit tests of the device-side math against independent NumPy/SciPy oracles."""
import numpy as np
import pytest
import scipy.stats
from scipy.special import gammaln as sp_gammaln

import jax.numpy as jnp

from sbayes_tpu.model import math as m
from sbayes_tpu.utils import log_binom, log_multinom



pytestmark = pytest.mark.smoke

def ref_dirichlet_categorical_logpdf(counts, a):
    """Oracle: collapsed categorical log-lh, straight from the definition."""
    n = counts.sum(-1)
    sum_a = a.sum(-1)
    const = sp_gammaln(sum_a) - sp_gammaln(n + sum_a)
    with np.errstate(invalid="ignore"):
        series = np.where(a > 0, sp_gammaln(counts + a) - sp_gammaln(a), 0.0)
    return const + series.sum(-1)


def test_dirichlet_categorical_matches_scipy_oracle(rng):
    F, S = 7, 5
    a = rng.gamma(2.0, size=(F, S)).astype(np.float32)
    a[:, 3:] = 0.0  # non-applicable states
    counts = rng.integers(0, 50, size=(F, S)).astype(np.float32)
    counts[:, 3:] = 0.0

    got = np.asarray(m.dirichlet_categorical_logpdf(jnp.asarray(counts), jnp.asarray(a)))
    want = ref_dirichlet_categorical_logpdf(counts.astype(np.float64), a.astype(np.float64))
    # float32 lgamma accumulation: tolerate ~1e-4 relative error
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_dirichlet_categorical_known_value():
    # P(obs = [s0, s0, s1] ordered | a=[1,1]) = (1/2)*(2/3)*(1/4) ... via polya urn
    a = np.array([[1.0, 1.0]], dtype=np.float32)
    counts = np.array([[2.0, 1.0]], dtype=np.float32)
    got = float(np.asarray(m.dirichlet_categorical_logpdf(jnp.asarray(counts), jnp.asarray(a)))[0])
    # polya urn: first draw s0: 1/2; second s0: 2/3; then s1: 1/4
    want = np.log((1 / 2) * (2 / 3) * (1 / 4))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_dirichlet_logpdf_matches_scipy(rng):
    n = 4
    alpha = rng.gamma(2.0, size=(10, n)) + 0.1
    x = rng.dirichlet(np.ones(n), size=10)
    got = np.asarray(m.dirichlet_logpdf(jnp.asarray(x, jnp.float32), jnp.asarray(alpha, jnp.float32)))
    want = np.array([scipy.stats.dirichlet.logpdf(x[i][:-1], alpha[i]) for i in range(10)])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_normalize_weights_matches_reference_pattern(rng):
    F, C, N = 6, 3, 11
    weights = rng.dirichlet(np.ones(C), size=F).astype(np.float32)
    has_comp = rng.random((N, C)) < 0.7
    has_comp[:, 1] = True  # at least one component everywhere
    got = np.asarray(m.normalize_weights(jnp.asarray(weights), jnp.asarray(has_comp)))
    # Oracle: per-object masked renormalization
    want = weights[None] * has_comp[:, None, :]
    want = want / want.sum(-1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_feature_counts_matches_loop_oracle(rng):
    N, F, S, K, Cm1, G = 9, 4, 3, 2, 2, 3
    features = (rng.random((N, F, S)) < 0.4).astype(np.float32)
    C = Cm1 + 1
    src_idx = rng.integers(0, C, size=(N, F))
    source = np.eye(C, dtype=bool)[src_idx]
    clusters = rng.random((K, N)) < 0.3
    groups = (rng.random((Cm1, G, N)) < 0.4).astype(np.float32)

    cl, cf = m.compute_feature_counts(
        jnp.asarray(clusters), jnp.asarray(source), jnp.asarray(features), jnp.asarray(groups)
    )
    # loop oracle
    want_cl = np.zeros((K, F, S))
    for k in range(K):
        for n in range(N):
            if clusters[k, n]:
                want_cl[k] += source[n, :, 0][:, None] * features[n]
    np.testing.assert_allclose(np.asarray(cl), want_cl, rtol=1e-5)

    want_cf = np.zeros((Cm1, G, F, S))
    for c in range(Cm1):
        for g in range(G):
            for n in range(N):
                if groups[c, g, n]:
                    want_cf[c, g] += source[n, :, c + 1][:, None] * features[n]
    np.testing.assert_allclose(np.asarray(cf), want_cf, rtol=1e-5)


def test_log_multinom_symmetry_and_binom():
    """Reference test behavior: test/test_util.py and test_model.py."""
    # symmetry under permutation of sample sizes
    assert np.isclose(log_multinom(10, [3, 2, 1]), log_multinom(10, [1, 3, 2]))
    # consistency with binomial coefficient
    assert np.isclose(log_multinom(13, [4]), log_binom(13, 4))
    assert np.isclose(log_multinom(13, [3, 2]), log_binom(13, 3) + log_binom(10, 2))
    # log(5!) special case
    import math

    assert np.isclose(log_multinom(5, [1, 1, 1, 1]), np.log(math.factorial(5)))


def test_log_multinom_jax_matches_host():
    got = float(m.log_multinom(13.0, jnp.asarray([3.0, 2.0]), max_n=13))
    want = log_multinom(13, [3, 2])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sample_categorical_onehot_distribution(rng):
    import jax

    p = jnp.asarray([[0.2, 0.8], [0.5, 0.5]], dtype=jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 3000)
    draws = jax.vmap(lambda k: m.sample_categorical_onehot(k, p))(keys)
    freq = np.asarray(draws).mean(0)
    np.testing.assert_allclose(freq, np.asarray(p), atol=0.03)
    assert np.all(np.asarray(draws).sum(-1) == 1)


def test_dirichlet_categorical_delta_matches_full_difference(rng):
    """dirichlet_categorical_delta == logpdf(counts+d) - logpdf(counts)
    summed, for random unit count moves (at most one +1 and one -1 per
    feature), including no-op features and a batch axis."""
    K, F, S = 3, 11, 4
    counts = rng.integers(0, 9, size=(K, F, S)).astype(np.float64)
    a = rng.uniform(0.2, 2.0, size=(K, F, S))
    # random unit moves: per (k, f) pick add-state and remove-state
    d = np.zeros((K, F, S))
    for k in range(K):
        for f in range(F):
            kind = rng.integers(0, 4)  # 0: none, 1: add, 2: remove, 3: move
            s_add, s_rm = rng.choice(S, size=2, replace=False)
            if kind in (1, 3):
                d[k, f, s_add] += 1
            if kind in (2, 3) and counts[k, f, s_rm] >= 1:
                d[k, f, s_rm] -= 1

    def full(c):
        n = c.sum(-1)
        sum_a = a.sum(-1)
        series = (sp_gammaln(c + a) - sp_gammaln(a)).sum(-1)
        return (sp_gammaln(sum_a) - sp_gammaln(n + sum_a) + series).sum()

    want = full(counts + d) - full(counts)
    got = m.dirichlet_categorical_delta(
        jnp.asarray(counts, jnp.float32), jnp.asarray(a, jnp.float32),
        jnp.asarray(d, jnp.float32)).sum()
    np.testing.assert_allclose(float(got), want, rtol=1e-4, atol=1e-4)


def test_gather_scatter_rows_engines(monkeypatch):
    """gather_rows/scatter_rows: the one-hot matmul form and the native
    gather/scatter agree with direct indexing, incl. the padded index N
    (gather -> all-False row; scatter -> dropped) and vmap batching."""
    import jax

    from sbayes_tpu.model import math as m

    rng = np.random.default_rng(3)
    B, N, F, C, mm = 4, 23, 7, 3, 5
    src = rng.random((B, N, F, C)) < 0.4
    idx = np.stack([rng.choice(N, size=mm, replace=False) for _ in range(B)])
    idx[0, -1] = N  # padded
    idx[2, 0] = N
    rows = rng.random((B, mm, F, C)) < 0.4

    want_g = np.zeros((B, mm, F, C), bool)
    want_s = src.copy()
    for b in range(B):
        for j in range(mm):
            if idx[b, j] < N:
                want_g[b, j] = src[b, idx[b, j]]
                want_s[b, idx[b, j]] = rows[b, j]

    for eng in ("1", "0"):
        monkeypatch.setenv("SBAYES_TPU_ROWS_MM", eng)
        g = jax.jit(jax.vmap(m.gather_rows))(jnp.asarray(src), jnp.asarray(idx))
        s = jax.jit(jax.vmap(m.scatter_rows))(
            jnp.asarray(src), jnp.asarray(idx), jnp.asarray(rows))
        if eng == "1":
            np.testing.assert_array_equal(np.asarray(g), want_g)
        else:
            # native gather fills padded rows with False too (mode='fill')
            np.testing.assert_array_equal(np.asarray(g), want_g)
        np.testing.assert_array_equal(np.asarray(s), want_s)
