"""Masked Prim MST vs scipy's minimum_spanning_tree."""
import numpy as np
import jax.numpy as jnp
from scipy.sparse.csgraph import minimum_spanning_tree

from sbayes_tpu.ops.mst import cluster_mst_edge_costs, mst_aggregate


import pytest

pytestmark = pytest.mark.smoke

def scipy_mst_edges(cost, mask):
    sub = cost[np.ix_(mask, mask)]
    if sub.shape[0] <= 1:
        return np.zeros(0)
    mst = minimum_spanning_tree(sub)
    return np.asarray(mst.tocsr()[mst.nonzero()]).ravel()


def test_mst_total_matches_scipy(rng):
    for trial in range(10):
        n = 20
        pts = rng.random((n, 2))
        cost = np.linalg.norm(pts[:, None] - pts[None], axis=-1).astype(np.float32)
        mask = rng.random(n) < 0.5
        if mask.sum() == 0:
            mask[0] = True
        edges, count = cluster_mst_edge_costs(jnp.asarray(cost), jnp.asarray(mask))
        want = scipy_mst_edges(cost.astype(float), mask)
        assert int(count) == len(want)
        np.testing.assert_allclose(float(jnp.sum(edges)), want.sum(), rtol=1e-5)
        # max edge also matches
        if len(want):
            np.testing.assert_allclose(float(jnp.max(edges)), want.max(), rtol=1e-5)


def test_mst_singleton_and_empty():
    cost = jnp.asarray(np.random.default_rng(0).random((5, 5)), jnp.float32)
    edges, count = cluster_mst_edge_costs(cost, jnp.asarray([False, True, False, False, False]))
    assert float(jnp.sum(edges)) == 0.0 and int(count) == 0

    # aggregations of singleton cluster are all 0 (matching reference fallback)
    for agg in ("sum", "mean", "max"):
        assert float(mst_aggregate(cost, jnp.asarray([True, False, False, False, False]), agg)) == 0.0


def shifted_scipy_mst_edges(cost, mask):
    """scipy MST oracle with TRUE zero-edge semantics: scipy's sparse
    minimum_spanning_tree silently DROPS zero-weight edges (they vanish
    in the CSR representation), so duplicate locations corrupt it. A
    constant shift keeps the edge structure (MST is invariant under
    uniform shifts); subtracting it back recovers the true edge costs.
    (The reference inherits the scipy artifact — prior.py:950-962; our
    kernels treat zero-distance edges as real, documented divergence.)"""
    sub = cost[np.ix_(mask, mask)]
    if sub.shape[0] <= 1:
        return np.zeros(0)
    mst = minimum_spanning_tree(sub + 1.0 - np.eye(sub.shape[0]))
    return np.asarray(mst.tocsr()[mst.nonzero()]).ravel() - 1.0


def test_boruvka_matches_scipy_and_prim(rng):
    """Boruvka aggregate stats == scipy MST == masked Prim, including
    duplicate-location ties (equal-weight edges exercise the (w, pid)
    total-order dedup/contraction logic)."""
    from sbayes_tpu.ops.boruvka import cluster_mst_stats

    for trial in range(20):
        n = rng.integers(2, 40)
        pts = rng.random((n, 2))
        if trial % 3 == 0 and n >= 6:
            # duplicated coordinates -> exact zero-distance / equal-weight ties
            pts[1] = pts[0]
            pts[3] = pts[2]
            pts[5] = pts[0]
        cost = np.linalg.norm(pts[:, None] - pts[None], axis=-1).astype(np.float32)
        mask = rng.random(n) < rng.uniform(0.2, 0.9)
        if mask.sum() == 0:
            mask[0] = True
        total, count, maxe = cluster_mst_stats(jnp.asarray(cost), jnp.asarray(mask))
        want = shifted_scipy_mst_edges(cost.astype(float), mask)
        assert int(count) == len(want), f"trial {trial}: {int(count)} != {len(want)}"
        np.testing.assert_allclose(float(total), want.sum(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(maxe), want.max() if len(want) else 0.0,
                                   rtol=1e-5, atol=1e-6)
        # consistency with the Prim kernel
        edges, pcount = cluster_mst_edge_costs(jnp.asarray(cost), jnp.asarray(mask))
        np.testing.assert_allclose(float(total), float(jnp.sum(edges)), rtol=1e-5,
                                   atol=1e-6)
        assert int(count) == int(pcount)


def test_boruvka_batch_vmap(rng):
    from sbayes_tpu.ops.boruvka import cluster_mst_stats
    import jax

    n = 30
    pts = rng.random((n, 2))
    cost = np.linalg.norm(pts[:, None] - pts[None], axis=-1).astype(np.float32)
    masks = rng.random((16, n)) < 0.5
    masks[0] = False  # empty
    masks[1] = False
    masks[1, 7] = True  # singleton
    f = jax.jit(jax.vmap(lambda m: cluster_mst_stats(jnp.asarray(cost), m)))
    tot, cnt, mx = f(jnp.asarray(masks))
    for i in range(16):
        want = shifted_scipy_mst_edges(cost.astype(float), masks[i])
        assert int(cnt[i]) == len(want)
        np.testing.assert_allclose(float(tot[i]), want.sum(), rtol=1e-5, atol=1e-6)


def test_prim_mm_matches_scipy_and_prim(rng):
    """The matmul row-select Prim (cluster_mst_stats_prim) == scipy == the
    gather-form Prim, including size<=1 clusters and tie-heavy inputs."""
    import jax

    from sbayes_tpu.ops.mst import cluster_mst_stats_prim

    for trial in range(20):
        n = int(rng.integers(2, 40))
        pts = rng.random((n, 2))
        if trial % 3 == 0 and n >= 6:
            pts[1] = pts[0]
            pts[3] = pts[2]
        cost = np.linalg.norm(pts[:, None] - pts[None], axis=-1).astype(np.float32)
        mask = rng.random(n) < rng.uniform(0.1, 0.9)
        total, count, maxe = jax.jit(cluster_mst_stats_prim)(
            jnp.asarray(cost), jnp.asarray(mask))
        if mask.sum() <= 1:
            assert float(total) == 0.0 and int(count) == 0 and float(maxe) == 0.0
            continue
        want = shifted_scipy_mst_edges(cost.astype(float), mask)
        assert int(count) == len(want), f"trial {trial}"
        np.testing.assert_allclose(float(total), want.sum(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(maxe), want.max() if len(want) else 0.0,
                                   rtol=1e-5, atol=1e-6)


def test_prim_mm_batch_vmap(rng):
    import jax

    from sbayes_tpu.ops.mst import cluster_mst_stats_prim

    n = 30
    pts = rng.random((n, 2))
    cost = np.linalg.norm(pts[:, None] - pts[None], axis=-1).astype(np.float32)
    masks = rng.random((16, n)) < 0.5
    masks[0] = False   # empty
    masks[1] = False
    masks[1, 7] = True  # singleton
    f = jax.jit(jax.vmap(lambda m: cluster_mst_stats_prim(jnp.asarray(cost), m)))
    tot, cnt, mx = f(jnp.asarray(masks))
    for i in range(16):
        want = shifted_scipy_mst_edges(cost.astype(float), masks[i])
        assert int(cnt[i]) == len(want)
        np.testing.assert_allclose(float(tot[i]), want.sum(), rtol=1e-5, atol=1e-6)


def test_posterior_mst_engine_switch(rng, monkeypatch):
    """Posterior.skeleton_triple under SBAYES_TPU_MST=boruvka must equal the
    Prim default on random clusters (the engine is a pure backend swap)."""
    import jax

    from sbayes_tpu.model.model import Model
    from sbayes_tpu.model.posterior import Posterior
    from sbayes_tpu.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=20, n_features=4, n_states=3, seed=2)
    config = synthetic_config(n_clusters=2, geo_prior="cost_based", rate=1e6)
    post = Posterior(Model(data, config.model).consts)

    masks = np.zeros((6, 20), bool)
    for i in range(6):
        masks[i, rng.choice(20, size=rng.integers(1, 12), replace=False)] = True
    masks = jnp.asarray(masks)

    monkeypatch.setenv("SBAYES_TPU_MST", "prim")
    prim = np.asarray(jax.jit(jax.vmap(post.skeleton_triple))(masks))
    monkeypatch.setenv("SBAYES_TPU_MST", "boruvka")
    bor = np.asarray(jax.jit(jax.vmap(post.skeleton_triple))(masks))
    np.testing.assert_allclose(prim, bor, rtol=1e-5, atol=1e-5)
    monkeypatch.setenv("SBAYES_TPU_MST", "prim_mm")
    mm = np.asarray(jax.jit(jax.vmap(post.skeleton_triple))(masks))
    np.testing.assert_allclose(prim, mm, rtol=1e-5, atol=1e-5)
