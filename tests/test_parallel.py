"""Sharding/vmapping equivalence tests (the reference has no distributed
tests; SURVEY.md flags this as a gap to close in the rebuild)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp


@pytest.fixture(scope="module")
def small_runtime():
    from sbayes_tpu.model.model import Model
    from sbayes_tpu.sampling.runner import SamplerRuntime
    from sbayes_tpu.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=16, n_features=5, n_states=3, n_families=2, seed=3)
    config = synthetic_config(n_clusters=2, geo_prior="uniform")
    model = Model(data, config.model)
    return SamplerRuntime(model, config.mcmc, sample_from_prior=False)


def _run(rt, states, n_chains, n_steps, mesh=None):
    from sbayes_tpu.sampling.kernel import OperatorStats

    stats = jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(n_chains))
    ones = jnp.ones(n_chains, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), n_chains)
    if mesh is not None:
        from sbayes_tpu.parallel.mesh import shard_chain_batch

        states = shard_chain_batch(states, mesh)
        stats = shard_chain_batch(stats, mesh)
        keys = shard_chain_batch(keys, mesh)
        ones_s = shard_chain_batch(ones, mesh)
        with mesh:
            return rt.run_chunk(keys, states, stats, ones_s, ones_s, n_steps)
    return rt.run_chunk(keys, states, stats, ones, ones, n_steps)


def test_sharded_equals_unsharded(small_runtime):
    """Chains sharded over an 8-device mesh produce bitwise the same states
    as the single-device vmapped run."""
    from sbayes_tpu.parallel.mesh import chain_mesh

    rt = small_runtime
    n_chains = 8
    # run_chunk donates its state/stats buffers -> build fresh states per run
    states = rt.init_chains(jax.random.PRNGKey(0), n_chains, shard=False)
    carry_single = _run(rt, states, n_chains, n_steps=25)
    mesh = chain_mesh()
    states = rt.init_chains(jax.random.PRNGKey(0), n_chains)
    carry_sharded = _run(rt, states, n_chains, n_steps=25, mesh=mesh)

    np.testing.assert_array_equal(
        np.asarray(carry_single.state.clusters), np.asarray(carry_sharded.state.clusters)
    )
    np.testing.assert_allclose(
        np.asarray(carry_single.state.log_lh), np.asarray(carry_sharded.state.log_lh),
        rtol=1e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(carry_single.stats.accepts), np.asarray(carry_sharded.stats.accepts)
    )


def test_chains_are_independent(small_runtime):
    """Each vmapped chain evolves exactly as it would alone (lane 0 of a
    batch == a 1-chain batch with the same key)."""
    rt = small_runtime
    states4 = rt.init_chains(jax.random.PRNGKey(0), 4)
    # slice lane 0 BEFORE running (run_chunk donates its input buffers)
    state0 = jax.tree.map(lambda x: jnp.copy(x[:1]), states4)
    carry4 = _run(rt, states4, 4, n_steps=20)
    from sbayes_tpu.sampling.kernel import OperatorStats

    stats1 = jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(1))
    keys = jax.random.split(jax.random.PRNGKey(7), 4)[:1]
    carry1 = rt.run_chunk(keys, state0, stats1, jnp.ones(1), jnp.ones(1), 20)

    np.testing.assert_array_equal(
        np.asarray(carry4.state.clusters[0]), np.asarray(carry1.state.clusters[0])
    )
    np.testing.assert_allclose(
        float(carry4.state.log_lh[0]), float(carry1.state.log_lh[0]), rtol=1e-5
    )


def _run_mc3(rt, states, n_chains, n_steps, mesh=None):
    from sbayes_tpu.sampling.kernel import OperatorStats

    stats = jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(n_chains))
    temps = 1.0 + 0.1 * jnp.arange(n_chains, dtype=jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), n_chains)
    swap_matrix = jnp.zeros((2, n_chains, n_chains), jnp.int32)
    if mesh is not None:
        from sbayes_tpu.parallel.mesh import shard_chain_batch

        states, stats, keys, temps = (
            shard_chain_batch(states, mesh), shard_chain_batch(stats, mesh),
            shard_chain_batch(keys, mesh), shard_chain_batch(temps, mesh),
        )
    return rt._run_mc3_chunk(keys, states, stats, temps, temps,
                             jax.random.PRNGKey(12), swap_matrix,
                             jnp.int32(0), n_steps, 3, 2, False)


def test_sharded_mc3_equals_single_device(small_runtime):
    """The fused MC3 chunk (subchains + in-scan swap permutation of the
    chain axis — a cross-device collective under sharding) produces bitwise
    the same ladder on an 8-device mesh as on one device (the swap
    collective itself must be exercised sharded)."""
    from sbayes_tpu.parallel.mesh import chain_mesh

    rt = small_runtime
    n_chains = 8
    states = rt.init_chains(jax.random.PRNGKey(5), n_chains, shard=False)
    _, st_single, stats_s, swaps_single, acc_s, att_s = _run_mc3(
        rt, states, n_chains, n_steps=30)

    states = rt.init_chains(jax.random.PRNGKey(5), n_chains, shard=False)
    _, st_shard, stats_m, swaps_shard, acc_m, att_m = _run_mc3(
        rt, states, n_chains, n_steps=30, mesh=chain_mesh())

    assert int(att_s) == int(att_m) and int(att_s) == 10 * 2  # 10 swap phases
    assert int(acc_s) == int(acc_m)
    np.testing.assert_array_equal(np.asarray(swaps_single), np.asarray(swaps_shard))
    np.testing.assert_array_equal(np.asarray(st_single.clusters), np.asarray(st_shard.clusters))
    np.testing.assert_allclose(np.asarray(st_single.log_lh), np.asarray(st_shard.log_lh), rtol=1e-5)


def test_auto_chain_mesh_policy():
    """auto_chain_mesh shards only full-device even splits (partial-device
    meshes would conflict with consts replicated over all devices) and
    honors the kill switch."""
    import os

    from sbayes_tpu.parallel.mesh import auto_chain_mesh

    assert auto_chain_mesh(8).devices.size == 8
    assert auto_chain_mesh(16).devices.size == 8
    assert auto_chain_mesh(1024).devices.size == 8
    assert auto_chain_mesh(6) is None    # 6 % 8 != 0 -> no sharding
    assert auto_chain_mesh(12) is None
    assert auto_chain_mesh(1) is None
    os.environ["SBAYES_TPU_SHARDING"] = "off"
    try:
        assert auto_chain_mesh(8) is None
    finally:
        del os.environ["SBAYES_TPU_SHARDING"]


def test_mc3_warmup_best_of_per_rung(small_runtime):
    """warmup_ladder (reference mcmc_setup.py:507-526) runs W warm-up
    chains per ladder rung and keeps the per-rung argmax by
    log-likelihood; with warmup_steps=0 the selection over the raw
    initializer states is exactly reproducible — and the rungs keep
    DISTINCT initializations (ladder init diversity)."""
    rt = small_runtime
    n_chains, W = 3, 4
    temps = 1.0 + 0.2 * jnp.arange(n_chains, dtype=jnp.float32)
    key = jax.random.PRNGKey(21)

    picked = rt.warmup_ladder(key, n_chains, W, temps, temps, n_steps=0)
    assert picked.clusters.shape[0] == n_chains

    # reproduce the selection: same key split + init grid
    k_init, _ = jax.random.split(key)
    grid = rt.init_chains(k_init, n_chains * W)
    ll = np.asarray(grid.log_lh).reshape(n_chains, W)
    expect_sel = ll.argmax(axis=1) + np.arange(n_chains) * W
    np.testing.assert_allclose(
        np.asarray(picked.log_lh), np.asarray(grid.log_lh)[expect_sel])
    for i in range(n_chains):
        np.testing.assert_array_equal(
            np.asarray(picked.clusters[i]),
            np.asarray(grid.clusters[expect_sel[i]]))

    # init diversity: not all rungs collapsed onto identical states
    flat = np.asarray(picked.clusters).reshape(n_chains, -1)
    assert not all(np.array_equal(flat[0], flat[i]) for i in range(1, n_chains))

    # and with warm-up steps the ladder still returns per-rung states
    picked2 = rt.warmup_ladder(jax.random.PRNGKey(22), n_chains, 2, temps,
                               temps, n_steps=10)
    assert picked2.clusters.shape[0] == n_chains
    assert np.all(np.isfinite(np.asarray(picked2.log_lh)))


def test_ess_and_rhat():
    from sbayes_tpu.results.ess import effective_sample_size, split_rhat

    rng = np.random.default_rng(0)
    # iid series: ESS ~ n
    x = rng.normal(size=4000)
    ess = effective_sample_size(x)
    assert 2500 < ess <= 4000

    # AR(1) with phi=0.9: ESS ~ n*(1-phi)/(1+phi) ~ n/19
    phi = 0.9
    ar = np.empty(20000)
    ar[0] = 0
    noise = rng.normal(size=20000)
    for i in range(1, len(ar)):
        ar[i] = phi * ar[i - 1] + noise[i]
    ess_ar = effective_sample_size(ar)
    expected = len(ar) * (1 - phi) / (1 + phi)
    assert 0.5 * expected < ess_ar < 2.0 * expected

    # R-hat of identical-distribution chains ~ 1
    chains = rng.normal(size=(4, 2000))
    assert abs(split_rhat(chains) - 1.0) < 0.05
    # diverged chains -> large R-hat
    bad = chains.copy()
    bad[0] += 10
    assert split_rhat(bad) > 1.5


def test_sharded_refresh_equals_unsharded(small_runtime):
    """The periodic carried-invariant refresh (_refresh_states_jit) under a
    sharded chain batch produces bitwise the same carried values as the
    single-device run — the refresh is a new jitted program over sharded
    states, so its GSPMD lowering needs its own equivalence check."""
    from sbayes_tpu.parallel.mesh import chain_mesh, shard_chain_batch
    from sbayes_tpu.sampling.runner import _refresh_states_jit

    rt = small_runtime
    n_chains = 8
    states = rt.init_chains(jax.random.PRNGKey(3), n_chains, shard=False)
    ref = _refresh_states_jit(rt.consts, rt.sample_from_prior, states)

    mesh = chain_mesh()
    states_s = shard_chain_batch(rt.init_chains(jax.random.PRNGKey(3), n_chains,
                                                shard=False), mesh)
    with mesh:
        got = _refresh_states_jit(rt.consts, rt.sample_from_prior, states_s)

    np.testing.assert_array_equal(np.asarray(ref.log_lh), np.asarray(got.log_lh))
    np.testing.assert_array_equal(np.asarray(ref.prior_parts),
                                  np.asarray(got.prior_parts))
    np.testing.assert_array_equal(np.asarray(ref.cl_counts), np.asarray(got.cl_counts))
