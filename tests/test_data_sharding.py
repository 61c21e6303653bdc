"""Object-axis (data) sharding: the big-data scaling path.

For very large datasets the one-hot feature tensor and per-chain source
arrays dominate memory; they shard over an 'objects' mesh axis and GSPMD
partitions the count einsums (psum over object shards) automatically.
This validates that the posterior and a full MH step run correctly with
all object-axis arrays sharded — and match the unsharded results.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@pytest.fixture(scope="module")
def sharded_setup():
    from sbayes_tpu.model.constants import build_model_constants
    from sbayes_tpu.model.model import Model
    from sbayes_tpu.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=64, n_features=8, n_states=4, n_families=2, seed=9)
    config = synthetic_config(n_clusters=2, geo_prior="uniform")
    model = Model(data, config.model)

    mesh = Mesh(np.asarray(jax.devices()), ("objects",))
    return model, config, mesh


def _shard_consts(consts, mesh):
    """Place the object-axis arrays of ModelConstants across the mesh."""
    import dataclasses

    on_objects = NamedSharding(mesh, P("objects"))
    groups_sh = NamedSharding(mesh, P(None, None, "objects"))
    return dataclasses.replace(
        consts,
        features=jax.device_put(jnp.asarray(consts.features), on_objects),
        na=jax.device_put(jnp.asarray(consts.na), on_objects),
        groups=jax.device_put(jnp.asarray(consts.groups), groups_sh),
        hc_conf=jax.device_put(jnp.asarray(consts.hc_conf), on_objects),
    )


def test_sharded_posterior_matches(sharded_setup):
    from sbayes_tpu.model.posterior import Posterior
    from sbayes_tpu.sampling.conditionals import Conditionals
    from sbayes_tpu.sampling.prior_sampling import generate_prior_sample

    model, config, mesh = sharded_setup
    cond = Conditionals(Posterior(model.consts), 1.0, 1.0)
    state = generate_prior_sample(jax.random.PRNGKey(2), cond)

    want = jax.jit(cond.post.parts)(state)

    consts_sh = _shard_consts(model.consts, mesh)
    post_sh = Posterior(consts_sh)
    state_sh = state._replace(
        clusters=jax.device_put(state.clusters, NamedSharding(mesh, P(None, "objects"))),
        source=jax.device_put(state.source, NamedSharding(mesh, P("objects"))),
    )
    got = jax.jit(post_sh.parts)(state_sh)

    np.testing.assert_allclose(float(got.log_lh), float(want.log_lh), rtol=1e-5)
    np.testing.assert_allclose(float(got.source_prior), float(want.source_prior), rtol=1e-5)


def test_sharded_mh_step_runs(sharded_setup):
    """A full MH step executes with object-sharded constants and state."""
    from sbayes_tpu.model.posterior import Posterior
    from sbayes_tpu.sampling.conditionals import Conditionals
    from sbayes_tpu.sampling.kernel import make_mh_apply_fn
    from sbayes_tpu.sampling.operators import get_operator_schedule
    from sbayes_tpu.sampling.prior_sampling import generate_prior_sample

    model, config, mesh = sharded_setup
    consts_sh = _shard_consts(model.consts, mesh)
    cond = Conditionals(Posterior(consts_sh), 1.0, 1.0)
    state = generate_prior_sample(jax.random.PRNGKey(2), cond)
    state = jax.jit(cond.post.fill_state)(state)
    state = state._replace(
        clusters=jax.device_put(state.clusters, NamedSharding(mesh, P(None, "objects"))),
        source=jax.device_put(state.source, NamedSharding(mesh, P("objects"))),
    )

    ops = get_operator_schedule(cond, config.mcmc.operators)
    apply = jax.jit(make_mh_apply_fn(cond, ops))
    for i in range(len(ops)):
        state, accept, _ss, nf = apply(jnp.int32(i), jax.random.PRNGKey(50 + i), state)
        assert int(nf) == 0
    assert np.isfinite(float(state.log_lh))


def test_scale_shaped_2d_mesh_chunk(monkeypatch):
    """The 10k x 5k execution shape scaled down:
    feature-tiled kernels (feature_chunk set) on a 2-D chains x objects
    mesh. A multi-step production sampling chunk must execute, stay
    finite, and keep every carried invariant (counts, pattern counts,
    prior parts, log_lh) exactly consistent with a full recompute of the
    gathered final states. benchmarks/sharding_plan.py extracts the GSPMD
    collective plan."""
    monkeypatch.setenv("SBAYES_TPU_FEATURE_CHUNK", "16")

    from sbayes_tpu.model.model import Model
    from sbayes_tpu.model.posterior import Posterior
    from sbayes_tpu.parallel.mesh import CHAIN_AXIS, DATA_AXIS, data_mesh
    from sbayes_tpu.sampling.kernel import OperatorStats
    from sbayes_tpu.sampling.runner import SamplerRuntime
    from sbayes_tpu.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=48, n_features=32, n_states=3,
                          n_families=2, seed=13)
    config = synthetic_config(n_clusters=2, geo_prior="uniform")
    model = Model(data, config.model)
    assert model.consts.feature_chunk == 16  # the scale execution shape

    import dataclasses

    mesh = data_mesh(2, 4)  # 2 chain shards x 4 object shards = 8 devices
    on_obj = NamedSharding(mesh, P(DATA_AXIS))
    model.consts = dataclasses.replace(
        model.consts,
        features=jax.device_put(jnp.asarray(model.consts.features), on_obj),
        na=jax.device_put(jnp.asarray(model.consts.na), on_obj),
        groups=jax.device_put(jnp.asarray(model.consts.groups),
                              NamedSharding(mesh, P(None, None, DATA_AXIS))),
        hc_conf=jax.device_put(jnp.asarray(model.consts.hc_conf), on_obj),
        static_pat=jax.device_put(jnp.asarray(model.consts.static_pat), on_obj),
    )
    rt = SamplerRuntime(model, config.mcmc)

    n_chains = 2
    states = rt.init_chains(jax.random.PRNGKey(0), n_chains, shard=False)
    states = states._replace(
        clusters=jax.device_put(
            states.clusters, NamedSharding(mesh, P(CHAIN_AXIS, None, DATA_AXIS))),
        source=jax.device_put(
            states.source, NamedSharding(mesh, P(CHAIN_AXIS, DATA_AXIS))),
        weights=jax.device_put(states.weights, NamedSharding(mesh, P(CHAIN_AXIS))),
        log_lh=jax.device_put(states.log_lh, NamedSharding(mesh, P(CHAIN_AXIS))),
        log_prior=jax.device_put(states.log_prior, NamedSharding(mesh, P(CHAIN_AXIS))),
        prior_parts=jax.device_put(states.prior_parts,
                                   NamedSharding(mesh, P(CHAIN_AXIS))),
    )
    stats = jax.device_put(
        jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(n_chains)),
        NamedSharding(mesh, P(CHAIN_AXIS)))
    keys = jax.device_put(jax.random.split(jax.random.PRNGKey(1), n_chains),
                          NamedSharding(mesh, P(CHAIN_AXIS)))
    ones = jax.device_put(jnp.ones(n_chains, jnp.float32),
                          NamedSharding(mesh, P(CHAIN_AXIS)))

    with mesh:
        carry = rt.run_chunk(keys, states, stats, ones, ones, 25)
        jax.block_until_ready(carry.state)

    final = jax.device_get(carry.state)
    assert np.all(np.isfinite(final.log_lh))
    assert int(jax.device_get(carry.stats.non_finite.sum())) == 0
    total = int(jax.device_get(carry.stats.accepts.sum()
                               + carry.stats.rejects.sum()))
    assert total == 25 * n_chains

    # carried invariants vs full recompute on the gathered final states
    post = Posterior(Model(data, config.model).consts)  # unsharded oracle
    for i in range(n_chains):
        st = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[i]), carry.state)
        ref = jax.jit(post.fill_state)(st)
        np.testing.assert_allclose(np.asarray(st.cl_counts),
                                   np.asarray(ref.cl_counts), atol=1e-3)
        np.testing.assert_allclose(np.asarray(st.pat_counts),
                                   np.asarray(ref.pat_counts), atol=1e-3)
        np.testing.assert_allclose(float(st.log_lh), float(ref.log_lh),
                                   rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(np.asarray(st.prior_parts),
                                   np.asarray(ref.prior_parts),
                                   rtol=1e-4, atol=1e-2)
