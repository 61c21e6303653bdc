"""The feature-tiled membership marginal (``lax.map`` over F-tiles, the
path every model with N·F above the tiling cutover runs) against the
untiled single-pass form on the same model, state and RNG stream.

The two differ only in ``ModelConstants.feature_chunk``; everything the
marginal computes is feature-separable given the counts, so they agree to
f32 summation order."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

TOL = dict(rtol=2e-4, atol=2e-4)


def _factory(consts, T, Tp):
    from sbayes_tpu.model.posterior import Posterior
    from sbayes_tpu.sampling.conditionals import Conditionals
    from sbayes_tpu.sampling.operators import OperatorFactory

    return OperatorFactory(Conditionals(Posterior(consts), T, Tp))


@pytest.fixture(scope="module")
def setup():
    from sbayes_tpu.model.model import Model
    from sbayes_tpu.sampling.prior_sampling import generate_prior_sample
    from sbayes_tpu.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=48, n_features=8, n_states=3,
                          n_families=2, seed=5)
    config = synthetic_config(n_clusters=2, geo_prior="uniform")
    model = Model(data, config.model)
    untiled = model.consts
    assert untiled.feature_chunk is None
    tiled = dataclasses.replace(untiled, feature_chunk=4)
    fact_t = _factory(tiled, 1.2, 1.5)
    fact_u = _factory(untiled, 1.2, 1.5)
    state = generate_prior_sample(jax.random.PRNGKey(4), fact_u.cond)
    state = fact_u.cond.post.fill_state(state)
    return tiled, untiled, fact_t, fact_u, state


@pytest.mark.parametrize("heat", [False, True])
def test_pallas_marginal_matches_xla(setup, heat):
    """Tiled log-odds log_m1 - log_m0 (the quantity every gibbsish
    proposal feeds into a sigmoid) match the untiled log-odds and the
    difference of the untiled absolute marginals."""
    tiled, untiled, fact_t, fact_u, state = setup
    avail = jnp.ones(tiled.N, bool)
    counts = (state.cl_counts, state.conf_counts)

    odds = fact_t._cluster_log_odds(state, 1, avail, counts=counts,
                                    heat_effect_lh=heat)
    u_odds = fact_u._cluster_log_odds(state, 1, avail, counts=counts,
                                      heat_effect_lh=heat)
    u0, u1 = fact_u._log_marginal_with_without(state, 1, avail, counts=counts,
                                               heat_effect_lh=heat)
    np.testing.assert_allclose(np.asarray(odds), np.asarray(u_odds), **TOL)
    np.testing.assert_allclose(np.asarray(odds), np.asarray(u1 - u0), **TOL)


@pytest.mark.parametrize("heat", [False, True])
def test_pallas_marginal_both_mode_matches_xla(setup, heat):
    """Both tiled absolute marginals (the form the EPS-flooring jump
    consumes) match the untiled ones, for either heat specialization."""
    tiled, untiled, fact_t, fact_u, state = setup
    avail = jnp.ones(tiled.N, bool)
    counts = (state.cl_counts, state.conf_counts)

    t0, t1 = fact_t._log_marginal_with_without(state, 1, avail, counts=counts,
                                               heat_effect_lh=heat)
    u0, u1 = fact_u._log_marginal_with_without(state, 1, avail, counts=counts,
                                               heat_effect_lh=heat)
    np.testing.assert_allclose(np.asarray(t0), np.asarray(u0), **TOL)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(u1), **TOL)


def _assert_same_move(res_t, res_u):
    np.testing.assert_array_equal(np.asarray(res_t.state.clusters),
                                  np.asarray(res_u.state.clusters))
    np.testing.assert_allclose(float(res_t.log_q), float(res_u.log_q), **TOL)
    np.testing.assert_allclose(float(res_t.log_q_back), float(res_u.log_q_back),
                               **TOL)


def test_pallas_jump_logspace_matches_xla(setup, monkeypatch):
    """The log-space jump (sigmoid of log_jump - log_stay) tiled and
    untiled: same RNG stream -> identical proposals, matching q
    densities."""
    tiled, untiled, fact_t, fact_u, state = setup
    monkeypatch.setenv("SBAYES_TPU_JUMP_LOGSPACE", "1")
    key = jax.random.PRNGKey(78)
    _assert_same_move(fact_t.make_cluster_jump(gibbsish=True)(key, state),
                      fact_u.make_cluster_jump(gibbsish=True)(key, state))


def test_pallas_jump_matches_xla(setup, monkeypatch):
    """The EPS-flooring jump (exponentiated stay/jump marginals) tiled and
    untiled: same RNG stream -> identical proposals, matching q
    densities."""
    tiled, untiled, fact_t, fact_u, state = setup
    monkeypatch.setenv("SBAYES_TPU_JUMP_LOGSPACE", "0")
    key = jax.random.PRNGKey(77)
    _assert_same_move(fact_t.make_cluster_jump(gibbsish=True)(key, state),
                      fact_u.make_cluster_jump(gibbsish=True)(key, state))


# (ratio, heat, two_eff): the five static specializations the membership
# marginal is compiled in — gibbsish log-odds, wide raw-probs log-odds,
# both absolute marginals unheated and heated, and the two-effect
# log-space jump.
SPECIALIZATIONS = [
    (True, False, False), (True, True, False), (False, False, False),
    (False, True, False), (True, False, True),
]


@pytest.mark.parametrize("ratio,heat,two_eff", SPECIALIZATIONS)
def test_tiled_marginal_vmapped_ladder_matches_untiled(setup, monkeypatch,
                                                       ratio, heat, two_eff):
    """Each specialization, jitted and vmapped over a three-rung
    temperature ladder with TRACED per-chain temperatures (the MC3
    program's shape): tiled agrees with untiled on every rung."""
    tiled, untiled, _, _, state = setup
    monkeypatch.setenv("SBAYES_TPU_JUMP_LOGSPACE", "1")
    temps = jnp.asarray([1.0, 1.3, 1.9], jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), temps.shape[0])
    avail = jnp.ones(tiled.N, bool)
    counts = (state.cl_counts, state.conf_counts)

    def run(consts):
        def one(T, key):
            fact = _factory(consts, T, T)
            if two_eff:
                res = fact.make_cluster_jump(gibbsish=True)(key, state)
                return (res.state.clusters.astype(jnp.float32),
                        res.log_q, res.log_q_back)
            if ratio:
                return (fact._cluster_log_odds(state, 0, avail, counts=counts,
                                               heat_effect_lh=heat),)
            return fact._log_marginal_with_without(state, 0, avail, counts=counts,
                                                   heat_effect_lh=heat)

        return jax.jit(jax.vmap(one))(temps, keys)

    out_t, out_u = run(tiled), run(untiled)
    for a, b in zip(out_t, out_u):
        assert a.shape[0] == temps.shape[0]
        assert np.all(np.isfinite(np.asarray(a)))
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)
