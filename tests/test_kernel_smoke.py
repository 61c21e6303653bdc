"""Smoke test: build the toy model, initialize, run MCMC steps jitted."""
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp


pytestmark = pytest.mark.smoke

TOY_CONFIG = Path(__file__).parent / "fixtures" / "config.yaml"


@pytest.fixture(scope="module")
def toy_model():
    from sbayes_tpu.config.schema import SBayesConfig
    from sbayes_tpu.data.loader import Data
    from sbayes_tpu.model.model import Model

    config = SBayesConfig.from_config_file(TOY_CONFIG)
    data = Data.from_config(config)
    model = Model(data, config.model)
    return config, data, model


def test_model_shapes(toy_model):
    config, data, model = toy_model
    c = model.consts
    assert c.N == 5 and c.F == 2 and c.K == 1
    assert c.C == 3  # cluster + universal + family
    assert tuple(c.conf_names) == ("universal", "family")
    # family prior: famA has dirichlet params (+1 initial counts)
    i_fam = c.conf_names.index("family")
    i_fam1 = c.group_names["family"].index("famA")
    # F1: A=8, B=2 -> +1 -> 9, 3
    np.testing.assert_allclose(c.conc_conf[i_fam, i_fam1, 0, :2], [9.0, 3.0])


def test_initializer_and_posterior(toy_model):
    config, data, model = toy_model
    from sbayes_tpu.model.posterior import Posterior
    from sbayes_tpu.sampling.conditionals import Conditionals
    from sbayes_tpu.sampling.initializer import Initializer
    from sbayes_tpu.sampling.kernel import init_state_posterior

    cond = Conditionals(model.posterior)
    init = Initializer(cond, initial_size=1, attempts=2, n_em_steps=10)
    state = init.generate_sample(jax.random.PRNGKey(0))
    state = init_state_posterior(cond, state)

    assert np.isfinite(float(state.log_lh))
    assert np.isfinite(float(state.log_prior))
    # source is one-hot on valid observations, zero on NA
    src = np.asarray(state.source)
    na = np.asarray(model.consts.na)
    assert np.all(src[na].sum(-1) == 0)
    assert np.all(src[~na].sum(-1) == 1)
    # cluster size within bounds
    sizes = np.asarray(state.clusters).sum(-1)
    assert np.all(sizes >= model.consts.min_size)
    assert np.all(sizes <= model.consts.max_size)


def test_mcmc_chunk_runs_and_stats(toy_model):
    config, data, model = toy_model
    from sbayes_tpu.sampling.conditionals import Conditionals
    from sbayes_tpu.sampling.initializer import Initializer
    from sbayes_tpu.sampling.kernel import OperatorStats, init_state_posterior, make_chunk_runner
    from sbayes_tpu.sampling.operators import get_operator_schedule

    cond = Conditionals(model.posterior)
    ops = get_operator_schedule(cond, config.mcmc.operators)
    assert abs(sum(o.weight for o in ops) - 1.0) < 1e-6
    # K=1 -> jump operator dropped
    assert all(o.name != "cluster_jump_gibbsish" for o in ops)

    init = Initializer(cond, initial_size=1, attempts=1, n_em_steps=5)
    state = init_state_posterior(cond, init.generate_sample(jax.random.PRNGKey(1)))

    run = make_chunk_runner(cond, ops)
    carry = run(jax.random.PRNGKey(2), state, OperatorStats.zeros(len(ops)), n_steps=50)

    final = carry.state
    stats = carry.stats
    assert int(stats.accepts.sum() + stats.rejects.sum()) == 50
    assert int(stats.non_finite) == 0
    assert np.isfinite(float(final.log_lh))
    # posterior bookkeeping consistent with recompute
    lh_direct = model.likelihood(final)
    np.testing.assert_allclose(float(final.log_lh), lh_direct, rtol=1e-4, atol=1e-3)
    pr_direct = model.prior(final)
    np.testing.assert_allclose(float(final.log_prior), pr_direct, rtol=1e-4, atol=1e-3)
    # invariants: NA sources stay zero, valid sources stay one-hot
    src = np.asarray(final.source)
    na = np.asarray(model.consts.na)
    assert np.all(src[na].sum(-1) == 0)
    assert np.all(src[~na].sum(-1) == 1)
