"""Per-operator-family stationarity under the prior.

Run sample-from-prior MCMC with ONLY the cluster operator family enabled:
if any grow/shrink/wide/jump proposal asymmetry (log_q/log_q_back) were
wrong, the chain would drift away from the prior's membership marginals.
(The reference sketches per-operator stationarity tests but leaves them
commented out; this is the live version.)
"""
from pathlib import Path

import numpy as np
import pytest
from scipy.stats import binomtest

import jax

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.mark.slow
def test_cluster_operators_preserve_prior(tmp_path):
    from sbayes_tpu.cli import run_experiment
    from sbayes_tpu.config.schema import SBayesConfig
    from sbayes_tpu.data.loader import Data
    from sbayes_tpu.model.model import Model
    from sbayes_tpu.model.posterior import Posterior
    from sbayes_tpu.results.results import Results
    from sbayes_tpu.sampling.conditionals import Conditionals
    from sbayes_tpu.sampling.prior_sampling import generate_prior_samples

    settings = {
        "results": {"path": str(tmp_path)},
        "mcmc": {
            "steps": 12_000, "samples": 200, "sample_from_prior": True,
            # clusters-only schedule
            "operators": {"clusters": 1.0, "weights": 0.0, "source": 0.0},
        },
        "model": {"clusters": 2, "prior": {"geo": {"type": "uniform"}}},
    }
    run_experiment(FIXTURES / "config.yaml", "stat_clusters", custom_settings=settings,
                   resume=False, i_run=0)
    results = Results.from_csv_files(
        tmp_path / "stat_clusters" / "K2" / "clusters_K2_0.txt",
        tmp_path / "stat_clusters" / "K2" / "stats_K2_0.txt",
        burn_in=0.1,
    )

    config = SBayesConfig.from_config_file(FIXTURES / "config.yaml", custom_settings=settings)
    data = Data.from_config(config)
    model = Model(data, config.model)
    cond = Conditionals(Posterior(model.consts), 1.0, 1.0)
    ref = generate_prior_samples(jax.random.PRNGKey(5), cond, 4000)
    p_ref = np.asarray(ref.clusters).any(axis=1).mean(axis=0)

    in_any = results.clusters.any(axis=0)
    n = results.n_samples
    failures = []
    for o in range(results.n_objects):
        p = float(np.clip(p_ref[o], 1e-9, 1 - 1e-9))
        pv = binomtest(k=int(in_any[:, o].sum()), n=n, p=p).pvalue
        if pv <= 0.005:
            failures.append(f"object {o}: mcmc={in_any[:, o].mean():.3f} prior={p:.3f} p={pv:.4f}")
    assert not failures, "cluster-family stationarity violations:\n" + "\n".join(failures)


@pytest.mark.slow
def test_wide_cap_truncation_is_stationary(monkeypatch):
    """Force the wide operator's gathered-rows cap tiny (3 of 12 objects)
    so multi-object proposals routinely auto-reject: the truncation is
    symmetric (the flip count is identical forward and backward), so the
    restricted proposal must still preserve the prior's membership
    marginals (ref operators.py:1382-1568)."""
    monkeypatch.setenv("SBAYES_TPU_WIDE_ROWS_CAP", "3")

    import jax.numpy as jnp

    from sbayes_tpu.model.model import Model
    from sbayes_tpu.model.posterior import Posterior
    from sbayes_tpu.sampling.conditionals import Conditionals
    from sbayes_tpu.sampling.kernel import OperatorStats, make_chunk_runner
    from sbayes_tpu.sampling.operators import OperatorFactory, OperatorSpec
    from sbayes_tpu.sampling.prior_sampling import (
        generate_prior_sample, generate_prior_samples)
    from sbayes_tpu.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=12, n_features=4, n_states=3, n_families=2,
                          seed=11)
    config = synthetic_config(n_clusters=2, geo_prior="uniform")
    model = Model(data, config.model)
    cond = Conditionals(Posterior(model.consts, sample_from_prior=True), 1.0, 1.0)
    factory = OperatorFactory(cond)
    assert factory.wide_rows_cap == 3

    wide = factory.make_alter_cluster_wide(consider_geo=False)
    ops = [OperatorSpec("wide", 1.0, wide, "clusters")]
    run = make_chunk_runner(cond, ops)

    state = jax.jit(lambda k: generate_prior_sample(k, cond))(jax.random.PRNGKey(0))
    state = jax.jit(cond.post.fill_state)(state)

    # the cap must actually bind: a healthy share of proposals flip > 3
    # objects (OpResult.step_size carries the flip count even on reject)
    wide_j = jax.jit(wide)
    flips = np.asarray([
        float(wide_j(jax.random.PRNGKey(1000 + s), state).step_size)
        for s in range(60)
    ])
    assert (flips > 3).mean() > 0.2, (
        f"cap never binds (flip counts {flips[:20]}): test is vacuous")

    stats = OperatorStats.zeros(1)
    key = jax.random.PRNGKey(42)
    occupancy = []
    n_chunks, chunk = 250, 60
    for _ in range(n_chunks):
        key, k = jax.random.split(key)
        carry = run(k, state, stats, chunk)
        state, stats = carry.state, carry.stats
        occupancy.append(np.asarray(state.clusters).any(axis=0))
    assert int(stats.accepts.sum()) > 200, "wide operator stopped mixing under the cap"

    occ = np.asarray(occupancy[n_chunks // 5:])
    ref = generate_prior_samples(jax.random.PRNGKey(5), cond, 4000)
    p_ref = np.asarray(ref.clusters).any(axis=1).mean(axis=0)
    n = occ.shape[0]
    failures = []
    for o in range(occ.shape[1]):
        p = float(np.clip(p_ref[o], 1e-9, 1 - 1e-9))
        pv = binomtest(k=int(occ[:, o].sum()), n=n, p=p).pvalue
        if pv <= 0.005:
            failures.append(
                f"object {o}: mcmc={occ[:, o].mean():.3f} prior={p:.3f} p={pv:.4f}")
    assert not failures, (
        "wide-cap stationarity violations:\n" + "\n".join(failures))
