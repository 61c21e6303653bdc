"""Detailed-balance & stationarity checks for individual operators.

Three layers of evidence:

1. A deterministic reverse-density identity for the ClusterJump source
   resample: the reported ``log_q_back`` must equal the forward proposal
   density of the explicitly-constructed reverse jump (reference
   gibbs_sample_source_jump, operators.py:1775-1827). This catches the
   round-1 bug where the backward likelihood was computed from the NEW
   clusters with the *target* cluster instead of the OLD clusters with
   the *source* cluster.

2. Prior-invariance per operator at N=20, K=2: start 512 chains at exact
   prior samples, apply ONE operator repeatedly in sample-from-prior mode
   and verify the membership marginals are unchanged (start-at-
   stationarity Geweke-style check — needs no ergodicity, so it works
   for size-preserving operators like the jump). Exercises the q-ratio
   bookkeeping (standstill corrections, boundary terms) with real power.

3. A two-sampler consistency test with the LIKELIHOOD live: a jump-heavy
   schedule and a no-jump schedule must agree on membership marginals
   (Welch t-test across independent chains).
"""
from __future__ import annotations

import numpy as np
import pytest
from scipy.stats import binomtest, ttest_ind

import jax
import jax.numpy as jnp
from jax import lax


def _build(n_objects=20, n_features=6, n_states=3, n_clusters=2, seed=3,
           sample_from_prior=False):
    from sbayes_tpu.model.model import Model
    from sbayes_tpu.model.posterior import Posterior
    from sbayes_tpu.sampling.conditionals import Conditionals
    from sbayes_tpu.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=n_objects, n_features=n_features,
                          n_states=n_states, n_families=2, seed=seed)
    config = synthetic_config(n_clusters=n_clusters)
    model = Model(data, config.model)
    cond = Conditionals(Posterior(model.consts, sample_from_prior=sample_from_prior),
                        1.0, 1.0, sample_from_prior=sample_from_prior)
    return cond, config


def _prior_state_with_valid_jump(cond, seed=0):
    """A prior sample where cluster 0 can give an object to cluster 1."""
    from sbayes_tpu.sampling.prior_sampling import generate_prior_sample

    c = cond.consts
    for i in range(100):
        state = jax.jit(lambda k: generate_prior_sample(k, cond))(jax.random.PRNGKey(seed + i))
        sizes = np.asarray(state.clusters.sum(-1))
        if sizes[0] > c.min_size + 1 and sizes[1] < c.max_size - 1:
            return state
    raise RuntimeError("no valid prior state found")


def test_jump_log_q_back_is_reverse_forward_density():
    """rs.log_q_back of the jump source-resample == forward density of the
    explicit reverse move (computed independently from the post-move state)."""
    from sbayes_tpu.model.math import normalize, normalize_weights

    cond, _ = _build()
    state = _prior_state_with_valid_jump(cond)
    i_src, i_tgt = 0, 1
    obj = int(np.flatnonzero(np.asarray(state.clusters[i_src]))[0])
    N = cond.consts.N

    clusters_new = state.clusters.at[i_src, obj].set(False).at[i_tgt, obj].set(True)
    subset = jnp.zeros(N, bool).at[obj].set(True)
    conf_counts = cond.post.feature_counts(state.clusters, state.source)[1]

    rs = cond.gibbs_resample_source_jump(
        jax.random.PRNGKey(42), state, clusters_new, subset,
        i_cluster_new=i_tgt, i_cluster_old=i_src, conf_counts_full=conf_counts,
    )
    state_new = state._replace(clusters=clusters_new, source=rs.source)

    # Reverse move: from state_new, jump `obj` from i_tgt back to i_src and
    # resample its source rows back to their OLD values. Its forward density
    # is built from the reverse move's own ingredients: the reverse NEW
    # clusters (= the original ones), the post-move source array, and the
    # reverse target cluster i_src.
    conf_counts_new = cond.post.feature_counts(clusters_new, state_new.source)[1]
    lh_rev = cond.component_likelihood_given_unchanged(
        state.clusters, state_new.source, subset, i_src,
        conf_counts_full=conf_counts_new,
    )
    w_rev = normalize_weights(state_new.weights,
                              cond.post.has_components(state.clusters))
    p_rev = normalize(w_rev * lh_rev, axis=-1)
    log_q_rev = cond._masked_source_logp(p_rev, state.source, subset)

    assert np.isfinite(float(rs.log_q_back))
    np.testing.assert_allclose(float(rs.log_q_back), float(log_q_rev), rtol=1e-4)

    # And symmetrically: the reverse move's backward density is our forward
    # density (same lh pair, swapped roles).
    lh_fwd = cond.component_likelihood_given_unchanged(
        clusters_new, state_new.source, subset, i_tgt,
        conf_counts_full=conf_counts_new,
    )
    p_rev_back = normalize(w_rev * lh_fwd, axis=-1)
    log_q_rev_back = cond._masked_source_logp(p_rev_back, state_new.source, subset)
    np.testing.assert_allclose(float(rs.log_q), float(log_q_rev_back), rtol=1e-4)


@pytest.mark.slow
@pytest.mark.parametrize("op_name", [
    "gibbsish_sample_cluster_wide_geo",
    "cluster_jump_gibbsish",
    "cluster_gibbsish_geo",
    "cluster_naive_n2_geo",
    "gibbs_sample_weights",
])
def test_single_operator_preserves_prior(op_name):
    """Start at exact prior samples, apply ONE operator 120 times per chain
    in sample-from-prior mode; membership marginals must stay at the prior."""
    from sbayes_tpu.sampling.kernel import Carry, OperatorStats, make_step_fn
    from sbayes_tpu.sampling.operators import get_operator_schedule
    from sbayes_tpu.sampling.prior_sampling import generate_prior_samples

    cond, config = _build(sample_from_prior=True)
    ops = [o for o in get_operator_schedule(cond, config.mcmc.operators)
           if o.name == op_name]
    assert ops, f"operator {op_name} not in schedule"
    ops = [ops[0]._replace(weight=1.0)]
    step = make_step_fn(cond, ops)

    n_chains, n_steps = 512, 120
    inits = generate_prior_samples(jax.random.PRNGKey(11), cond, n_chains)
    inits = jax.vmap(cond.post.fill_state)(inits)
    keys = jax.random.split(jax.random.PRNGKey(12), n_chains)

    def run_one(key, state):
        def body(c, _):
            return step(c), None
        carry, _ = lax.scan(body, Carry(key, state, OperatorStats.zeros(len(ops))),
                            length=n_steps)
        return carry.state.clusters, carry.state.weights, carry.stats

    clusters, weights, stats = jax.jit(jax.vmap(run_one))(keys, inits)
    clusters = np.asarray(clusters)  # (n_chains, K, N)

    # some moves must actually be accepted, otherwise the test is vacuous
    accepts = int(np.asarray(stats.accepts).sum())
    assert accepts > n_chains, f"{op_name}: only {accepts} accepts — vacuous test"

    # reference prior marginals from a large fresh prior sample
    ref = generate_prior_samples(jax.random.PRNGKey(13), cond, 30_000)
    p_ref = np.asarray(ref.clusters).any(axis=1).mean(axis=0)  # (N,)

    in_any = clusters.any(axis=1)  # (n_chains, N)
    # Per-object marginals are correlated through the size bounds, so a
    # single borderline p-value among 20 objects is expected noise
    # (verified over seeds: min-p fluctuates 1e-3..4e-2 with no systematic
    # direction). A real balance bug shifts MANY objects the same way —
    # flag an extreme single deviation, a cluster of deviations, or a
    # pooled shift.
    pvs, details = [], []
    for o in range(in_any.shape[1]):
        p = float(np.clip(p_ref[o], 1e-9, 1 - 1e-9))
        pv = binomtest(k=int(in_any[:, o].sum()), n=n_chains, p=p).pvalue
        pvs.append(pv)
        details.append(f"object {o}: final={in_any[:, o].mean():.3f} prior={p:.3f} p={pv:.5f}")
    pooled_dev = abs(in_any.mean() - p_ref.mean())
    n_low = sum(pv < 0.005 for pv in pvs)
    assert min(pvs) > 1e-4 and n_low <= 3 and pooled_dev < 0.02, (
        f"{op_name} drifts off the prior (min_p={min(pvs):.2e}, n_low={n_low}, "
        f"pooled_dev={pooled_dev:.4f}):\n" + "\n".join(details)
    )

    if op_name == "gibbs_sample_weights":
        w_ref = np.asarray(ref.weights).mean(axis=0)
        w_mc = np.asarray(weights).mean(axis=0)
        se = np.asarray(ref.weights).std(axis=0) / np.sqrt(len(in_any))
        assert np.all(np.abs(w_mc - w_ref) < 6 * se + 0.03), (
            f"weights marginals drift:\n{w_mc}\nvs\n{w_ref}"
        )


@pytest.mark.slow
@pytest.mark.parametrize("jump_logspace", ["0", "1"])
def test_jump_sampler_consistency_with_likelihood(jump_logspace, monkeypatch):
    """Jump-heavy vs no-jump schedules must sample the same posterior
    (likelihood LIVE — this is the configuration where the round-1
    backward-proposal bug biased every K>1 run). Parametrized over both
    jump-proposal numerics (reference EPS-flooring and the scale-default
    log-space form): either proposal must leave the posterior invariant."""
    from sbayes_tpu.sampling.kernel import Carry, OperatorStats, make_step_fn
    from sbayes_tpu.sampling.operators import get_operator_schedule
    from sbayes_tpu.sampling.initializer import Initializer

    monkeypatch.setenv("SBAYES_TPU_JUMP_LOGSPACE", jump_logspace)
    cond, config = _build()
    base = get_operator_schedule(cond, config.mcmc.operators)

    def reweight(jump_w):
        ops = []
        for o in base:
            if o.name == "cluster_jump_gibbsish":
                if jump_w == 0.0:
                    continue
                ops.append(o._replace(weight=jump_w))
            else:
                ops.append(o)
        total = sum(o.weight for o in ops)
        return [o._replace(weight=o.weight / total) for o in ops]

    n_chains, n_steps, burn = 32, 3000, 1500
    init = Initializer(cond, initial_size=5, attempts=1, n_em_steps=3)
    init_keys = jax.random.split(jax.random.PRNGKey(21), n_chains)
    states = jax.jit(jax.vmap(init.generate_sample))(init_keys)
    states = jax.vmap(cond.post.fill_state)(states)

    def run_schedule(ops, seed):
        step = make_step_fn(cond, ops)

        def run_one(key, state):
            def body(c, _):
                c2 = step(c)
                return c2, c2.state.clusters.any(0)
            carry, trace = lax.scan(
                body, Carry(key, state, OperatorStats.zeros(len(ops))), length=n_steps
            )
            # per-chain mean membership over the post-burn-in window
            return trace[burn:].mean(0), carry.stats
        keys = jax.random.split(jax.random.PRNGKey(seed), n_chains)
        means, stats = jax.jit(jax.vmap(run_one))(keys, states)
        return np.asarray(means), stats

    means_nojump, _ = run_schedule(reweight(0.0), seed=31)
    means_jumpy, stats_j = run_schedule(reweight(1.5), seed=32)

    # the jump operator must actually fire and be accepted sometimes
    i_jump = [o.name for o in reweight(1.5)].index("cluster_jump_gibbsish")
    jump_accepts = int(np.asarray(stats_j.accepts)[:, i_jump].sum())
    assert jump_accepts > n_chains, f"only {jump_accepts} accepted jumps — vacuous"

    failures = []
    for o in range(means_nojump.shape[1]):
        pv = ttest_ind(means_nojump[:, o], means_jumpy[:, o], equal_var=False).pvalue
        if pv <= 0.001:
            failures.append(
                f"object {o}: nojump={means_nojump[:, o].mean():.3f} "
                f"jumpy={means_jumpy[:, o].mean():.3f} p={pv:.5f}"
            )
    assert not failures, (
        "jump-heavy sampler disagrees with no-jump sampler:\n" + "\n".join(failures)
    )
