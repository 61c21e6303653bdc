"""Host-level MCMC orchestration: warm-up, sampling loop, MC3, logging.

Counterpart of the reference's ``MCMCSetup`` + ``MCMC.generate_samples``
(sbayes/mcmc_setup.py, sbayes/sampling/mcmc.py), redesigned for an
accelerator:

* ALL chains (warm-up races, MC3 temperature ladders, plain ensembles) are
  one vmapped axis of a single compiled program. Per-chain temperatures are
  traced inputs, so an MC3 ladder costs one compilation.
* The hot loop runs on device in chunks of ``steps_per_sample`` steps; the
  host only syncs at sample-logging boundaries (1000ish times per run).
* MC3 runs FULLY on device: subchains and swap proposals are fused into
  one jitted scan (swaps permute the chain axis in-scan); the host syncs
  only at sample-logging intervals.
"""
from __future__ import annotations

import math
import pickle
import time
from datetime import timedelta
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sbayes_tpu.data.loader import Data
from sbayes_tpu.model.model import Model
from sbayes_tpu.model.posterior import Posterior
from sbayes_tpu.model.math import normalize_weights
from sbayes_tpu.results.loggers import (
    ClustersLogger,
    LikelihoodLogger,
    OperatorStatsLogger,
    OperatorView,
    ParametersCSVLogger,
    ResultsLogger,
    SampleRecord,
    StateDumper,
)
from sbayes_tpu.sampling.conditionals import Conditionals
from sbayes_tpu.sampling.initializer import Initializer
from sbayes_tpu.sampling.kernel import Carry, OperatorStats, make_mh_apply_fn
from sbayes_tpu.sampling.operators import get_operator_schedule
from sbayes_tpu.sampling.state import ChainState


from functools import partial


def _all_unit_temps(T, Tp) -> bool:
    """Host-side check that every chain temperature is exactly 1 (plain,
    non-MC3 ensembles). Used as a STATIC jit argument so the compiled
    program folds all ``x ** (1/T)`` heating away and the fused marginal
    can use the noheat Pallas variant. Tiny transfer (n_chains floats)."""
    import numpy as _np

    return bool(_np.all(_np.asarray(T) == 1.0) and _np.all(_np.asarray(Tp) == 1.0))


@partial(jax.jit, static_argnums=(1,))
def _fill_state_jit(consts, sample_from_prior, state):
    """fill_state with consts as a traced argument (no HLO literals)."""
    return Posterior(consts, sample_from_prior).fill_state(state)


@partial(jax.jit, static_argnums=(1,))
def _refresh_states_jit(consts, sample_from_prior, states):
    """Vmapped exact recompute of every carried invariant (log_lh,
    prior_parts, counts, geo aggregates) for a chain batch. The step
    kernel feeds EXACT deltas into the MH ratio, but the stored f32
    running totals accumulate one rounding (~ulp(|value|)) per accepted
    move; a periodic refresh keeps MC3 swap ratios, the warm-up race and
    the screen log drift-free over million-step runs."""
    post = Posterior(consts, sample_from_prior)
    return jax.vmap(post.fill_state)(states)


# Chunk cadence of the exact carried-invariant refresh in the sampling
# loops (one full posterior recompute per this many chunks: amortized
# to noise, while bounding f32 drift to a few hundred accepted moves).
REFRESH_EVERY_CHUNKS = 64


class SamplerRuntime:
    """Compiled, vmapped sampling programs for one model."""

    def __init__(self, model: Model, mcmc_config, sample_from_prior: bool = False):
        self.model = model
        self.consts = model.consts
        self.mcmc_config = mcmc_config
        self.sample_from_prior = sample_from_prior
        self.op_cfg = mcmc_config.operators
        self.p_grow = 0.5

        # Operator names/parameters for stats logging (weights from a
        # representative cold-chain schedule).
        cold = Conditionals(Posterior(self.consts, sample_from_prior), 1.0, 1.0)
        self._op_specs_cold = get_operator_schedule(cold, self.op_cfg, self.p_grow)
        self.op_names = [o.name for o in self._op_specs_cold]
        self.n_ops = len(self.op_names)

        self._run_chunk = self._build_run_chunk()
        self._run_chunk_trace = self._build_run_chunk_trace()
        self._run_mc3_chunk = self._build_run_mc3_chunk()
        self._init_chains = self._build_init_chains()
        self._sample_view = self._build_sample_view()
        self._cluster_contribution = self._build_cluster_contribution()
        self._branch_chunks: dict = {}  # (op_idx, unit_temps) -> jitted single-branch chunk

    # -------------------- compiled programs --------------------

    def _build_run_chunk(self):
        """The ensemble hot loop: scan over steps, vmap over chains INSIDE
        the step, with ONE shared operator draw per step.

        Sharing the operator index across the ensemble makes ``lax.switch``
        execute exactly one operator branch per step (a per-chain draw
        under vmap would execute every branch for every chain — measured
        ~4x slower). The draw is state-independent, so each chain remains
        a valid sampler of its posterior; see kernel.make_mh_apply_fn.
        """
        sfp = self.sample_from_prior
        op_cfg = self.op_cfg
        p_grow = self.p_grow
        op_logits = np.log(np.asarray([o.weight for o in self._op_specs_cold], np.float32))

        def run(consts, keys, states, stats, T, Tp, n_steps, unit_temps):
            # keys: (n_chains,) per-chain PRNG keys. The shared per-step
            # operator draws derive from a master key folded out of the
            # chain keys (stable under sharding; depends only on keys[0]).
            # ``consts`` is a traced argument: its arrays lower to
            # executable parameters, not embedded HLO literals.
            # ``unit_temps`` (static): the host saw every temperature == 1
            # (plain, non-MC3 ensembles), so build the operators with
            # STATIC Python-float temps — XLA folds all ``x ** (1/T)``
            # heating away and the marginal picks the cheap noheat Pallas
            # variant (operators.py:_marginal_impl).
            master_key = jax.random.fold_in(keys[0], 0x5ba135)

            def apply_one(op_idx, key, state, T_c, Tp_c):
                if unit_temps:
                    T_c, Tp_c = 1.0, 1.0
                cond = Conditionals(Posterior(consts, sfp), T_c, Tp_c)
                ops = get_operator_schedule(cond, op_cfg, p_grow)
                apply = make_mh_apply_fn(cond, ops)
                return apply(op_idx, key, state)

            vapply = jax.vmap(apply_one, in_axes=(None, 0, 0, 0, 0))

            def body(carry, step_key):
                keys, states, stats = carry
                op_idx = jax.random.categorical(step_key, jnp.asarray(op_logits))
                split = jax.vmap(jax.random.split)(keys)
                keys, k_apply = split[:, 0], split[:, 1]
                new_states, accept, step_size, nf = vapply(op_idx, k_apply, states, T, Tp)
                stats = OperatorStats(
                    accepts=stats.accepts.at[:, op_idx].add(accept.astype(jnp.int32)),
                    rejects=stats.rejects.at[:, op_idx].add((~accept).astype(jnp.int32)),
                    step_size_sum=stats.step_size_sum.at[:, op_idx].add(
                        jnp.where(accept, step_size, 0.0)
                    ),
                    non_finite=stats.non_finite + nf.astype(jnp.int32),
                )
                return (keys, new_states, stats), None

            step_keys = jax.random.split(master_key, n_steps)
            (keys, states, stats), _ = jax.lax.scan(body, (keys, states, stats), step_keys)
            return Carry(keys, states, stats)

        jitted = jax.jit(run, static_argnums=(6, 7), donate_argnums=(2, 3))

        def call(keys, states, stats, T, Tp, n_steps):
            return jitted(self.consts, keys, states, stats, T, Tp, n_steps,
                          _all_unit_temps(T, Tp))

        call._jitted = jitted  # AOT lowering access (sharding_plan.py, chip_smoke.py)
        return call

    def _build_run_chunk_trace(self):
        """Like the ensemble chunk runner, but additionally returns the
        per-step log-posterior trace (n_steps, n_chains) — used for ESS
        measurement (ESS/sec is the headline benchmark metric)."""
        sfp = self.sample_from_prior
        op_cfg = self.op_cfg
        p_grow = self.p_grow
        op_logits = np.log(np.asarray([o.weight for o in self._op_specs_cold], np.float32))

        def run(consts, keys, states, stats, T, Tp, n_steps, unit_temps):
            master_key = jax.random.fold_in(keys[0], 0x5ba135)

            def apply_one(op_idx, key, state, T_c, Tp_c):
                if unit_temps:
                    T_c, Tp_c = 1.0, 1.0
                cond = Conditionals(Posterior(consts, sfp), T_c, Tp_c)
                ops = get_operator_schedule(cond, op_cfg, p_grow)
                return make_mh_apply_fn(cond, ops)(op_idx, key, state)

            vapply = jax.vmap(apply_one, in_axes=(None, 0, 0, 0, 0))

            def body(carry, step_key):
                keys, states, stats = carry
                op_idx = jax.random.categorical(step_key, jnp.asarray(op_logits))
                split = jax.vmap(jax.random.split)(keys)
                keys, k_apply = split[:, 0], split[:, 1]
                new_states, accept, step_size, nf = vapply(op_idx, k_apply, states, T, Tp)
                stats = OperatorStats(
                    accepts=stats.accepts.at[:, op_idx].add(accept.astype(jnp.int32)),
                    rejects=stats.rejects.at[:, op_idx].add((~accept).astype(jnp.int32)),
                    step_size_sum=stats.step_size_sum.at[:, op_idx].add(
                        jnp.where(accept, step_size, 0.0)
                    ),
                    non_finite=stats.non_finite + nf.astype(jnp.int32),
                )
                trace = new_states.log_lh + new_states.log_prior
                return (keys, new_states, stats), trace

            step_keys = jax.random.split(master_key, n_steps)
            (keys, states, stats), trace = jax.lax.scan(body, (keys, states, stats), step_keys)
            return Carry(keys, states, stats), trace

        jitted = jax.jit(run, static_argnums=(6, 7), donate_argnums=(2, 3))

        def call(keys, states, stats, T, Tp, n_steps):
            return jitted(self.consts, keys, states, stats, T, Tp, n_steps,
                          _all_unit_temps(T, Tp))

        return call

    def _build_run_mc3_chunk(self):
        """Fully fused MC3: subchains AND swap proposals inside one device
        program (SURVEY §2.3 P2: swaps become a permutation of the chain
        axis inside the jitted scan — no host round trips between swaps).

        Signature: run(keys, states, stats, T, Tp, swap_key, swap_matrix,
                       step0, n_steps, swap_interval, attempts, only_adjacent)
        ``step0`` is the TRACED global step offset; a swap phase fires
        after every step where ``(step0 + i + 1) % swap_interval == 0``, so
        swap cadence is exact regardless of the (host-chosen) chunk length:
        sample logging and swapping are fully decoupled. The last four args
        are static. Swap MH semantics mirror the reference
        (mcmc_setup.py:365-418): `attempts` distinct chain pairs proposed
        sequentially per swap phase, accepted with probability
        exp(-(Δlog_prior·Δ(1/Tp) + Δlog_lh·Δ(1/T))).
        """
        sfp = self.sample_from_prior
        op_cfg = self.op_cfg
        p_grow = self.p_grow
        op_logits = np.log(np.asarray([o.weight for o in self._op_specs_cold], np.float32))

        def run(consts, keys, states, stats, T, Tp, swap_key, swap_matrix,
                step0, n_steps, swap_interval, attempts, only_adjacent):
            n_chains = T.shape[0]
            if only_adjacent:
                pairs = [(i, i + 1) for i in range(n_chains - 1)]
            else:
                pairs = [(i, j) for i in range(n_chains - 1) for j in range(i + 1, n_chains)]
            pair_a = jnp.asarray([p[0] for p in pairs], jnp.int32)
            pair_b = jnp.asarray([p[1] for p in pairs], jnp.int32)
            n_pairs = len(pairs)
            attempts = min(attempts, n_pairs)

            def apply_one(op_idx, key, state, T_c, Tp_c):
                cond = Conditionals(Posterior(consts, sfp), T_c, Tp_c)
                ops = get_operator_schedule(cond, op_cfg, p_grow)
                return make_mh_apply_fn(cond, ops)(op_idx, key, state)

            vapply = jax.vmap(apply_one, in_axes=(None, 0, 0, 0, 0))

            def swap_phase(states, swap_matrix, n_acc, n_att, phase_key):
                """Sequential swap proposals over random distinct pairs."""
                k_pairs, k_u = jax.random.split(phase_key)
                order = jax.random.permutation(k_pairs, n_pairs)[:attempts]
                us = jnp.log(jax.random.uniform(k_u, (attempts,)))

                def do_swap(t, sc):
                    perm, ll, lp, swap_matrix, n_acc = sc
                    idx = order[t]
                    a, b = pair_a[idx], pair_b[idx]
                    prior_exp_diff = 1.0 / Tp[a] - 1.0 / Tp[b]
                    lh_exp_diff = 1.0 / T[a] - 1.0 / T[b]
                    mh = -((lp[a] - lp[b]) * prior_exp_diff + (ll[a] - ll[b]) * lh_exp_diff)
                    accept = us[t] < mh
                    pa, pb = perm[a], perm[b]
                    perm = perm.at[a].set(jnp.where(accept, pb, pa))
                    perm = perm.at[b].set(jnp.where(accept, pa, pb))
                    la, lb = ll[a], ll[b]
                    ll = ll.at[a].set(jnp.where(accept, lb, la)).at[b].set(jnp.where(accept, la, lb))
                    qa, qb = lp[a], lp[b]
                    lp = lp.at[a].set(jnp.where(accept, qb, qa)).at[b].set(jnp.where(accept, qa, qb))
                    # (2, n, n): layer 0 accepts, layer 1 attempts — the
                    # per-pair ATTEMPT counts turn the accept matrix into
                    # per-rung acceptance rates for temperature_diff tuning
                    swap_matrix = (swap_matrix.at[0, a, b].add(accept.astype(jnp.int32))
                                   .at[1, a, b].add(1))
                    return perm, ll, lp, swap_matrix, n_acc + accept.astype(jnp.int32)

                perm0 = jnp.arange(n_chains)
                perm, _ll, _lp, swap_matrix, n_acc = jax.lax.fori_loop(
                    0, attempts, do_swap,
                    (perm0, states.log_lh, states.log_prior, swap_matrix, n_acc),
                )
                states = jax.tree.map(lambda x: x[perm], states)
                return states, swap_matrix, n_acc, n_att + attempts

            def body(carry, inp):
                step_key, i = inp
                keys, states, stats, swap_matrix, n_acc, n_att = carry
                k_op, k_swap = jax.random.split(step_key)
                op_idx = jax.random.categorical(k_op, jnp.asarray(op_logits))
                split = jax.vmap(jax.random.split)(keys)
                keys, k_apply = split[:, 0], split[:, 1]
                new_states, accept, step_size, nf = vapply(op_idx, k_apply, states, T, Tp)
                stats = OperatorStats(
                    accepts=stats.accepts.at[:, op_idx].add(accept.astype(jnp.int32)),
                    rejects=stats.rejects.at[:, op_idx].add((~accept).astype(jnp.int32)),
                    step_size_sum=stats.step_size_sum.at[:, op_idx].add(
                        jnp.where(accept, step_size, 0.0)
                    ),
                    non_finite=stats.non_finite + nf.astype(jnp.int32),
                )
                do_swap = ((step0 + i + 1) % swap_interval) == 0
                new_states, swap_matrix, n_acc, n_att = jax.lax.cond(
                    do_swap,
                    lambda s, m, a, t: swap_phase(s, m, a, t, k_swap),
                    lambda s, m, a, t: (s, m, a, t),
                    new_states, swap_matrix, n_acc, n_att,
                )
                return (keys, new_states, stats, swap_matrix, n_acc, n_att), None

            step_keys = jax.random.split(swap_key, n_steps)
            (keys, states, stats, swap_matrix, n_acc, n_att), _ = jax.lax.scan(
                body,
                (keys, states, stats, swap_matrix, jnp.int32(0), jnp.int32(0)),
                (step_keys, jnp.arange(n_steps, dtype=jnp.int32)),
            )
            return keys, states, stats, swap_matrix, n_acc, n_att

        jitted = jax.jit(run, static_argnums=(9, 10, 11, 12), donate_argnums=(2, 3, 7))

        def call(*args):
            return jitted(self.consts, *args)

        call._jitted = jitted  # AOT lowering access (chip_smoke.py)
        return call

    def _build_init_chains(self):
        """Initializer + posterior bookkeeping, vmapped over chains."""
        sfp = self.sample_from_prior
        init_cfg = self.mcmc_config.initialization

        def init_all(consts, keys):
            def init_one(key):
                cond = Conditionals(Posterior(consts, sfp), 1.0, 1.0)
                initializer = Initializer(
                    cond,
                    initial_size=init_cfg.objects_per_cluster,
                    attempts=init_cfg.attempts,
                    initial_cluster_steps=init_cfg.initial_cluster_steps,
                    n_em_steps=init_cfg.em_steps,
                    method=getattr(init_cfg, "method", "em"),
                )
                state = initializer.generate_sample(key)
                return cond.post.fill_state(state)

            return jax.vmap(init_one)(keys)

        jitted = jax.jit(init_all)
        return lambda keys: jitted(self.consts, keys)

    def _build_sample_view(self):
        """Per-sample device computation for the loggers: prior parts,
        sufficient-statistic counts and exact per-observation likelihood."""
        sfp = self.sample_from_prior

        def view(consts, state):
            cond = Conditionals(Posterior(consts, sfp), 1.0, 1.0)
            parts = cond.post.parts(state)
            cl_counts, conf_counts = cond.post.feature_counts(state.clusters, state.source)
            lh_exact = cond.likelihood_per_component_exact(state.clusters, state.source)
            w = normalize_weights(state.weights, cond.post.has_components(state.clusters))
            obs_lh = (w * lh_exact).sum(-1)
            return parts, cl_counts, conf_counts, obs_lh

        jitted = jax.jit(view)
        return lambda state: jitted(self.consts, state)

    def _build_cluster_contribution(self):
        """(K,) marginal log-lh + log-prior of each cluster in isolation.

        Capability parity with the reference's ``log_contribution_per_cluster``
        columns (loggers.py:238-250): the reference re-scores a sample copy
        holding only cluster i with ``source=None``. Here, with static
        shapes: zero out the other cluster rows and use the source-
        marginalized mixture likelihood with posterior-mean effects; the
        per-cluster prior is the single-cluster size prior + that cluster's
        geo prior + the weights prior (the reference's source prior is
        undefined at source=None and is excluded)."""
        sfp = self.sample_from_prior

        def contrib(consts, state):
            from jax.scipy.special import gammaln

            cond = Conditionals(Posterior(consts, sfp), 1.0, 1.0)
            post = cond.post
            na = jnp.asarray(consts.na)
            K = consts.K
            cl_counts, conf_counts = post.feature_counts(state.clusters, state.source)

            def one(i):
                only_i = jnp.arange(K) == i
                cl = state.clusters & only_i[:, None]
                counts_i = cl_counts * only_i[:, None, None]
                lh_pc = cond.likelihood_per_component(cl, counts_i, conf_counts)
                w = normalize_weights(state.weights, post.has_components(cl))
                obs = (w * lh_pc).sum(-1)
                lh_i = jnp.where(~na, jnp.log(jnp.maximum(obs, 1e-35)), 0.0).sum()

                size = cl[i].sum().astype(jnp.float32)
                n = jnp.float32(consts.N)
                if consts.size_prior_type == "uniform_size":
                    size_p = -(gammaln(n + 1.0) - gammaln(size + 1.0) - gammaln(n - size + 1.0))
                elif consts.size_prior_type == "quadratic":
                    size_p = -jnp.log(size**2)
                else:  # uniform_area
                    size_p = jnp.float32(0.0)
                geo_i = post.geo_prior_per_cluster(cl)[i]
                prior_i = size_p + geo_i + post.weights_prior(state.weights)
                return lh_i, prior_i

            return jax.vmap(one)(jnp.arange(K))

        jitted = jax.jit(contrib)
        return lambda state: jitted(self.consts, state)

    # -------------------- host helpers --------------------

    def run_chunk(self, keys, states, stats, temps, prior_temps, n_steps: int) -> Carry:
        return self._run_chunk(keys, states, stats, jnp.asarray(temps, jnp.float32),
                               jnp.asarray(prior_temps, jnp.float32), n_steps)

    def shard_ensemble(self, n_chains: int, *trees, logger=None):
        """Production multi-device layout: split the chain axis of the given
        chain-batched PyTrees over all available devices (the reference's
        distributed layer lives in its production path — cli.py:104-109
        run pool, mcmc_setup.py:274-282 MC3 processes — so ours does too).
        No-op on a single device; kill switch
        SBAYES_TPU_SHARDING=off. Donated buffers keep their sharding, so
        one placement before the sampling loop is enough."""
        from sbayes_tpu.parallel.mesh import auto_chain_mesh, shard_chain_batch

        mesh = auto_chain_mesh(n_chains)
        if mesh is None:
            return trees if len(trees) != 1 else trees[0]
        n_dev = int(mesh.devices.size)
        if logger is not None:
            logger.info(
                f"Sharding {n_chains} chains over {n_dev} devices "
                f"({n_chains // n_dev} per device, mesh axis 'chains')."
            )
        out = tuple(shard_chain_batch(t, mesh) for t in trees)
        return out if len(out) != 1 else out[0]

    def init_chains(self, key, n_chains: int, shard: bool = True) -> ChainState:
        keys = jax.random.split(key, n_chains)
        if shard:
            keys = self.shard_ensemble(n_chains, keys)
        return self._init_chains(keys)

    def measure_op_step_times(self, keys, states, temps, prior_temps,
                              n_steps: int = 20) -> np.ndarray:
        """Per-operator wall time [s] per ensemble step.

        The fused scan cannot time individual `lax.switch` branches, so we
        time each operator once per run with a dedicated single-branch
        chunk (a strict sub-program of the production kernel; cached by the
        persistent compile cache). The reference times operators inline
        (operators.py:278-330); one probe per run is the fused-kernel
        equivalent."""
        import time as _time

        sfp = self.sample_from_prior
        op_cfg = self.op_cfg
        p_grow = self.p_grow
        temps = jnp.asarray(temps, jnp.float32)
        prior_temps = jnp.asarray(prior_temps, jnp.float32)

        unit_temps = _all_unit_temps(temps, prior_temps)
        times = np.zeros(self.n_ops)
        for i_op in range(self.n_ops):
            cache_key = (i_op, unit_temps)
            if cache_key not in self._branch_chunks:
                def make(i_op=i_op):
                    def run(consts, keys, states, T, Tp, n_steps):
                        def apply_one(key, state, T_c, Tp_c):
                            if unit_temps:
                                T_c, Tp_c = 1.0, 1.0
                            cond = Conditionals(Posterior(consts, sfp), T_c, Tp_c)
                            ops = [get_operator_schedule(cond, op_cfg, p_grow)[i_op]]
                            return make_mh_apply_fn(cond, ops)(0, key, state)

                        vapply = jax.vmap(apply_one)

                        def body(carry, _):
                            keys, states = carry
                            split = jax.vmap(jax.random.split)(keys)
                            keys, k_apply = split[:, 0], split[:, 1]
                            new_states, _, _, _ = vapply(k_apply, states, T, Tp)
                            return (keys, new_states), None

                        (keys, states), _ = jax.lax.scan(body, (keys, states), length=n_steps)
                        return states

                    jitted = jax.jit(run, static_argnums=(5,))
                    return lambda *a: jitted(self.consts, *a)

                self._branch_chunks[cache_key] = make()
            run = self._branch_chunks[cache_key]
            jax.block_until_ready(run(keys, states, temps, prior_temps, n_steps))  # compile+warm
            t0 = _time.perf_counter()
            jax.block_until_ready(run(keys, states, temps, prior_temps, n_steps))
            times[i_op] = (_time.perf_counter() - t0) / n_steps
        return times

    def make_record(self, state_c: ChainState, i_step: int, chain: int = 0,
                    with_likelihood: bool = True,
                    with_cluster_contribution: bool = False) -> SampleRecord:
        parts, cl_counts, conf_counts, obs_lh = self._sample_view(state_c)
        contrib_lh = contrib_prior = None
        if with_cluster_contribution:
            lh_k, prior_k = self._cluster_contribution(state_c)
            contrib_lh, contrib_prior = np.asarray(lh_k), np.asarray(prior_k)
        from sbayes_tpu.model.math import source_onehot

        return SampleRecord(
            i_step=i_step,
            clusters=np.asarray(state_c.clusters),
            weights=np.asarray(state_c.weights),
            # loggers consume the one-hot (N, F, C) view; unpack the
            # packed int8 state form on the host (one sample at a time)
            source=np.asarray(source_onehot(state_c.source, self.consts.C)),
            log_lh=float(parts.log_lh),
            log_prior=float(parts.log_prior),
            size_prior=float(parts.size_prior),
            geo_prior=float(parts.geo_prior),
            weights_prior=float(parts.weights_prior),
            source_prior=float(parts.source_prior),
            cluster_counts=np.asarray(cl_counts),
            conf_counts=np.asarray(conf_counts),
            observation_lh=np.asarray(obs_lh) if with_likelihood else None,
            cluster_contribution_lh=contrib_lh,
            cluster_contribution_prior=contrib_prior,
            chain=chain,
        )

    def warmup_ladder(self, key, n_chains: int, warmup_chains: int, temps,
                      prior_temps, n_steps: int, logger=None) -> ChainState:
        """Best-of-W warm-up race PER MC3 ladder rung (reference
        mcmc_setup.py:507-526: each chain process runs ``warmup_chains``
        sequential init+warm-ups at its own temperature and keeps the
        argmax by log-likelihood). Here all n_chains x W warm-ups are one
        vmapped axis; returns the (n_chains,) selected states."""
        W = max(1, int(warmup_chains))
        k_init, k_run = jax.random.split(key)
        states = self.init_chains(k_init, n_chains * W)
        if n_steps > 0:
            temps_cw = jnp.repeat(jnp.asarray(temps, jnp.float32), W)
            ptemps_cw = jnp.repeat(jnp.asarray(prior_temps, jnp.float32), W)
            keys, stats, temps_cw, ptemps_cw = self.shard_ensemble(
                n_chains * W,
                jax.random.split(k_run, n_chains * W),
                jax.vmap(lambda _: OperatorStats.zeros(self.n_ops))(
                    jnp.arange(n_chains * W)),
                temps_cw, ptemps_cw,
            )
            carry = self.run_chunk(keys, states, stats, temps_cw, ptemps_cw, n_steps)
            # exact recompute before ranking (carried totals drift; see warmup)
            states = _refresh_states_jit(self.consts, self.sample_from_prior,
                                         carry.state)
        ll_cw = np.asarray(states.log_lh).reshape(n_chains, W)
        sel = jnp.asarray(ll_cw.argmax(axis=1) + np.arange(n_chains) * W)
        if logger and W > 1:
            logger.info(
                f"MC3 warm-up: best of {W} per rung; selected log-likelihoods "
                f"{ll_cw.max(axis=1).round(2).tolist()}"
            )
        return jax.tree.map(lambda x: x[sel], states)

    def warmup(self, key, n_chains: int, n_steps: int, logger=None) -> ChainState:
        """Warm-up race: run n_chains, keep the best by likelihood
        (reference: mcmc.py:204-230)."""
        k_init, k_run = jax.random.split(key)
        states = self.init_chains(k_init, n_chains)
        stats = jax.vmap(lambda _: OperatorStats.zeros(self.n_ops))(jnp.arange(n_chains))
        ones = jnp.ones(n_chains, jnp.float32)
        if n_steps > 0:
            keys, stats, ones = self.shard_ensemble(
                n_chains, jax.random.split(k_run, n_chains), stats, ones)
            carry = self.run_chunk(keys, states, stats, ones, ones, n_steps)
            # exact recompute before ranking: the race compares carried
            # totals across chains, which accumulate f32 rounding per
            # accepted move over the (chunk-refresh-free) warm-up
            states = _refresh_states_jit(self.consts, self.sample_from_prior,
                                         carry.state)
        best = int(jnp.argmax(states.log_lh))
        if logger:
            logger.info(
                f"Starting state taken from warmup chain {best} with log-likelihood "
                f"{float(states.log_lh[best]):.2f} (all chains: {np.asarray(states.log_lh).round(2).tolist()})."
            )
        return jax.tree.map(lambda x: x[best], states)


class MCMCSetup:
    """Per-(K, run) sampling orchestration + results files."""

    def __init__(self, data: Data, experiment):
        self.data = data
        self.config = experiment.config
        n_clusters = self.config.model.clusters
        if not isinstance(n_clusters, int):
            raise ValueError("MCMCSetup needs an integer cluster count (CLI resolves lists).")
        if self.config.results.log_likelihood and not self.config.mcmc.sample_from_prior:
            LikelihoodLogger.require_h5py()
        self.model = Model(data, self.config.model)
        self.path_results: Path = experiment.path_results / f"K{self.model.n_clusters}"
        self.path_results.mkdir(exist_ok=True, parents=True)
        self.logger = experiment.logger
        self.runtime = SamplerRuntime(
            self.model, self.config.mcmc, sample_from_prior=self.config.mcmc.sample_from_prior
        )
        self.swap_attempts = 0
        self.swap_accepts = 0
        self.swap_matrix: Optional[np.ndarray] = None
        self.last_swap_matrix_save = 0
        self.t_start = None
        self._op_step_times: Optional[np.ndarray] = None

    # -------------------- paths / loggers --------------------

    def get_results_file_path(self, prefix: str, run: int, chain: int = 0, suffix: str = "txt") -> Path:
        k = self.model.n_clusters
        if chain == 0:
            base_dir, chain_str = self.path_results, ""
        else:
            base_dir, chain_str = self.path_results / "hot_chains", f".chain{chain}"
            base_dir.mkdir(exist_ok=True)
        return base_dir / f"{prefix}_K{k}_{run}{chain_str}.{suffix}"

    def get_sample_loggers(self, run: int, resume: bool, chain: int = 0) -> list[ResultsLogger]:
        consts = self.model.consts
        state_path = self.get_results_file_path("state", run, chain, "pickle")
        loggers: list[ResultsLogger] = [StateDumper(state_path, consts, self.data, resume=resume)]
        if chain > 0 and not self.config.results.log_hot_chains:
            return loggers

        loggers += [
            ParametersCSVLogger(
                self.get_results_file_path("stats", run, chain), consts, self.data,
                resume=resume,
                log_source=self.config.results.log_source,
                log_contribution_per_cluster=self.config.results.log_contribution_per_cluster,
                float_format=f"%.{self.config.results.float_precision}g",
            ),
            ClustersLogger(self.get_results_file_path("clusters", run, chain), consts, self.data, resume=resume),
            OperatorStatsLogger(
                self.get_results_file_path("operator_stats", run, chain), consts, self.data, resume=resume
            ),
        ]
        if (
            not self.config.mcmc.sample_from_prior
            and self.config.results.log_likelihood
            and chain == 0
        ):
            loggers.append(
                LikelihoodLogger(
                    self.get_results_file_path("likelihood", run, chain, "h5"),
                    consts, self.data, resume=resume,
                )
            )
        return loggers

    def log_setup(self):
        cfg = self.config.mcmc
        self.logger.info(self.model.get_setup_message())
        self.logger.info(
            f"\nMCMC SETUP\n##########################################\n"
            f"MCMC with {cfg.steps} steps and {cfg.samples} samples\n"
            f"Warm-up: {cfg.warmup.warmup_chains} chains exploring the parameter space in "
            f"{cfg.warmup.warmup_steps} steps\n"
            f"Ratio of cluster steps: {cfg.operators.clusters}\n"
            f"Ratio of weight steps: {cfg.operators.weights}\n"
            f"Ratio of source steps: {cfg.operators.source}"
        )

    # -------------------- resume --------------------

    def _load_state_pickle(self, path: Path) -> tuple[ChainState, int]:
        with open(path, "rb") as f:
            d = pickle.load(f)
        state = ChainState.from_numpy(d)
        # Convert the checkpoint's source form to the model's configured
        # layout (a bool checkpoint resumes fine into a packed-source
        # runtime and vice versa).
        from sbayes_tpu.model.math import pack_source, source_is_packed, source_onehot

        consts = self.model.consts
        if consts.source_packed and not source_is_packed(state.source):
            state = state._replace(source=pack_source(state.source))
        elif not consts.source_packed and source_is_packed(state.source):
            state = state._replace(source=source_onehot(state.source, consts.C))
        # Recompute the posterior bookkeeping: robust against checkpoints
        # missing prior_parts (stale parts would bias the specialized
        # source/weights MH updates after resume).
        state = _fill_state_jit(self.model.consts, self.config.mcmc.sample_from_prior, state)
        return state, int(d.get("i_step", 0))

    def _resume_from_results(self, run: int, chain: int = 0) -> tuple[ChainState, int]:
        """Legacy resume from clusters/stats files + source imputation
        (reference: mcmc_setup.py:203-245)."""
        from sbayes_tpu.results.results import Results

        results = Results.from_csv_files(
            self.get_results_file_path("clusters", run, chain),
            self.get_results_file_path("stats", run, chain),
        )
        consts = self.model.consts
        clusters = jnp.asarray(results.clusters[:, -1, :], dtype=bool)
        weights = jnp.asarray(
            np.stack([results.weights[f][-1] for f in self.data.features.names]), jnp.float32
        )

        cond = Conditionals(Posterior(consts), 1.0, 1.0)

        @jax.jit
        def impute(key):
            from sbayes_tpu.model.math import pack_source, sample_categorical_onehot

            def store(src_bool):
                return pack_source(src_bool) if consts.source_packed else src_bool

            na = jnp.asarray(consts.na)
            w = normalize_weights(weights, cond.post.has_components(clusters))
            src = sample_categorical_onehot(key, w) & ~na[:, :, None]
            state = ChainState(clusters, weights, store(src), jnp.float32(-jnp.inf),
                               jnp.float32(-jnp.inf), jnp.full((4,), -jnp.inf, jnp.float32))
            # one posterior Gibbs pass over the source
            p = cond.source_posterior(clusters, weights, state.source)
            src2 = sample_categorical_onehot(jax.random.fold_in(key, 1), p) & ~na[:, :, None]
            state = state._replace(source=store(src2))
            return cond.post.fill_state(state)

        state = impute(jax.random.PRNGKey(run))
        return state, int(results.sample_id[-1] + 1)

    # -------------------- single-chain sampling --------------------

    def sample(self, initial_sample: Optional[ChainState] = None, resume: bool = True,
               run: int = 1, seed: int = 0):
        cfg = self.config.mcmc
        rt = self.runtime
        key = jax.random.PRNGKey(seed + 1000003 * run)
        k_warm, k_run = jax.random.split(key)

        sample_loggers = self.get_sample_loggers(run, resume)
        i_step_start = 0

        if initial_sample is not None:
            state = initial_sample
        elif resume:
            state_path = self.get_results_file_path("state", run, 0, "pickle")
            if state_path.exists():
                state, i_step_start = self._load_state_pickle(state_path)
            else:
                state, i_step_start = self._resume_from_results(run)
        else:
            t0 = time.time()
            state = rt.warmup(k_warm, cfg.warmup.warmup_chains, cfg.warmup.warmup_steps, self.logger)
            self.logger.info(f"Initialization and warm-up finished after {time.time() - t0:.1f} seconds")

        self._sample_loop(
            state, sample_loggers, n_steps=cfg.steps, n_samples=cfg.samples,
            i_step_start=i_step_start, key=k_run, run=run,
        )

    # -------------------- ensemble sampling (multiple runs at once) --------------------

    def sample_ensemble(self, run_ids, resume: bool = False, seed: int = 0):
        """Execute ALL requested run IDs as ONE vmapped chain ensemble.

        The reference executes `mcmc.runs` independent repetitions
        sequentially (or via an OS process pool, cli.py:98-109); here the
        whole batch of runs is a single chain axis — R runs cost barely
        more than one. Each run keeps its own results files and warm-up
        race. RNG streams differ from sequential `sample()` execution (one
        master key drives the batch, and the per-step operator draw is
        shared across runs — state-independent, so each run remains a valid
        sampler), so outputs are statistically equivalent to, but not
        bit-identical with, R separate runs.
        """
        cfg = self.config.mcmc
        rt = self.runtime
        R = len(run_ids)
        if R == 1 or resume:
            # resume paths can have differing i_step offsets -> sequential
            for r in run_ids:
                self.sample(resume=resume, run=r, seed=seed)
            return

        loggers_by_run = [self.get_sample_loggers(r, resume) for r in run_ids]

        # Warm-up races for all runs at once: (R x W) chains, best-of-W per run
        W = cfg.warmup.warmup_chains
        t0 = time.time()
        k_init = jax.random.PRNGKey(seed + 101)
        states_rw = rt.init_chains(k_init, R * W)
        if cfg.warmup.warmup_steps > 0:
            keys_rw, stats_rw, ones_rw = rt.shard_ensemble(
                R * W,
                jax.random.split(jax.random.fold_in(k_init, 1), R * W),
                jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(R * W)),
                jnp.ones(R * W, jnp.float32),
            )
            carry = rt.run_chunk(keys_rw, states_rw, stats_rw, ones_rw, ones_rw,
                                 cfg.warmup.warmup_steps)
            # exact recompute before ranking (see SamplerRuntime.warmup)
            states_rw = _refresh_states_jit(rt.consts, rt.sample_from_prior,
                                            carry.state)
        ll_rw = np.asarray(states_rw.log_lh).reshape(R, W)
        best = ll_rw.argmax(axis=1)
        sel = jnp.asarray(best + np.arange(R) * W)
        states = jax.tree.map(lambda x: x[sel], states_rw)
        self.logger.info(
            f"Warm-up for {R} runs ({R * W} chains) finished after {time.time() - t0:.1f}s; "
            f"best warm-up log-likelihoods: {ll_rw.max(axis=1).round(2).tolist()}"
        )

        steps_per_sample = int(math.ceil(cfg.steps / cfg.samples))
        keys, states, stats, ones = rt.shard_ensemble(
            R,
            jax.random.split(jax.random.PRNGKey(seed + 7), R),
            states,
            jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(R)),
            jnp.ones(R, jnp.float32),
            logger=self.logger,
        )
        self._maybe_measure_op_times(keys, states, ones, ones)

        self.t_start = time.time()
        self.logger.info(f"Sampling from posterior ({R} runs as one ensemble)...")
        log_every = max(1, int(round(cfg.screen_log_interval / steps_per_sample)))
        i_step = 0
        for i_sample in range(cfg.samples):
            carry = rt.run_chunk(keys, states, stats, ones, ones, steps_per_sample)
            keys, states, stats = carry.key, carry.state, carry.stats
            i_step += steps_per_sample
            if (i_sample + 1) % REFRESH_EVERY_CHUNKS == 0:
                states = _refresh_states_jit(rt.consts, rt.sample_from_prior, states)
            if i_sample + 1 == max(1, cfg.samples // 2):
                self._maybe_measure_op_times(keys, states, ones, ones, force=True)

            if int(jax.device_get(stats.non_finite.sum())) > 0:
                raise ValueError("Non-finite log-posterior was accepted during MCMC.")

            for i_r, r in enumerate(run_ids):
                state_c = jax.tree.map(lambda x: x[i_r], states)
                record = rt.make_record(
                    state_c, i_step=i_step, chain=0,
                    with_cluster_contribution=self.config.results.log_contribution_per_cluster,
                )
                self._push_operator_stats(loggers_by_run[i_r], stats, chain_idx=i_r,
                                          elapsed=time.time() - self.t_start,
                                          steps_done=i_step)
                for logger in loggers_by_run[i_r]:
                    logger.write_sample(record)

            if (i_sample + 1) % log_every == 0:
                self._print_screen_log(i_step, float(states.log_lh[0]))

        for run_loggers in loggers_by_run:
            for logger in run_loggers:
                logger.close()
        self.logger.info(
            f"{R}-run ensemble finished after {time.time() - self.t_start:.1f} seconds"
        )

    def _sample_loop(self, state: ChainState, sample_loggers, n_steps: int, n_samples: int,
                     i_step_start: int, key, run: int):
        rt = self.runtime
        cfg = self.config.mcmc
        steps_per_sample = int(math.ceil(n_steps / n_samples))

        # batch of 1 chain
        states = jax.tree.map(lambda x: x[None], state)
        stats = jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(1))
        ones = jnp.ones(1, jnp.float32)
        self._maybe_measure_op_times(
            jax.random.split(jax.random.fold_in(key, 0x0b5e), 1), states, ones, ones
        )

        self.t_start = time.time()
        self.logger.info("Sampling from posterior...")
        i_step = i_step_start
        log_every = max(1, int(round(cfg.screen_log_interval / steps_per_sample)))

        i_sample_start = i_step_start // steps_per_sample
        for i_sample in range(i_sample_start, n_samples):
            key, k_chunk = jax.random.split(key)
            carry = rt.run_chunk(k_chunk[None], states, stats, ones, ones, steps_per_sample)
            states, stats = carry.state, carry.stats
            i_step += steps_per_sample
            if (i_sample + 1) % REFRESH_EVERY_CHUNKS == 0:
                states = _refresh_states_jit(rt.consts, rt.sample_from_prior, states)
            if i_sample + 1 == max(1, n_samples // 2):
                # midpoint re-probe on the equilibrated state
                self._maybe_measure_op_times(
                    jax.random.split(jax.random.fold_in(key, 0xbe5), 1),
                    states, ones, ones, force=True)

            if int(jax.device_get(stats.non_finite[0])) > 0:
                raise ValueError("Non-finite log-posterior was accepted during MCMC.")

            state_c = jax.tree.map(lambda x: x[0], states)
            record = rt.make_record(
                state_c, i_step=i_step, chain=0,
                with_cluster_contribution=self.config.results.log_contribution_per_cluster,
            )
            self._push_operator_stats(sample_loggers, stats, chain_idx=0,
                                      elapsed=time.time() - self.t_start,
                                      steps_done=i_step - i_step_start)
            for logger in sample_loggers:
                logger.write_sample(record)

            if (i_sample + 1) % log_every == 0:
                self._print_screen_log(i_step, record.log_lh, i_step_start)
                self._print_memory_usage()

        for logger in sample_loggers:
            logger.close()
        self.logger.info(f"MCMC run finished after {time.time() - self.t_start:.1f} seconds")

    def _maybe_measure_op_times(self, keys, states, temps, prior_temps,
                                force: bool = False):
        """Per-operator timing probe (config-gated).

        Runs once at start-up and again at the run's midpoint
        (``force=True``) so the stats file's STEP-TIME column reflects the
        equilibrated state distribution (cluster sizes change the MST
        depth and gather widths) rather than the initializer's."""
        if not self.config.results.log_operator_step_times:
            return
        if self._op_step_times is not None and not force:
            return
        t0 = time.time()
        self._op_step_times = self.runtime.measure_op_step_times(keys, states, temps, prior_temps)
        self.logger.info(
            "Per-operator step times [ms]: "
            + ", ".join(f"{n}={1e3 * t:.2f}"
                        for n, t in zip(self.runtime.op_names, self._op_step_times))
            + f" (probe took {time.time() - t0:.1f}s)"
        )

    def _push_operator_stats(self, sample_loggers, stats, chain_idx: int,
                             elapsed: float, steps_done: int):
        accepts = np.asarray(stats.accepts[chain_idx])
        rejects = np.asarray(stats.rejects[chain_idx])
        sss = np.asarray(stats.step_size_sum[chain_idx])
        mean_step_time = elapsed / max(steps_done, 1)
        op_times = self._op_step_times
        views = [
            OperatorView(
                name=self.runtime.op_names[i],
                accepts=int(accepts[i]),
                rejects=int(rejects[i]),
                step_size_sum=float(sss[i]),
                mean_step_time_s=float(op_times[i]) if op_times is not None else mean_step_time,
                parameters=self.runtime._op_specs_cold[i].parameters,
            )
            for i in range(self.runtime.n_ops)
        ]
        for logger in sample_loggers:
            if isinstance(logger, OperatorStatsLogger):
                logger.operators = views

    def _print_memory_usage(self):
        """Host memory telemetry (reference: mcmc.py:254-255, 363-364)."""
        from sbayes_tpu.utils import process_memory

        self.logger.info(f"Peak memory usage: {process_memory(unit='MB')} MB")

    def _print_screen_log(self, i_step: int, likelihood: float, i_step_start: int = 0):
        time_per_million = (time.time() - self.t_start) / max(i_step - i_step_start, 1) * 1_000_000
        self.logger.info(
            f"{i_step:<12}log-likelihood:  {likelihood:<19.2f}"
            f"{timedelta(seconds=int(time_per_million))} / million steps"
        )

    # -------------------- MC3 --------------------

    def sample_mc3(self, resume: bool = False, run: int = 1, seed: int = 0):
        """Metropolis-coupled MCMC: a vmapped temperature ladder with
        periodic state swaps (reference: mcmc_setup.py:247-426, re-designed
        as one on-device chain axis instead of one OS process per chain)."""
        cfg = self.config.mcmc
        mc3 = cfg.mc3
        rt = self.runtime
        n_chains = mc3.chains
        swap_interval = mc3.swap_interval
        logging_interval = int(np.ceil(cfg.steps / cfg.samples))

        chain_idxs = np.arange(n_chains)
        if mc3.exponential_temperatures:
            temperatures = (1 + mc3.temperature_diff) ** chain_idxs
            prior_temperatures = (1 + mc3.prior_temperature_diff) ** chain_idxs
        else:
            temperatures = 1 + mc3.temperature_diff * chain_idxs
            prior_temperatures = 1 + mc3.prior_temperature_diff * chain_idxs
        temps = jnp.asarray(temperatures, jnp.float32)
        ptemps = jnp.asarray(prior_temperatures, jnp.float32)

        key = jax.random.PRNGKey(seed + 7000003 * run)
        k_init, k_run = jax.random.split(key)

        t_pre_init = time.time()
        loggers_by_chain = [self.get_sample_loggers(run, resume, chain=c) for c in range(n_chains)]

        i_step_start = 0
        if resume:
            states_list, step_starts = [], []
            for c in range(n_chains):
                state_path = self.get_results_file_path("state", run, c, "pickle")
                if state_path.exists():
                    st, i0 = self._load_state_pickle(state_path)
                else:
                    st, i0 = self._resume_from_results(run, chain=c)
                states_list.append(st)
                step_starts.append(i0)
            states = jax.tree.map(lambda *xs: jnp.stack(xs), *states_list)
            # Resume the global step counter (chains checkpoint together, so
            # min() is conservative if files disagree). The Sample column
            # then continues monotonically instead of restarting at 0.
            i_step_start = min(step_starts)
        else:
            # Best-of-W warm-up race per ladder rung at the rung's own
            # temperature (reference mcmc_setup.py:507-526) — all
            # n_chains x W warm-ups run as one vmapped axis.
            states = rt.warmup_ladder(
                k_init, n_chains, cfg.warmup.warmup_chains, temps, ptemps,
                cfg.warmup.warmup_steps, logger=self.logger,
            )

        # Multi-chip: the whole temperature ladder is one sharded chain axis
        # (the swap phase's chain permutation becomes an XLA collective).
        states, stats, temps, ptemps = rt.shard_ensemble(
            n_chains,
            states,
            jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(n_chains)),
            temps, ptemps,
            logger=self.logger,
        )
        self._maybe_measure_op_times(
            jax.random.split(jax.random.fold_in(k_init, 0x0b5e), n_chains),
            states, temps, ptemps,
        )
        self.swap_attempts = 0
        self.swap_accepts = 0
        self.swap_matrix = np.zeros((n_chains, n_chains), dtype=int)
        self.t_start = time.time()
        self.logger.info(
            f"Initialization and warm-up time: {timedelta(seconds=int(self.t_start - t_pre_init))}"
        )
        self.logger.info("Sampling from posterior...")

        # Fused device loop: each call runs one logging interval of MH steps
        # WITH any swap phases falling inside it (swaps fire at exact global
        # multiples of swap_interval inside the jitted scan, SURVEY §2.3 P2)
        # — the host syncs only at sample-logging intervals, and sample
        # cadence is independent of swap cadence (exactly cfg.samples rows).
        keys = rt.shard_ensemble(
            n_chains, jax.random.split(jax.random.fold_in(k_run, 99), n_chains))
        swap_matrix_dev = jnp.zeros((2, n_chains, n_chains), jnp.int32)
        i_step = i_step_start
        i_sample_start = i_step_start // logging_interval
        for i_outer in range(i_sample_start, cfg.samples):
            n_steps_chunk = min(logging_interval, cfg.steps - i_outer * logging_interval)
            if n_steps_chunk <= 0:
                break
            k_run, k_swap = jax.random.split(k_run)
            keys, states, stats, swap_matrix_dev, n_acc, n_att = rt._run_mc3_chunk(
                keys, states, stats, temps, ptemps, k_swap, swap_matrix_dev,
                jnp.int32(i_step), n_steps_chunk, swap_interval,
                int(mc3.swap_attempts), bool(mc3.only_swap_adjacent_chains),
            )
            i_step += n_steps_chunk
            self.swap_accepts += int(jax.device_get(n_acc))
            self.swap_attempts += int(jax.device_get(n_att))
            if (i_outer + 1) % REFRESH_EVERY_CHUNKS == 0:
                # swap ratios compare carried log_lh ACROSS chains — keep
                # them drift-free over long ladders
                states = _refresh_states_jit(rt.consts, rt.sample_from_prior, states)
            if i_outer + 1 == max(1, cfg.samples // 2):
                self._maybe_measure_op_times(
                    jax.random.split(jax.random.fold_in(k_run, 0xbe5), n_chains),
                    states, temps, ptemps, force=True)

            # Save only when NEW swap attempts happened since the last save
            # (reference cadence: mcmc_setup.py:331-335). Track attempts on
            # both sides of the guard — comparing attempts to accepts (the
            # round-4 wart) made it save every interval regardless.
            if mc3.log_swap_matrix and self.last_swap_matrix_save < self.swap_attempts:
                self.swap_matrix = np.asarray(swap_matrix_dev[0])
                path = self.path_results / f"mc3_swaps_K{self.model.n_clusters}_{run}.txt"
                np.savetxt(path, self.swap_matrix, fmt="%i")
                self.last_swap_matrix_save = self.swap_attempts

            # ---- logging at sample intervals ----
            for c in range(n_chains):
                state_c = jax.tree.map(lambda x: x[c], states)
                record = rt.make_record(
                    state_c, i_step=i_step, chain=c, with_likelihood=(c == 0),
                    with_cluster_contribution=self.config.results.log_contribution_per_cluster,
                )
                self._push_operator_stats(loggers_by_chain[c], stats, chain_idx=c,
                                          elapsed=time.time() - self.t_start,
                                          steps_done=i_step - i_step_start)
                for logger in loggers_by_chain[c]:
                    logger.write_sample(record)
            self.logger.info(
                f"swap accept-rate={self.swap_accepts / max(self.swap_attempts, 1):.3f} "
                f"({self.swap_attempts} attempts)"
            )
            # Per-rung (adjacent-pair) acceptance summary for tuning
            # mc3.temperature_diff: too-cold rungs
            # show ~0, too-tight ladders show ~1 everywhere.
            sm = np.asarray(jax.device_get(swap_matrix_dev))
            rung_rates = " ".join(
                f"{i}<->{i + 1}:{sm[0, i, i + 1] / max(sm[1, i, i + 1], 1):.2f}"
                for i in range(n_chains - 1)
            )
            self.logger.info(f"swap accept-rate per rung: {rung_rates}")
            self._print_screen_log(i_step, float(states.log_lh[0]))

        for chain_loggers in loggers_by_chain:
            for logger in chain_loggers:
                logger.close()
        self.logger.info(
            f"MCMC run finished after {timedelta(seconds=int(time.time() - self.t_start))}"
        )
