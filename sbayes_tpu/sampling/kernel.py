"""The Metropolis-Hastings step kernel: one fused, scanned device program.

Replaces the reference's Python hot loop (sbayes/sampling/mcmc.py:237-328):
each step draws an operator from the schedule (``lax.switch``), proposes a
candidate, recomputes the FULL posterior (fused kernels, no caching), and
accepts/rejects with the MH ratio incl. the Gibbs/reject sentinels and the
MC3 temperature semantics (likelihood heated by 1/T, prior by 1/Tp;
reference: mcmc_chain.py:88,109 and mcmc.py:330-350).

A chain is ``lax.scan`` over steps; chains are a vmapped leading axis.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from sbayes_tpu.sampling.conditionals import Conditionals
from sbayes_tpu.sampling.operators import OperatorSpec
from sbayes_tpu.sampling.state import ChainState


class OperatorStats(NamedTuple):
    """Per-operator accept/reject counters and step sizes (for the
    operator_stats results file; reference: operators.py:221-330)."""

    accepts: jnp.ndarray        # int32 (n_ops,)
    rejects: jnp.ndarray        # int32 (n_ops,)
    step_size_sum: jnp.ndarray  # f32 (n_ops,) summed over accepted steps
    non_finite: jnp.ndarray     # int32 () accepted non-finite posteriors

    @classmethod
    def zeros(cls, n_ops: int) -> "OperatorStats":
        return cls(
            accepts=jnp.zeros(n_ops, jnp.int32),
            rejects=jnp.zeros(n_ops, jnp.int32),
            step_size_sum=jnp.zeros(n_ops, jnp.float32),
            non_finite=jnp.zeros((), jnp.int32),
        )


class Carry(NamedTuple):
    key: jnp.ndarray
    state: ChainState
    stats: OperatorStats


def make_mh_apply_fn(cond: Conditionals, op_specs: Sequence[OperatorSpec]) -> Callable:
    """Build ``apply(op_idx, key, state) -> (new_state, accept, step_size, nf)``:
    apply operator ``op_idx`` and the MH accept/reject to one chain.

    ``op_idx`` is expected to be UNBATCHED under ``vmap`` (one shared draw
    per ensemble step), so ``lax.switch`` executes exactly one operator
    branch per step instead of all of them for every chain. The operator
    draw is independent of the state, so sharing it across chains leaves
    every chain a valid sampler of the posterior (each branch kernel
    preserves it); only the operator *identity* is correlated across
    chains, which carries no information about the states.
    """
    post = cond.post
    T, Tp = cond.T, cond.Tp
    sfp = cond.sample_from_prior

    from sbayes_tpu.sampling.state import PRIOR_GEO, PRIOR_SIZE, PRIOR_SOURCE, PRIOR_WEIGHTS

    def evaluate_candidate(spec: OperatorSpec, old_state, cand,
                           sp_delta=None, ll_delta=None):
        """Posterior bookkeeping of the candidate, specialized to the terms
        the operator can actually change (static per branch). The candidate
        counts are the operator-maintained exact state counts
        (ChainState.cl_counts/conf_counts) — no count-einsum recompute.
        ``sp_delta`` (OpResult.source_prior_delta) replaces the full
        source-prior stream for subset moves; ``ll_delta``
        (OpResult.ll_delta) replaces the full lgamma likelihood recompute
        for single-object movers. Exact deltas also flow into the returned
        (d_ll, d_prior) MH terms DIRECTLY: at scale the carried totals'
        f32 ulp (~2 at |log_lh| ~ 3e7) would otherwise quantize the MH
        ratio; the carried state values themselves may accumulate that
        rounding (bounded, asserted vs recompute in
        tests/test_counts_threading.py; logged samples are recomputed).

        Returns (cand_filled, d_ll, d_prior)."""
        counts = (None if cand.cl_counts is None
                  else (cand.cl_counts, cand.conf_counts))

        def candidate_source_prior():
            if sp_delta is not None:
                return old_state.prior_parts[PRIOR_SOURCE] + sp_delta
            return post.source_prior(cand.clusters, cand.weights, cand.source)

        def candidate_log_lh():
            """(log_lh, exact d_ll). With candidate counts but no operator
            delta (wide / source subset moves), the delta comes from the
            per-feature diff-then-sum: unchanged count entries produce
            bitwise-identical terms that cancel exactly, so the MH ratio
            is exact instead of ulp(|log_lh|)-quantized at scale.
            Statically forced-accept branches (Gibbs sweeps) skip the
            double evaluation — their d_ll never gates acceptance."""
            if sfp:
                z = jnp.zeros((), jnp.float32)
                return z, z
            if ll_delta is not None:
                return old_state.log_lh + ll_delta, ll_delta
            if (counts is not None and old_state.cl_counts is not None
                    and not getattr(spec, "forced_accept", False)):
                # Exact generic count-diff. Two forms, both exact (unchanged
                # cells cancel bitwise): the per-feature two-pass diff and
                # the lane-packed single-stack diff (posterior.py). On an
                # earlier accelerator the packed form won standalone and
                # lost inside the fused multi-branch ensemble program at
                # the headline shape. Default: per-feature;
                # SBAYES_TPU_PACKED_DLL=1 opts into the packed form for
                # re-measurement on the GPU (ROADMAP Design 2).
                import os

                if os.environ.get("SBAYES_TPU_PACKED_DLL") == "1":
                    d = post.log_likelihood_diff_from_counts(
                        counts, (old_state.cl_counts, old_state.conf_counts))
                else:
                    ncl, nconf = post.log_likelihood_per_feature(*counts)
                    ocl, oconf = post.log_likelihood_per_feature(
                        old_state.cl_counts, old_state.conf_counts)
                    d = (ncl - ocl).sum() + (nconf - oconf).sum()
                return old_state.log_lh + d, d
            if counts is not None:
                ll = post.log_likelihood_from_counts(*counts)
            else:
                ll = post.log_likelihood(cand)
            return ll, ll - old_state.log_lh

        if spec.changes == "clusters":
            ll, d_ll = candidate_log_lh()
            # weights untouched by every cluster-changing operator: the
            # weights prior carries over from the old state
            # Carried (K, 3) geo aggregates: the operator re-derived only
            # its changed cluster's skeleton, so the geo prior is a cheap
            # map over the triple instead of K fresh MSTs.
            if cand.geo_agg is not None:
                geo = post.geo_prior_from_agg(cand.clusters, cand.geo_agg).sum()
            else:
                geo = post.geo_prior_per_cluster(cand.clusters).sum()
            pp = (
                old_state.prior_parts
                .at[PRIOR_SIZE].set(post.size_prior(cand.clusters))
                .at[PRIOR_GEO].set(geo)
                .at[PRIOR_SOURCE].set(candidate_source_prior())
            )
        elif spec.changes == "source":
            # clusters & weights untouched: size/geo/weights priors carry over
            ll, d_ll = candidate_log_lh()
            pp = old_state.prior_parts.at[PRIOR_SOURCE].set(candidate_source_prior())
        elif spec.changes == "weights":
            # the collapsed likelihood does not involve the weights
            ll = old_state.log_lh
            d_ll = jnp.zeros((), jnp.float32)
            wp = post.weights_prior(cand.weights)
            # gibbs_sample_weights prices the source prior of BOTH weight
            # vectors from the carried pattern counts and hands the exact
            # accepted-feature delta over (source_prior_delta) — the
            # candidate_source_prior fallback's full (N,F,C) stream runs
            # only for delta-less weight ops (AlterWeights, not scheduled).
            pp = (old_state.prior_parts
                  .at[PRIOR_WEIGHTS].set(wp)
                  .at[PRIOR_SOURCE].set(candidate_source_prior()))
        else:
            raise ValueError(f"Unknown operator change group {spec.changes}")

        # Exact MH terms: per-part prior differences (small magnitudes),
        # with the carried parts' exact deltas substituted where known.
        d_parts = pp - old_state.prior_parts
        if sp_delta is not None:
            d_parts = d_parts.at[PRIOR_SOURCE].set(sp_delta)
        d_prior = d_parts.sum()
        return cand._replace(log_lh=ll, log_prior=pp.sum(), prior_parts=pp), d_ll, d_prior

    def make_branch(spec: OperatorSpec):
        def branch(key, state):
            k_prop, k_u = jax.random.split(key)
            res = spec.fn(k_prop, state)
            if res.source_rows is not None and res.source_prior_delta is None:
                # The deferred-rows state carries the STALE source buffer;
                # every source-dependent term must arrive as an exact delta.
                raise ValueError(
                    f"operator {spec.name}: source_rows requires "
                    "source_prior_delta (the kernel must not recompute "
                    "source terms from the old buffer)")
            if res.source_rows is not None and res.ll_delta is None and (
                    res.state.cl_counts is None):
                # Without carried counts AND without an ll_delta,
                # evaluate_candidate would fall back to
                # post.log_likelihood(cand), which reads the STALE source
                # buffer — a silently wrong MH ratio.
                raise ValueError(
                    f"operator {spec.name}: source_rows requires carried "
                    "counts or ll_delta (the likelihood must not be "
                    "recomputed from the old source buffer)")
            cand, d_ll, d_prior = evaluate_candidate(
                spec, state, res.state,
                sp_delta=res.source_prior_delta, ll_delta=res.ll_delta)

            gibbs = jnp.isneginf(res.log_q)
            direct_reject = jnp.isneginf(res.log_q_back)
            mh_ratio = (
                d_ll / T
                + d_prior / Tp
                - (res.log_q - res.log_q_back)
            )
            u = jnp.log(jax.random.uniform(k_u))
            accept = (~direct_reject) & (gibbs | (u < mh_ratio))

            # Guard: flag accepted non-finite posteriors (reference raises;
            # we count and let the host raise after the chunk).
            nf = accept & (~jnp.isfinite(cand.log_lh) | ~jnp.isfinite(cand.log_prior))

            new_state = jax.tree.map(lambda a, b: jnp.where(accept, a, b), cand, state)
            if res.source_rows is not None:
                # Deferred source-row write: ``cand.source`` is the old
                # buffer (the tree-select above folded to the identity on
                # it); scatter the accepted rows in ONE pass. Rejected /
                # padded proposals carry index N, whose writes XLA drops.
                # With the buffer scan-carried and otherwise dead, XLA
                # performs the scatter in place — no 150 MB copy per step.
                # mode= pins the out-of-bounds semantics the scheme relies
                # on (gathered values at idx==N are dead; writes dropped)
                # rather than leaning on JAX's defaults.
                # gather/scatter ride the one-hot matmul form at small
                # sizes (math.gather_rows) and the native in-place forms
                # at scale.
                from sbayes_tpu.model.math import gather_rows, scatter_rows

                idx, rows_new = res.source_rows
                rows_final = jnp.where(
                    accept, rows_new,
                    gather_rows(state.source, idx, post.consts.C))
                new_state = new_state._replace(
                    source=scatter_rows(state.source, idx, rows_final))
            return new_state, accept, res.step_size, nf

        return branch

    branches = [make_branch(spec) for spec in op_specs]

    def apply(op_idx, key, state):
        return lax.switch(op_idx, branches, key, state)

    return apply


def make_step_fn(cond: Conditionals, op_specs: Sequence[OperatorSpec]) -> Callable:
    """Single-chain step ``step(carry) -> carry`` (per-chain operator draw).

    Used by the harness entry point; the production ensemble path shares
    the operator draw across chains (see runner._build_run_chunk).
    """
    op_logits = jnp.log(jnp.asarray([o.weight for o in op_specs], jnp.float32))
    apply = make_mh_apply_fn(cond, op_specs)

    def step(carry: Carry) -> Carry:
        key, state, stats = carry
        key, k_op, k_apply = jax.random.split(key, 3)
        op_idx = jax.random.categorical(k_op, op_logits)
        new_state, accept, step_size, nf = apply(op_idx, k_apply, state)
        stats = OperatorStats(
            accepts=stats.accepts.at[op_idx].add(accept.astype(jnp.int32)),
            rejects=stats.rejects.at[op_idx].add((~accept).astype(jnp.int32)),
            step_size_sum=stats.step_size_sum.at[op_idx].add(jnp.where(accept, step_size, 0.0)),
            non_finite=stats.non_finite + nf.astype(jnp.int32),
        )
        return Carry(key, new_state, stats)

    return step


def make_chunk_runner(cond: Conditionals, op_specs: Sequence[OperatorSpec]) -> Callable:
    """``run(key, state, stats, n_steps)`` scanning the step kernel.

    ``n_steps`` is static (one compilation per distinct chunk length).
    """
    step = make_step_fn(cond, op_specs)

    @partial(jax.jit, static_argnames=("n_steps",))
    def run(key, state: ChainState, stats: OperatorStats, n_steps: int):
        def body(carry, _):
            return step(carry), None

        carry, _ = lax.scan(body, Carry(key, state, stats), length=n_steps)
        return carry

    return run


def init_state_posterior(cond: Conditionals, state: ChainState) -> ChainState:
    """Fill in log_lh / log_prior / prior_parts of a freshly built state."""
    return jax.jit(cond.post.fill_state)(state)
