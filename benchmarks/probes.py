"""Performance probes (one script, three modes):

    python benchmarks/probes.py chains [sizes...]      # throughput vs n_chains
    python benchmarks/probes.py branch [family]        # per-operator-family cost
    python benchmarks/probes.py bigdata [N F S chains steps]  # large-data feasibility

One shared setup, one entry point.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from sbayes_tpu.model.model import Model
from sbayes_tpu.sampling.kernel import OperatorStats
from sbayes_tpu.sampling.runner import SamplerRuntime
from sbayes_tpu.testing import synthetic_config, synthetic_data


def _runtime(n_objects=100, n_features=36, n_states=6, n_families=6, n_clusters=3,
             operator_weights=None):
    data = synthetic_data(n_objects=n_objects, n_features=n_features,
                          n_states=n_states, n_families=n_families, seed=0)
    config = synthetic_config(n_clusters=n_clusters, geo_prior="uniform")
    cfg = config.mcmc
    if operator_weights:
        cfg = cfg.model_copy(update={"operators": cfg.operators.model_copy(update=operator_weights)})
    model = Model(data, config.model)
    return SamplerRuntime(model, cfg, sample_from_prior=False)


def _chains_setup(rt, n_chains):
    states = rt.init_chains(jax.random.PRNGKey(0), n_chains)
    stats = jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(n_chains))
    ones = jnp.ones(n_chains, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), n_chains)
    return keys, states, stats, ones


def probe_chains(n_chains, chunk_steps=200, reps=2):
    rt = _runtime()
    keys, states, stats, ones = _chains_setup(rt, n_chains)

    t_compile = time.perf_counter()
    carry = rt.run_chunk(keys, states, stats, ones, ones, chunk_steps)
    jax.block_until_ready(carry.state)
    print(f"chains={n_chains:5d}  compile+first-chunk: {time.perf_counter() - t_compile:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    for i in range(reps):
        keys = jax.vmap(jax.random.fold_in, in_axes=(0, None))(carry.key, i)
        carry = rt.run_chunk(keys, carry.state, carry.stats, ones, ones, chunk_steps)
    jax.block_until_ready(carry.state)
    dt = time.perf_counter() - t0
    total = reps * chunk_steps * n_chains
    print(
        f"chains={n_chains:5d}  steps/sec={total/dt:10.0f}  per-chain={total/dt/n_chains:8.1f}"
        f"  step-wall={dt/(reps*chunk_steps)*1e3:6.2f} ms",
        flush=True,
    )


def probe_branch(family: str, n_chains=256, chunk_steps=200):
    if family == "all":
        for fam in ("clusters", "weights", "source"):
            probe_branch(fam, n_chains=n_chains, chunk_steps=chunk_steps)
        return
    weights = {"clusters": 0.0, "weights": 0.0, "source": 0.0}
    weights[family] = 1.0
    rt = _runtime(operator_weights=weights)
    keys, states, stats, ones = _chains_setup(rt, n_chains)

    carry = rt.run_chunk(keys, states, stats, ones, ones, chunk_steps)
    jax.block_until_ready(carry.state)
    t0 = time.perf_counter()
    carry = rt.run_chunk(carry.key, carry.state, carry.stats, ones, ones, chunk_steps)
    jax.block_until_ready(carry.state)
    dt = time.perf_counter() - t0
    print(f"{family:10s} ({n_chains} chains): {dt/chunk_steps*1e3:6.2f} ms/ensemble-step "
          f"({n_chains*chunk_steps/dt:8.0f} steps/s)", flush=True)


def probe_bigdata(n_objects=2000, n_features=500, n_states=5, n_chains=64, chunk_steps=50):
    t0 = time.perf_counter()
    rt = _runtime(n_objects=n_objects, n_features=n_features, n_states=n_states,
                  n_families=8, n_clusters=5)
    print(f"setup: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    keys, states, stats, ones = _chains_setup(rt, n_chains)
    jax.block_until_ready(states.clusters)
    print(f"init {n_chains} chains: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    carry = rt.run_chunk(keys, states, stats, ones, ones, chunk_steps)
    jax.block_until_ready(carry.state)
    print(f"compile+first chunk: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    keys2 = jax.vmap(jax.random.fold_in, in_axes=(0, None))(carry.key, 1)
    carry = rt.run_chunk(keys2, carry.state, carry.stats, ones, ones, chunk_steps)
    jax.block_until_ready(carry.state)
    dt = time.perf_counter() - t0
    total = chunk_steps * n_chains
    print(
        f"N={n_objects} F={n_features} chains={n_chains}: steps/sec={total/dt:.0f} "
        f"(step-wall={dt/chunk_steps*1e3:.1f} ms)  lh[0]={float(carry.state.log_lh[0]):.0f}",
        flush=True,
    )


if __name__ == "__main__":
    from sbayes_tpu.compile_cache import place_compile_cache

    place_compile_cache()
    mode = sys.argv[1] if len(sys.argv) > 1 else "chains"
    rest = sys.argv[2:]
    if mode == "chains":
        for n in [int(s) for s in rest] or [64, 256, 1024, 4096]:
            probe_chains(n)
    elif mode == "branch":
        probe_branch(rest[0] if rest else "clusters",
                     n_chains=int(rest[1]) if len(rest) > 1 else 256)
    elif mode == "bigdata":
        probe_bigdata(*[int(a) for a in rest])
    else:
        raise SystemExit(f"unknown probe mode '{mode}' (chains | branch | bigdata)")
