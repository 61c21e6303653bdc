"""Benchmark: MCMC throughput of a chain ensemble on one GPU.

    python bench.py

The model is the seeded headline dataset (``sbayes_tpu.testing.
synthetic_data`` at its defaults: 100 objects x 36 features x 6 states,
6 families, universal + family confounders), K = 3, run twice: with the
uniform geo prior, and with the cost_based geo prior, which puts the
masked-Prim MST (ops/mst.py) inside every cluster operator. Each run is a
1024-chain ensemble: 10 chunks of 200 steps to equilibrate, then 50 timed
chunks whose log-posterior trace gives the multi-chain ESS.

Reported per run: chain-steps/s (chains x steps / wall time of the timed
window, the median chunk time times the chunk count), ESS/s, and the
minimum, median and maximum chunk time. The device, the card's name and
its power limit go with every result. Without a GPU the run stops.

Prints ONE JSON line on standard output; progress goes to standard error.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

N_CHAINS = 1024
CHUNK_STEPS = 200
EQUILIBRATION_CHUNKS = 10   # 2k steps per chain before the ESS window
MEASURE_CHUNKS = 50         # 10k steps per chain in the ESS window


def build_runtime(geo_on: bool, seed: int = 0):
    from sbayes_tpu.model.model import Model
    from sbayes_tpu.sampling.runner import SamplerRuntime
    from sbayes_tpu.testing import synthetic_config, synthetic_data

    data = synthetic_data(seed=seed)
    config = synthetic_config(n_clusters=3, geo_prior="cost_based" if geo_on else "uniform",
                              rate=1e6)
    return SamplerRuntime(Model(data, config.model), config.mcmc)


def measure(rt, n_chains: int = N_CHAINS, chunk_steps: int = CHUNK_STEPS,
            n_equilibration: int = EQUILIBRATION_CHUNKS,
            n_measure: int = MEASURE_CHUNKS) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sbayes_tpu.results.ess import multichain_ess
    from sbayes_tpu.sampling.kernel import OperatorStats

    t0 = time.perf_counter()
    states = rt.init_chains(jax.random.PRNGKey(0), n_chains)
    stats = jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(n_chains))
    ones = jnp.ones(n_chains, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), n_chains)
    carry = rt.run_chunk(keys, states, stats, ones, ones, chunk_steps)
    for _ in range(n_equilibration - 2):
        carry = rt.run_chunk(carry.key, carry.state, carry.stats, ones, ones, chunk_steps)
    # the last equilibration chunk compiles the traced program
    carry, _ = rt._run_chunk_trace(carry.key, carry.state, carry.stats, ones, ones,
                                   chunk_steps)
    jax.block_until_ready(carry.state)
    setup_s = time.perf_counter() - t0

    times, traces = [], []
    for _ in range(n_measure):
        t0 = time.perf_counter()
        carry, tr = rt._run_chunk_trace(carry.key, carry.state, carry.stats, ones, ones,
                                        chunk_steps)
        jax.block_until_ready(tr)
        times.append(time.perf_counter() - t0)
        traces.append(np.asarray(tr))

    wall = float(np.median(times)) * n_measure
    ess = float(multichain_ess(np.concatenate(traces, axis=0).T))
    return {
        "n_chains": n_chains,
        "chain_steps_per_s": n_measure * chunk_steps * n_chains / wall,
        "ess": ess,
        "ess_per_s": ess / wall,
        "window_steps_per_chain": n_measure * chunk_steps,
        "chunk_ms": [1e3 * min(times), 1e3 * float(np.median(times)), 1e3 * max(times)],
        "setup_s_incl_compile": setup_s,
    }


def main():
    import jax

    from sbayes_tpu.compile_cache import place_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures a GPU; the default backend is "
                         f"{jax.default_backend()!r}")
    place_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    dev = jax.devices()[0]
    out = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": smi.stdout.strip().splitlines()[0],
    }
    for geo_on in (False, True):
        label = "geo_on" if geo_on else "geo_off"
        m = measure(build_runtime(geo_on))
        print(f"{label}: {m['chain_steps_per_s']:.0f} chain-steps/s, ESS/s "
              f"{m['ess_per_s']:.2f}, chunk ms {m['chunk_ms']}", file=sys.stderr)
        out[label] = m
    print(json.dumps(out))


if __name__ == "__main__":
    main()
