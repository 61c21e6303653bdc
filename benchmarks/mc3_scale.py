"""Fused MC3 ladder at the 10k x 5k scale point (single chip).

Measures the fully fused in-scan MC3 program (subchains + swap MH +
chain-axis permutation, runner.py `_run_mc3_chunk`) against the plain
ensemble `run_chunk` at the same chain count — the cost of temperature
swaps at scale. Reference equivalent: one MC3 process per chain + Pipe
RPC (mcmc_setup.py:428-570), which cannot batch chains at all.

    python benchmarks/mc3_scale.py [n_objects n_features n_chains chunk_steps]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def run(n_objects=10_000, n_features=5_000, n_chains=4, chunk_steps=40):
    from sbayes_tpu.model.model import Model
    from sbayes_tpu.sampling.kernel import OperatorStats
    from sbayes_tpu.sampling.runner import SamplerRuntime
    from sbayes_tpu.testing import synthetic_config
    from sbayes_tpu.testing_scale import synthetic_data_large

    t0 = time.perf_counter()
    data = synthetic_data_large(n_objects=n_objects, n_features=n_features,
                                n_states=5, n_families=10, seed=0,
                                cache_dir="/root/repo/.scale_cache")
    config = synthetic_config(n_clusters=5, geo_prior="uniform")
    config.model.prior.objects_per_cluster.min = 10
    config.model.prior.objects_per_cluster.max = 3000
    model = Model(data, config.model)
    jax.block_until_ready(model.consts.features)
    print(f"data+model: {time.perf_counter()-t0:.0f}s", flush=True)

    cfg = config.mcmc.model_copy(update={
        "initialization": config.mcmc.initialization.model_copy(update={
            "attempts": 1, "em_steps": 3, "objects_per_cluster": 200,
        })
    })
    rt = SamplerRuntime(model, cfg, sample_from_prior=False)

    t0 = time.perf_counter()
    states = rt.init_chains(jax.random.PRNGKey(0), n_chains, shard=False)
    jax.block_until_ready(states.clusters)
    print(f"init {n_chains} chains: {time.perf_counter()-t0:.0f}s", flush=True)

    # linear temperature ladder as in the reference default (dT=0.02)
    T = jnp.asarray([1.0 + 0.02 * i for i in range(n_chains)], jnp.float32)
    Tp = jnp.ones(n_chains, jnp.float32)
    stats = jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(n_chains))
    keys = jax.random.split(jax.random.PRNGKey(1), n_chains)
    swap_matrix = jnp.zeros((2, n_chains, n_chains), jnp.int32)
    n_acc = n_att = jnp.zeros((), jnp.int32)
    swap_key = jax.random.PRNGKey(2)

    # Chunk programs donate their state buffers — keep an independent
    # copy for the plain-ensemble comparison below.
    states_plain = jax.tree.map(jnp.copy, states)
    stats_plain = jax.tree.map(jnp.copy, stats)

    # --- fused MC3 chunk (swap every 10 steps) ---
    t0 = time.perf_counter()
    out = rt._run_mc3_chunk(keys, states, stats, T, Tp, swap_key, swap_matrix,
                            jnp.zeros((), jnp.int32), chunk_steps, 10, 1, True)
    jax.block_until_ready(out[1])
    print(f"mc3 compile+first chunk: {time.perf_counter()-t0:.0f}s", flush=True)

    times = []
    step0 = chunk_steps
    for rep in range(3):
        t0 = time.perf_counter()
        out = rt._run_mc3_chunk(out[0], out[1], out[2], T, Tp, swap_key,
                                out[3], jnp.asarray(step0, jnp.int32),
                                chunk_steps, 10, 1, True)
        jax.block_until_ready(out[1])
        times.append(time.perf_counter() - t0)
        step0 += chunk_steps
    dt = float(np.median(times))
    mc3_rate = chunk_steps * n_chains / dt
    print(f"MC3 ladder ({n_chains} chains, swap/10): "
          f"{mc3_rate:.1f} chain-steps/s ({dt/chunk_steps*1e3:.0f} ms/step), "
          f"swap accepts: {int(out[4])}/{int(out[5])}", flush=True)

    # --- plain ensemble chunk at the same chain count ---
    ones = jnp.ones(n_chains, jnp.float32)
    keys2 = jax.random.split(jax.random.PRNGKey(3), n_chains)
    carry = rt.run_chunk(keys2, states_plain, stats_plain, ones, ones, chunk_steps)
    jax.block_until_ready(carry.state)
    times = []
    for rep in range(3):
        t0 = time.perf_counter()
        carry = rt.run_chunk(carry.key, carry.state, carry.stats, ones, ones,
                             chunk_steps)
        jax.block_until_ready(carry.state)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    plain_rate = chunk_steps * n_chains / dt
    print(f"plain ensemble ({n_chains} chains): {plain_rate:.1f} chain-steps/s "
          f"({dt/chunk_steps*1e3:.0f} ms/step)", flush=True)
    print(f"MC3 overhead: {100*(1 - mc3_rate/plain_rate):.1f}%", flush=True)


if __name__ == "__main__":
    from sbayes_tpu.compile_cache import place_compile_cache

    place_compile_cache()
    run(*[int(a) for a in sys.argv[1:]])
