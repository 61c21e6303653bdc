"""The 10k x 5k scale-up workload (BASELINE.json configs[4]).

Runs the FULL operator schedule on a synthetic 10k objects x 5k features x
5 states dataset, K=5 clusters, universal+family confounders, with the
feature-tiled execution path (ModelConstants.feature_chunk, auto-enabled
at this size) keeping every intermediate tile-sized and the XLA program
compile-bounded. One device; prints setup/compile/steady-state timings.

    python benchmarks/scale10k.py [n_objects n_features n_chains chunk_steps]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import faulthandler
import signal

faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps the stack

import jax
import jax.numpy as jnp


def run(n_objects=10_000, n_features=5_000, n_chains=2, chunk_steps=20):
    import numpy as np

    from sbayes_tpu.model.model import Model
    from sbayes_tpu.sampling.kernel import OperatorStats
    from sbayes_tpu.sampling.runner import SamplerRuntime
    from sbayes_tpu.testing import synthetic_config
    from sbayes_tpu.testing_scale import synthetic_data_large

    t0 = time.perf_counter()
    data = synthetic_data_large(n_objects=n_objects, n_features=n_features,
                                n_states=5, n_families=10, seed=0,
                                cache_dir="/root/repo/.scale_cache")
    print(f"data gen: {time.perf_counter() - t0:.1f}s", flush=True)
    config = synthetic_config(n_clusters=5, geo_prior="uniform")
    # wider size bounds for 10k objects
    config.model.prior.objects_per_cluster.min = 10
    config.model.prior.objects_per_cluster.max = 3000
    t0 = time.perf_counter()
    model = Model(data, config.model)
    jax.block_until_ready(model.consts.features)
    print(f"model build + device upload: {time.perf_counter() - t0:.1f}s  "
          f"feature_chunk={model.consts.feature_chunk}  "
          f"feature_dtype={model.consts.features.dtype}", flush=True)

    cfg = config.mcmc.model_copy(update={
        "initialization": config.mcmc.initialization.model_copy(update={
            "attempts": 1, "em_steps": 3, "objects_per_cluster": 200,
        })
    })
    rt = SamplerRuntime(model, cfg, sample_from_prior=False)

    t0 = time.perf_counter()
    states = rt.init_chains(jax.random.PRNGKey(0), n_chains)
    jax.block_until_ready(states.clusters)
    print(f"init {n_chains} chains (EM, tiled): {time.perf_counter() - t0:.1f}s  "
          f"lh={np.asarray(states.log_lh).round(0).tolist()}", flush=True)

    stats = jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(n_chains))
    ones = jnp.ones(n_chains, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), n_chains)

    t0 = time.perf_counter()
    carry = rt.run_chunk(keys, states, stats, ones, ones, chunk_steps)
    jax.block_until_ready(carry.state)
    print(f"compile+first chunk ({chunk_steps} steps): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    for rep in range(3):
        t0 = time.perf_counter()
        keys = jax.vmap(jax.random.fold_in, in_axes=(0, None))(carry.key, rep)
        carry = rt.run_chunk(keys, carry.state, carry.stats, ones, ones, chunk_steps)
        jax.block_until_ready(carry.state)
        dt = time.perf_counter() - t0
        total = chunk_steps * n_chains
        print(
            f"rep {rep}: N={n_objects} F={n_features} chains={n_chains}: "
            f"steps/sec={total/dt:.1f} (step-wall={dt/chunk_steps*1e3:.0f} ms) "
            f"lh[0]={float(carry.state.log_lh[0]):.0f}",
            flush=True,
        )
    acc = np.asarray(carry.stats.accepts).sum(0)
    rej = np.asarray(carry.stats.rejects).sum(0)
    print("accept-rates:", {n: f"{a}/{a+r}" for n, a, r in zip(rt.op_names, acc, rej)},
          flush=True)


if __name__ == "__main__":
    from sbayes_tpu.compile_cache import place_compile_cache

    place_compile_cache()
    args = [int(a) for a in sys.argv[1:]]
    run(*args)
