"""Per-branch and fused-chunk step cost at the headline shape.

Measures, on the seeded headline dataset (bench.py's runtime, 1024 chains):
  * each operator branch standalone (runner.measure_op_step_times), and
  * the FUSED production chunk (geo_off and geo_on) in ms per ensemble step.
The fused numbers are the ones the end-to-end throughput depends on: a
branch can be fast alone and slow inside the fused multi-branch program,
so both are reported.

    python benchmarks/branch_budget.py

Prints one JSON object with the device and the card's power limit. Needs a
GPU.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_CHAINS = 1024
CHUNK_STEPS = 200


def fused_ms_per_step(rt) -> float:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sbayes_tpu.sampling.kernel import OperatorStats

    states = rt.init_chains(jax.random.PRNGKey(0), N_CHAINS)
    stats = jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(N_CHAINS))
    ones = jnp.ones(N_CHAINS, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), N_CHAINS)
    carry = rt.run_chunk(keys, states, stats, ones, ones, CHUNK_STEPS)
    jax.block_until_ready(carry.state)  # compile + warm
    times = []
    for _ in range(8):
        t0 = time.perf_counter()
        carry = rt.run_chunk(carry.key, carry.state, carry.stats, ones, ones, CHUNK_STEPS)
        jax.block_until_ready(carry.state)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / CHUNK_STEPS * 1e3


def measure() -> dict:
    import jax
    import jax.numpy as jnp

    import bench

    out = {}
    for geo_on in (False, True):
        rt = bench.build_runtime(geo_on)
        out["fused_geo_on" if geo_on else "fused_geo_off"] = fused_ms_per_step(rt)
        if not geo_on:
            states = rt.init_chains(jax.random.PRNGKey(0), N_CHAINS)
            keys = jax.random.split(jax.random.PRNGKey(1), N_CHAINS)
            ones = jnp.ones(N_CHAINS, jnp.float32)
            t = rt.measure_op_step_times(keys, states, ones, ones, n_steps=20)
            for name, ms in zip(rt.op_names, t * 1e3):
                out[f"branch:{name}"] = float(ms)
    return out


def main():
    import jax

    from sbayes_tpu.compile_cache import place_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(f"needs a GPU; the default backend is {jax.default_backend()!r}")
    place_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = jax.devices()[0]
    print(json.dumps({"device": {"platform": dev.platform, "kind": dev.device_kind,
                                 "count": len(jax.devices())},
                      "card": card, "n_chains": N_CHAINS, "ms_per_step": measure()},
                     indent=2))


if __name__ == "__main__":
    main()
