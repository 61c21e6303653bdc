"""Headline-bench chain-count sweep on the seeded headline dataset.

The bench ensemble (vmapped chains, shared operator draw) may be
latency-bound at small per-chain shapes: more chains amortize fixed
per-step cost, and multi-chain ESS grows ~linearly in chains once
equilibrated. This sweep measures chain-steps/s and ESS/sec for
256..4096 chains so bench.py's N_CHAINS is a measured choice.

    python benchmarks/chain_sweep.py [n_chains ...]
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import bench
    from sbayes_tpu.compile_cache import place_compile_cache

    place_compile_cache()
    ns = [int(a) for a in sys.argv[1:]] or [256, 1024, 2048, 4096]
    rt = bench.build_runtime(geo_on=False)
    for n in ns:
        t0 = time.perf_counter()
        m = bench.measure(rt, n, n_measure=15)
        print(
            f"{n:5d} chains: {m['chain_steps_per_s']:10.0f} chain-steps/s  "
            f"ESS/sec {m['ess_per_s']:8.2f}  (ESS {m['ess']:.0f} over "
            f"{m['window_steps_per_chain']} steps/chain; wall {time.perf_counter()-t0:.0f}s)",
            flush=True,
        )


if __name__ == "__main__":
    main()
