"""Smoke test of the sampler on an NVIDIA GPU, through its normal entry points.

    python chip_smoke.py [--seed N]          # one card: device, cli, ensemble, tiled
    python chip_smoke.py --four-cards        # four cards: the sharded phase only

Everything runs in this one process (a second JAX process could not take
the card). Phases:

  device    names the device and the card's power limit; anything but a
            GPU default backend ends the run here with a non-zero exit.
  cli       writes a seeded south_america-shaped dataset (100 objects x 36
            features x 6 states, 6 families, universal + family
            confounders) as reference CSVs plus a JSON config, runs
            ``sbayes_tpu.cli.cli`` with ``mcmc.runs: 4`` (the vmapped
            ensemble) and then one MC3 run, and checks the results files.
  ensemble  1024 chains, K = 3, cost_based geo prior, through
            ``SamplerRuntime.init_chains`` + ``run_chunk``; compares the
            carried log-likelihood and log-prior of 8 chains with a full
            recompute on the CPU backend (``Model.parts``).
  tiled     2048 objects x 2048 features x 5 states (feature tiling on,
            fc = 512): runs chunks, compares the tiled membership marginals
            with the untiled ones on the CPU backend, times the marginal
            alone against the card's memory bandwidth, and traces one chunk.
  four      (--four-cards) the 1024-chain ensemble and one MC3 chunk with
            swaps, sharded over four cards by ``shard_ensemble``, against
            the same seeds on one card.

Any failure raises, so the exit code is non-zero and no result line is
printed. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# Published peak of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth.
H100_HBM_BYTES_PER_S = 3.35e12
MARGINAL_TOL = 2e-4          # rtol = atol for tiled vs untiled marginals
HEADLINE = dict(n_objects=100, n_features=36, n_states=6, n_families=6)
TILED = dict(n_objects=2048, n_features=2048, n_states=5, n_families=10)


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(platform: str, kind: str, count: int) -> str:
    """The final line of a successful run."""
    return json.dumps({"ok": True, "device": {"platform": platform, "kind": kind,
                                              "count": count}})


def lh_tolerance(value: float) -> float:
    """Carried vs recomputed log-likelihood / log-prior tolerance."""
    return 1e-3 + 1e-5 * abs(value)


# --------------------------------------------------------------------------
# device
# --------------------------------------------------------------------------

def phase_device(n_cards: int):
    import jax

    devices = jax.devices()
    log(f"[device] jax {jax.__version__} devices: {devices}")
    log(f"[device] default backend: {jax.default_backend()}; "
        f"device_kind: {devices[0].device_kind}")
    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: the default JAX backend is "
                         f"{jax.default_backend()!r}, not 'gpu'; nothing was run.")
    if len(devices) < n_cards:
        raise SystemExit(f"chip_smoke: {n_cards} GPUs needed, {len(devices)} found.")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log("[device] nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    return devices


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def headline_model(seed: int, device=None):
    """The headline model (synthetic south_america shape, K = 3, cost_based
    geo prior) with its constants on ``device`` (default: JAX's)."""
    import jax

    from sbayes_tpu.model.model import Model
    from sbayes_tpu.testing import synthetic_config, synthetic_data

    data = synthetic_data(**HEADLINE, seed=seed)
    config = synthetic_config(n_clusters=3, geo_prior="cost_based", rate=1e6)
    if device is None:
        return data, config, Model(data, config.model)
    with jax.default_device(device):
        return data, config, Model(data, config.model)


def zero_stats(rt, n):
    import jax
    import jax.numpy as jnp

    from sbayes_tpu.sampling.kernel import OperatorStats

    return jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(n))


def run_chunks(rt, states, seed: int, n_chunks: int, n_steps: int):
    """``n_chunks`` timed chunks of ``n_steps``; returns (carry, seconds per
    chunk). The first chunk includes compilation."""
    import jax
    import jax.numpy as jnp

    n = int(states.log_lh.shape[0])
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), n)
    stats = zero_stats(rt, n)
    ones = jnp.ones(n, jnp.float32)
    times = []
    carry = None
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        carry = rt.run_chunk(keys, states, stats, ones, ones, n_steps)
        jax.block_until_ready(carry.state)
        times.append(time.perf_counter() - t0)
        keys, states, stats = carry.key, carry.state, carry.stats
    return carry, times


def peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def worst_lh_gap(carried_lh, carried_prior, recomputed) -> float:
    """Largest gap as a fraction of its tolerance; raises above 1."""
    worst = 0.0
    for i, (lh, pr) in enumerate(zip(carried_lh, carried_prior)):
        lh_r, pr_r = recomputed[i]
        for name, a, b in (("log_lh", lh, lh_r), ("log_prior", pr, pr_r)):
            gap = abs(float(a) - float(b))
            frac = gap / lh_tolerance(b)
            log(f"[ensemble]   chain {i} {name}: carried {float(a):.6f} "
                f"recomputed {float(b):.6f} gap {gap:.3e} ({frac:.3f} of tol)")
            if not frac <= 1.0:
                raise AssertionError(f"chain {i} {name}: carried {a} vs CPU {b}")
            worst = max(worst, frac)
    return worst


# --------------------------------------------------------------------------
# cli
# --------------------------------------------------------------------------

def _smoke_config(steps: int, samples: int, runs: int, mc3: bool) -> dict:
    return {
        "data": {"features": "features.csv", "feature_states": "feature_states.csv"},
        "model": {
            "clusters": 3,
            "confounders": ["universal", "family"],
            "prior": {
                "objects_per_cluster": {"type": "uniform_area", "min": 2, "max": 50},
                "geo": {"type": "cost_based", "rate": 1e6, "aggregation": "mean"},
                "weights": {"type": "uniform"},
                "cluster_effect": {"type": "uniform"},
                "confounding_effects": {
                    "universal": {"<ALL>": {"type": "uniform"}},
                    "family": {"<DEFAULT>": {"type": "uniform"}},
                },
            },
        },
        "mcmc": {
            "steps": steps,
            "samples": samples,
            "runs": runs,
            "initialization": {"attempts": 2, "em_steps": 20, "objects_per_cluster": 10},
            # one warm-up chain per run: the warm-up and the sampling
            # chunks then share one compiled program (4 chains x 50 steps)
            "warmup": {"warmup_steps": 50, "warmup_chains": 1},
            "mc3": {"activate": mc3, "chains": 4, "swap_interval": 10,
                    "swap_attempts": 2},
        },
        "results": {"path": "results", "log_file": False, "log_likelihood": False,
                    "log_operator_step_times": False},
    }


def _check_run_files(k_dir: Path, run: int, n_objects: int, n_clusters: int,
                     steps: int, samples: int, chain: str = "") -> None:
    stats = (k_dir / f"stats_K{n_clusters}_{run}{chain}.txt").read_text().splitlines()
    header = stats[0].split("\t")
    if header[:4] != ["Sample", "posterior", "likelihood", "prior"] or \
            "size_a0" not in header or not any(h.startswith("w_areal_") for h in header):
        raise AssertionError(f"stats header of run {run}{chain}: {header[:8]}")
    rows = [r.split("\t") for r in stats[1:]]
    if len(rows) != samples:
        raise AssertionError(f"run {run}{chain}: {len(rows)} stats rows, expected {samples}")
    values = np.asarray(rows, dtype=float)
    if not np.all(np.isfinite(values)):
        raise AssertionError(f"run {run}{chain}: non-finite stats values")
    clusters = (k_dir / f"clusters_K{n_clusters}_{run}{chain}.txt").read_text().splitlines()
    if len(clusters) != samples:
        raise AssertionError(f"run {run}{chain}: {len(clusters)} cluster rows")
    for row in clusters:
        bits = row.split("\t")
        if len(bits) != n_clusters or any(
                len(b) != n_objects or set(b) - {"0", "1"} for b in bits):
            raise AssertionError(f"run {run}{chain}: malformed cluster row {row[:40]}")
    ops = (k_dir / f"operator_stats_K{n_clusters}_{run}{chain}.txt").read_text().splitlines()
    total = 0
    for row in ops[2:]:
        cells = row.split()
        if cells[1] == "-":
            continue
        acc, rej, tot = int(cells[1]), int(cells[2]), int(cells[3])
        if acc + rej != tot:
            raise AssertionError(f"operator row {row}")
        total += tot
    if total != steps:
        raise AssertionError(f"run {run}{chain}: operator totals {total} != {steps} steps")


def phase_cli(seed: int, workdir: Path) -> None:
    from sbayes_tpu.cli import cli
    from sbayes_tpu.testing import synthetic_data, write_reference_csvs

    data = synthetic_data(**HEADLINE, seed=seed)
    write_reference_csvs(data, workdir)
    steps, samples, runs = 200, 4, 4
    cfg_path = workdir / "smoke.json"
    cfg_path.write_text(json.dumps(_smoke_config(steps, samples, runs, mc3=False)))
    t0 = time.perf_counter()
    cli([str(cfg_path), "-n", "ensemble"])
    log(f"[cli] {runs}-run ensemble through cli(): {time.perf_counter() - t0:.1f} s")
    k_dir = workdir / "results" / "ensemble" / "K3"
    for r in range(runs):
        _check_run_files(k_dir, r, HEADLINE["n_objects"], 3, steps, samples)
    log(f"[cli] stats/clusters/operator_stats of {runs} runs: ok")

    mc3_path = workdir / "smoke_mc3.json"
    mc3_steps = 100
    mc3_path.write_text(json.dumps(_smoke_config(mc3_steps, samples, 1, mc3=True)))
    t0 = time.perf_counter()
    cli([str(mc3_path), "-n", "mc3"])
    log(f"[cli] MC3 run through cli(): {time.perf_counter() - t0:.1f} s")
    k_dir = workdir / "results" / "mc3" / "K3"
    _check_run_files(k_dir, 0, HEADLINE["n_objects"], 3, mc3_steps, samples)
    for chain in (1, 2, 3):
        _check_run_files(k_dir / "hot_chains", 0, HEADLINE["n_objects"], 3,
                         mc3_steps, samples, chain=f".chain{chain}")
    swaps = np.loadtxt(k_dir / "mc3_swaps_K3_0.txt")
    if swaps.shape != (4, 4):
        raise AssertionError(f"mc3 swap matrix shape {swaps.shape}")
    log(f"[cli] MC3 files (cold, 3 hot chains, swap matrix): ok; "
        f"accepted swaps {int(swaps.sum())}")


# --------------------------------------------------------------------------
# ensemble
# --------------------------------------------------------------------------

def phase_ensemble(seed: int, n_chains: int = 1024, n_chunks: int = 3,
                   n_steps: int = 200, n_check: int = 8) -> None:
    import jax

    from sbayes_tpu.sampling.runner import SamplerRuntime

    data, config, model = headline_model(seed)
    rt = SamplerRuntime(model, config.mcmc)
    t0 = time.perf_counter()
    states = rt.init_chains(jax.random.PRNGKey(seed), n_chains)
    jax.block_until_ready(states)
    log(f"[ensemble] init_chains({n_chains}) incl. compile: {time.perf_counter() - t0:.2f} s")
    carry, times = run_chunks(rt, states, seed, n_chunks, n_steps)
    steady = statistics.median(times[1:]) if len(times) > 1 else times[0]
    log(f"[ensemble] first chunk (compile + run): {times[0]:.2f} s; compile ~ "
        f"{times[0] - steady:.2f} s")
    log(f"[ensemble] steady chunk: {1e3 * steady:.2f} ms for {n_steps} steps x "
        f"{n_chains} chains ({n_chains * n_steps / steady:.0f} chain-steps/s); "
        f"chunks {[round(1e3 * t, 2) for t in times]} ms")
    log(f"[ensemble] peak_bytes_in_use: {peak_bytes(jax.devices()[0])}")

    final = jax.device_get(carry.state)
    if not (np.all(np.isfinite(final.log_lh)) and np.all(np.isfinite(final.log_prior))):
        raise AssertionError("non-finite log_lh / log_prior in the ensemble")
    if int(jax.device_get(carry.stats.non_finite.sum())) != 0:
        raise AssertionError("a non-finite proposal was accepted")
    log(f"[ensemble] all {n_chains} log_lh and log_prior finite")

    cpu = jax.devices("cpu")[0]
    _, _, model_cpu = headline_model(seed, device=cpu)
    recomputed = []
    with jax.default_device(cpu):
        for i in range(n_check):
            s = jax.device_put(jax.tree.map(lambda x: x[i], final), cpu)
            parts = model_cpu.parts(s)
            recomputed.append((float(parts.log_lh), float(parts.log_prior)))
    worst = worst_lh_gap(final.log_lh[:n_check], final.log_prior[:n_check], recomputed)
    log(f"[ensemble] worst carried-vs-CPU gap over {n_check} chains: "
        f"{worst:.4f} of atol = 1e-3 + 1e-5*|value|")


# --------------------------------------------------------------------------
# tiled
# --------------------------------------------------------------------------

def tiled_model(seed: int, shape: dict, device=None):
    import jax

    from sbayes_tpu.model.model import Model
    from sbayes_tpu.testing import synthetic_config
    from sbayes_tpu.testing_scale import synthetic_data_large

    data = synthetic_data_large(**shape, seed=seed)
    config = synthetic_config(n_clusters=3, geo_prior="uniform")
    if device is None:
        return config, Model(data, config.model)
    with jax.default_device(device):
        return config, Model(data, config.model)


def _marginals(consts, state):
    """(log-odds, log_m0, log_m1) of cluster 0 for one state."""
    import jax.numpy as jnp

    from sbayes_tpu.model.posterior import Posterior
    from sbayes_tpu.sampling.conditionals import Conditionals
    from sbayes_tpu.sampling.operators import OperatorFactory

    fact = OperatorFactory(Conditionals(Posterior(consts), 1.0, 1.0))
    avail = jnp.ones(consts.N, bool)
    counts = (state.cl_counts, state.conf_counts)
    odds = fact._cluster_log_odds(state, 0, avail, counts=counts)
    m0, m1 = fact._log_marginal_with_without(state, 0, avail, counts=counts)
    return odds, m0, m1


def phase_tiled(seed: int, shape: dict = TILED, n_chains: int = 8, n_chunks: int = 3,
                n_steps: int = 50) -> None:
    import jax
    import jax.numpy as jnp

    from sbayes_tpu.model.posterior import Posterior
    from sbayes_tpu.profiling import device_events, load_profile, scoped_ops, summarize
    from sbayes_tpu.sampling.conditionals import Conditionals
    from sbayes_tpu.sampling.operators import MARGINAL_SCOPE, OperatorFactory
    from sbayes_tpu.sampling.runner import SamplerRuntime

    t0 = time.perf_counter()
    config, model = tiled_model(seed, shape)
    c = model.consts
    log(f"[tiled] N={c.N} F={c.F} S={c.S} C={c.C}: feature_chunk={c.feature_chunk}, "
        f"features {c.features.dtype}, packed source {c.source_packed}; "
        f"data + model {time.perf_counter() - t0:.1f} s")
    if c.feature_chunk is None:
        raise AssertionError("feature tiling did not switch on")
    rt = SamplerRuntime(model, config.mcmc)
    t0 = time.perf_counter()
    states = rt.init_chains(jax.random.PRNGKey(seed), n_chains)
    jax.block_until_ready(states)
    log(f"[tiled] init_chains({n_chains}) incl. compile: {time.perf_counter() - t0:.2f} s")
    carry, times = run_chunks(rt, states, seed, n_chunks, n_steps)
    steady = statistics.median(times[1:]) if len(times) > 1 else times[0]
    log(f"[tiled] first chunk (compile + run): {times[0]:.2f} s; steady chunk "
        f"{1e3 * steady:.2f} ms for {n_steps} steps x {n_chains} chains "
        f"({n_chains * n_steps / steady:.1f} chain-steps/s)")
    log(f"[tiled] peak_bytes_in_use: {peak_bytes(jax.devices()[0])}")
    final = jax.device_get(carry.state)
    if not np.all(np.isfinite(final.log_lh)):
        raise AssertionError("non-finite log_lh in the tiled run")

    # tiled marginals on the card vs untiled on the CPU backend
    state0 = jax.tree.map(lambda x: x[0], final)
    gpu_out = jax.jit(_marginals)(c, jax.device_put(state0, jax.devices()[0]))
    cpu = jax.devices("cpu")[0]
    _, model_cpu = tiled_model(seed, shape, device=cpu)
    untiled = dataclasses.replace(model_cpu.consts, feature_chunk=None)
    with jax.default_device(cpu):
        cpu_out = jax.jit(_marginals)(untiled, jax.device_put(state0, cpu))
    for name, a, b in zip(("log_odds", "log_m0", "log_m1"), gpu_out, cpu_out):
        a, b = np.asarray(a), np.asarray(b)
        gap = np.max(np.abs(a - b) / (MARGINAL_TOL + MARGINAL_TOL * np.abs(b)))
        log(f"[tiled] {name}: worst |tiled GPU - untiled CPU| = "
            f"{np.max(np.abs(a - b)):.3e} ({gap:.4f} of rtol=atol={MARGINAL_TOL})")
        np.testing.assert_allclose(a, b, rtol=MARGINAL_TOL, atol=MARGINAL_TOL)

    # the marginal alone, vmapped over the chains: time per call against
    # the bytes it has to read (the feature tensor and NA mask, once)
    def batch_odds(consts, states):
        def one(s):
            fact = OperatorFactory(Conditionals(Posterior(consts), 1.0, 1.0))
            return fact._cluster_log_odds(s, 0, jnp.ones(consts.N, bool),
                                          counts=(s.cl_counts, s.conf_counts))
        return jax.vmap(one)(states)

    f = jax.jit(batch_odds)
    out = f(c, carry.state)
    jax.block_until_ready(out)
    reps = []
    for _ in range(10):
        t0 = time.perf_counter()
        jax.block_until_ready(f(c, carry.state))
        reps.append(time.perf_counter() - t0)
    t_call = statistics.median(reps)
    need = c.features.size * c.features.dtype.itemsize + c.na.size * c.na.dtype.itemsize
    log(f"[tiled] marginal alone ({n_chains} chains, one call): {1e3 * t_call:.3f} ms; "
        f"reads >= {need / 1e6:.1f} MB -> {need / t_call / 1e9:.1f} GB/s = "
        f"{need / t_call / H100_HBM_BYTES_PER_S:.3f} of 3.35 TB/s")

    # trace of one chunk: the marginal's share of device time
    ones = jnp.ones(n_chains, jnp.float32)
    stats = zero_stats(rt, n_chains)
    compiled = rt._run_chunk._jitted.lower(
        c, carry.key, carry.state, stats, ones, ones, n_steps, True).compile()
    marked = scoped_ops(compiled.as_text(), MARGINAL_SCOPE)
    with tempfile.TemporaryDirectory() as tmp:
        with jax.profiler.trace(tmp):
            carry2 = rt.run_chunk(carry.key, carry.state, stats, ones, ones, n_steps)
            jax.block_until_ready(carry2.state)
        # device events: the GPU's kernel streams (the CPU backend, when
        # the phase is rehearsed there, records its ops on the host plane)
        plane = "/device:GPU" if jax.default_backend() == "gpu" else "/host:CPU"
        summary = summarize(device_events(load_profile(tmp), plane), marked, MARGINAL_SCOPE)
    log(f"[tiled] traced chunk: {json.dumps(summary)}")
    log(f"[tiled] HLO instructions in scope {MARGINAL_SCOPE!r}: {len(marked)}; "
        f"their share of kernel time: {summary['marked_share_of_kernel_time']:.3f}; "
        f"device idle share {summary['idle_share']:.3f}")
    if summary["marked_events"] == 0:
        raise AssertionError("no marginal kernel found in the trace")


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------

def _compile_all(lowered: dict) -> dict:
    """Compile lowered programs in parallel threads (XLA releases the GIL):
    the wall time is that of the slowest, not the sum."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(lowered)) as pool:
        futures = {name: pool.submit(low.compile) for name, low in lowered.items()}
        compiled = {name: f.result() for name, f in futures.items()}
    log(f"[four] compiled {sorted(compiled)} in parallel: {time.perf_counter() - t0:.1f} s")
    return compiled


def phase_four(seed: int, n_cards: int = 4, n_chains: int = 1024, n_chunks: int = 2,
               n_steps: int = 200, mc3_chains: int = 8, mc3_steps: int = 50) -> None:
    """The ensemble and an MC3 chunk, sharded over ``n_cards`` by
    ``shard_ensemble`` and on one card, from the same initial states and
    keys. Per-chain keys do not depend on the layout, so every chain must
    end where it ends on one card and the swaps must be identical."""
    import jax
    import jax.numpy as jnp

    from sbayes_tpu.sampling.runner import SamplerRuntime

    data, config, model = headline_model(seed)
    rt = SamplerRuntime(model, config.mcmc)
    if len(jax.devices()) != n_cards:
        raise AssertionError(f"{n_cards} devices expected, found {len(jax.devices())}")

    t0 = time.perf_counter()
    states0 = rt.init_chains(jax.random.PRNGKey(seed), n_chains, shard=False)
    jax.block_until_ready(states0)
    log(f"[four] init_chains({n_chains}) on one card: {time.perf_counter() - t0:.1f} s")
    keys0 = jax.random.split(jax.random.PRNGKey(seed + 1), n_chains)
    ones = jnp.ones(n_chains, jnp.float32)
    m_states = jax.tree.map(lambda x: x[:mc3_chains], states0)
    m_keys = jax.random.split(jax.random.PRNGKey(seed + 3), mc3_chains)
    m_temps = 1.0 + 0.05 * jnp.arange(mc3_chains, dtype=jnp.float32)
    swap_key = jax.random.PRNGKey(seed + 4)
    mc3_static = (jnp.int32(0), mc3_steps, 5, 4, False)

    inputs = {}
    for layout in ("sharded", "one card"):
        ens = (keys0, states0, zero_stats(rt, n_chains), ones, ones)
        mc3 = (m_keys, m_states, zero_stats(rt, mc3_chains), m_temps, m_temps)
        if layout == "sharded":
            ens = rt.shard_ensemble(n_chains, *ens)
            mc3 = rt.shard_ensemble(mc3_chains, *mc3)
            if len(ens[1].log_lh.sharding.device_set) != n_cards:
                raise AssertionError(f"ensemble not sharded: {ens[1].log_lh.sharding}")
        inputs[layout] = (ens, mc3)

    t0 = time.perf_counter()
    lowered = {}
    for layout, (ens, mc3) in inputs.items():
        lowered[f"chunk/{layout}"] = rt._run_chunk._jitted.lower(
            rt.consts, *ens, n_steps, True)
        k, s, st, T, Tp = mc3
        swaps = jnp.zeros((2, mc3_chains, mc3_chains), jnp.int32)
        lowered[f"mc3/{layout}"] = rt._run_mc3_chunk._jitted.lower(
            rt.consts, k, s, st, T, Tp, swap_key, swaps, *mc3_static)
    log(f"[four] lowered {len(lowered)} programs: {time.perf_counter() - t0:.1f} s")
    compiled = _compile_all(lowered)

    results = {}
    for layout, (ens, mc3) in inputs.items():
        keys, states, stats, T, Tp = ens
        run = compiled[f"chunk/{layout}"]
        times = []
        for _ in range(n_chunks):
            t0 = time.perf_counter()
            keys, states, stats = run(rt.consts, keys, states, stats, T, Tp)
            jax.block_until_ready(states)
            times.append(time.perf_counter() - t0)
        log(f"[four] {layout}: {n_chains} chains x {n_steps} steps, chunks "
            f"{[round(1e3 * t, 2) for t in times]} ms ({n_chains * n_steps / min(times):.0f} "
            f"chain-steps/s); devices {sorted(d.id for d in states.log_lh.sharding.device_set)}")
        k, s, st, T, Tp = mc3
        swaps = jnp.zeros((2, mc3_chains, mc3_chains), jnp.int32)
        out = jax.device_get(compiled[f"mc3/{layout}"](
            rt.consts, k, s, st, T, Tp, swap_key, swaps, mc3_static[0]))
        log(f"[four] {layout}: MC3 chunk ({mc3_chains} chains, {mc3_steps} steps) swaps "
            f"accepted {int(out[4])} of {int(out[5])}")
        results[layout] = (jax.device_get(states), out)

    (f_s, m_s), (f_1, m_1) = results["sharded"], results["one card"]
    for name in ("log_lh", "log_prior"):
        a, b = np.asarray(getattr(f_s, name)), np.asarray(getattr(f_1, name))
        if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
            raise AssertionError(f"non-finite {name}")
        gap = np.abs(a - b) / (1e-3 + 1e-5 * np.abs(b))
        log(f"[four] ensemble {name}: worst sharded-vs-one-card gap {gap.max():.4f} "
            f"of tol over {a.size} chains; chains over tol: {int((gap > 1).sum())}")
        if not np.all(gap <= 1.0):
            raise AssertionError(f"sharded {name} differs from one card")
    _, st_s, _, sw_s, acc_s, att_s = m_s
    _, st_1, _, sw_1, acc_1, att_1 = m_1
    if int(acc_s) != int(acc_1) or int(att_s) != int(att_1) or \
            not np.array_equal(np.asarray(sw_s), np.asarray(sw_1)):
        raise AssertionError("MC3 swap counts differ between layouts")
    gap = np.abs(np.asarray(st_s.log_lh) - np.asarray(st_1.log_lh)) / (
        1e-3 + 1e-5 * np.abs(np.asarray(st_1.log_lh)))
    log(f"[four] MC3: swap counts identical ({int(acc_s)}/{int(att_s)}); worst "
        f"log_lh gap {gap.max():.4f} of tol")
    if not np.all(gap <= 1.0):
        raise AssertionError("sharded MC3 log_lh differs from one card")


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase, over four GPUs")
    ns = ap.parse_args(argv)

    n_cards = 4 if ns.four_cards else 1
    devices = phase_device(n_cards)
    from sbayes_tpu.compile_cache import place_compile_cache

    log(f"[device] compile cache: {place_compile_cache()}")
    t_start = time.perf_counter()
    if ns.four_cards:
        phase_four(ns.seed, n_cards=n_cards)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            phase_cli(ns.seed, Path(tmp))
            log(f"[cli] phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_ensemble(ns.seed)
        log(f"[ensemble] phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_tiled(ns.seed)
        log(f"[tiled] phase: {time.perf_counter() - t0:.1f} s")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(result_line(devices[0].platform, devices[0].device_kind, len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
