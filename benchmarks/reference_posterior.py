"""Collect the REFERENCE sampler's posterior on the real south_america
experiment for the head-to-head comparison (BASELINE.json north-star
clause: "cluster posteriors matching within MCSE").

Runs the shimmed reference (same harness as reference_baseline.py) on the
real config at a reduced step count (the full 5M steps is ~16 h on this
single-core host, so the schedule is subsampled) and
records:

  * per-object cluster membership samples (n_samples, K, N) bool
  * the log-posterior trace at every sample point
  * wall time / steps for the throughput record

    nice -n 19 python benchmarks/reference_posterior.py [n_steps] [sample_interval]

Writes benchmarks/reference_posterior_real.npz
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))
from reference_baseline import install_shims, make_real_config  # noqa: E402

OUT = Path(__file__).parent / "reference_posterior_real.npz"


def main(n_steps=1_200_000, sample_interval=600):
    install_shims()
    import scipy.special
    import sbayes.util

    sbayes.util.gammaln = scipy.special.gammaln

    import tempfile

    tmpdir = Path(tempfile.mkdtemp())
    cfg_path = make_real_config(tmpdir)

    from sbayes.experiment_setup import Experiment
    from sbayes.load_data import Data
    from sbayes.model import Model
    from sbayes.sampling.initializers import SbayesInitializer
    from sbayes.sampling.mcmc import MCMC

    experiment = Experiment(config_file=cfg_path, experiment_name="bench", log=False)
    import logging

    experiment.logger = logging.getLogger("bench")
    data = Data.from_experiment(experiment)
    model = Model(data=data, config=experiment.config.model)

    initializer = SbayesInitializer(
        model=model, data=data, initial_size=10, attempts=5,
        initial_cluster_steps=True, n_em_steps=50,
    )
    mcmc = MCMC(
        model=model, data=data, operators=experiment.config.mcmc.operators,
        sample_loggers=[], sample_from_prior=False,
        logger=experiment.logger, screen_log_interval=10**9,
    )

    sample = initializer.generate_sample()
    mcmc._ll[0] = mcmc.likelihood(sample, 0)
    mcmc._prior[0] = mcmc.prior(sample, 0)

    for _ in range(200):
        sample = mcmc.step(sample, 0)
        sample.i_step = 10**9  # disable CHECK_CACHING asserts

    clusters_trace = []
    lp_trace = []
    t0 = time.perf_counter()
    done = 0
    for i in range(n_steps):
        sample = mcmc.step(sample, 0)
        done += 1
        if (i + 1) % sample_interval == 0:
            clusters_trace.append(np.array(sample.clusters.value, dtype=bool))
            lp_trace.append(float(mcmc._ll[0] + mcmc._prior[0]))
        if (i + 1) % 50_000 == 0:
            dt = time.perf_counter() - t0
            print(f"{i+1}/{n_steps} steps  {done/dt:.1f} steps/s  "
                  f"lp={mcmc._ll[0] + mcmc._prior[0]:.1f}", flush=True)
            # incremental save so a partial run is still usable
            np.savez_compressed(
                OUT,
                clusters=np.array(clusters_trace, dtype=bool),
                log_posterior=np.array(lp_trace),
                meta=json.dumps({
                    "n_steps": i + 1, "sample_interval": sample_interval,
                    "seconds": dt, "steps_per_sec": done / dt,
                    "workload": "real south_america config (reduced steps)",
                }),
            )
    dt = time.perf_counter() - t0
    np.savez_compressed(
        OUT,
        clusters=np.array(clusters_trace, dtype=bool),
        log_posterior=np.array(lp_trace),
        meta=json.dumps({
            "n_steps": n_steps, "sample_interval": sample_interval,
            "seconds": dt, "steps_per_sec": n_steps / dt,
            "workload": "real south_america config (reduced steps)",
        }),
    )
    print(f"done: {n_steps} steps in {dt:.0f}s -> {OUT}", flush=True)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)
