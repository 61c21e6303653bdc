"""Command-line interface.

Mirrors the reference CLI contract (sbayes/cli.py): positional config file,
``-n/--name -t/--threads -r/--resume -K/--numClusters -i/--runID`` and one
run per (run_id x n_clusters) combination. Everything runs in this one
process: the runs of one K are a single vmapped chain ensemble, which
replaces the reference's process pool, and a second JAX process could not
share the accelerator anyway. ``--threads`` is accepted for compatibility
and changes nothing.
"""
from __future__ import annotations

import argparse
import warnings
from copy import deepcopy
from itertools import product
from pathlib import Path

from sbayes_tpu.compile_cache import place_compile_cache
from sbayes_tpu.experiment import Experiment
from sbayes_tpu.utils import PathLike, update_recursive


def run_experiment(
    config: PathLike,
    experiment_name: str,
    custom_settings: dict = None,
    resume: bool = False,
    i_run: int = 0,
):
    from sbayes_tpu.data.loader import Data
    from sbayes_tpu.sampling.runner import MCMCSetup

    experiment = Experiment(
        config_file=config,
        experiment_name=experiment_name,
        custom_settings=custom_settings,
        log=True,
        i_run=i_run,
    )
    data = Data.from_experiment(experiment)
    data.logger = None

    mcmc = MCMCSetup(data=data, experiment=experiment)
    mcmc.log_setup()

    if experiment.config.mcmc.mc3.activate:
        mcmc.sample_mc3(run=i_run, resume=resume)
    else:
        mcmc.sample(run=i_run, resume=resume)


def run_one(i_run, n_clusters, config, experiment_name, custom_settings, resume):
    """Run one (run_id, n_clusters) configuration as a single chain."""
    run_settings = deepcopy(custom_settings) if custom_settings else {}
    update_recursive(run_settings, {"model": {"clusters": n_clusters}, "mcmc": {"runs": 1}})
    run_experiment(
        config=config,
        experiment_name=experiment_name,
        custom_settings=run_settings,
        resume=resume,
        i_run=i_run,
    )


def main(
    config: PathLike,
    experiment_name: str = None,
    custom_settings: dict = None,
    processes: int = 1,
    resume: bool = False,
    n_clusters=None,
    i_run: int = None,
):
    """Run every (run_id x n_clusters) combination of a config in this
    process. ``processes`` is kept for CLI compatibility and ignored."""
    place_compile_cache()
    if processes > 1:
        warnings.warn(f"--threads={processes} is ignored: all runs execute in this process.")
    experiment = Experiment(
        config_file=config,
        experiment_name=experiment_name,
        custom_settings=custom_settings,
        log=False,
    )

    n_runs = experiment.config.mcmc.runs
    i_run_range = list(range(n_runs)) if i_run is None else [i_run]

    if n_clusters is None:
        n_clusters = experiment.config.model.clusters
    else:
        warnings.warn(
            f"The number of clusters was set as a command-line argument, so the config "
            f"entry `clusters={experiment.config.model.clusters}` will be ignored."
        )
    if isinstance(n_clusters, int):
        n_clusters = [n_clusters]

    mc3_active = experiment.config.mcmc.mc3.activate

    if len(i_run_range) > 1 and not resume and not mc3_active:
        # All runs of one K execute as a single vmapped ensemble (the
        # reference loops them sequentially or through a process pool).
        for k in n_clusters:
            run_settings = deepcopy(custom_settings) if custom_settings else {}
            update_recursive(run_settings, {"model": {"clusters": int(k)}})
            ensemble_experiment = Experiment(
                config_file=config,
                experiment_name=experiment.experiment_name,
                custom_settings=run_settings,
                log=True,
                i_run=i_run_range[0],
            )
            from sbayes_tpu.data.loader import Data
            from sbayes_tpu.sampling.runner import MCMCSetup

            data = Data.from_experiment(ensemble_experiment)
            data.logger = None
            mcmc = MCMCSetup(data=data, experiment=ensemble_experiment)
            mcmc.log_setup()
            mcmc.sample_ensemble(run_ids=i_run_range, resume=False)
        return

    for i, k in product(i_run_range, n_clusters):
        run_one(i, k, config, experiment.experiment_name, custom_settings, resume)


def _ask_config_file_dialog() -> "str | None":
    """File-dialog fallback when no config argument is given (reference:
    cli.py:161-173). Returns None when no usable GUI exists (headless
    environment, tkinter missing, or no display)."""
    import os
    import sys

    if not (sys.stdin.isatty() and (os.environ.get("DISPLAY")
                                    or sys.platform in ("win32", "darwin"))):
        return None
    try:
        import tkinter as tk
        from tkinter import filedialog
    except ImportError:
        return None
    try:
        tk.Tk().withdraw()
        return filedialog.askopenfilename(
            title="Select a config file in YAML or JSON format.",
            initialdir="..",
            filetypes=(("json files", ".json"),
                       ("yaml files", ".yaml .yml"),
                       ("all files", "*.*")),
        ) or None
    except tk.TclError:
        return None


def _str2bool(v: str) -> bool:
    if v.lower() in ("1", "true", "yes", "y", "on"):
        return True
    if v.lower() in ("0", "false", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"Expected a boolean, got {v!r}")


def cli(args=None):
    parser = argparse.ArgumentParser(
        description="MCMC on an accelerator to detect clusters in the presence of confounders."
    )
    parser.add_argument("config", type=Path, nargs="?",
                        help="The YAML (or JSON) configuration file")
    parser.add_argument("-n", "--name", nargs="?", type=str,
                        help="Experiment name (results directory; default: date/time).")
    parser.add_argument("-t", "--threads", nargs="?", type=int, default=1,
                        help="Accepted for compatibility; all runs execute in one process.")
    # NOT type=bool: argparse's bool("False") == True (the reference has
    # this wart, cli.py:142-146; fixed here). Bare `-r` means resume=True.
    parser.add_argument("-r", "--resume", nargs="?", type=_str2bool,
                        const=True, default=False,
                        help="Resume a previous run (requires matching name, runID, K).")
    parser.add_argument("-K", "--numClusters", nargs="*", type=int,
                        help="Number of clusters (overrides config; multiple => multiple runs).")
    parser.add_argument("-i", "--runID", nargs="?", type=int,
                        help="Index of this run (to distinguish runs with the same K/name).")
    ns = parser.parse_args(args)

    config = ns.config
    if config is None:
        # Reference parity (cli.py:161-173): ask for the config via a file
        # dialog when none was given. Only attempt the GUI on an interactive
        # display; headless machines get a readable error instead of a
        # tkinter TclError traceback.
        config = _ask_config_file_dialog()
        if not config:
            parser.error("A config file is required (no config argument and "
                         "no interactive display for the file dialog).")
    if not Path(config).is_file():
        parser.error(f"Config file not found: {config}")

    main(config=config, experiment_name=ns.name, processes=ns.threads,
         resume=ns.resume, n_clusters=ns.numClusters, i_run=ns.runID)


if __name__ == "__main__":
    cli()
