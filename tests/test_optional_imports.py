"""The sampler runs without pandas, h5py, psutil and PyYAML: a JSON config
through the CLI, with those imports blocked in a fresh interpreter. With
the HDF5 likelihood log on, the run fails at set-up and names the
config key."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import yaml

FIXTURES = Path(__file__).parent / "fixtures"
REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib.abc, json, sys
BLOCKED = {"pandas", "h5py", "psutil", "yaml"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"No module named {name!r} (blocked)")
        return None

sys.meta_path.insert(0, Block())
from sbayes_tpu.cli import cli

cfg_path = sys.argv[1]
cfg = json.load(open(cfg_path))
cfg["results"]["log_likelihood"] = True
h5_path = cfg_path.replace(".json", "_h5.json")
json.dump(cfg, open(h5_path, "w"))
try:
    cli([h5_path, "-n", "with_h5"])
except ImportError as e:
    assert "results.log_likelihood" in str(e), e
else:
    sys.exit("the HDF5 log ran without h5py")
cli([cfg_path, "-n", "plain"])
loaded = sorted(m for m in BLOCKED if m in sys.modules)
assert not loaded, loaded
print("BLOCKED_IMPORTS_OK")
"""


def test_cli_runs_without_optional_packages(tmp_path):
    for name in ("features.csv", "feature_states.csv"):
        shutil.copy(FIXTURES / name, tmp_path / name)
    cfg = yaml.safe_load((FIXTURES / "config.yaml").read_text())
    cfg["mcmc"].update(steps=40, samples=2)
    cfg["mcmc"]["warmup"]["warmup_steps"] = 10
    cfg["results"] = {"path": "results", "log_file": False, "log_likelihood": False,
                      "log_operator_step_times": False}
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(cfg_path)], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_IMPORTS_OK" in proc.stdout
    k_dir = tmp_path / "results" / "plain" / "K1"
    stats = (k_dir / "stats_K1_0.txt").read_text().splitlines()
    assert stats[0].startswith("Sample\tposterior\tlikelihood\tprior")
    assert len(stats) == 3
    assert not list(k_dir.glob("*.h5"))
