"""Measure the reference sBayes sampler's throughput on this machine.

The reference depends on packages not present in this image (numba,
ruamel.yaml, unidecode, pyproj, cartopy, libpysal, tables). This harness
injects thin shims so the reference can run unmodified, then times its MCMC
hot loop on a south_america-shaped synthetic workload.

Shim fidelity notes (to keep the baseline fair):
  * numba @jit/@njit become passthroughs, and the reference's
    numba-vectorized ``gammaln`` is replaced by scipy's C implementation —
    comparable speed to the numba-compiled original for array inputs.
  * pyproj/cartopy geodesics are replaced by a haversine distance matrix —
    only used in one-time preprocessing, not in the timed loop.

Writes benchmarks/reference_baseline.json with measured steps/sec.
"""
from __future__ import annotations

import json
import sys
import time
import types
import unicodedata
from pathlib import Path

import numpy as np

REFERENCE_PATH = "/root/reference"
OUT_PATH = Path(__file__).parent / "reference_baseline.json"


def install_shims():
    # ---- numba ----
    numba = types.ModuleType("numba")

    def _identity_decorator(*dargs, **dkwargs):
        if len(dargs) == 1 and callable(dargs[0]) and not dkwargs:
            return dargs[0]

        def wrap(fn):
            return fn

        return wrap

    def _vectorize(*dargs, **dkwargs):
        def wrap(fn):
            return np.vectorize(fn)

        if len(dargs) == 1 and callable(dargs[0]):
            return np.vectorize(dargs[0])
        return wrap

    numba.jit = _identity_decorator
    numba.njit = _identity_decorator
    numba.vectorize = _vectorize
    for t in ["float32", "float64", "int64", "int32", "boolean"]:
        setattr(numba, t, type(t, (), {"__call__": lambda self, *a: None})())
    sys.modules["numba"] = numba

    # ---- unidecode ----
    unidecode_mod = types.ModuleType("unidecode")
    unidecode_mod.unidecode = lambda s: (
        unicodedata.normalize("NFKD", s).encode("ascii", "ignore").decode("ascii")
    )
    sys.modules["unidecode"] = unidecode_mod

    # ---- ruamel.yaml ----
    import yaml as _pyyaml

    ruamel = types.ModuleType("ruamel")
    ruamel_yaml = types.ModuleType("ruamel.yaml")

    class _YAML:
        def __init__(self, typ="safe"):
            pass

        def load(self, stream):
            if hasattr(stream, "read"):
                return _pyyaml.safe_load(stream)
            return _pyyaml.safe_load(open(stream))

    ruamel_yaml.YAML = _YAML
    ruamel.yaml = ruamel_yaml
    sys.modules["ruamel"] = ruamel
    sys.modules["ruamel.yaml"] = ruamel_yaml

    # ---- pyproj ----
    pyproj = types.ModuleType("pyproj")

    class _CRS:
        def __init__(self, name):
            self.name = name

    class _Transformer:
        @staticmethod
        def from_crs(crs_from=None, crs_to=None):
            class T:
                @staticmethod
                def transform(x, y):
                    return x, y

            return T()

    pyproj.CRS = _CRS
    pyproj.transformer = types.SimpleNamespace(Transformer=_Transformer)
    pyproj.Transformer = _Transformer
    sys.modules["pyproj"] = pyproj
    sys.modules["pyproj.transformer"] = pyproj.transformer  # type: ignore

    # ---- cartopy (Geodesic via haversine) ----
    cartopy = types.ModuleType("cartopy")
    cartopy.__version__ = "0.22.0"
    geodesic_mod = types.ModuleType("cartopy.geodesic")

    class _Geodesic:
        def inverse(self, a, pts):
            a = np.asarray(a, dtype=float)
            pts = np.asarray(pts, dtype=float)
            lon1, lat1 = a[0], a[1]
            lon2, lat2 = pts[:, 0], pts[:, 1]
            R = 6371008.8
            p1, p2 = np.radians(lat1), np.radians(lat2)
            dl = np.radians(lon2 - lon1)
            h = np.sin((p2 - p1) / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
            d = 2 * R * np.arcsin(np.sqrt(np.clip(h, 0, 1)))
            return np.column_stack([d, np.zeros_like(d), np.zeros_like(d)])

    geodesic_mod.Geodesic = _Geodesic
    cartopy.geodesic = geodesic_mod
    sys.modules["cartopy"] = cartopy
    sys.modules["cartopy.geodesic"] = geodesic_mod

    # ---- libpysal (only needed for delaunay geo-prior skeleton) ----
    libpysal = types.ModuleType("libpysal")
    libpysal.cg = types.SimpleNamespace(voronoi_frames=None)
    libpysal.weights = types.SimpleNamespace(Rook=None)
    sys.modules["libpysal"] = libpysal

    # ---- tables (avoid: disable likelihood logging) ----
    tables_mod = types.ModuleType("tables")

    class _HDF5ExtError(Exception):
        pass

    tables_mod.exceptions = types.SimpleNamespace(HDF5ExtError=_HDF5ExtError)
    tables_mod.open_file = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("tables shim"))
    tables_mod.Float32Col = object
    tables_mod.BoolCol = object
    tables_mod.Filters = lambda **k: None
    sys.modules["tables"] = tables_mod

    sys.path.insert(0, REFERENCE_PATH)


def make_dataset(tmpdir: Path, n_objects=100, n_features=36, n_states=6, n_families=6, seed=0):
    """Write a south_america-shaped synthetic CSV dataset."""
    rng = np.random.default_rng(seed)
    n_states_f = rng.integers(2, n_states + 1, size=n_features)
    feats = {}
    fam = rng.integers(0, n_families, size=n_objects)
    rows = []
    for o in range(n_objects):
        row = {
            "id": f"o{o}",
            "name": f"obj{o}",
            "family": f"fam{fam[o]}",
            "x": rng.uniform(-75, -35),
            "y": rng.uniform(-30, 10),
        }
        for f in range(n_features):
            row[f"f{f}"] = f"s{rng.integers(0, n_states_f[f])}"
        rows.append(row)
    import pandas as pd

    df = pd.DataFrame(rows)
    df.to_csv(tmpdir / "features.csv", index=False)

    states = {}
    for f in range(n_features):
        states[f"f{f}"] = [f"s{j}" for j in range(n_states_f[f])] + [None] * (
            n_states - n_states_f[f]
        )
    pd.DataFrame(states).to_csv(tmpdir / "feature_states.csv", index=False)

    config = {
        "data": {
            "features": str(tmpdir / "features.csv"),
            "feature_states": str(tmpdir / "feature_states.csv"),
        },
        "model": {
            "clusters": 3,
            "confounders": ["universal", "family"],
            "prior": {
                "objects_per_cluster": {"type": "uniform_area", "min": 2, "max": 50},
                "geo": {"type": "uniform"},
                "weights": {"type": "uniform"},
                "cluster_effect": {"type": "uniform"},
                "confounding_effects": {
                    "universal": {"<ALL>": {"type": "uniform"}},
                    "family": {"<DEFAULT>": {"type": "uniform"}},
                },
            },
        },
        "mcmc": {
            "steps": 20000,
            "samples": 100,
            "initialization": {"attempts": 1, "em_steps": 10, "objects_per_cluster": 10},
            "warmup": {"warmup_steps": 10, "warmup_chains": 1},
        },
        "results": {"path": str(tmpdir / "results"), "log_likelihood": False,
                    "log_file": False},
    }
    import yaml

    cfg_path = tmpdir / "config.yaml"
    yaml.safe_dump(config, open(cfg_path, "w"))
    return cfg_path


def make_real_config(tmpdir: Path) -> Path:
    """Copy the real south_america config with absolute data/prior paths."""
    import yaml

    src_dir = Path(REFERENCE_PATH) / "experiments" / "south_america"
    cfg = yaml.safe_load(open(src_dir / "config.yaml"))

    def absolutize(node):
        if isinstance(node, dict):
            return {k: (str(src_dir / v) if k in ("features", "feature_states", "file")
                        and isinstance(v, str) else absolutize(v))
                    for k, v in node.items()}
        return node

    cfg = absolutize(cfg)
    cfg["results"] = {"path": str(tmpdir / "results"), "log_likelihood": False,
                      "log_file": False}
    cfg["mcmc"]["runs"] = 1
    cfg_path = tmpdir / "config.yaml"
    yaml.safe_dump(cfg, open(cfg_path, "w"))
    return cfg_path


def main(n_steps=20000, real=False):
    install_shims()

    import scipy.special

    # Patch the numpy-vectorized lgamma with scipy's C gammaln (fair speed)
    import sbayes.util

    sbayes.util.gammaln = scipy.special.gammaln
    import sbayes.model.likelihood  # ensure module-level names rebind where needed

    import tempfile

    tmpdir = Path(tempfile.mkdtemp())
    cfg_path = make_real_config(tmpdir) if real else make_dataset(tmpdir)

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
        model=model, data=data, initial_size=10, attempts=1,
        initial_cluster_steps=True, n_em_steps=10,
    )
    mcmc = MCMC(
        model=model, data=data, operators=experiment.config.mcmc.operators,
        sample_loggers=[], sample_from_prior=False,
        logger=experiment.logger, screen_log_interval=10**9,
    )

    sample = initializer.generate_sample()
    mcmc._ll[0] = mcmc.likelihood(sample, 0)
    mcmc._prior[0] = mcmc.prior(sample, 0)

    # Warm the caches
    for i in range(200):
        sample = mcmc.step(sample, 0)
        sample.i_step = 10**9  # disable CHECK_CACHING asserts

    lh_trace = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        sample = mcmc.step(sample, 0)
        lh_trace.append(mcmc._ll[0] + mcmc._prior[0])
    dt = time.perf_counter() - t0

    steps_per_sec = n_steps / dt

    # ESS of the log-posterior trace with the same estimator used for the
    # JAX sampler (sbayes_tpu.results.ess): apples-to-apples ESS/sec.
    sys.path.insert(0, "/root/repo")
    from sbayes_tpu.results.ess import effective_sample_size

    ess = effective_sample_size(np.asarray(lh_trace, dtype=float))
    result = {
        "workload": (
            "real south_america experiment (100 languages x 36 features, K=3, "
            "6 families, Dirichlet file priors)" if real else
            "synthetic south_america-shaped (100 objects x 36 features x <=6 states, K=3, 6 families)"
        ),
        "n_steps": n_steps,
        "seconds": dt,
        "steps_per_sec": steps_per_sec,
        "log_posterior_ess": ess,
        "ess_per_sec": ess / dt,
        "machine": "driver CPU, single core (reference has no intra-chain parallelism)",
        "notes": "numba shimmed with scipy gammaln; geodesics shimmed (preprocessing only)",
    }
    out = OUT_PATH.parent / "reference_baseline_real.json" if real else OUT_PATH
    out.write_text(json.dumps(result, indent=2))
    print(json.dumps(result))


if __name__ == "__main__":
    main(real="--real" in sys.argv)
