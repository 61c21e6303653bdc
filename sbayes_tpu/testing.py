"""Synthetic in-memory datasets + configs for benchmarks and harness entry.

Generates data in the generative model's own terms (mixture of cluster and
confounder effects); ``write_reference_csvs`` writes such a dataset in the
reference's CSV format for runs through the CLI.
"""
from __future__ import annotations

import csv
from collections import OrderedDict
from pathlib import Path

import numpy as np

from sbayes_tpu.config.schema import SBayesConfig
from sbayes_tpu.data.loader import Confounder, Data, Features, Objects


def synthetic_data(
    n_objects: int = 100,
    n_features: int = 36,
    n_states: int = 6,
    n_families: int = 6,
    seed: int = 0,
) -> Data:
    """A synthetic dataset shaped like the south_america case study."""
    rng = np.random.default_rng(seed)

    locations = rng.uniform(-75, -35, size=(n_objects, 2))
    ids = [f"o{i}" for i in range(n_objects)]
    objects = Objects(id=ids, locations=locations, names=list(ids))

    # applicable states: between 2 and n_states per feature
    n_states_f = rng.integers(2, n_states + 1, size=n_features)
    applicable = np.zeros((n_features, n_states), dtype=bool)
    for f in range(n_features):
        applicable[f, : n_states_f[f]] = True

    # draw features from random per-family categorical distributions
    family_of = rng.integers(0, n_families, size=n_objects)
    probs = rng.dirichlet(np.ones(n_states), size=(n_families, n_features))
    probs = np.where(applicable[None], probs, 0.0)
    probs /= probs.sum(-1, keepdims=True)

    values = np.zeros((n_objects, n_features, n_states), dtype=bool)
    for o in range(n_objects):
        for f in range(n_features):
            s = rng.choice(n_states, p=probs[family_of[o], f])
            values[o, f, s] = True
    # sprinkle some NA
    na_mask = rng.random((n_objects, n_features)) < 0.02
    values[na_mask] = False

    state_names = [[f"s{j}" for j in range(n_states_f[f])] for f in range(n_features)]
    features = Features(
        values=values,
        names=np.asarray([f"f{j}" for j in range(n_features)]),
        states=applicable,
        state_names=state_names,
        na_number=int(na_mask.sum()),
    )

    fam_names = [f"fam{i}" for i in range(n_families)]
    fam_assign = np.zeros((n_families, n_objects), dtype=bool)
    for i in range(n_families):
        fam_assign[i, family_of == i] = True
    confounders = OrderedDict(
        universal=Confounder("universal", np.ones((1, n_objects), bool), ["<ALL>"]),
        family=Confounder("family", fam_assign, fam_names),
    )

    return Data(objects=objects, features=features, confounders=confounders,
                projection="epsg:4326", geo_costs="from_data")


def synthetic_config(
    n_clusters: int = 3,
    steps: int = 100_000,
    samples: int = 100,
    geo_prior: str = "uniform",
    rate: float = 1e6,
) -> SBayesConfig:
    """A config dict matching the synthetic data (no files involved)."""
    geo = {"type": geo_prior}
    if geo_prior == "cost_based":
        geo.update({"rate": rate, "aggregation": "mean"})
    cfg = {
        "data": {"features": __file__, "feature_states": __file__},  # placeholders, not read
        "model": {
            "clusters": n_clusters,
            "confounders": ["universal", "family"],
            "prior": {
                "objects_per_cluster": {"type": "uniform_area", "min": 2, "max": 50},
                "geo": geo,
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
            "initialization": {"attempts": 2, "em_steps": 20, "objects_per_cluster": 10},
            "warmup": {"warmup_steps": 100, "warmup_chains": 2},
        },
        "results": {"path": "/tmp/sbayes_tpu_results", "log_file": False},
    }
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return SBayesConfig(**cfg)


def write_reference_csvs(data: Data, directory) -> tuple[Path, Path]:
    """Write ``data`` as the reference's ``features.csv`` (id, name, x, y,
    one column per confounder that has a column, one per feature; blank =
    NA) and ``feature_states.csv`` (one column of state names per
    feature). Returns both paths."""
    directory = Path(directory)
    feats = data.features
    conf_cols = [name for name, conf in data.confounders.items()
                 if conf.group_names != ["<ALL>"]]
    features_path = directory / "features.csv"
    with open(features_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "name", "x", "y", *conf_cols, *feats.names])
        for n in range(feats.n_objects):
            groups = []
            for name in conf_cols:
                conf = data.confounders[name]
                member = conf.group_assignment[:, n]
                groups.append(conf.group_names[int(member.argmax())] if member.any() else "")
            states = [feats.state_names[i_f][int(feats.values[n, i_f].argmax())]
                      if feats.values[n, i_f].any() else ""
                      for i_f in range(feats.n_features)]
            x, y = data.objects.locations[n]
            w.writerow([data.objects.id[n], data.objects.names[n], repr(float(x)),
                        repr(float(y)), *groups, *states])
    states_path = directory / "feature_states.csv"
    n_rows = max(len(s) for s in feats.state_names)
    with open(states_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(feats.names))
        for r in range(n_rows):
            w.writerow([s[r] if r < len(s) else "" for s in feats.state_names])
    return features_path, states_path
