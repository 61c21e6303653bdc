"""Synthetic-data simulation from the generative model.

Counterpart of the reference simulation subsystem (sbayes/simulation.py +
sbayes/preprocessing.py:24-89, 320-394): reads a canvas CSV with ground-
truth cluster and confounder columns, simulates mixture weights (Dirichlet
over effect intensities), per-group categorical effects (symmetric
Dirichlet with configured concentration), samples features from the
mixture, and writes ``simulated_features.csv`` +
``simulated_feature_states.csv`` in the format the analysis pipeline reads.

Run via ``python -m sbayes_tpu.simulation <config.json>``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
from pathlib import Path

import numpy as np

from sbayes_tpu.utils import (
    PathLike,
    decompose_config_path,
    fix_relative_path,
    iter_items_recursive,
    set_defaults,
)

REQUIRED = "<REQUIRED>"

DEFAULT_CONFIG = {
    "canvas": REQUIRED,
    "results": {"path": ""},
    "n_features": 20,
    "n_states": {"2": 0.4, "3": 0.3, "4": 0.3},
    "cluster_effect": REQUIRED,
    "confounding_effects": REQUIRED,
    "seed": None,
}


def load_canvas(canvas_path: PathLike, confounder_names) -> dict:
    """Read the simulation canvas CSV: columns id, x, y, cluster + one
    column per confounder; empty cells mean 'no group' (encoded 0)."""
    import pandas as pd

    df = pd.read_csv(canvas_path, dtype=str, keep_default_na=False)
    for col in ["id", "x", "y", "cluster"]:
        if col not in df.columns:
            raise KeyError(f"The canvas csv ('{canvas_path}') must contain columns `x`, `y`, `id` and `cluster`")
    confounders = {}
    for name in confounder_names:
        if name not in df.columns:
            raise KeyError(f"The canvas csv ('{canvas_path}') must contain the column '{name}'.")
        confounders[name] = [v if len(v) else "0" for v in df[name]]

    return {
        "locations": np.column_stack([df["x"].astype(float), df["y"].astype(float)]),
        "id": df["id"].tolist(),
        "cluster": [int(z) if len(z) else 0 for z in df["cluster"]],
        "confounders": confounders,
    }


def assign_to_cluster(sites) -> np.ndarray:
    """(n_clusters, n_sites) membership from the canvas `cluster` column
    (0 = no cluster)."""
    labels = np.asarray(sites["cluster"], dtype=int)
    cluster_ids = sorted(set(labels) - {0})
    clusters = np.zeros((len(cluster_ids), len(labels)), dtype=bool)
    for i, cid in enumerate(cluster_ids):
        clusters[i] = labels == cid
    return clusters


def assign_to_confounders(sites) -> dict:
    """Per-confounder group membership matrices from canvas columns."""
    out = {}
    for name, labels in sites["confounders"].items():
        labels = np.asarray(labels)
        group_names = sorted(set(labels) - {"0"})
        membership = np.zeros((len(group_names), len(labels)), dtype=bool)
        for i, g in enumerate(group_names):
            membership[i] = labels == g
        out[name] = {"membership": membership, "names": group_names}
    return out


def simulate_weights(config, rng) -> np.ndarray:
    """(n_features, 1 + n_confounders) Dirichlet weights over intensities."""
    alpha = [config["cluster_effect"]["intensity"]]
    for v in config["confounding_effects"].values():
        alpha.append(v["intensity"])
    return rng.dirichlet(alpha, config["n_features"])


def draw_n_states_per_feature(config, rng) -> list[int]:
    """Number of states per feature from the configured fractions."""
    n_features = config["n_features"]
    n_states_per_feature: list[int] = []
    for k, frac in config["n_states"].items():
        n_states_per_feature.extend([int(k)] * int(n_features * frac))
    if len(n_states_per_feature) < n_features:
        missing = n_features - len(n_states_per_feature)
        n_states_per_feature.extend(rng.choice(n_states_per_feature, missing).tolist())
    n_states_per_feature = n_states_per_feature[:n_features]
    rng.shuffle(n_states_per_feature)
    return n_states_per_feature


def simulate_assignment_probabilities(config, clusters, confounders, n_states_per_feature, rng):
    """Per-effect categorical distributions drawn from symmetric Dirichlets."""
    n_features = config["n_features"]
    max_states = max(n_states_per_feature)
    n_clusters = clusters.shape[0]

    def draw_probs(n_groups, concentration):
        p = np.zeros((n_groups, n_features, max_states), dtype=float)
        for feat in range(n_features):
            s = n_states_per_feature[feat]
            alpha = np.full(s, concentration)
            p[:, feat, :s] = rng.dirichlet(alpha, size=n_groups)
        return p

    probs = {"cluster_effect": draw_probs(n_clusters, config["cluster_effect"]["concentration"])}
    for name, v in confounders.items():
        probs[name] = draw_probs(
            v["membership"].shape[0], config["confounding_effects"][name]["concentration"]
        )
    return probs


def simulate_features(clusters, confounders, probabilities, weights, rng) -> np.ndarray:
    """(n_sites, n_features) integer state indices sampled from the mixture."""
    n_clusters, n_sites = clusters.shape
    _, n_features, n_states = probabilities["cluster_effect"].shape
    assert np.allclose(weights.sum(-1), 1.0)

    # Which components are available at each site
    assignment = [np.any(clusters, axis=0)]
    for v in confounders.values():
        assignment.append(np.any(v["membership"], axis=0))
    has_components = np.column_stack(assignment)

    w = weights[None, :, :] * has_components[:, None, :]
    w = w / w.sum(-1, keepdims=True)  # (n_sites, n_features, C)

    # Mixture likelihood per site/feature/state
    lh = w[:, :, 0, None] * np.einsum("kn,kfs->nfs", clusters.astype(float),
                                      probabilities["cluster_effect"])
    for i, (name, v) in enumerate(confounders.items(), start=1):
        lh += w[:, :, i, None] * np.einsum(
            "gn,gfs->nfs", v["membership"].astype(float), probabilities[name]
        )

    # Sample a state per (site, feature)
    cdf = np.cumsum(lh, axis=-1)
    cdf /= cdf[..., [-1]]
    u = rng.random((n_sites, n_features, 1))
    return np.argmax(u < cdf, axis=-1)


class Simulation:
    def __init__(self, log: bool = True):
        self.config: dict = {}
        self.config_file = None
        self.base_directory = None
        self.path_results = None
        self.logger = logging.Logger("simulationLogger", level=logging.DEBUG)
        self.logger.addHandler(logging.StreamHandler())

        self.sites = None
        self.network = None
        self.clusters = None
        self.confounders = None
        self.weights = None
        self.probabilities = None
        self.features = None
        self.n_states_per_feature = None

    def load_config_simulation(self, config_file: PathLike):
        self.base_directory, self.config_file = decompose_config_path(config_file)
        with open(self.config_file, "r") as f:
            self.config = json.load(f)
        set_defaults(self.config, DEFAULT_CONFIG)

        for key, value, loc in iter_items_recursive(self.config):
            if value == REQUIRED:
                loc_string = ": ".join(f'"{k}"' for k in (loc + (key, REQUIRED)))
                raise NameError(
                    f"The value for a required field is not defined in {self.config_file}:\n\t{loc_string}"
                )

        self.config["canvas"] = fix_relative_path(self.config["canvas"], self.base_directory)
        self.path_results = fix_relative_path(self.config["results"]["path"], self.base_directory)
        os.makedirs(self.path_results, exist_ok=True)
        self.logger.addHandler(logging.FileHandler(self.path_results / "simulation.log"))

    def run_simulation(self):
        rng = np.random.default_rng(self.config.get("seed"))
        self.sites = load_canvas(self.config["canvas"], self.config["confounding_effects"].keys())
        self.clusters = assign_to_cluster(self.sites)
        self.confounders = assign_to_confounders(self.sites)
        self.weights = simulate_weights(self.config, rng)
        self.n_states_per_feature = draw_n_states_per_feature(self.config, rng)
        self.probabilities = simulate_assignment_probabilities(
            self.config, self.clusters, self.confounders, self.n_states_per_feature, rng
        )
        self.features = simulate_features(
            self.clusters, self.confounders, self.probabilities, self.weights, rng
        )

    def write_to_csv(self):
        n_sites, n_features = self.features.shape
        out = {
            "id": self.sites["id"],
            "x": self.sites["locations"][:, 0],
            "y": self.sites["locations"][:, 1],
        }
        for k, v in self.sites["confounders"].items():
            out[k] = v
        feature_names = [f"f{i + 1}" for i in range(n_features)]
        for i, fname in enumerate(feature_names):
            out[fname] = self.features[:, i]
        import pandas as pd

        pd.DataFrame(out).to_csv(self.path_results / "simulated_features.csv", index=False)

        states_per_feature = [
            [str(s) for s in sorted(set(self.features[:, i]))] for i in range(n_features)
        ]
        rows = list(itertools.zip_longest(*states_per_feature))
        pd.DataFrame(rows, columns=feature_names).to_csv(
            self.path_results / "simulated_feature_states.csv", index=False
        )

    def write_ground_truth(self):
        """Additionally dump the simulated ground truth (clusters, weights)."""
        np.savetxt(self.path_results / "ground_truth_clusters.txt",
                   self.clusters.astype(int), fmt="%i")
        np.savetxt(self.path_results / "ground_truth_weights.txt", self.weights)


def main(config_path: PathLike):
    sim = Simulation()
    sim.load_config_simulation(config_file=config_path)
    sim.run_simulation()
    sim.write_to_csv()
    sim.write_ground_truth()


def cli(args=None):
    parser = argparse.ArgumentParser(description="Simulations for sbayes_tpu")
    parser.add_argument("config", type=Path, help="The JSON configuration file")
    ns = parser.parse_args(args)
    main(config_path=ns.config)


if __name__ == "__main__":
    cli()
