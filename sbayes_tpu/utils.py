"""Host-side utilities: encodings, combinatorics, config-dict helpers.

Behavioral counterpart of the reference's ``sbayes/util.py`` (math kernels,
state encodings, graph helpers); everything device-side lives in
``sbayes_tpu.model.math`` / ``sbayes_tpu.ops`` instead.
"""
from __future__ import annotations

import csv
import math
import unicodedata
from pathlib import Path
from typing import Sequence, Union

import numpy as np
from numpy.typing import NDArray
from scipy.optimize import linear_sum_assignment
from scipy.special import betaln

FLOAT_TYPE = np.float32
INT_TYPE = np.int64
EPS = np.finfo(FLOAT_TYPE).eps
LOG_EPS = np.finfo(FLOAT_TYPE).min

PathLike = Union[str, Path]


class FamilyError(Exception):
    pass


# ---------------------------------------------------------------------------
# Cluster bit-string encoding (results-file format contract)
# Reference behavior: sbayes/util.py:61-81
# ---------------------------------------------------------------------------

def encode_cluster(cluster: NDArray[np.bool_]) -> str:
    """Format one cluster as a compact '0'/'1' bit-string."""
    return "".join("1" if x else "0" for x in cluster)


def decode_cluster(cluster_str: str) -> NDArray[np.bool_]:
    """Parse a bit-string back into a boolean membership array."""
    return np.fromiter(cluster_str, dtype="U1").astype(int).astype(bool)


def format_cluster_columns(clusters: NDArray[np.bool_]) -> str:
    """Tab-separate the bit-strings of all clusters in a sample."""
    return "\t".join(encode_cluster(c) for c in clusters)


def parse_cluster_columns(clusters_encoded: str) -> NDArray[np.bool_]:
    """Read tab-separated bit-strings into a (n_clusters, n_objects) array."""
    return np.array([decode_cluster(c) for c in clusters_encoded.split("\t")])


# ---------------------------------------------------------------------------
# Combinatorics (cluster-size prior; reference: sbayes/util.py:1104-1173)
# ---------------------------------------------------------------------------

def log_binom(n, k):
    """log(n choose k), vectorized over either argument."""
    return -betaln(1 + np.asarray(n) - np.asarray(k), 1 + np.asarray(k)) - np.log(np.asarray(n) + 1)


def log_multinom(n: int, ks: Sequence[int]) -> float:
    """log of the multinomial coefficient log(n choose k1,k2,...).

    The sum of the sample sizes may not exceed the population size ``n``.
    """
    ks = np.asarray(ks)
    if np.sum(ks) == 0:
        return 0.0
    ks = ks[ks > 0]

    log_i = np.log(1 + np.arange(n))
    log_i_cumsum = np.cumsum(log_i)

    m = np.sum(log_i)
    m -= np.sum(log_i_cumsum[ks - 1])
    rest = n - np.sum(ks)
    if rest > 0:
        m -= log_i_cumsum[rest - 1]
    return float(m)


def normalize(x, axis=-1):
    """Normalize so the given axis sums to 1 (float32, like the reference)."""
    x = np.asarray(x)
    assert np.all(np.sum(x, axis=axis) > 0), np.min(x)
    return (x / np.sum(x, axis=axis, keepdims=True)).astype(FLOAT_TYPE)


def heat_binary_probability(p, temperature: float):
    """p**(1/T) renormalized against (1-p)**(1/T)."""
    pow_ = 1 / temperature
    p_pow = np.asarray(p) ** pow_
    return p_pow / (p_pow + (1 - np.asarray(p)) ** pow_)


# ---------------------------------------------------------------------------
# Cluster alignment (Hungarian; reference: sbayes/util.py:1249-1255)
# ---------------------------------------------------------------------------

def get_best_permutation(
    clusters: NDArray[np.bool_],       # (n_clusters, n_objects)
    prev_cluster_sum: NDArray[np.int_],  # (n_clusters, n_objects)
) -> NDArray[np.int_]:
    """Permutation of cluster labels maximizing agreement with running sums."""
    agreement = np.matmul(prev_cluster_sum.astype(float), clusters.T.astype(float))
    return linear_sum_assignment(agreement, maximize=True)[1]


# ---------------------------------------------------------------------------
# Graph neighbourhoods (reference: sbayes/util.py:121-143)
# ---------------------------------------------------------------------------

def get_neighbours(cluster, already_in_cluster, adjacency_matrix, indirection: int = 0):
    """Neighbourhood of a cluster in the adjacency graph, excluding occupied objects."""
    reachable = adjacency_matrix.dot(cluster)
    for _ in range(indirection):
        reachable = adjacency_matrix.dot(reachable)
    return np.logical_and(reachable, ~already_in_cluster)


# ---------------------------------------------------------------------------
# CSV I/O with the reference's NA & unicode conventions
# (reference: sbayes/util.py:349-379)
# ---------------------------------------------------------------------------

def _ascii_fold(s: str) -> str:
    """Fold unicode to its closest ASCII representation (unidecode-lite)."""
    return unicodedata.normalize("NFKD", s).encode("ascii", "ignore").decode("ascii")


# Cells read as NA (exact matches, before stripping), as in the reference.
NA_STRINGS = ("", " ", "\t", "  ")


def normalize_str(s):
    """Strip and ASCII-fold a cell; NA (None or NaN) passes through."""
    if s is None or (isinstance(s, float) and math.isnan(s)):
        return s
    return _ascii_fold(str.strip(str(s)))


def _read_csv_rows(csv_path: PathLike) -> list[list[str]]:
    with open(csv_path, newline="", encoding="utf-8-sig") as f:
        return [row for row in csv.reader(f) if row]


def read_csv_columns(csv_path: PathLike) -> dict[str, list]:
    """Read a data CSV as ``{column: [cell, ...]}`` with the stdlib reader.

    Column names and cells are ASCII-folded and stripped; cells in
    ``NA_STRINGS`` become None. Short rows are padded with NA."""
    rows = _read_csv_rows(csv_path)
    header = [_ascii_fold(c) for c in rows[0]]
    columns: dict[str, list] = {h: [] for h in header}
    for row in rows[1:]:
        row = row + [""] * (len(header) - len(row))
        for h, v in zip(header, row):
            columns[h].append(None if v in NA_STRINGS else normalize_str(v))
    return columns


def read_data_csv(csv_path: PathLike):
    """``read_csv_columns`` as a pandas DataFrame (NA cells are None), for
    the post-processing tools; the sampler itself does not need pandas."""
    import pandas as pd

    return pd.DataFrame(read_csv_columns(csv_path))


def read_costs_from_csv(file: PathLike, logger=None):
    """Read a cost matrix CSV: the header row names the columns, the first
    column names the rows. Returns (row_names, column_names, (R, C) float
    array)."""
    rows = _read_csv_rows(file)
    col_names = rows[0][1:]
    row_names = [r[0] for r in rows[1:]]
    values = np.asarray([[float(x) for x in r[1:]] for r in rows[1:]], dtype=float)
    if logger:
        logger.info(f"Geographical cost matrix read from {file}.")
    return row_names, col_names, values


def range_like(a):
    return list(range(len(a)))


# ---------------------------------------------------------------------------
# One-hot encoding of categorical data
# (reference behavior: sbayes/util.py:294-346)
# ---------------------------------------------------------------------------

def encode_states(features_raw: dict, feature_states: dict):
    """Encode raw categorical features as a one-hot boolean tensor.

    ``feature_states`` maps each feature to the column of its legal state
    labels (shorter lists are NA-padded); ``features_raw`` maps each
    feature to the observed label per object (``read_csv_columns``
    output). NA observations stay all-zero rows.

    Returns (dict with 'values' / 'states' applicable-state mask /
    'state_names', n_NA). Behavior matches reference util.py:294-346.
    """
    columns = list(feature_states)
    n_states = len(feature_states[columns[0]]) if columns else 0
    n_objects = len(features_raw[columns[0]]) if columns else 0

    state_names = [[s for s in feature_states[c] if s is not None] for c in columns]
    # applicable-state mask: state slot s is legal for feature f iff the
    # feature_states cell is not NA
    applicable_states = np.asarray(
        [[s is not None for s in feature_states[c]] for c in columns], dtype=bool
    ).reshape(len(columns), n_states)

    values = np.zeros((n_objects, len(columns), n_states), dtype=bool)
    na_number = 0
    for i_f, col in enumerate(columns):
        code_of = {name: i for i, name in enumerate(state_names[i_f])}
        observed = features_raw[col]
        undefined = sorted({v for v in observed if v is not None and v not in code_of})
        if undefined:
            raise ValueError(
                f"Features of feature `{col}` contain states that are not defined "
                f"in the feature_states file: {undefined}"
            )
        rows = [n for n, v in enumerate(observed) if v is not None]
        values[rows, i_f, [code_of[observed[n]] for n in rows]] = True
        na_number += n_objects - len(rows)

    features = {
        "values": values,
        "states": applicable_states,
        "state_names": state_names,
    }
    return features, na_number


# ---------------------------------------------------------------------------
# Config-dict helpers (reference: sbayes/util.py:1265-1329)
# ---------------------------------------------------------------------------

def set_defaults(cfg: dict, default_cfg: dict) -> dict:
    """Recursively fill missing fields of ``cfg`` from ``default_cfg``."""
    for key in default_cfg:
        if key not in cfg:
            cfg[key] = default_cfg[key]
        elif isinstance(default_cfg[key], dict) and isinstance(cfg[key], dict):
            set_defaults(cfg[key], default_cfg[key])
    return cfg


def update_recursive(cfg: dict, new_cfg: dict) -> dict:
    """Recursively override fields of ``cfg`` with values from ``new_cfg``."""
    for key in new_cfg:
        if key in cfg and isinstance(new_cfg[key], dict) and isinstance(cfg[key], dict):
            update_recursive(cfg[key], new_cfg[key])
        else:
            cfg[key] = new_cfg[key]
    return cfg


def iter_items_recursive(cfg: dict, loc=tuple()):
    for key, value in cfg.items():
        if isinstance(value, dict):
            yield from iter_items_recursive(value, loc + (key,))
        else:
            yield key, value, loc


def decompose_config_path(config_path: PathLike) -> tuple[Path, Path]:
    """Return (base directory, absolute path) of a config file."""
    abs_config_path = Path(config_path).absolute()
    return abs_config_path.parent, abs_config_path


def fix_relative_path(path: PathLike, base_directory: PathLike) -> Path:
    """Resolve ``path`` relative to ``base_directory`` unless it is absolute."""
    path = Path(path)
    if path.is_absolute():
        return path
    return Path(base_directory) / path


def scale_counts(counts: NDArray, scale_to: float, prior_inflation: float = 1.0):
    """Scale feature-state counts so they sum to at most ``scale_to`` per feature.

    Used by the prior-count extraction tools (reference: sbayes/util.py:520-537).
    """
    counts = counts * prior_inflation
    counts_sum = np.sum(counts, axis=0)
    counts_sum = np.where(counts_sum == 0, 1.0, counts_sum)
    scale_factor = scale_to / counts_sum
    scale_factor = np.where(scale_factor < 1, scale_factor, 1)
    return counts * scale_factor


def timeit(fn):
    """Decorator printing the runtime of a function call (debug helper)."""
    import functools
    import time

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        print(f"{fn.__name__} took {time.time() - t0:.3f}s")
        return out

    return wrapped


def process_memory(unit: str = "MB") -> int:
    """Peak resident memory of this process (stdlib ``resource``)."""
    import resource
    import sys

    mem = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    if sys.platform != "darwin":  # kilobytes everywhere but macOS
        mem *= 1024
    shift = {"B": 0, "KB": 10, "MB": 20, "GB": 30, "TB": 40}[unit]
    return mem >> shift
