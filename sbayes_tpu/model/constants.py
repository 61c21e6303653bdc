"""Static per-model constants: everything the jitted kernels close over.

This replaces the reference's Prior/Likelihood object hierarchy state
(sbayes/model/prior.py concentration parsing, sbayes/model/model.py shapes)
with one frozen bundle of device arrays + Python scalars. Prior
concentrations are parsed host-side from the same YAML/JSON formats.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np
from numpy.typing import NDArray

from sbayes_tpu.config.schema import (
    DirichletPriorConfig,
    GeoPriorConfig,
    ModelConfig,
)
from sbayes_tpu.data.loader import Data
from sbayes_tpu.model.shapes import ModelShapes
from sbayes_tpu.utils import FLOAT_TYPE

PriorTypes = DirichletPriorConfig.Types


def _symmetric_concentration(applicable: NDArray, c: float) -> NDArray:
    """(F, S) array with value c on applicable states, 0 elsewhere."""
    return np.where(applicable, c, 0.0).astype(FLOAT_TYPE)


def _oneovern_concentration(applicable: NDArray) -> NDArray:
    n_states_f = applicable.sum(-1, keepdims=True)
    return np.where(applicable, 1.0 / n_states_f, 0.0).astype(FLOAT_TYPE)


def _load_concentration_dict(path: Path) -> dict:
    with open(path, "r") as f:
        if Path(path).suffix.lower() in (".yaml", ".yml"):
            import yaml

            return yaml.safe_load(f)
        return json.load(f)


def _concentration_from_dict(
    concentration_dict: dict,
    feature_names,
    state_names,
    applicable: NDArray,
    initial_counts: float = 1.0,
) -> NDArray:
    """Parse {feature: {state: count}} into a padded (F, S) array.

    Adds ``initial_counts`` to every given count (reference behavior:
    sbayes/model/prior.py:210-222).
    """
    n_features, n_states = applicable.shape
    conc = np.zeros((n_features, n_states), dtype=FLOAT_TYPE)
    for i_f, f in enumerate(feature_names):
        states_f = state_names[i_f]
        for i_s, s in enumerate(states_f):
            conc[i_f, i_s] = initial_counts + concentration_dict[f][s]
    return conc


def parse_dirichlet_concentration(
    cfg: DirichletPriorConfig,
    feature_names,
    state_names,
    applicable: NDArray,
    initial_counts: float = 1.0,
) -> NDArray:
    """Concentration array (F, S) for one Dirichlet prior config section."""
    t = cfg.type
    if t is PriorTypes.UNIFORM:
        return _symmetric_concentration(applicable, 1.0)
    if t is PriorTypes.JEFFREYS:
        return _symmetric_concentration(applicable, 0.5)
    if t is PriorTypes.BBS:
        return _oneovern_concentration(applicable)
    if t is PriorTypes.SYMMETRIC_DIRICHLET:
        return _symmetric_concentration(applicable, cfg.prior_concentration)
    if t is PriorTypes.DIRICHLET:
        if cfg.file is not None:
            d = _load_concentration_dict(cfg.file)
        else:
            d = cfg.parameters
        return _concentration_from_dict(d, feature_names, state_names, applicable, initial_counts)
    raise ValueError(f"Unsupported Dirichlet prior type {t}")


@dataclass(frozen=True)
class GeoPriorConstants:
    prior_type: str                 # uniform | cost_based | simulated
    aggregation: str                # mean | sum | max
    probability_function: str       # exponential | sigmoid
    skeleton: str                   # mst | delaunay | diameter | complete_graph
    scale: Optional[float]          # rate
    inflection_point: Optional[float]
    mean_edge_length: float         # for 'simulated'


@dataclass(frozen=True)
class ModelConstants:
    """All static inputs of the jitted posterior/operator kernels."""

    shapes: ModelShapes

    # Data tensors (numpy here; moved to device lazily by JAX on first use)
    features: Any                   # f32 (N, F, S)
    na: Any                         # bool (N, F)
    applicable: Any                 # bool (F, S)
    n_states_per_feature: Any       # f32 (F,)

    # Confounders, padded to Gmax groups per component
    conf_names: tuple               # names of confounders, order = component 1..C-1
    group_names: dict               # conf -> list of group names
    groups: Any                     # f32 (C-1, Gmax, N)
    group_valid: Any                # bool (C-1, Gmax)
    n_groups: Any                   # int (C-1,)
    hc_conf: Any                    # bool (N, C-1)  has_components for confounders

    # Prior concentrations
    conc_cluster: Any               # f32 (F, S)
    unif_conc: Any                  # f32 (F, S)
    conc_conf: Any                  # f32 (C-1, Gmax, F, S)
    conc_weights: Any               # f32 (F, C)
    weights_prior_uniform: bool

    # Geo prior
    geo: GeoPriorConstants
    cost_matrix: Any                # f32 (N, N)
    adjacency: Any                  # bool (N, N)
    locations: Any                  # f32 (N, 2)

    # Size prior
    size_prior_type: str
    min_size: int
    max_size: int

    # Feature-tiled execution: when set, the O(N*F) kernels (counts,
    # collapsed likelihoods, source resampling, membership marginals) run
    # as a lax.map over F-tiles of this width instead of one fused program.
    # Mathematically identical (everything is feature-separable given the
    # counts); keeps intermediates tile-sized and XLA compile time bounded
    # at scale (the 10k x 5k workload). None = fully fused (small models).
    feature_chunk: Optional[int] = None

    # Availability-pattern encoding for the weights-likelihood sufficient
    # statistic (ChainState.pat_counts; see operators.make_gibbs_sample_weights):
    # every object's confounder availability (hc_conf row) is one of a few
    # distinct STATIC patterns; only the cluster bit is dynamic. Pattern id
    # of object n = static_pat[n] + any_cluster(n) * n_static_pats, so
    # P = 2 * n_static_pats total patterns (instead of 2^C).
    static_pat: Any = None          # int32 (N,) static pattern id per object
    pat_bits: Any = None            # f32 (P, C) availability bits per pattern

    # Packed source-state layout: the chain state carries the component
    # attribution as int8 (N, F) indices (sentinel C = NA) instead of the
    # bool one-hot (N, F, C) tensor — C x less memory AND HBM traffic for
    # the biggest chain-state leaf (10k x 5k x 3 = 150 MB/chain in bool).
    # All source math is polymorphic on the two forms (model/math.py
    # source_* helpers); ops exchange one-hot ROWS either way. Auto-on at
    # scale (see auto_source_packed); env SBAYES_TPU_SOURCE_DTYPE=idx|bool.
    source_packed: bool = False

    # misc
    dtype: Any = np.float32

    @property
    def K(self):
        return self.shapes.n_clusters

    @property
    def N(self):
        return self.shapes.n_sites

    @property
    def F(self):
        return self.shapes.n_features

    @property
    def S(self):
        return self.shapes.n_states

    @property
    def C(self):
        return self.shapes.n_components

    @property
    def Gmax(self):
        return int(self.groups.shape[1])


def build_model_constants(data: Data, config: ModelConfig, n_clusters: Optional[int] = None) -> ModelConstants:
    """Assemble ModelConstants from loaded data and a model config."""
    features = data.features
    confounders = data.confounders
    K = int(n_clusters if n_clusters is not None else config.clusters)
    if not isinstance(K, int):
        raise ValueError("build_model_constants needs a single integer cluster count")

    N, F, S = features.values.shape
    conf_names = tuple(confounders.keys())
    n_conf = len(conf_names)

    shapes = ModelShapes(
        n_clusters=K,
        n_sites=N,
        n_features=F,
        n_states=S,
        states_per_feature=features.states,
        n_confounders=n_conf,
        n_groups={name: conf.n_groups for name, conf in confounders.items()},
    )

    applicable = features.states.astype(bool)
    unif_conc = _symmetric_concentration(applicable, 1.0)
    feature_names = list(features.names)
    state_names = features.state_names

    # --- cluster effect prior (reference: prior.py:438-487) ---
    ce_cfg = config.prior.cluster_effect
    if ce_cfg.type is PriorTypes.DIRICHLET:
        raise ValueError("Prior type `dirichlet` is not supported for the cluster effect.")
    conc_cluster = parse_dirichlet_concentration(ce_cfg, feature_names, state_names, applicable)

    # --- confounding effect priors, padded (reference: prior.py:282-323) ---
    Gmax = max((conf.n_groups for conf in confounders.values()), default=1)
    Gmax = max(Gmax, 1)
    groups = np.zeros((n_conf, Gmax, N), dtype=FLOAT_TYPE)
    group_valid = np.zeros((n_conf, Gmax), dtype=bool)
    conc_conf = np.tile(unif_conc[None, None], (max(n_conf, 1), Gmax, 1, 1)).astype(FLOAT_TYPE)
    n_groups_arr = np.zeros(n_conf, dtype=np.int32)
    group_names: dict = {}

    for i_c, conf_name in enumerate(conf_names):
        conf = confounders[conf_name]
        prior_cfg_by_group = config.prior.confounding_effects[conf_name]
        default_cfg = prior_cfg_by_group.get("<DEFAULT>", None)
        group_names[conf_name] = list(conf.group_names)
        n_groups_arr[i_c] = conf.n_groups
        for i_g, g_name in enumerate(conf.group_names):
            groups[i_c, i_g] = conf.group_assignment[i_g].astype(FLOAT_TYPE)
            group_valid[i_c, i_g] = True
            cfg_g = prior_cfg_by_group.get(g_name, default_cfg)
            if cfg_g is None:
                from sbayes_tpu.config.schema import ConfoundingEffectPriorConfig

                cfg_g = ConfoundingEffectPriorConfig()
            conc_conf[i_c, i_g] = parse_dirichlet_concentration(
                cfg_g, feature_names, state_names, applicable
            )

    hc_conf = groups.sum(axis=1).T > 0  # (N, C-1)

    # Availability-pattern encoding (see the ModelConstants field docs):
    # distinct rows of hc_conf are the static patterns; the dynamic cluster
    # bit doubles them.
    static_rows, static_pat = np.unique(hc_conf, axis=0, return_inverse=True)
    static_pat = static_pat.astype(np.int32).reshape(-1)
    n_static = static_rows.shape[0]
    pat_bits = np.concatenate([
        np.concatenate([np.zeros((n_static, 1)), static_rows], axis=1),
        np.concatenate([np.ones((n_static, 1)), static_rows], axis=1),
    ]).astype(FLOAT_TYPE)  # (2 * n_static, C)

    # --- weights prior (reference: prior.py:490-565) ---
    C = n_conf + 1
    w_cfg = config.prior.weights
    if w_cfg.type is PriorTypes.UNIFORM:
        conc_weights = np.full((F, C), 1.0, dtype=FLOAT_TYPE)
        weights_prior_uniform = True
    elif w_cfg.type is PriorTypes.JEFFREYS:
        conc_weights = np.full((F, C), 0.5, dtype=FLOAT_TYPE)
        weights_prior_uniform = False
    elif w_cfg.type is PriorTypes.BBS:
        conc_weights = np.full((F, C), 1.0 / C, dtype=FLOAT_TYPE)
        weights_prior_uniform = False
    elif w_cfg.type is PriorTypes.SYMMETRIC_DIRICHLET:
        conc_weights = np.full((F, C), w_cfg.prior_concentration, dtype=FLOAT_TYPE)
        weights_prior_uniform = False
    else:
        raise ValueError(f"Unsupported weights prior type {w_cfg.type}")

    # --- geo prior (reference: prior.py:705-872) ---
    geo_cfg = config.prior.geo
    if geo_cfg.type is GeoPriorConfig.Types.UNIFORM and N > 2000:
        # The cost matrix is only read by cost_based/simulated geo paths;
        # under the uniform geo prior skip the O(N^2) device residency
        # (400 MB at the 10k scale-up). Small models
        # keep the real matrix so post-hoc ``dataclasses.replace`` of the
        # geo config (tests, exploratory API use) still works.
        cost_matrix = np.zeros((1, 1), dtype=FLOAT_TYPE)
    else:
        cost_matrix = np.asarray(data.geo_cost_matrix, dtype=FLOAT_TYPE)
    mean_edge_length = 1.0
    if geo_cfg.type is GeoPriorConfig.Types.SIMULATED:
        from scipy.sparse.csgraph import minimum_spanning_tree

        mst = minimum_spanning_tree(np.asarray(data.network.dist_mat, dtype=float))
        edges = mst.tocsr()[mst.nonzero()]
        mean_edge_length = float(np.mean(edges)) if edges.size else 1.0

    geo = GeoPriorConstants(
        prior_type=geo_cfg.type.value,
        aggregation=geo_cfg.aggregation.value,
        probability_function=geo_cfg.probability_function.value,
        skeleton=geo_cfg.skeleton.value,
        scale=geo_cfg.rate,
        inflection_point=geo_cfg.inflection_point,
        mean_edge_length=mean_edge_length,
    )

    adjacency = np.asarray(data.network.adj_mat.todense()).astype(bool)
    np.fill_diagonal(adjacency, False)

    # --- size prior ---
    sp_cfg = config.prior.objects_per_cluster
    size_prior_type = sp_cfg.type.value

    # Place the big arrays on device NOW: closure-captured device arrays are
    # hoisted to executable parameters, whereas NumPy constants get embedded
    # as HLO literals (which bloats every compile and breaks at large N*F).
    import jax.numpy as jnp

    feature_chunk = auto_feature_chunk(N, F)
    feat_dtype = auto_feature_dtype(N, F)

    return ModelConstants(
        shapes=shapes,
        # bool -> target dtype directly (no f32 intermediate: at 10k x 5k
        # that temp alone is 1 GB of fresh pages)
        features=jnp.asarray(features.values, dtype=feat_dtype),
        na=jnp.asarray(features.na_values.astype(bool)),
        applicable=jnp.asarray(applicable),
        n_states_per_feature=jnp.asarray(applicable.sum(-1).astype(FLOAT_TYPE)),
        conf_names=conf_names,
        group_names=group_names,
        groups=jnp.asarray(groups),
        group_valid=jnp.asarray(group_valid),
        n_groups=n_groups_arr,
        hc_conf=jnp.asarray(hc_conf),
        conc_cluster=jnp.asarray(conc_cluster),
        unif_conc=jnp.asarray(unif_conc),
        conc_conf=jnp.asarray(conc_conf),
        conc_weights=jnp.asarray(conc_weights),
        weights_prior_uniform=weights_prior_uniform,
        geo=geo,
        cost_matrix=jnp.asarray(cost_matrix),
        adjacency=jnp.asarray(adjacency),
        locations=jnp.asarray(np.asarray(data.objects.locations, dtype=FLOAT_TYPE)),
        size_prior_type=size_prior_type,
        min_size=int(sp_cfg.min),
        max_size=int(min(sp_cfg.max, N)),
        feature_chunk=feature_chunk,
        static_pat=jnp.asarray(static_pat),
        pat_bits=jnp.asarray(pat_bits),
        source_packed=auto_source_packed(N, F, 1 + n_conf),
    )


# ----------------------------------------------------------------------
# PyTree registration: ModelConstants can be passed as a jit ARGUMENT so
# its device arrays lower to executable parameters. Closed-over arrays are
# inlined as dense HLO literals (a 10k x 5k features tensor becomes a
# 400 MB literal, blowing compile memory and the remote-compile payload
# limit), so the SamplerRuntime threads consts as the first argument of
# every compiled program instead of closing over it.
# ----------------------------------------------------------------------

_MC_ARRAY_FIELDS = (
    "features", "na", "applicable", "n_states_per_feature", "groups",
    "group_valid", "hc_conf", "conc_cluster", "unif_conc", "conc_conf",
    "conc_weights", "cost_matrix", "adjacency", "locations",
    "static_pat", "pat_bits",
)
_MC_STATIC_FIELDS = (
    "shapes", "conf_names", "group_names", "n_groups", "weights_prior_uniform",
    "geo", "size_prior_type", "min_size", "max_size", "feature_chunk", "dtype",
    "source_packed",
)


def _static_signature(v):
    """Hashable content signature for jit-cache keys of static fields."""
    import dataclasses as _dc

    if isinstance(v, np.ndarray):
        return ("nd", v.shape, str(v.dtype), v.tobytes())
    if isinstance(v, dict):
        return ("d",) + tuple((k, _static_signature(x)) for k, x in v.items())
    if isinstance(v, (list, tuple)):
        return ("t",) + tuple(_static_signature(x) for x in v)
    if _dc.is_dataclass(v) and not isinstance(v, type):
        return ("dc", type(v).__name__) + tuple(
            (f.name, _static_signature(getattr(v, f.name))) for f in _dc.fields(v)
        )
    if isinstance(v, type):
        return ("ty", v.__module__, v.__name__)
    return v


class _StaticConsts:
    """Aux-data wrapper: keeps the raw static field values for unflatten,
    hashes/compares by content (jit cache key)."""

    __slots__ = ("values", "_sig")

    def __init__(self, values: tuple):
        self.values = values
        self._sig = _static_signature(values)

    def __hash__(self):
        return hash(self._sig)

    def __eq__(self, other):
        return isinstance(other, _StaticConsts) and self._sig == other._sig


def _mc_flatten(c: "ModelConstants"):
    children = tuple(getattr(c, f) for f in _MC_ARRAY_FIELDS)
    aux = _StaticConsts(tuple(getattr(c, f) for f in _MC_STATIC_FIELDS))
    return children, aux


def _mc_unflatten(aux: _StaticConsts, children):
    kw = dict(zip(_MC_ARRAY_FIELDS, children))
    kw.update(zip(_MC_STATIC_FIELDS, aux.values))
    return ModelConstants(**kw)


import jax.tree_util  # noqa: E402

jax.tree_util.register_pytree_node(ModelConstants, _mc_flatten, _mc_unflatten)


def auto_source_packed(n_objects: int, n_features: int, n_components: int,
                       byte_threshold: int = 16 * 1024 * 1024) -> bool:
    """Whether the chain state stores the packed int8 (N, F) source form.

    Packed only at scale: the per-chain bool (N, F, C) buffer must exceed
    ``byte_threshold`` (small models keep the bool form, which the oracle
    tests and the one-hot matmul row engine exercise bit-tight), and the
    sentinel C must fit int8. Env ``SBAYES_TPU_SOURCE_DTYPE``:
    ``idx`` | ``bool``.
    """
    import os

    env = os.environ.get("SBAYES_TPU_SOURCE_DTYPE")
    if env is not None:
        return {"idx": True, "int8": True, "bool": False}[env.lower()]
    return (n_components < 127
            and n_objects * n_features * n_components > byte_threshold)


def auto_feature_dtype(n_objects: int, n_features: int,
                       cell_threshold: int = 4_000_000):
    """Storage dtype of the one-hot feature tensor.

    The posterior recompute is HBM-bound streaming this tensor; bf16 halves
    the traffic and is EXACT for one-hot 0/1 values (all count/likelihood
    einsums force ``preferred_element_type=f32`` accumulation). Float
    effects contracted against it stay f32 (the bf16 operand converts
    exactly): a bf16-rounded effect would make results depend on whether
    a backend keeps excess precision in a fusion. Small
    models stay f32 (they are compute-trivial anyway and f32 keeps CPU test
    oracles bit-tight). Env override ``SBAYES_TPU_FEATURE_DTYPE``:
    ``float32`` | ``bfloat16``.
    """
    import os

    import jax.numpy as jnp

    env = os.environ.get("SBAYES_TPU_FEATURE_DTYPE")
    if env is not None:
        return {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                "bf16": jnp.bfloat16, "f32": jnp.float32}[env.lower()]
    return jnp.bfloat16 if n_objects * n_features > cell_threshold else jnp.float32


def auto_feature_chunk(n_objects: int, n_features: int,
                       cell_threshold: int = 4_000_000,
                       target: int = 512) -> Optional[int]:
    """Feature-tile width for large models: the divisor of F closest to
    ``target`` (None for small models, keeping the fully fused path).
    Env override ``SBAYES_TPU_FEATURE_CHUNK``: 0 forces fused, any other
    integer forces that tile width (must divide F)."""
    import os

    env = os.environ.get("SBAYES_TPU_FEATURE_CHUNK")
    if env is not None:
        fc = int(env)
        if fc <= 0 or fc >= n_features:
            return None
        assert n_features % fc == 0, (
            f"SBAYES_TPU_FEATURE_CHUNK={fc} must divide n_features={n_features}"
        )
        return fc
    if n_objects * n_features <= cell_threshold:
        return None
    divisors = [d for d in range(1, n_features + 1) if n_features % d == 0]
    best = min(divisors, key=lambda d: abs(d - target))
    return best if best < n_features else None
