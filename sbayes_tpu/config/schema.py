"""Config schema: pydantic v2 models mirroring the reference's config keys.

Behavioral contract (same YAML/JSON files must parse identically):
reference sbayes/config/config.py:102-557 — sections ``data``, ``model``
(clusters, confounders, prior with geo / objects_per_cluster / weights /
cluster_effect / confounding_effects), ``mcmc`` (steps, samples, operators,
warmup, initialization, mc3, ...) and ``results``.

Differences from the reference are deliberate:
* extra optional ``mcmc.chains`` (vmapped chain-ensemble size) and
  ``mcmc.precision`` knobs, defaulting to reference-equivalent behavior.
"""
from __future__ import annotations

import json
import os
import warnings
from enum import Enum
from pathlib import Path
from typing import Annotated, Dict, List, Literal, Optional, Union

from pydantic import (
    BaseModel,
    DirectoryPath,
    Field,
    NonNegativeFloat,
    PositiveFloat,
    PositiveInt,
    model_validator,
)
from pydantic_core import PydanticCustomError, core_schema

from sbayes_tpu.utils import PathLike, decompose_config_path, fix_relative_path, update_recursive


class RelativePath:
    """Path that is resolved relative to the config file location.

    ``BASE_DIR`` is set by ``SBayesConfig.from_config_file`` before parsing
    (reference behavior: sbayes/config/config.py:29-58).
    """

    BASE_DIR: DirectoryPath = "."

    def __init__(self, kind: Literal["file", "dir"]):
        self.kind = kind

    @classmethod
    def fix_path(cls, value: PathLike) -> Path:
        return fix_relative_path(value, cls.BASE_DIR)

    def __get_pydantic_core_schema__(self, source_type, handler):
        def validate(value, _info):
            path = RelativePath.fix_path(value)
            if self.kind == "file":
                if not path.is_file():
                    raise PydanticCustomError("path_not_file", "Path does not point to a file")
            else:
                os.makedirs(path, exist_ok=True)
                if not path.is_dir():
                    raise PydanticCustomError("path_not_directory", "Path does not point to a directory")
            return path

        return core_schema.with_info_plain_validator_function(validate)


RelativeFilePath = Annotated[Path, RelativePath("file")]
RelativeDirectoryPath = Annotated[Path, RelativePath("dir")]


class BaseConfig(BaseModel, extra="forbid"):
    """Base class: forbid unknown keys, warn on deprecated ones."""

    def __getitem__(self, key):
        return getattr(self, key)

    @classmethod
    def deprecated_attributes(cls) -> list:
        return []

    @model_validator(mode="before")
    @classmethod
    def warn_about_deprecated_attributes(cls, values):
        if isinstance(values, dict):
            for key in cls.deprecated_attributes():
                if key in values:
                    warnings.warn(
                        f"The {key} key in {cls.__name__} is deprecated "
                        f"and will be removed in future versions."
                    )
                    values.pop(key)
        return values


# ============================= PRIOR CONFIGS =============================


class GeoPriorConfig(BaseConfig):
    """Configuration of the geo-prior."""

    class Types(str, Enum):
        UNIFORM = "uniform"
        COST_BASED = "cost_based"
        SIMULATED = "simulated"

    class AggregationStrategies(str, Enum):
        MEAN = "mean"
        SUM = "sum"
        MAX = "max"

    class ProbabilityFunction(str, Enum):
        EXPONENTIAL = "exponential"
        SIGMOID = "sigmoid"

    class Skeleton(str, Enum):
        MST = "mst"
        DELAUNAY = "delaunay"
        DIAMETER = "diameter"
        COMPLETE = "complete_graph"

    type: Types = Types.UNIFORM
    """Type of prior distribution. Choose from: [uniform, cost_based, simulated]."""

    costs: Union[RelativeFilePath, Literal["from_data"]] = "from_data"
    """Source of geographic costs: `from_data` (geodesic distances) or a CSV file path."""

    aggregation: AggregationStrategies = AggregationStrategies.MEAN
    """How costs of single edges are aggregated: [mean, sum, max]."""

    probability_function: ProbabilityFunction = ProbabilityFunction.EXPONENTIAL
    """Monotonic function mapping aggregated costs to prior probabilities."""

    rate: Optional[PositiveFloat] = None
    """Rate of probability decrease for a cost_based geo-prior (required if cost_based)."""

    inflection_point: Optional[float] = None
    """Sigmoid inflection point (required if probability_function=sigmoid)."""

    skeleton: Skeleton = Skeleton.MST
    """Graph along which costs are aggregated: [mst, delaunay, diameter, complete_graph]."""

    @model_validator(mode="before")
    @classmethod
    def validate_geo_prior_parameters(cls, values):
        if isinstance(values, dict) and values.get("type") == "cost_based" and values.get("rate") is None:
            raise ValueError("Field `rate` is required for geo-prior of type `cost_based`.")
        return values


class ClusterSizePriorConfig(BaseConfig):
    """Configuration of the cluster-size prior."""

    class Types(str, Enum):
        UNIFORM_AREA = "uniform_area"
        UNIFORM_SIZE = "uniform_size"
        QUADRATIC_SIZE = "quadratic"

    type: Types
    """Type of prior distribution: [uniform_area, uniform_size, quadratic]."""

    min: PositiveInt = 2
    """Minimum cluster size."""

    max: PositiveInt = 10000
    """Maximum cluster size."""


class DirichletPriorConfig(BaseConfig):

    class Types(str, Enum):
        UNIFORM = "uniform"
        DIRICHLET = "dirichlet"
        JEFFREYS = "jeffreys"
        BBS = "BBS"
        UNIVERSAL = "universal"
        SYMMETRIC_DIRICHLET = "symmetric_dirichlet"

    type: Types = Types.UNIFORM
    """Type of prior: [uniform, dirichlet, jeffreys, BBS, symmetric_dirichlet]."""

    file: Optional[RelativeFilePath] = None
    """Path to Dirichlet parameters (YAML or JSON). This or `parameters` required if dirichlet."""

    parameters: Optional[Dict] = None
    """Inline Dirichlet parameters. This or `file` required if type=dirichlet."""

    prior_concentration: Optional[float] = None
    """Concentration value (required if type=symmetric_dirichlet or universal)."""

    @model_validator(mode="before")
    @classmethod
    def warn_when_using_default_type(cls, values):
        if isinstance(values, dict) and "type" not in values:
            warnings.warn(f"No `type` defined for `{cls.__name__}`. Using `uniform` as a default.")
        return values

    @model_validator(mode="after")
    def validate_dirichlet_parameters(self):
        cls_name = type(self).__name__
        if self.type == self.Types.DIRICHLET:
            if self.file is None and self.parameters is None:
                raise ValueError(f"Provide `file` or `parameters` for `{cls_name}` of type `dirichlet`.")
        elif self.type in [self.Types.UNIVERSAL, self.Types.SYMMETRIC_DIRICHLET]:
            if self.prior_concentration is None:
                raise ValueError(f"Provide `prior_concentration` for `{cls_name}` of type `{self.type}`.")
        return self

    @model_validator(mode="after")
    def validate_no_hierarchical_prior(self):
        # Matches the reference, which blocks the (experimental) hierarchical
        # `universal` prior type (reference: sbayes/config/config.py:226-232).
        if self.type == self.Types.UNIVERSAL:
            type_options = [t.value for t in self.Types if t != self.Types.UNIVERSAL]
            raise NotImplementedError(
                f"The hierarchical prior type `universal` is not implemented yet."
                f" Choose one of the following prior types: {type_options}"
            )
        return self

    def dict(self, *args, **kwargs):
        self_dict = super().model_dump(*args, **kwargs)
        if self.type is self.Types.UNIFORM:
            self_dict.pop("file", None)
            self_dict.pop("parameters", None)
        else:
            if self.file is not None:
                self_dict.pop("parameters", None)
            elif self.parameters is not None:
                self_dict.pop("file", None)
        return self_dict


class WeightsPriorConfig(DirichletPriorConfig):
    """Prior on the weights of the mixture components."""


class ConfoundingEffectPriorConfig(DirichletPriorConfig):
    """Prior on the parameters of the confounding-effects."""


class ClusterEffectConfig(DirichletPriorConfig):
    """Prior on the parameters of the cluster-effect."""


class PriorConfig(BaseConfig):
    """Configuration of all priors of the model."""

    confounding_effects: Dict[str, Dict[str, ConfoundingEffectPriorConfig]]
    """The priors for the confounding effects in each group of each confounder."""

    cluster_effect: ClusterEffectConfig
    geo: GeoPriorConfig
    objects_per_cluster: ClusterSizePriorConfig
    weights: WeightsPriorConfig


class ModelConfig(BaseConfig):
    """Configuration of the model."""

    clusters: Union[int, List[int]] = 1
    """The number of clusters to be inferred."""

    confounders: List[str] = Field(default_factory=list)
    """The list of confounder names."""

    prior: PriorConfig
    """The priors of the model."""

    @classmethod
    def deprecated_attributes(cls) -> list:
        return ["sample_source"]

    @model_validator(mode="before")
    @classmethod
    def validate_confounder_priors(cls, values):
        if isinstance(values, dict):
            for conf in values.get("confounders", []):
                if conf not in values["prior"]["confounding_effects"]:
                    raise NameError(f"Prior for the confounder '{conf}' is not defined in the config file.")
        return values


class OperatorsConfig(BaseConfig):
    """Relative frequency of each MCMC operator family (normalized at runtime)."""

    clusters: NonNegativeFloat = 70.0
    """Frequency of cluster-membership updates."""

    weights: NonNegativeFloat = 10.0
    """Frequency of mixture-weight updates."""

    source: NonNegativeFloat = 20.0
    """Frequency of source (observation-component assignment) updates."""

    @classmethod
    def deprecated_attributes(cls) -> list:
        return ["cluster_effect", "confounding_effects"]


class WarmupConfig(BaseConfig):
    """Configuration of the warm-up phase."""

    warmup_steps: PositiveInt = 50000
    """Number of steps in the warm-up phase."""

    warmup_chains: PositiveInt = 10
    """Number of parallel chains in the warm-up phase (one vmapped batch)."""


class InitializationConfig(BaseConfig):
    """Configuration of the per-chain sample initializer."""

    attempts: PositiveInt = 10
    """Number of initial samples per warm-up chain; the best (by likelihood) is kept."""

    em_steps: PositiveInt = 50
    """Number of steps in the expectation-maximization initializer."""

    objects_per_cluster: PositiveInt = 10
    """Average number of objects per cluster in the initialization phase."""

    initial_cluster_steps: bool = True
    """If true, apply an initial deterministic cluster step to each cluster."""

    method: Literal["em", "seed_points", "random_growth"] = "em"
    """Initial-cluster construction: 'em' = annealed EM soft clustering
    (reference SbayesInitializer, initializers.py:93-169); 'seed_points' =
    one random seed object per cluster (reference initialize_clusters,
    initializers.py:336-351); 'random_growth' = adjacency-constrained
    random growth to the initial size (reference grow_random_clusters,
    initializers.py:353-442)."""


class MC3Config(BaseConfig):
    """Metropolis-coupled MCMC (MC3 / parallel tempering) parameters."""

    activate: bool = False
    """If true, use MC3 sampling."""

    chains: PositiveInt = 4
    """Number of MC3 chains."""

    swap_interval: PositiveInt = 1000
    """Number of MCMC steps between chain-swap attempts."""

    swap_attempts: PositiveInt = 100
    """Number of chain pairs proposed to swap after each interval."""

    only_swap_adjacent_chains: bool = False
    """Only swap chains adjacent in the temperature schedule."""

    temperature_diff: PositiveFloat = 0.05
    """Difference between temperatures of MC3 chains."""

    prior_temperature_diff: Union[PositiveFloat, Literal["temperature_diff"]] = "temperature_diff"
    """Difference between prior-temperatures (defaults to `temperature_diff`)."""

    exponential_temperatures: bool = False
    """If true, temperatures grow exponentially ((1+dt)**i) instead of linearly (1+dt*i)."""

    log_swap_matrix: bool = True
    """If true, log the matrix of accepted swaps between chain pairs."""

    @classmethod
    def deprecated_attributes(cls) -> list:
        return ["only_heat_likelihood"]

    @model_validator(mode="after")
    def validate_mc3(self):
        if self.activate and self.chains < 2:
            self.activate = False
            warnings.warn("Deactivated MC3, as it is pointless with less than 2 chains.")

        if self.only_swap_adjacent_chains:
            valid_chain_pairs = self.chains - 1
        else:
            valid_chain_pairs = int(self.chains * (self.chains - 1) / 2)
        if self.swap_attempts > valid_chain_pairs:
            self.swap_attempts = valid_chain_pairs

        if self.prior_temperature_diff == "temperature_diff":
            self.prior_temperature_diff = self.temperature_diff
        return self


class MCMCConfig(BaseConfig):
    """Configuration of MCMC parameters."""

    steps: PositiveInt = 1000000
    """Total number of iterations in the MCMC chain."""

    samples: PositiveInt = 1000
    """Number of samples to be generated."""

    runs: PositiveInt = 1
    """Number of independent repetitions of the sampling."""

    sample_from_prior: bool = False
    """If true, ignore the data and sample from the prior."""

    grow_to_adjacent: Annotated[float, Field(ge=0, le=1)] = 0.8
    """Fraction of grow-steps restricted to adjacent objects. Accepted for
    config compatibility but inert: the reference stores it as
    ClusterOperator.p_grow_connected (operators.py:721) and never reads it
    either — neighbourhood restriction is set per scheduled operator."""

    screen_log_interval: PositiveInt = 1000
    """Step interval of screen-log lines."""

    operators: OperatorsConfig = Field(default_factory=OperatorsConfig)
    initialization: InitializationConfig = Field(default_factory=InitializationConfig)
    warmup: WarmupConfig = Field(default_factory=WarmupConfig)
    mc3: MC3Config = Field(default_factory=MC3Config)

    @model_validator(mode="before")
    @classmethod
    def forward_init_objects_per_cluster(cls, values):
        if isinstance(values, dict) and "init_objects_per_cluster" in values:
            if "initialization" in values and "objects_per_cluster" in values["initialization"]:
                raise ValueError(
                    "The `init_objects_per_cluster` field was moved to `initialization > "
                    "objects_per_cluster`. Please remove the old `init_objects_per_cluster` entry."
                )
            values.setdefault("initialization", {})
            values["initialization"]["objects_per_cluster"] = values.pop("init_objects_per_cluster")
            warnings.warn(
                "The `init_objects_per_cluster` field was moved to `initialization > objects_per_cluster`."
            )
        return values

    @model_validator(mode="after")
    def validate_sample_spacing(self):
        # Tracer does not like unevenly spaced samples.
        if self.steps % self.samples != 0:
            raise ValueError("Inconsistent spacing between samples. Set `steps` to be a multiple of `samples`.")
        return self


class DataConfig(BaseConfig):
    """Information on the data of an analysis."""

    features: RelativeFilePath
    """Path to the CSV file with the features used for the analysis."""

    feature_states: RelativeFilePath
    """Path to the CSV file defining the possible states of each feature."""

    projection: str = "epsg:4326"
    """String identifier of the projection in which locations are given."""


class ResultsConfig(BaseConfig):
    """Information on where and how results are written."""

    path: RelativeDirectoryPath = Field(default_factory=lambda: RelativePath.fix_path("./results"))
    """Path to the results directory."""

    log_file: bool = True
    """Whether to write log messages to a file."""

    log_likelihood: bool = True
    """Whether to log the likelihood of each observation to an HDF5 file."""

    log_source: bool = False
    """Whether to log per-feature component assignment fractions."""

    log_hot_chains: bool = True
    """Whether to write results files for hot MC3 chains."""

    float_precision: PositiveInt = 8
    """Number of decimal places of real-valued parameters in the stats file."""

    log_contribution_per_cluster: bool = False
    """Whether to log per-cluster likelihood/prior contribution columns
    (post_a*, lh_a*, prior_a*) in the stats file."""

    log_operator_step_times: bool = True
    """Whether to measure per-operator step times (one timing probe per
    run; adds a few small compilations) for the operator_stats file."""


class SBayesConfig(BaseConfig):
    data: DataConfig
    model: ModelConfig
    mcmc: MCMCConfig
    results: ResultsConfig = Field(default_factory=ResultsConfig)

    @classmethod
    def from_config_file(cls, path: PathLike, custom_settings: Optional[dict] = None) -> "SBayesConfig":
        """Create an SBayesConfig from a YAML or JSON config file."""
        base_directory, _config_file = decompose_config_path(path)
        RelativePath.BASE_DIR = base_directory

        with open(path, "r") as f:
            path_str = str(path).lower()
            if path_str.endswith(".yaml") or path_str.endswith("yml"):
                import yaml

                config_dict = yaml.safe_load(f)
            else:
                config_dict = json.load(f)

        if custom_settings:
            update_recursive(config_dict, custom_settings)

        return SBayesConfig(**config_dict)

    def update(self, other: dict) -> "SBayesConfig":
        new_dict = update_recursive(self.model_dump(), other)
        return type(self)(**new_dict)
