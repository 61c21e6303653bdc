"""sbayes_tpu: a JAX/XLA Bayesian clustering framework for accelerators.

A from-scratch rebuild of the capabilities of sBayes (Bayesian detection of
spatial clusters in categorical data, controlling for confounders) designed
for a data-parallel accelerator (an NVIDIA GPU):

* The collapsed Dirichlet-categorical mixture likelihood is one fused
  full-recompute kernel (sufficient-statistic einsums as matrix products +
  a Dirichlet-categorical log-pdf), replacing the reference's incremental
  Python cache DAG (reference: sbayes/sampling/state.py, counts.py).
* Every MCMC operator is a pure jittable transition function
  ``(key, state) -> (state', log_q, log_q_back, stats)``; a chain is a
  ``lax.scan`` over MH steps with the operator chosen by ``lax.switch``.
* Chains (warm-up races, initializer attempts, MC3 ladders, large
  ensembles) are a vmapped axis, sharded over a device mesh via
  ``jax.sharding`` for multi-device runs.
* Config schema, data formats and results files (stats TSV, clusters
  bit-strings, likelihood HDF5, operator stats, state checkpoints) are kept
  compatible with the reference so existing post-processing (sBlot, Tracer,
  ELPD model comparison) works unchanged.
"""

__version__ = "0.1.0"

from sbayes_tpu.config.schema import SBayesConfig  # noqa: F401
