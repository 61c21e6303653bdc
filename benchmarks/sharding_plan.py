"""Extract the GSPMD collective plan of the 2-D chains x objects layout.

Compiles the production ensemble chunk (SamplerRuntime._run_chunk) over a
virtual chains x objects CPU mesh at a scaled-down 10k-shaped config
(feature-tiled kernels) and summarizes the collectives XLA inserted —
the sharding plan of the 10k x 5k scale point.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/sharding_plan.py
"""
import collections
import dataclasses
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("SBAYES_TPU_FEATURE_CHUNK", "16")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


def main(n_chain_shards=2, n_data_shards=4):
    from sbayes_tpu.model.model import Model
    from sbayes_tpu.parallel.mesh import CHAIN_AXIS, DATA_AXIS, data_mesh
    from sbayes_tpu.sampling.kernel import OperatorStats
    from sbayes_tpu.sampling.runner import SamplerRuntime, _all_unit_temps
    from sbayes_tpu.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=48, n_features=32, n_states=3,
                          n_families=2, seed=13)
    config = synthetic_config(n_clusters=2, geo_prior="uniform")
    model = Model(data, config.model)
    mesh = data_mesh(n_chain_shards, n_data_shards)

    on_obj = NamedSharding(mesh, P(DATA_AXIS))
    model.consts = dataclasses.replace(
        model.consts,
        features=jax.device_put(jnp.asarray(model.consts.features), on_obj),
        na=jax.device_put(jnp.asarray(model.consts.na), on_obj),
        groups=jax.device_put(jnp.asarray(model.consts.groups),
                              NamedSharding(mesh, P(None, None, DATA_AXIS))),
        hc_conf=jax.device_put(jnp.asarray(model.consts.hc_conf), on_obj),
        static_pat=jax.device_put(jnp.asarray(model.consts.static_pat), on_obj),
    )
    rt = SamplerRuntime(model, config.mcmc)

    n_chains = n_chain_shards
    states = rt.init_chains(jax.random.PRNGKey(0), n_chains, shard=False)
    states = states._replace(
        clusters=jax.device_put(
            states.clusters, NamedSharding(mesh, P(CHAIN_AXIS, None, DATA_AXIS))),
        source=jax.device_put(
            states.source, NamedSharding(mesh, P(CHAIN_AXIS, DATA_AXIS))),
        weights=jax.device_put(states.weights, NamedSharding(mesh, P(CHAIN_AXIS))),
        log_lh=jax.device_put(states.log_lh, NamedSharding(mesh, P(CHAIN_AXIS))),
        log_prior=jax.device_put(states.log_prior,
                                 NamedSharding(mesh, P(CHAIN_AXIS))),
        prior_parts=jax.device_put(states.prior_parts,
                                   NamedSharding(mesh, P(CHAIN_AXIS))),
    )
    stats = jax.device_put(
        jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(n_chains)),
        NamedSharding(mesh, P(CHAIN_AXIS)))
    keys = jax.device_put(jax.random.split(jax.random.PRNGKey(1), n_chains),
                          NamedSharding(mesh, P(CHAIN_AXIS)))
    ones = jax.device_put(jnp.ones(n_chains, jnp.float32),
                          NamedSharding(mesh, P(CHAIN_AXIS)))

    jitted = rt._run_chunk._jitted
    with mesh:
        lowered = jitted.lower(rt.consts, keys, states, stats, ones, ones, 4,
                               _all_unit_temps(ones, ones))
        txt = lowered.compile().as_text()

    ops = collections.Counter(
        m.group(1) for m in re.finditer(
            r"\b(all-reduce|all-gather|reduce-scatter|collective-permute|"
            r"all-to-all)[.\w]*\(", txt))
    print(f"mesh: {n_chain_shards} chain shards x {n_data_shards} object shards")
    print("GSPMD collectives in the compiled ensemble chunk (4 steps):")
    for k, v in sorted(ops.items()):
        print(f"  {k}: {v}")
    repl = collections.Counter(
        m.group(1) for m in re.finditer(
            r'replica_groups=\{([^}]*)\}', txt))
    print(f"distinct replica groupings: {len(repl)}")


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])
