"""Every float32 x float32 contraction in the sampler's compiled programs
pins ``precision=HIGHEST`` (model/math.py ``HIGHEST``).

At default precision a GPU may run a float32 dot in TF32, which keeps a
10-bit mantissa; the CPU backend ignores the setting, so numerical tests
here cannot see the difference. This walks the jaxprs of the programs the
runtime compiles (initializer, MC3 chunk with every operator branch,
logging view, posterior recompute) and lists any float32 dot left at the
default."""
import collections
import dataclasses

import pytest

import jax
import jax.numpy as jnp
from jax._src import source_info_util
from jax.extend import core as jcore


def _unpinned_f32_dots(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            f32 = all(v.aval.dtype == jnp.float32 for v in eqn.invars)
            prec = eqn.params.get("precision")
            pinned = prec is not None and all(
                p == jax.lax.Precision.HIGHEST for p in prec)
            if f32 and not pinned:
                out[source_info_util.summarize(eqn.source_info)] += 1
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _unpinned_f32_dots(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _unpinned_f32_dots(sub, out)
    return out


@pytest.mark.parametrize("layout", ["fused", "tiled_packed"])
def test_every_f32_dot_pins_highest(layout):
    from sbayes_tpu.model.model import Model
    from sbayes_tpu.sampling.kernel import OperatorStats
    from sbayes_tpu.sampling.runner import SamplerRuntime
    from sbayes_tpu.testing import synthetic_config, synthetic_data

    data = synthetic_data(n_objects=20, n_features=6, n_states=3, seed=0)
    config = synthetic_config(n_clusters=2, geo_prior="cost_based", rate=1e6)
    model = Model(data, config.model)
    if layout == "tiled_packed":
        model.consts = dataclasses.replace(model.consts, feature_chunk=3,
                                           source_packed=True)
    rt = SamplerRuntime(model, config.mcmc)

    n = 2
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    states = jax.eval_shape(rt._init_chains, keys)
    stats = jax.vmap(lambda _: OperatorStats.zeros(rt.n_ops))(jnp.arange(n))
    temps = jnp.asarray([1.0, 1.5], jnp.float32)
    swaps = jnp.zeros((2, n, n), jnp.int32)

    def mc3(k, s, st):
        return rt._run_mc3_chunk(k, s, st, temps, temps, jax.random.PRNGKey(1),
                                 swaps, jnp.int32(0), 3, 2, 1, False)

    def first(s):
        return jax.tree.map(lambda x: x[0], s)

    found = collections.Counter()
    for fn, args in [
        (rt._init_chains, (keys,)),
        (mc3, (keys, states, stats)),
        (lambda s: rt._sample_view(first(s)), (states,)),
        (lambda s: model.posterior.parts(first(s)), (states,)),
    ]:
        _unpinned_f32_dots(jax.make_jaxpr(fn)(*args).jaxpr, found)
    assert not found, "float32 dots without precision=HIGHEST:\n" + "\n".join(
        f"{n}x {site}" for site, n in sorted(found.items()))
