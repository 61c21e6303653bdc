"""The trace reduction (sbayes_tpu.profiling): interval arithmetic on known
events, and attribution of a named scope in a trace recorded on the CPU."""
import jax
import jax.numpy as jnp
import pytest


def test_summarize_intervals():
    from sbayes_tpu.profiling import summarize

    # busy [0,10) + [5,15) + [20,30) = 25 of a 30 ns window
    events = [(0, 10, "fusion_1", ""), (5, 10, "dot_2", ""), (20, 10, "fusion_1", "")]
    s = summarize(events, {"fusion_1"})
    assert s["window_ms"] == pytest.approx(30e-6)
    assert s["busy_ms"] == pytest.approx(25e-6)
    assert s["idle_share"] == pytest.approx(5 / 30)
    assert s["kernel_ms"] == pytest.approx(30e-6)
    assert s["marked_ms"] == pytest.approx(20e-6)
    assert s["marked_events"] == 2
    assert s["marked_share_of_kernel_time"] == pytest.approx(2 / 3)
    # the scope path marks an event whose op is not in the set
    s = summarize(events[:2] + [(20, 10, "fusion_3", "jit(f)/region/mul")], set(), "region")
    assert s["marked_events"] == 1 and s["marked_ms"] == pytest.approx(10e-6)


def test_named_scope_found_in_cpu_trace(tmp_path):
    from sbayes_tpu.profiling import device_events, load_profile, scoped_ops, summarize

    def f(x):
        with jax.named_scope("marked_region"):
            y = jnp.tanh(x) @ x
        return jnp.cos(y).sum()

    x = jnp.ones((128, 128))
    jf = jax.jit(f)
    marked = scoped_ops(jf.lower(x).compile().as_text(), "marked_region")
    assert marked
    jf(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        jf(x).block_until_ready()
    s = summarize(device_events(load_profile(str(tmp_path)), "/host:CPU"), marked)
    assert s["marked_events"] >= 1
    assert 0.0 < s["marked_ms"] <= s["kernel_ms"]
    assert 0.0 <= s["idle_share"] < 1.0
