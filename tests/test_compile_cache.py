"""Placement of the persistent compilation cache (sbayes_tpu.compile_cache)."""
from pathlib import Path

import jax
import pytest


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield before
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_environment(monkeypatch, tmp_path, restore_cache_dir):
    from sbayes_tpu.compile_cache import place_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert place_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper changes nothing
    assert jax.config.jax_compilation_cache_dir == restore_cache_dir


def test_cache_dir_default_in_checkout(monkeypatch, restore_cache_dir):
    from sbayes_tpu.compile_cache import place_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(Path(__file__).resolve().parent.parent / ".jax_cache")
    assert place_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
