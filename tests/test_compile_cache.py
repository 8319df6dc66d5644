"""The one place that decides where JAX's persistent compile cache lives."""

import os

import jax
import pytest

from orbslam2_tpu.utils import compile_cache


@pytest.mark.parametrize("from_env", [False, True])
def test_cache_dir_honours_environment(monkeypatch, tmp_path, from_env):
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    compile_cache.enable_compile_cache()

    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if from_env:
        assert compile_cache.cache_dir() is None
        assert "jax_compilation_cache_dir" not in updates
    else:
        expect = os.path.join(checkout, ".jax_cache")
        assert compile_cache.cache_dir() == expect
        assert updates["jax_compilation_cache_dir"] == expect
    assert updates["jax_persistent_cache_min_compile_time_secs"] == 0.0
