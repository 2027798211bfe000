"""utils/compile_cache.py: JAX_COMPILATION_CACHE_DIR wins and nothing else
is set; otherwise one fixed directory inside the checkout."""

import os

import jax

from mask_yolo_tpu.utils import compile_cache


def test_env_var_names_the_directory():
    assert compile_cache.cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/some/cache"}) == "/some/cache"


def test_default_is_one_fixed_path_in_the_checkout():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.cache_dir({}) == os.path.join(repo, ".jax_cache")
    assert compile_cache.cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == \
        compile_cache.cache_dir({})


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_enable_with_env_sets_no_directory(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_enable_without_env_uses_the_fixed_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    path = compile_cache.enable()
    assert path == compile_cache.DEFAULT and os.path.isdir(path)
    assert calls["jax_compilation_cache_dir"] == compile_cache.DEFAULT
