"""The persistent compilation cache directory (utils/compile_cache.py)."""

import os

from multigrid_tpu.utils import compile_cache


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.cache_dir() == os.path.join(root, '.jax_cache')
    assert compile_cache.cache_dir('abc') == os.path.join(
        root, '.jax_cache', 'abc')
    # Fixed across calls: the path is part of every cache entry's key.
    assert compile_cache.cache_dir() == compile_cache.cache_dir()


def test_cache_dir_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    # The environment's directory is used as it is, with no subdirectory.
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.cache_dir('abc') == str(tmp_path)
