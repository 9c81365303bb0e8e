"""config.compilation_cache_dir / enable_compilation_cache."""

import os

import jax

from twenty_first_tpu import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_the_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert config.compilation_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_enable_points_jax_at_the_directory(monkeypatch, tmp_path):
    saved = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert config.enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
