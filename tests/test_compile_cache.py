"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR when it is
set, and otherwise lives at <repo>/.jax_cache."""

from pathlib import Path

import jax

import judo_tpu


def test_cache_dir_env_var_is_left_to_jax(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert judo_tpu.configure_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_repo_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = judo_tpu.configure_compile_cache()
    repo = Path(__file__).resolve().parent.parent
    assert path == repo / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == str(path)
    assert ".jax_cache/" in (repo / ".gitignore").read_text().splitlines()
