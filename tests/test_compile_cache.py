"""The compile-cache helper: placeable from outside, fixed path otherwise."""

import jax

from lightdock_tpu.utils import compile_cache


def test_env_var_is_left_to_jax(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_default_is_the_checkout_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.setup_compile_cache()
        repo = compile_cache.DEFAULT_DIR.parent
        assert path == str(repo / ".jax_cache")
        assert (repo / "lightdock_tpu").is_dir()
        assert jax.config.jax_compilation_cache_dir == path
        assert ".jax_cache/" in (repo / ".gitignore").read_text()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
