"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX (it reads the
variable itself) and nothing is set in code, so a deployment can place the
cache from outside.  Otherwise the cache lives at ``<checkout>/.jax_cache``:
a fixed path, because the path is part of the cache key and a directory
that moves never hits.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use.  Call before the first compilation."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
