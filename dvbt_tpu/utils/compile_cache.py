"""JAX persistent compilation cache location.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that directory
and nothing is changed.  Otherwise the cache goes to ``<checkout>/.jax_cache``
(listed in .gitignore): a fixed path, because the path is part of the cache
key, so a per-process or temporary directory would never be hit again.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses: the env var's, else DEFAULT_DIR."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at cache_dir(); returns that path."""
    path = cache_dir()
    if not os.environ.get(ENV):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
