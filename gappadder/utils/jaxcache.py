"""JAX's persistent compilation cache, in one place.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache lives at the fixed path
``<repo>/.jax_cache`` (listed in .gitignore): the path is part of the
cache key, so a directory that moves between runs would never hit.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def setup_compile_cache() -> str:
    """Enable the persistent cache; returns the directory in use."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
