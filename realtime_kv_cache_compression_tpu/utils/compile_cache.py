"""Persistent XLA compile cache shared by the entry points.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing is
set here. Otherwise the cache lives at a fixed path inside the checkout
(`<repo>/.jax_cache`, listed in .gitignore): the path is part of the cache
key, so a path that moved between runs would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
