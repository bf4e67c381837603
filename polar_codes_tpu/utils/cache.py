"""Persistent XLA compilation cache shared by the entry points.

The cache key includes the directory, so the directory must not move
between runs: with `JAX_COMPILATION_CACHE_DIR` set, JAX reads it itself and
nothing is set here; otherwise the cache lives in `.jax_cache` at the root
of the checkout (listed in .gitignore).
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = CHECKOUT_ROOT / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
