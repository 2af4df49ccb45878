"""Where the program keeps what it caches between runs.

Every entry point calls `setup_compile_cache()` before its first compile.
JAX's persistent compilation cache goes where `JAX_COMPILATION_CACHE_DIR`
says when that variable is set (JAX reads it itself); otherwise it goes to
`.jax_cache` at the root of the checkout, a fixed path, so a second run of
any entry point finds what the first one compiled.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JAX_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")
BVH_CACHE_DIR = os.path.join(CHECKOUT, ".bvh_cache")


def setup_compile_cache() -> str:
    """Point JAX's compilation cache at its directory; returns that path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", JAX_CACHE_DIR)
    return JAX_CACHE_DIR
