"""Persistent XLA compilation cache location.

A restart (systemd ``Restart=always``, build/chalkydri-tpu.service) would
otherwise pay the full fused-program compile before the first pose goes
out; with the cache, warm restarts reload the compiled executables.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honored as is: JAX reads it
    itself and nothing else is configured. Otherwise the cache lives at a
    fixed path inside the checkout (``<repo>/.jax_cache``, git-ignored), so
    every entry point of one checkout shares it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
