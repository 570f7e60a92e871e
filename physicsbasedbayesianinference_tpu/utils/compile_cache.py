"""Persistent compilation cache for the entry points (CLI, bench.py,
chip_smoke.py); never turned on at package import.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is changed here. Otherwise the cache lives at a fixed path inside the
checkout, ``<repo>/.jax_cache`` (listed in ``.gitignore``): the path is
part of the cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
