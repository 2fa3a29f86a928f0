"""Persistent XLA compilation cache.

On the GPU a cold start compiles the engine step, the PPO update and the
DQN iteration; the persistent cache makes each a one-time cost across
processes.  Called by all CLIs, bench.py and chip_smoke.py.

The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads
the variable itself; no other path is set here).  Otherwise it is the fixed
``<checkout>/.jax_cache``: the directory is part of what a later process
must find again, so it never depends on a pid, a timestamp or a temporary
directory.
"""

from __future__ import annotations

import os
import pathlib

import jax

CACHE_ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = str(
    pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"
)


def cache_dir() -> str:
    """The cache directory a GPU process uses (env var, else the default)."""
    return os.environ.get(CACHE_ENV_VAR) or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Turn the cache on when the backend in use is the GPU; return its
    directory ("" when off).

    Off for the CPU: CPU programs compile fast, and cached CPU executables
    are pinned to the compiling machine's ISA features (SIGILL risk when a
    cache directory moves between machines).
    """
    if jax.default_backend() != "gpu":
        return ""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get(CACHE_ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    # JAX's default threshold (programs that took >= 1 s to compile) stays:
    # the cache serves every backend of the process, and the CPU programs
    # a GPU run compiles (chip_smoke's float32 reference) are fast to
    # compile and must not be cached for the ISA reason above.
    return path
