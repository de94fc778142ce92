"""Persistent JAX compilation cache at a fixed path.

The receiver's device programs take seconds to tens of seconds to compile,
once per block size and multiplex configuration.  An on-disk cache lets
the next process (a CLI run, a bench section) load them instead.  The
directory is part of the cache's key, so it must not move between runs.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory; otherwise the cache is ``<repo>/.jax_cache``.
"""

from __future__ import annotations

import os
import pathlib

_DEFAULT = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache() -> str:
    """Turn on JAX's on-disk compilation cache; returns the directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    _DEFAULT.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(_DEFAULT))
    return str(_DEFAULT)
