"""Persistent XLA compilation cache for the program's entry points.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX keeps its cache in that
directory and nothing here names another. Otherwise the cache lives at one
fixed path inside the checkout, `<repo>/.jax_cache`: the directory is part
of what a later process must find again, so it is never built from a
temporary name, a process id or the time.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir(environ=os.environ) -> str:
    """The directory the cache uses under `environ`."""
    return environ.get(ENV) or DEFAULT


def enable() -> str:
    """Turn on jax's persistent compilation cache (every compile is kept,
    whatever its duration) and return its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
