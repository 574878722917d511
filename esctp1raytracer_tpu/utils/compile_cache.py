"""The persistent compilation cache shared by the entry points."""

from __future__ import annotations

import os

import jax

# The checkout's root: a fixed path, so every run of every entry point
# finds what an earlier run compiled.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    `JAX_COMPILATION_CACHE_DIR` wins when it is set, and then no other
    directory is used; otherwise the cache lives in `<checkout>/.jax_cache`.
    Entry points call this; importing the library sets nothing.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
