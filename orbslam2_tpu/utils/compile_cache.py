"""Where JAX's persistent compilation cache lives, for every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, names the directory and JAX reads
it itself; nothing here overrides it.  Otherwise the cache is kept at
``<checkout>/.jax_cache``: a fixed path, because the path is part of what
a later process looks up, so a directory that moves never hits.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> Optional[str]:
    """The directory to configure, or None when the environment names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> None:
    """Turn the persistent cache on for every program, however small."""
    path = cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
