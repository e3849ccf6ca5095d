"""Persistent XLA compilation cache.

Placement rule: when ``JAX_COMPILATION_CACHE_DIR`` is set, jax reads it
itself and nothing here names another directory.  Otherwise the cache
lives at one fixed directory inside the checkout, ``<repo>/.jax_cache/``
(gitignored), so every process of this checkout finds the entries the
others wrote: the cache key does not depend on where the process runs
from.

CPU-pinned runs skip the cache: CPU compiles are local and fast.
Safe to call multiple times.
"""

from __future__ import annotations

import os

_enabled = False

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
CHECKOUT_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def state_dir() -> str:
    """Per-checkout directory (gitignored) for the dispatch calibration
    and the device server's socket: nothing is written outside the
    checkout."""
    path = os.path.join(_CHECKOUT, ".state")
    os.makedirs(path, exist_ok=True)
    return path


def cache_dir() -> str:
    """The directory compiled executables land in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compile_cache(force: bool = False) -> None:
    global _enabled
    if _enabled:
        return
    from phylonium_tpu.utils.platform import cpu_pinned

    if not force and cpu_pinned():
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _enabled = True
