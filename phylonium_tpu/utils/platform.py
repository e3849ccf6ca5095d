"""Platform pin helpers.

The program runs on whatever ``jax.devices()`` gives.  The CPU is chosen
only by ``JAX_PLATFORMS=cpu`` or ``PHYLONIUM_TPU_PLATFORM=cpu``.

None of these helpers import jax on their own: ``import jax`` costs
~1.8 s, and the host-only dispatch path (panels below the work
threshold) must never pay it.  When jax was never imported, the process
cannot be in a jax.distributed run and the pin is whatever the
environment will hand jax at import time.
"""

from __future__ import annotations

import os
import sys
import threading


def cpu_pinned() -> bool:
    """True when jax is pinned to the CPU backend (tests, forced runs)."""
    # the product's own override wins: every jax-touching chokepoint
    # applies it via apply_platform_override() before the first backend
    # init, so it IS the effective platform even before jax loads
    override = os.environ.get("PHYLONIUM_TPU_PLATFORM")
    if override:
        return override.split(",")[0].strip().lower() == "cpu"
    if "jax" not in sys.modules:
        # nobody can have called jax.config.update yet; the env var is
        # the only pin source a future import would see
        platforms = os.environ.get("JAX_PLATFORMS", "")
        return platforms.split(",")[0].strip().lower() == "cpu"
    import jax

    platforms = getattr(jax.config, "jax_platforms", None)
    if not platforms:
        return False
    return str(platforms).split(",")[0].strip().lower() == "cpu"


def distributed_state() -> tuple[int, int]:
    """(process count, process id) of a jax.distributed run, (1, 0)
    otherwise — read WITHOUT importing anything: another thread may be
    importing jax right now (backend init), and importing a jax
    submodule from here mid-way leaves it half-initialized for that
    thread.  A run that called jax.distributed.initialize has the
    module fully imported."""
    mod = sys.modules.get("jax._src.distributed")
    state = getattr(mod, "global_state", None)
    n = getattr(state, "num_processes", None) or 1
    if n <= 1:
        return 1, 0
    return n, getattr(state, "process_id", 0) or 0


_override_applied = False
_override_lock = threading.Lock()


def apply_platform_override() -> None:
    """Apply ``PHYLONIUM_TPU_PLATFORM`` before the first backend init.

    Applied lazily, at the first jax-touching chokepoint, rather than at
    CLI startup, so a host-dispatched run never pays the jax import just
    to configure a backend it won't use.  Concurrent device-bound
    threads block until it is applied."""
    global _override_applied
    if _override_applied:
        return
    with _override_lock:
        if _override_applied:
            return
        override = os.environ.get("PHYLONIUM_TPU_PLATFORM")
        if override:
            import jax

            jax.config.update("jax_platforms", override)
        _override_applied = True


def device_setup() -> None:
    """The chokepoint every in-process device path passes first: the
    platform pin, then the persistent compile cache (idempotent)."""
    apply_platform_override()
    from phylonium_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
