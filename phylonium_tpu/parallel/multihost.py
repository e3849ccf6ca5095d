"""Multi-process initialization and the all-device counting entry point.

Run one process per host (or per device) under ``jax.distributed``
(coordinator address, process count and id passed explicitly); the
global mesh spans every process's devices.  The default layout puts
one process per ``rows`` block: one all_gather of genome-block states
plus one int32 psum per run.

Counts are exact integer sums (see ops/pallas_match.py), so any device
topology returns bit-identical matrices; the compare phase is
embarrassingly parallel over columns with a single [N, N] int32
reduction at the end.
"""

from __future__ import annotations

import jax
import numpy as np


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed (no-op if already initialized)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized


def make_pod_mesh(rows: int | None = None) -> jax.sharding.Mesh:
    """('rows','cols') mesh over all global devices; rows defaults to the
    process count, so each process's devices share one rows block."""
    from phylonium_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    n = len(devices)
    if rows is None:
        rows = max(1, jax.process_count())
    while n % rows:
        rows -= 1
    return make_mesh((rows, n // rows), devices=devices)


def pair_counts_pod(states: np.ndarray, rows: int | None = None):
    """All-pairs counts over every device of the (multi-process)
    runtime."""
    from phylonium_tpu.parallel.distributed import pair_counts_sharded

    mesh = make_pod_mesh(rows)
    return pair_counts_sharded(states, mesh)
