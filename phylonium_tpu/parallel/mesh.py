"""Device mesh construction.

The framework's parallel axes (replacing the reference's OpenMP loops,
SURVEY.md section 2 "Parallelism & communication"):

- ``cols``: pileup reference-column blocks, data-parallel.  This is the
  analogue of sharding the O(N^2 * L) comparison work; per-device partial
  counts are exact integer partial sums merged with ``psum``.
- ``rows``: genome blocks (output-matrix row blocks), the scale-out axis
  for large N; each shard holds a slice of genomes and computes its row
  block of the matrix against an ``all_gather`` of the others.

Every device reaches every other at the same rate, so the shape follows
the algorithm: ``cols`` alone moves no panel bytes between devices (one
int32 psum of the [N, N] counts), ``rows`` trades an all_gather for a
smaller output block per device.
"""

from __future__ import annotations

import jax
import numpy as np


def make_mesh(
    shape: tuple[int, int] | None = None,
    axis_names: tuple[str, str] = ("rows", "cols"),
    devices=None,
) -> jax.sharding.Mesh:
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        # favor the cols (bandwidth) axis; rows only helps at large N
        shape = (1, n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return jax.sharding.Mesh(dev_array, axis_names)
