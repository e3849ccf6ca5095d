"""The one device pair-counting entry point.

Every device counting site (the serial pipeline, the streamed row
feeder, the device server, the prewarm and the mesh's shard body) goes
through this module.  Panels arrive as row chunks in the split-nibble
packed layout (ops/shapes.pack_states) or as plain state bytes; the
chunks are concatenated and padded on the device, counted by the fused
kernel (ops/pallas_match.py) and fetched once as exact int64
(substitutions, homologs).

The kernel runs in interpret mode only on CPU-pinned runs (tests);
``panel_counts`` decides that here, for every caller.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from phylonium_tpu.core.pileup import INVALID
# counts (matches, homs) [Na, Nb] int32 of two tile-padded row blocks,
# jit- and shard_map-composable (the mesh's shard body)
from phylonium_tpu.ops.pallas_match import cross_counts_pallas as cross_counts
from phylonium_tpu.ops.shapes import (
    COL_CHUNK,
    _PACKED_PAD,
    bucket_cols,
    pad_rows,
    packed_width,
)


@functools.partial(jax.jit, static_argnames=("n_pad", "width", "fill"))
def concat_pad(chunks, n_pad: int, width: int, fill: int):
    """Row-concatenate shipped chunks and pad to the kernel's shape."""
    dev = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks, 0)
    rows, cols = dev.shape
    if rows != n_pad or cols != width:
        dev = jnp.pad(
            dev, ((0, n_pad - rows), (0, width - cols)),
            constant_values=fill,
        )
    return dev


@functools.partial(jax.jit, static_argnames=("packed", "interpret"))
def _panel_counts(dev, packed: bool, interpret: bool):
    m, h = cross_counts(
        dev, dev, packed=packed, symmetric=True, interpret=interpret
    )
    return jnp.stack((m, h))


def panel_counts(dev, packed: bool):
    """[2, n_pad, n_pad] int32 (matches, homs) of one padded panel."""
    from phylonium_tpu.utils.platform import cpu_pinned

    return _panel_counts(dev, packed, cpu_pinned())


def panel_shape(rows: int, width: int) -> tuple[int, int]:
    """(n_pad, width) of the padded panel the kernel counts: whole row
    tiles, and the width in its shape bucket (similar panels share one
    compiled program)."""
    return pad_rows(rows), bucket_cols(width, COL_CHUNK)


def pair_counts_chunks(
    chunks,
    n: int,
    *,
    packed: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (substitutions, homologs) of device-resident row chunks.

    ``chunks`` is a sequence of [rows_i, width] uint8 arrays whose rows
    concatenate to the panel (rows beyond ``n`` are padding); ``packed``
    says whether they hold the split-nibble layout.  Returns int64 host
    arrays with the diagonal zeroed (the reference never compares a
    genome with itself, src/process.cxx:525-529).
    """
    chunks = tuple(chunks)
    rows = sum(c.shape[0] for c in chunks)
    n_pad, width = panel_shape(rows, chunks[0].shape[1])
    fill = _PACKED_PAD if packed else INVALID
    dev = concat_pad(chunks, n_pad, width, fill)
    stacked = np.asarray(panel_counts(dev, packed))
    matches = stacked[0, :n, :n].astype(np.int64)
    homs = stacked[1, :n, :n].astype(np.int64)
    subs = homs - matches
    np.fill_diagonal(subs, 0)
    np.fill_diagonal(homs, 0)
    return subs, homs


def pair_counts_states(states) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs counts of a [N, L] state matrix (host or device array).

    The states ship unpacked and are padded on the device: on a local
    card the transfer of the unpacked bytes costs less than packing
    them on the host (PERF.md)."""
    return pair_counts_chunks(
        (jnp.asarray(states),), states.shape[0], packed=False
    )


def prewarm(n: int, ref_len: int, packed: bool) -> None:
    """Compile the counting program for an (n, ref_len) panel, packed
    (the streamed feeders' layout) or state bytes (host arrays), from
    abstract shapes only: no data, no transfer."""
    from phylonium_tpu.utils.platform import cpu_pinned

    width = packed_width(ref_len) if packed else ref_len
    n_pad, width = panel_shape(n, width)
    spec = jax.ShapeDtypeStruct((n_pad, width), jnp.uint8)
    _panel_counts.lower(spec, packed, cpu_pinned()).compile()
