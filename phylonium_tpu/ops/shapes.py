"""jax-free shape math for the device counting path.

The row tile, the column chunk, the column shape buckets and the host
nibble pack are pure numpy/int math.  They live apart from the kernel
(ops/pallas_match.py) because the device-server transport and the
low-memory pipeline need the SHAPES without importing jax.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu.core.pileup import INVALID

# output tile sides of the counting kernel: small panels take the
# small tile (less row padding, more programs), larger ones the big
# tile (more reuse per loaded byte); measured on an H100 in PERF.md
SMALL_TILE = 64
LARGE_TILE = 128
_SMALL_TILE_MAX_ROWS = 256
# the panel width is padded to a multiple of this many packed bytes
# (every kernel column step divides it)
COL_CHUNK = 64
# column-bucket granularity cap: very long pileups round up to this
_MAX_BUCKET_STEP = 1 << 22

# INVALID in both nibbles: the packed padding byte
_PACKED_PAD = INVALID | (INVALID << 4)


def bucket_cols(length: int, block: int = COL_CHUNK) -> int:
    """Pad a column count up to a shape bucket.

    Similar-length panels then share one compiled executable (padding
    columns are INVALID and contribute nothing to the counts).
    Eighth-octave granularity: at most ~8 shapes per factor of two and
    <= 12.5% padding (the kernel pays for every padded column).  Always
    a multiple of ``block`` (a power of two).
    """
    n = max(length, block)
    msb = (n - 1).bit_length()
    q = min(1 << max(msb - 3, 7), _MAX_BUCKET_STEP)
    q = max(q, block)
    return -(-n // q) * q


def tile_for(rows: int) -> int:
    """Output tile side for a row block of ``rows`` rows."""
    return SMALL_TILE if rows <= _SMALL_TILE_MAX_ROWS else LARGE_TILE


def pad_rows(n: int) -> int:
    """Row count padded up to a whole number of output tiles (the tile
    ``tile_for`` picks for the padded count divides it)."""
    tile = tile_for(n)
    return max(tile, -(-n // tile) * tile)


def packed_width(length: int) -> int:
    """Bucketed packed width (bytes per row) of an L-column pileup."""
    return bucket_cols(-(-max(length, 1) // 2))


def pack_states(
    states: np.ndarray, n_pad: int, width: int | None = None
) -> np.ndarray:
    """Split-layout nibble packing: byte [g, j] = state[g, j] |
    state[g, j + L2] << 4 with L2 = ceil(L/2) (odd tails pad INVALID).
    Halves transfer and device bytes; states are 0..10 so they fit 4
    bits.  ``width`` right-pads with packed-INVALID columns and
    ``n_pad`` adds packed-INVALID rows.

    One native pass when available (the numpy formulation's temporaries
    cost ~13 s at 1000 x 1 Mbp scale; the C++ pass is ~1 s).
    """
    n, length = states.shape
    l2 = -(-max(length, 1) // 2)
    width = max(width or l2, l2)
    try:
        from phylonium_tpu.native import pack_states_native

        return pack_states_native(states, n_pad, width)
    except Exception:
        pass
    lo = np.full((n, l2), INVALID, dtype=np.uint8)
    hi = np.full((n, l2), INVALID, dtype=np.uint8)
    lo[:, : min(l2, length)] = states[:, :l2]
    hi[:, : length - l2] = states[:, l2:]
    out = np.full((n_pad, width), _PACKED_PAD, dtype=np.uint8)
    out[:n, :l2] = lo | (hi << 4)
    return out
