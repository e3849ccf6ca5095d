"""Fused pair-counting kernel for the GPU (Pallas, Triton route).

The plain XLA formulation (ops/match_matrix.py) materialises one-hot
state planes in device memory: about 40 bytes per genome-column against
half a byte for the nibble-packed pileup.  This kernel never writes a
plane.  One program owns one (BM x BN) tile of the output matrix and
walks the packed columns of its two row tiles in chunks of ``bk``
bytes, building every plane in registers:

    per chunk (two [BM, bk] / [BN, bk] uint8 tiles, two nibble halves):
      va, vb  = state != INVALID                      (int8)
      homs   += va @ vb.T                             (int8 MMA, int32 acc)
      for each state s (static 10-step loop):
        pa    = (a == s)                              (int8)
        qb    = sum_{t in partners(s)} (b == t)       (int8, values 0/1)
        macc += pa @ qb.T

``partners(s)`` enumerates the states matching s per the match table
(ops/match_table.py); partner states are distinct, so the sum is the OR
exactly.  Operands are 0/1 in int8 and accumulate in int32, so the
counts are exact for any genome length below 2**31 with no column
chunking on the host.

Blocks on a GPU run in parallel and in no order, so nothing carries over
between programs: the column loop lives inside the program, and a third
grid axis splits the columns into ``n_split`` segments when the output
has too few tiles to fill the card (small panels).  The segments' int32
partials are summed afterwards.  For one panel against itself
(``symmetric``) programs below the tile diagonal skip their loop and the
upper triangle is mirrored.  Panels too large for the lowering's 32-bit
offsets and too small for its 64-bit ones are launched once per column
range (``column_ranges``).

This kernel stands in for the reference's SIMD mismatch loops
(libs/seqcmp*.c, libs/revseqcmp*.c).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from phylonium_tpu.core.pileup import INVALID, N_STATES
from phylonium_tpu.ops.match_table import MATCH_TABLE
from phylonium_tpu.ops.shapes import tile_for

# partners(s) = states t with MATCH_TABLE[s, t] == 1 (static)
_PARTNERS: tuple[tuple[int, ...], ...] = tuple(
    tuple(int(t) for t in np.flatnonzero(MATCH_TABLE[s, :N_STATES]))
    for s in range(N_STATES)
)

# programs the grid should offer before column splitting stops: two
# waves over an H100's 132 streaming multiprocessors
_TARGET_PROGRAMS = 264

# tile side -> (packed bytes per column step, warps per program),
# the fastest of the configurations measured on an H100 (PERF.md)
_LAUNCH = {64: (32, 4), 128: (64, 8)}

# operand sizes of the Triton lowering's offset widths (column_ranges)
_I32_ELEMS = 1 << 31
_I64_BYTES = 1 << 32


def _outer(x, y):
    """x [m, k] . y [n, k]^T -> [m, n] int32 (int8 operands)."""
    return jax.lax.dot_general(
        x,
        y,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def _accumulate(a, b, m, h):
    """Counts of one state-tile pair ([BM, bk] and [BN, bk] uint8)."""
    h = h + _outer(
        (a != INVALID).astype(jnp.int8), (b != INVALID).astype(jnp.int8)
    )
    planes_b = [(b == t).astype(jnp.int8) for t in range(N_STATES)]
    for s in range(N_STATES):
        partners = _PARTNERS[s]
        qb = planes_b[partners[0]]
        for t in partners[1:]:
            qb = qb + planes_b[t]
        m = m + _outer((a == s).astype(jnp.int8), qb)
    return m, h


def _count_kernel(
    a_ref, b_ref, m_ref, h_ref, *, bk, n_chunks, n_split, packed,
    symmetric,
):
    i = pl.program_id(0)
    j = pl.program_id(1)
    k = pl.program_id(2)
    per = -(-n_chunks // n_split)
    lo = k * per
    hi = jnp.minimum(lo + per, n_chunks)
    if symmetric:
        hi = jnp.where(j >= i, hi, lo)

    def body(c, carry):
        m, h = carry
        cols = pl.ds(pl.multiple_of(c * bk, bk), bk)
        a = a_ref[:, cols]
        b = b_ref[:, cols]
        if packed:
            m, h = _accumulate(a & 15, b & 15, m, h)
            return _accumulate(a >> 4, b >> 4, m, h)
        return _accumulate(a, b, m, h)

    zeros = jnp.zeros((a_ref.shape[0], b_ref.shape[0]), jnp.int32)
    m, h = jax.lax.fori_loop(lo, hi, body, (zeros, zeros))
    m_ref[...] = m
    h_ref[...] = h


def split_count(n_tiles: int, n_chunks: int) -> int:
    """Column segments per output tile: enough programs to fill the
    card, never more segments than column chunks."""
    return max(1, min(n_chunks, -(-_TARGET_PROGRAMS // max(n_tiles, 1))))


def column_ranges(
    rows_a: int, rows_b: int, width: int, bk: int
) -> list[tuple[int, int]]:
    """(start, stop) column ranges the kernel is launched on for uint8
    operands of ``rows_a`` and ``rows_b`` rows of ``width`` bytes.

    Pallas-Triton addresses an operand with 32-bit offsets unless it
    holds more than 2**32 bytes, and the offsets are signed: a byte
    operand of more than 2**31 elements would wrap to a negative
    offset.  If either operand falls in that band, the panel is counted
    in column ranges of at most 2**31 elements per operand (the counts
    add over columns).  The int32 outputs are addressed in 4-byte
    elements, so their offsets stay below 2**30.
    """
    sizes = (rows_a * width, rows_b * width)
    if all(s <= _I32_ELEMS or s > _I64_BYTES for s in sizes):
        return [(0, width)]
    steps = width // bk
    per = max(1, _I32_ELEMS // (max(rows_a, rows_b) * bk))
    return [(lo * bk, min(lo + per, steps) * bk) for lo in range(0, steps, per)]


def _launch(a, b, *, tile, bk, packed, symmetric, interpret):
    """One kernel launch: (matches, homs) [Na, Nb] int32, the lower
    tiles left zero when ``symmetric``."""
    na, width = a.shape
    nb = b.shape[0]
    n_chunks = width // bk
    ti, tj = na // tile, nb // tile
    n_tiles = ti * (ti + 1) // 2 if symmetric else ti * tj
    n_split = split_count(n_tiles, n_chunks)
    kernel = functools.partial(
        _count_kernel, bk=bk, n_chunks=n_chunks, n_split=n_split,
        packed=packed, symmetric=symmetric,
    )
    out = jax.ShapeDtypeStruct((n_split, na, nb), jnp.int32)
    m, h = pl.pallas_call(
        kernel,
        grid=(ti, tj, n_split),
        in_specs=[
            pl.BlockSpec((tile, width), lambda i, j, k: (i, 0)),
            pl.BlockSpec((tile, width), lambda i, j, k: (j, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, tile, tile), lambda i, j, k: (k, i, j)),
            pl.BlockSpec((None, tile, tile), lambda i, j, k: (k, i, j)),
        ],
        out_shape=[out, out],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_LAUNCH[tile][1], num_stages=2
        ),
        interpret=interpret,
        name="pair_counts",
    )(a, b)
    return m.sum(axis=0), h.sum(axis=0)


@functools.partial(
    jax.jit, static_argnames=("packed", "symmetric", "interpret", "bk")
)
def cross_counts_pallas(
    a,
    b,
    *,
    packed: bool = True,
    symmetric: bool = False,
    interpret: bool = False,
    bk: int | None = None,
):
    """[Na, W] x [Nb, W] uint8 -> (matches, homs) [Na, Nb] int32.

    Row counts must be multiples of the tile (``shapes.pad_rows``) and
    the width a multiple of the column step (pad with INVALID, or the
    packed INVALID byte).  With ``symmetric`` (``a is b``) only tiles on
    or above the diagonal are computed and the result is mirrored.
    ``bk`` overrides the column step.  jit- and shard_map-composable.
    """
    na, width = a.shape
    nb = b.shape[0]
    tile = tile_for(na)
    bk = bk or _LAUNCH[tile][0]
    assert na % tile == 0 and nb % tile == 0, (na, nb, tile)
    assert width % bk == 0 and b.shape[1] == width, (a.shape, b.shape, bk)
    m = h = None
    for lo, hi in column_ranges(na, nb, width, bk):
        sa = a[:, lo:hi]
        sb = sa if symmetric else b[:, lo:hi]
        pm, ph = _launch(
            sa, sb, tile=tile, bk=bk, packed=packed, symmetric=symmetric,
            interpret=interpret,
        )
        m, h = (pm, ph) if m is None else (m + pm, h + ph)
    if symmetric:
        t = jnp.arange(na) // tile
        upper = t[:, None] <= t[None, :]
        m = jnp.where(upper, m, m.T)
        h = jnp.where(upper, h, h.T)
    return m, h
