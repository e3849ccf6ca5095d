"""Device-side pileup construction from packed queries + intervals.

The host pileup (core/pileup.py) materializes the [N, ref_len] uint8
state matrix on host and ships it to the device — N*L bytes over the
host<->device link.  This op ships ~N*L/4 bytes instead (2-bit-packed
query bases + a sparse separator list + one interval record per
homology) and rebuilds the identical state matrix on device:

1. unpack 2-bit codes (pure reshape/shift math, no gather);
2. per genome, rasterize its disjoint homology intervals onto reference
   columns: coverage via scatter(+1/-1) + cumsum; per-column query base
   index and strand via scatter-at-starts + carry-forward
   ``associative_scan`` (intervals are start-sorted, as the overlap
   filter guarantees);
3. one gather from the concatenated query codes, then
   ``state = code + 5*strand`` or INVALID — byte-identical to
   core/pileup.build_pileup (asserted in tests/test_pileup_device.py).

The result stays on device and feeds the counting kernels directly, so
the full compare phase does one small upload and one [N, N] download.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from phylonium_tpu.config import ConfigError
from phylonium_tpu.core.homology import REVERSE, Homology
from phylonium_tpu.core.pileup import INVALID, N_BASE

# host prep (jax-free, shared with the device-server/low-mem paths):
# re-exported here so kernel-side callers keep one import surface
from phylonium_tpu.ops.pileup_prep import (  # noqa: F401
    _CODE_LUT,
    _MAX_GROUP_BASES,
    _SEP_BYTE,
    _bucket,
    _expand_ranges,
    _pack_queries_numpy,
    build_overlay,
    group_payload,
    intervals_from_homologies,
    pack_queries,
    padded_pack,
    prep_intervals,
)

def _build_core(packed, sep_idx, intervals, ref_len: int):
    # 1. 2-bit codes stay PACKED — the per-column fetch gathers the
    # byte and shifts out the code in place.  (Materializing the
    # unpacked [T/4, 4] quad array multiplies the device bytes four
    # times over at genome scale.)  Separator
    # ('!') positions — unrepresentable in 2 bits — live in an
    # on-device bitmap built from the sparse index list.
    # Covered columns always index real query bases, so trailing pack
    # padding is never read through a covered column.
    p = packed.astype(jnp.uint8)
    total = p.shape[0] * 4
    sep32 = sep_idx.astype(jnp.int32)
    bitmap = jnp.zeros((total + 7) // 8, jnp.uint8)
    bitmap = bitmap.at[sep32 >> 3].add(
        (1 << (sep32 & 7)).astype(jnp.uint8), mode="drop"
    )

    def fetch_codes(qidx):
        byte = p[qidx >> 2]
        code2 = (byte >> (2 * (qidx & 3)).astype(jnp.uint8)) & 3
        sep = (bitmap[qidx >> 3] >> (qidx & 7).astype(jnp.uint8)) & 1
        return jnp.where(sep == 1, jnp.uint8(4), code2)

    intervals = intervals.astype(jnp.int32)
    starts = intervals[:, :, 0]
    ends = intervals[:, :, 1]
    bvals = intervals[:, :, 2]
    dirs = intervals[:, :, 3]

    def one_genome(starts_g, ends_g, b_g, dir_g):
        # coverage raster (disjoint intervals -> 0/1)
        delta = jnp.zeros(ref_len + 1, jnp.int32)
        delta = delta.at[starts_g].add(1, mode="drop")
        delta = delta.at[ends_g].add(-1, mode="drop")
        cov = jnp.cumsum(delta[:-1]) > 0

        # piecewise-constant (B, dir) fill by delta-cumsum: intervals are
        # start-sorted, so scattering successive differences at the
        # starts and cumsumming yields B_k/dir_k on [start_k, start_k+1)
        # — including the gaps, where stale values are masked by cov.
        # (A carry-forward associative_scan is equivalent but its vmapped
        # HLO OOM-killed the XLA compile service at genome scale.)
        db = jnp.concatenate([b_g[:1], b_g[1:] - b_g[:-1]])
        dd = dir_g.astype(jnp.int32)
        dd = jnp.concatenate([dd[:1], dd[1:] - dd[:-1]])
        bcol = jnp.zeros(ref_len + 1, jnp.int32)
        dcol = jnp.zeros(ref_len + 1, jnp.int32)
        bcol = bcol.at[starts_g].add(db, mode="drop")
        dcol = dcol.at[starts_g].add(dd, mode="drop")
        bfill = jnp.cumsum(bcol[:-1])
        dfill = jnp.cumsum(dcol[:-1])

        # int32 query indices: callers split query batches so one
        # build's concatenated total stays below 2^31 bases
        r = jnp.arange(ref_len, dtype=jnp.int32)
        qidx = jnp.where(dfill == 1, bfill - r, bfill + r)
        qidx = jnp.clip(qidx, 0, max(total - 1, 0))
        vals = fetch_codes(qidx).astype(jnp.int32)
        state = jnp.where(
            cov, vals + N_BASE * dfill, jnp.int32(INVALID)
        )
        return state.astype(jnp.uint8)

    return jax.vmap(one_genome)(starts, ends, bvals, dirs)


@functools.partial(jax.jit, static_argnames=("ref_len",))
def _build(packed, sep_idx, intervals, ref_len: int):
    return _build_core(packed, sep_idx, intervals, ref_len)


def _build_core_nosep(packed32, intervals, ref_len: int):
    """[N, ref_len] states from u32-packed codes + intervals, with NO
    per-column gather: columns are fetched 16 at a time through TWO u32
    window gathers per group (the 2-bit codes are LSB-first across the
    little-endian word, so a code's bit offset is linear in its index).
    The gather is the build's main cost: 8x fewer gathered elements
    keep the build under the per-group mapping time, which is what lets
    the device compare hide behind the map phase.

    A 16-column group is fetched correctly only when it lies inside one
    interval (qidx affine, slope +-1).  Partial/boundary groups — and
    '!' separator columns, whose 2-bit slot packs as code 0 — are
    overwritten afterwards by the exact host-computed sparse overlay
    (:func:`build_overlay`), which knows the query bytes."""
    p32 = packed32.astype(jnp.uint32)
    nwords = p32.shape[0]
    total = nwords * 16  # 2-bit codes

    intervals = intervals.astype(jnp.int32)
    starts = intervals[:, :, 0]
    ends = intervals[:, :, 1]
    bvals = intervals[:, :, 2]
    dirs = intervals[:, :, 3]

    def one_genome(starts_g, ends_g, b_g, dir_g):
        delta = jnp.zeros(ref_len + 1, jnp.int32)
        delta = delta.at[starts_g].add(1, mode="drop")
        delta = delta.at[ends_g].add(-1, mode="drop")
        cov = jnp.cumsum(delta[:-1]) > 0

        db = jnp.concatenate([b_g[:1], b_g[1:] - b_g[:-1]])
        dd = dir_g.astype(jnp.int32)
        dd = jnp.concatenate([dd[:1], dd[1:] - dd[:-1]])
        bcol = jnp.zeros(ref_len + 1, jnp.int32)
        dcol = jnp.zeros(ref_len + 1, jnp.int32)
        bcol = bcol.at[starts_g].add(db, mode="drop")
        dcol = dcol.at[starts_g].add(dd, mode="drop")
        bfill = jnp.cumsum(bcol[:-1])
        dfill = jnp.cumsum(dcol[:-1])

        r = jnp.arange(ref_len, dtype=jnp.int32)
        qidx = jnp.where(dfill == 1, bfill - r, bfill + r)
        qidx = jnp.clip(qidx, 0, max(total - 1, 0))

        # window base per 16-column group: the lowest code index the
        # group touches (reverse runs descend), clamped so clean groups
        # never clip (their codes are real query positions)
        q0 = qidx[::16]
        d0 = dfill[::16]
        qmin = jnp.where(d0 == 1, q0 - 15, q0)
        qmin = jnp.clip(qmin, 0, max(total - 16, 0))
        w0i = qmin >> 4
        w0 = p32[w0i]
        w1 = p32[jnp.minimum(w0i + 1, nwords - 1)]
        wbase = jnp.repeat(w0i << 4, 16, total_repeat_length=ref_len)
        w0r = jnp.repeat(w0, 16, total_repeat_length=ref_len)
        w1r = jnp.repeat(w1, 16, total_repeat_length=ref_len)
        bit = (2 * (qidx - wbase)).astype(jnp.uint32)
        sel = bit < 32
        lo = w0r >> jnp.where(sel, bit, jnp.uint32(0))
        hi = w1r >> jnp.where(sel, jnp.uint32(0), bit - 32)
        code2 = (jnp.where(sel, lo, hi) & 3).astype(jnp.int32)
        state = jnp.where(
            cov, code2 + N_BASE * dfill, jnp.int32(INVALID)
        )
        return state.astype(jnp.uint8)

    return jax.vmap(one_genome)(starts, ends, bvals, dirs)


@functools.partial(
    jax.jit, static_argnames=("ref_len", "l2", "out_width")
)
def _build_packed(packed, intervals, orow, ocol, oval,
                  ref_len: int, l2: int, out_width: int):
    """Build pileup rows AND emit them in the counting kernels' split-
    nibble layout (ops/shapes.pack_states) in one program: byte j
    = state[j] | state[j + l2] << 4 for j < l2, INVALID-packed beyond.
    The streaming feeder ships 2-bit queries + interval records + the
    sparse separator overlay (a fraction of the nibble-states volume)
    and gets chunk arrays that feed the exact same counting program as
    host packing."""
    s = _build_core_nosep(packed, intervals, ref_len)
    # sparse separator overlay (host-computed, ops order irrelevant:
    # (row, col) pairs are unique — ref intervals are disjoint); padded
    # entries carry out-of-range rows and drop
    s = s.at[orow, ocol].set(oval, mode="drop")
    if s.shape[1] < 2 * l2:
        s = jnp.pad(
            s, ((0, 0), (0, 2 * l2 - s.shape[1])),
            constant_values=INVALID,
        )
    core = s[:, :l2] | (s[:, l2 : 2 * l2] << 4)
    if out_width > l2:
        core = jnp.pad(
            core, ((0, 0), (0, out_width - l2)),
            constant_values=INVALID | (INVALID << 4),
        )
    return core[:, :out_width].astype(jnp.uint8)


def build_packed_rows_device(
    queries: list[np.ndarray],
    homologies: list[list[Homology]],
    ref_len: int,
    l2: int,
    out_width: int,
    pad_rows: int = 0,
    resident=None,
):
    """One streamed row group: ship 2-bit-packed queries + interval
    records (~L/4 bytes per genome — half the nibble-states volume) and
    build + nibble-pack the pileup rows on device in a single program.

    Returns the [len(queries) + pad_rows, out_width] uint8 device chunk
    (dispatch is async); ``pad_rows`` appends INVALID-packed rows (the
    flat kernel's row padding).  Bit-identical to
    ``pack_states(host_rows, n + pad_rows, out_width)`` — asserted in
    tests/test_stream.py.

    ``resident`` (optional) is a (packed_dev, bases, seps) triple for
    THIS group, already on device (shipped during the read/index phases
    by core/query_ship.QueryShipper): only the interval records + the
    sparse separator overlay ship here, and the same cached program
    runs on the resident array.
    """
    limit = _MAX_GROUP_BASES - 2 * ref_len - 1
    if queries and sum(len(q) for q in queries) > limit:
        raise ConfigError(
            "device pileup group exceeds int32 indexing; use smaller "
            "row groups"
        )
    if resident is not None:
        packed, bases, seps = resident
    else:
        packed, bases, seps = group_payload(queries)
    intervals = prep_intervals(homologies, bases, ref_len, pad_rows)
    overlay = build_overlay(intervals, queries, bases, seps, ref_len)
    return dispatch_build_packed(
        packed, intervals, overlay, ref_len, l2, out_width
    )


def dispatch_build_packed(
    packed, intervals, overlay, ref_len: int, l2: int, out_width: int
):
    """Device half of one group build (see :func:`prep_intervals`)."""
    ref_pad = _bucket(ref_len)
    orow, ocol, oval = overlay
    return _build_packed(
        jnp.asarray(packed),
        jnp.asarray(intervals),
        jnp.asarray(orow),
        jnp.asarray(ocol),
        jnp.asarray(oval),
        ref_pad,
        l2,
        out_width,
    )


def build_pileup_device(
    queries: list[np.ndarray],
    homologies: list[list[Homology]],
    ref_len: int,
):
    """[N, >=ref_len] uint8 device state matrix (== core/pileup result,
    right-padded with INVALID to a shape bucket).

    All device shapes are padded to quarter-octave buckets so repeat
    runs at similar scales reuse compiled executables; padding entries
    scatter out of range (dropped) or read never-used positions.
    Query batches whose concatenated size exceeds int32 indexing are
    built in row groups and concatenated on device.
    """
    # reverse intervals address up to group_bases + 2*ref_len (see
    # _MAX_GROUP_BASES note); reserve that headroom
    limit = _MAX_GROUP_BASES - 2 * ref_len - 1
    total_all = sum(len(q) for q in queries)
    if queries and max(len(q) for q in queries) > limit:
        raise ConfigError(
            "device pileup builder addresses queries with int32 "
            f"indices; a {max(len(q) for q in queries)}-base query "
            "needs the host builder"
        )
    if total_all >= limit and len(queries) > 1:
        groups = []
        row = 0
        while row < len(queries):
            end = row + 1
            acc = len(queries[row])
            while (
                end < len(queries)
                and acc + len(queries[end]) < limit
            ):
                acc += len(queries[end])
                end += 1
            groups.append(
                build_pileup_device(
                    queries[row:end], homologies[row:end], ref_len
                )
            )
            row = end
        width = max(g.shape[1] for g in groups)
        groups = [
            jnp.pad(
                g,
                ((0, 0), (0, width - g.shape[1])),
                constant_values=INVALID,
            )
            for g in groups
        ]
        return jnp.concatenate(groups, axis=0)

    packed, sep_idx, bases = padded_pack(queries)
    intervals = intervals_from_homologies(homologies, bases, ref_len)

    hmax = intervals.shape[1]
    h_pad = _bucket(hmax, lo=16) - hmax
    if h_pad:
        fill = np.full(
            (intervals.shape[0], h_pad, 4), ref_len, dtype=np.int64
        )
        fill[:, :, 3] = 0
        intervals = np.concatenate([intervals, fill], axis=1)

    # build at bucketed width: columns >= ref_len have no intervals and
    # come out INVALID, which the counting kernels ignore — so the
    # padded matrix can feed pair counting directly, and slicing
    # [:, :ref_len] recovers the exact host pileup
    ref_pad = _bucket(ref_len)
    return _build(
        jnp.asarray(packed),
        jnp.asarray(sep_idx),
        jnp.asarray(intervals),
        ref_pad,
    )
