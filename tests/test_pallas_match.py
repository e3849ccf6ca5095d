"""Fused counting kernel correctness (interpret mode on the CPU).

The compiled kernel runs only on the GPU; its interpret mode executes
the same kernel body here, so these tests pin the arithmetic, the tile
and column-split bookkeeping and the wrapper's padding.  The compiled
kernel is compared with the plain references on the card by
``chip_smoke.py`` (phases 1-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from phylonium_tpu.ops.device_counts import (
    pair_counts_chunks,
    pair_counts_states,
    panel_shape,
)
from phylonium_tpu.ops.match_matrix import block_counts
from phylonium_tpu.ops.match_table import pair_counts_numpy
import phylonium_tpu.ops.pallas_match as pm
from phylonium_tpu.ops.pallas_match import (
    _PARTNERS,
    column_ranges,
    cross_counts_pallas,
    split_count,
)
from phylonium_tpu.ops.shapes import (
    LARGE_TILE,
    SMALL_TILE,
    _PACKED_PAD,
    pack_states,
    pad_rows,
    packed_width,
    tile_for,
)


def test_partner_sets():
    # forward A matches forward A and reverse T; forward T additionally
    # matches the reverse '!' (the ASCII complement quirk)
    assert _PARTNERS[0] == (0, 8)  # (A,f) -> (A,f), (T,r)
    assert 9 in _PARTNERS[3]  # (T,f) matches (!,r)
    assert all(len(p) <= 3 for p in _PARTNERS)


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_equals_numpy(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 7))
    length = int(rng.integers(100, 1200))
    states = rng.integers(0, 11, size=(n, length)).astype(np.uint8)
    s0, h0 = pair_counts_numpy(states)
    s1, h1 = pair_counts_states(states)
    assert np.array_equal(s0, s1)
    assert np.array_equal(h0, h1)


@pytest.mark.parametrize("bk", [32, 64])
def test_pallas_chunking_exactness(bk):
    """Many column steps split over several grid segments sum exactly
    (the in-kernel loop and the per-segment partials)."""
    rng = np.random.default_rng(2)
    states = rng.integers(0, 11, size=(3, 2000)).astype(np.uint8)
    s0, h0 = pair_counts_numpy(states)
    n_pad, width = panel_shape(3, packed_width(2000))
    packed = jnp.asarray(pack_states(states, n_pad, width))
    assert width // bk > 1 and split_count(1, width // bk) > 1
    m, h = cross_counts_pallas(
        packed, packed, symmetric=True, interpret=True, bk=bk
    )
    m = np.asarray(m, np.int64)[:3, :3]
    h = np.asarray(h, np.int64)[:3, :3]
    sub = h - m
    np.fill_diagonal(sub, 0)
    np.fill_diagonal(h, 0)
    assert np.array_equal(sub, s0)
    assert np.array_equal(h, h0)


def test_row_blocked_equals_flat():
    """Several row tiles: the symmetric (upper-triangle + mirror) grid,
    the full rectangular grid and the oracle agree."""
    rng = np.random.default_rng(3)
    n = 2 * SMALL_TILE + 5
    states = rng.integers(0, 11, size=(n, 700)).astype(np.uint8)
    s0, h0 = pair_counts_numpy(states)
    s1, h1 = pair_counts_states(states)
    assert np.array_equal(s0, s1)
    assert np.array_equal(h0, h1)
    n_pad, width = panel_shape(n, packed_width(700))
    packed = jnp.asarray(pack_states(states, n_pad, width))
    sym = cross_counts_pallas(packed, packed, symmetric=True, interpret=True)
    full = cross_counts_pallas(packed, packed, interpret=True)
    for a, b in zip(sym, full):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_cross_counts_rectangular(rng):
    """A row block against a different, taller block (the mesh shard
    body's shape) matches the plain XLA reference."""
    a = rng.integers(0, 11, size=(SMALL_TILE, 256)).astype(np.uint8)
    b = rng.integers(0, 11, size=(3 * SMALL_TILE, 256)).astype(np.uint8)
    m, h = cross_counts_pallas(
        jnp.asarray(a), jnp.asarray(b), packed=False, interpret=True
    )
    both = np.concatenate([a, b])
    rm, rh = block_counts(jnp.asarray(both))
    assert np.array_equal(np.asarray(m), np.asarray(rm)[:SMALL_TILE, SMALL_TILE:])
    assert np.array_equal(np.asarray(h), np.asarray(rh)[:SMALL_TILE, SMALL_TILE:])


def test_unpacked_device_input_matches_packed(rng):
    """A device-resident unpacked panel counts like the host-packed one
    (the wrapper pads rows and columns on the device)."""
    states = rng.integers(0, 11, size=(9, 333)).astype(np.uint8)
    packed = pair_counts_states(states)
    unpacked = pair_counts_states(jnp.asarray(states))
    for a, b in zip(packed, unpacked):
        assert np.array_equal(a, b)


def test_chunks_concatenate_and_pad(rng):
    """Row chunks of a panel (the feeder's shipped groups) count exactly,
    whatever their split and with no row padding of their own."""
    states = rng.integers(0, 11, size=(11, 500)).astype(np.uint8)
    width = packed_width(500)
    packed = pack_states(states, 11, width)
    chunks = [jnp.asarray(packed[lo:hi]) for lo, hi in ((0, 4), (4, 5), (5, 11))]
    s1, h1 = pair_counts_chunks(chunks, 11)
    s0, h0 = pair_counts_numpy(states)
    assert np.array_equal(s0, s1)
    assert np.array_equal(h0, h1)


def test_tile_and_padding_rules():
    assert tile_for(1) == SMALL_TILE
    assert tile_for(256) == SMALL_TILE
    assert tile_for(257) == LARGE_TILE
    for n in (1, 29, 64, 65, 256, 257, 600, 1000):
        n_pad = pad_rows(n)
        assert n_pad >= n and n_pad % tile_for(n_pad) == 0, n
    assert split_count(1, 10) == 10
    assert split_count(10_000, 10) == 1
    assert split_count(36, 5000) * 36 >= 264


@pytest.mark.parametrize(
    "rows_a,rows_b,width,bk,n_ranges",
    [
        (1024, 1024, 1 << 20, 64, 1),  # 1 GiB: 32-bit offsets suffice
        (512, 512, 5_242_880, 64, 2),  # 450 x 5 Mbp state bytes, 2.7 GB
        (1024, 1024, 2_621_440, 64, 2),  # 1000 x 5 Mbp packed, 2.7 GB
        (4096, 4096, 1_048_576, 64, 2),  # exactly 4 GiB: still 32-bit
        (1024, 1024, 5_242_880, 64, 1),  # 5.4 GB: the lowering's 64-bit
        # a row shard in the band against all rows above it
        (512, 1024, 5_242_880, 64, 3),
    ],
)
def test_column_ranges_keep_offsets_in_range(rows_a, rows_b, width, bk,
                                             n_ranges):
    """Operands between 2**31 elements and 2**32 bytes are launched in
    column ranges of at most 2**31 elements; the ranges tile the width
    in whole column steps."""
    ranges = column_ranges(rows_a, rows_b, width, bk)
    assert len(ranges) == n_ranges
    assert ranges[0][0] == 0 and ranges[-1][1] == width
    for (lo, hi), nxt in zip(ranges, ranges[1:] + [(width, None)]):
        assert hi == nxt[0] and lo % bk == 0 and hi % bk == 0 and hi > lo
        if n_ranges > 1:
            assert max(rows_a, rows_b) * (hi - lo) <= 1 << 31


def test_column_ranges_launches_sum_exactly(rng, monkeypatch):
    """With the offset limits shrunk to toy sizes, the kernel launches
    once per column range and the summed counts equal the one-launch
    counts and the oracle, for the symmetric and the rectangular grid."""
    states = rng.integers(0, 11, size=(9, 890)).astype(np.uint8)
    s0, h0 = pair_counts_numpy(states)
    width = packed_width(890)
    packed = jnp.asarray(pack_states(states, SMALL_TILE, width))
    whole = cross_counts_pallas(packed, packed, symmetric=True, interpret=True)
    launches = []
    real = pm._launch

    def spy(a, b, **kw):
        launches.append(a.shape[1])
        return real(a, b, **kw)

    monkeypatch.setattr(pm, "_launch", spy)
    monkeypatch.setattr(pm, "_I32_ELEMS", SMALL_TILE * 32 * 5)
    monkeypatch.setattr(pm, "_I64_BYTES", SMALL_TILE * width)
    cross_counts_pallas.clear_cache()
    try:
        sym = cross_counts_pallas(packed, packed, symmetric=True, interpret=True)
        assert launches == [160, 160, 160, 32]
        rect = cross_counts_pallas(packed, packed, interpret=True)
    finally:
        cross_counts_pallas.clear_cache()
    for x, y, z in zip(whole, sym, rect):
        assert np.array_equal(np.asarray(x), np.asarray(y))
        assert np.array_equal(np.asarray(x), np.asarray(z))
    m = np.asarray(sym[0], np.int64)[:9, :9]
    h = np.asarray(sym[1], np.int64)[:9, :9]
    sub = h - m
    np.fill_diagonal(sub, 0)
    np.fill_diagonal(h, 0)
    assert np.array_equal(sub, s0) and np.array_equal(h, h0)


def test_padding_contributes_nothing(rng):
    """Extra INVALID rows and packed-INVALID columns leave the counts
    of the real rows untouched."""
    states = rng.integers(0, 11, size=(5, 300)).astype(np.uint8)
    tight = pack_states(states, SMALL_TILE, packed_width(300))
    wide = np.full((SMALL_TILE, tight.shape[1] + 256), _PACKED_PAD, np.uint8)
    wide[:, : tight.shape[1]] = tight
    a = cross_counts_pallas(jnp.asarray(tight), jnp.asarray(tight), interpret=True)
    b = cross_counts_pallas(jnp.asarray(wide), jnp.asarray(wide), interpret=True)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_pack_states_native_matches_numpy(rng):
    """The one-pass native packer must be byte-identical to the numpy
    formulation for every shape/padding combination."""
    for n, length, n_pad, width in [
        (1, 1, 32, 128),
        (3, 7, 8, 4),
        (5, 101, 5, 51),
        (4, 100, 6, 64),
        (2, 0, 4, 8),
    ]:
        states = rng.integers(0, 11, size=(n, length), dtype=np.uint8)
        native = pack_states(states, n_pad, width)
        # force the numpy fallback
        import unittest.mock as mock

        with mock.patch(
            "phylonium_tpu.native.pack_states_native",
            side_effect=RuntimeError,
        ):
            fallback = pack_states(states, n_pad, width)
        np.testing.assert_array_equal(native, fallback, err_msg=str((n, length)))
