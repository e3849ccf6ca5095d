"""Streamed map→pileup→transfer pipeline (core/stream.py).

The feeder's concatenated device array must be exactly the array the
one-shot packed path ships, so every chunking must count bit-identically
to the numpy oracle — and the full streamed CLI must stay byte-identical
to the serial pipeline.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import pytest

from phylonium_tpu.core.homology import FORWARD, REVERSE, Homology
from phylonium_tpu.core.pileup import build_pileup
from phylonium_tpu.core.stream import DeviceRowFeeder
from phylonium_tpu.ops.match_table import pair_counts_numpy


def _hom(direction, proj_start, iq, length):
    return Homology(
        direction=direction,
        index_reference=proj_start,
        index_reference_projected=proj_start,
        index_query=iq,
        length=length,
    )


def _panel(rng, n, ref_len):
    """Synthetic mapped panel: queries + disjoint homologies with
    forward/reverse/partial/empty coverage and '!' separators."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    queries, homologies = [], []
    for g in range(n):
        qlen = ref_len + int(rng.integers(0, 60))
        q = rng.choice(acgt, qlen).astype(np.uint8)
        if g % 4 == 1 and qlen > 40:
            q[qlen // 2] = ord("!")
        hv = []
        if g % 5 != 4:  # every 5th genome: no homologies at all
            cut = int(rng.integers(1, ref_len))
            len1 = int(rng.integers(1, cut + 1))
            hv.append(_hom(FORWARD, cut - len1, 0, len1))
            len2 = int(rng.integers(0, ref_len - cut + 1))
            if len2 > 0:
                hv.append(
                    _hom(
                        REVERSE if g % 3 == 0 else FORWARD,
                        cut, qlen - len2 - 1 if g % 3 == 0 else cut,
                        len2,
                    )
                )
        queries.append(q)
        homologies.append(hv)
    return queries, homologies


def _feed_all(queries, homologies, ref_len, groups, **kw):
    n = len(queries)
    feeder = DeviceRowFeeder(n, ref_len, **kw)
    lo = 0
    for g in groups:
        feeder.feed(queries[lo : lo + g], homologies[lo : lo + g])
        lo += g
    assert lo == n
    return feeder.finish()


@pytest.mark.parametrize(
    "n,length,groups",
    [
        (12, 700, [12]),
        (12, 700, [5, 4, 3]),
        (33, 1500, [32, 1]),
        (40, 257, [7, 13, 11, 9]),
    ],
)
def test_feeder_flat_matches_oracle(rng, n, length, groups):
    queries, homologies = _panel(rng, n, length)
    subs, homs = _feed_all(queries, homologies, length, groups)
    states = build_pileup(queries, homologies, length)
    es, eh = pair_counts_numpy(states)
    np.testing.assert_array_equal(subs, es)
    np.testing.assert_array_equal(homs, eh)


def test_feeder_blocked_matches_oracle(rng):
    """A panel above the small-tile bound counts with the large output
    tile on shipped chunks."""
    n, length = 530, 600
    queries, homologies = _panel(rng, n, length)
    subs, homs = _feed_all(
        queries, homologies, length, [256, 256, 18]
    )
    states = build_pileup(queries, homologies, length)
    es, eh = pair_counts_numpy(states)
    np.testing.assert_array_equal(subs, es)
    np.testing.assert_array_equal(homs, eh)


def test_build_packed_rows_matches_host_pack(rng):
    """The fused build-and-nibble-pack program emits exactly
    pack_states(host rows) for every padding case."""
    from phylonium_tpu.ops.shapes import pack_states
    from phylonium_tpu.ops.pileup_device import build_packed_rows_device

    for ref_len, width_pad, pad_rows in [
        (301, 0, 0), (300, 37, 3), (515, 11, 1)
    ]:
        queries, homologies = _panel(rng, 6, ref_len)
        l2 = -(-ref_len // 2)
        width = l2 + width_pad
        got = np.asarray(
            build_packed_rows_device(
                queries, homologies, ref_len, l2, width,
                pad_rows=pad_rows,
            )
        )
        rows = build_pileup(queries, homologies, ref_len)
        want = pack_states(rows, 6 + pad_rows, width)
        np.testing.assert_array_equal(got, want)


def test_build_packed_window_alignments(rng):
    """The windowed 16-column fetch must be exact for every interval
    start/end alignment mod 16: dense tilings of tiny (1..40 col)
    forward/reverse intervals, back to back, plus separators."""
    from phylonium_tpu.ops.shapes import pack_states
    from phylonium_tpu.ops.pileup_device import build_packed_rows_device

    ref_len = 640
    queries, homologies = [], []
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for g in range(24):
        qlen = 2 * ref_len
        q = rng.choice(acgt, qlen).astype(np.uint8)
        q[rng.integers(0, qlen, 5)] = ord("!")
        hv = []
        col = int(g % 16)  # start offset sweeps every alignment
        qpos = 0
        while col < ref_len - 41 and qpos < qlen - 100:
            length = int(rng.integers(1, 41))
            if (col + g) % 3 == 0:
                hv.append(
                    _hom(REVERSE, col, qlen - qpos - length, length)
                )
            else:
                hv.append(_hom(FORWARD, col, qpos, length))
            col += length + int(rng.integers(0, 3))  # gaps of 0-2
            qpos += length + 1
        queries.append(q)
        homologies.append(hv)
    l2 = -(-ref_len // 2)
    got = np.asarray(
        build_packed_rows_device(queries, homologies, ref_len, l2, l2)
    )
    rows = build_pileup(queries, homologies, ref_len)
    want = pack_states(rows, len(queries), l2)
    np.testing.assert_array_equal(got, want)


def test_feeder_error_surfaces_in_finish(rng, monkeypatch):
    import phylonium_tpu.ops.pileup_device as pd

    def boom(*a, **k):
        raise RuntimeError("injected device fault")

    queries, homologies = _panel(rng, 8, 256)
    # patch before construction: the worker binds the builder at start
    monkeypatch.setattr(pd, "build_packed_rows_device", boom)
    feeder = DeviceRowFeeder(8, 256)
    feeder.feed(queries, homologies)
    with pytest.raises(RuntimeError, match="injected device fault"):
        feeder.finish()


def _write_panel(tmp_path, n, length, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, length)
    files = []
    for k in range(n):
        arr = base.copy()
        idx = rng.random(arr.size) < 0.01 * (k + 1)
        arr[idx] = (arr[idx] + rng.integers(1, 4, int(idx.sum()))) % 4
        seq = bytes(b"ACGT"[c] for c in arr)
        p = tmp_path / f"Q{k:02d}.fasta"
        p.write_bytes(b">Q%02d\n" % k + seq + b"\n")
        files.append(str(p))
    return files


def test_streamed_cli_byte_identical(tmp_path, monkeypatch):
    """PHYLONIUM_TPU_STREAM=force drives the full streamed pipeline
    (grouped native mapping, feeder, compare race) — stdout must be
    byte-identical to the serial run, including multi-group splits."""
    from phylonium_tpu.cli import main

    files = _write_panel(tmp_path, 7, 2600, seed=3)

    def run():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(["--progress=never", *files])
        return rc, out.getvalue()

    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "0")
    rc0, serial = run()
    assert rc0 == 0

    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "3")
    rc1, streamed = run()
    assert rc1 == 0
    assert streamed == serial


def test_streamed_cli_survives_feeder_abort(tmp_path, monkeypatch, capsys):
    """A device error inside the feeder loses the device leg of the auto
    race, not the run: rc 0, byte-identical output, and the error is
    recorded as the device leg's outcome and warned on stderr."""
    import phylonium_tpu.core.stream as st
    from phylonium_tpu.cli import main

    files = _write_panel(tmp_path, 5, 2200, seed=9)

    def run():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(["--progress=never", *files])
        return rc, out.getvalue()

    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "0")
    rc0, serial = run()
    assert rc0 == 0

    class BoomFeeder(st.DeviceRowFeeder):
        def finish(self, progress=None):
            raise RuntimeError("injected device fault")

    monkeypatch.setattr(st, "DeviceRowFeeder", BoomFeeder)
    import phylonium_tpu.core.pipeline as pl

    capsys.readouterr()
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    rc1, streamed = run()
    assert rc1 == 0
    assert streamed == serial
    leg = pl.LAST_RUN_INFO["device_leg"]
    assert leg["outcome"] == "error"
    assert "injected device fault" in leg["error"]
    assert "injected device fault" in capsys.readouterr().err


def test_should_stream_conditions(monkeypatch):
    from phylonium_tpu.config import RunConfig
    from phylonium_tpu.core.pipeline import _should_stream

    class FakeRef:
        backend_name = "native"

    ref = FakeRef()
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    assert _should_stream(100, 1000, RunConfig(), ref)
    # excluded paths stay serial even when forced
    assert not _should_stream(
        100, 1000, RunConfig(complete_deletion=True), ref
    )
    assert not _should_stream(
        100, 1000, RunConfig(count_backend="pallas"), ref
    )
    assert not _should_stream(100, 1000, RunConfig(mesh="2,4"), ref)
    assert not _should_stream(
        100, 1000, RunConfig(checkpoint_dir="/tmp/x"), ref
    )
    ref.backend_name = "numpy"
    assert not _should_stream(100, 1000, RunConfig(), ref)
    ref.backend_name = "native"
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "0")
    assert not _should_stream(100, 1000, RunConfig(), ref)
    # without force: CPU platform + below-threshold panels stay serial
    monkeypatch.delenv("PHYLONIUM_TPU_STREAM", raising=False)
    assert not _should_stream(10, 1000, RunConfig(), ref)


def test_lagging_feeder_still_races(tmp_path, monkeypatch):
    """However little of the panel shipped during mapping, the streamed
    compare races the device leg (on a local card the rest ships in
    moments); the leg's outcome lands in the run report."""
    import phylonium_tpu.core.pipeline as pl
    import phylonium_tpu.core.stream as st
    from phylonium_tpu.cli import main

    files = _write_panel(tmp_path, 5, 2200, seed=21)
    finished = []

    class LaggyFeeder(st.DeviceRowFeeder):
        def shipped_fraction(self):
            return 0.0

        def finish(self, progress=None):
            finished.append(True)
            return super().finish(progress)

    monkeypatch.setattr(st, "DeviceRowFeeder", LaggyFeeder)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--progress=never", *files])
    assert rc == 0
    assert finished == [True]
    assert pl.LAST_RUN_INFO["device_leg"]["outcome"] in ("won", "lost")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "0")
    out2 = io.StringIO()
    with contextlib.redirect_stdout(out2):
        assert main(["--progress=never", *files]) == 0
    assert out.getvalue() == out2.getvalue()


def test_multi_device_runtime_never_streams(monkeypatch):
    """The stream decision reads the real device count: a runtime with
    more than one device takes the mesh path, never the single-device
    feeder."""
    import phylonium_tpu.core.pipeline as pl
    import phylonium_tpu.utils.platform as plat
    from phylonium_tpu.config import RunConfig

    class FakeRef:
        backend_name = "native"

    monkeypatch.delenv("PHYLONIUM_TPU_STREAM", raising=False)
    monkeypatch.setattr(plat, "cpu_pinned", lambda: False)
    cfg = RunConfig(auto_device_min_gbp=0.0)
    monkeypatch.setattr(pl, "_device_count", lambda: 8)
    assert not pl._should_stream(100, 1000, cfg, FakeRef())
    monkeypatch.setattr(pl, "_device_count", lambda: 1)
    assert pl._should_stream(100, 1000, cfg, FakeRef())


def test_query_shipper_groups_bit_identical(rng, monkeypatch):
    """Groups shipped at read time are bit-identical to feed-time packs
    (same pack+pad helper), and the feeder's counts on resident groups
    match the numpy oracle."""
    from phylonium_tpu.core.query_ship import QueryShipper
    from phylonium_tpu.ops.pileup_device import group_payload

    n, length = 13, 900
    queries, homologies = _panel(rng, n, length)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "5")
    shipper = QueryShipper(n)
    assert shipper.group_rows == 5
    for q in queries:
        shipper.add(q)
    # groups: [0,5) [5,10) [10,13) — take() waits for in-flight groups
    for lo in (0, 5, 10):
        hi = min(lo + 5, n)
        got = shipper.take(lo, hi)
        assert got is not None
        packed, bases, seps = got
        ep, eb, es = group_payload(queries[lo:hi])
        np.testing.assert_array_equal(np.asarray(packed), ep)
        np.testing.assert_array_equal(bases, eb)
        np.testing.assert_array_equal(seps, es)
    # boundary mismatches hand back None (feeder ships itself)
    assert shipper.take(1, 6) is None
    assert shipper.take(5, 9) is None
    assert shipper.shipped_groups() == 3
    assert shipper.shipped_bytes() > 0

    subs, homs = _feed_all(
        queries, homologies, length, [5, 5, 3], shipper=shipper
    )
    states = build_pileup(queries, homologies, length)
    es, eh = pair_counts_numpy(states)
    np.testing.assert_array_equal(subs, es)
    np.testing.assert_array_equal(homs, eh)


def test_query_shipper_cancel_mid_run(rng, monkeypatch):
    """A cancelled shipper stops accepting groups; the feeder falls
    back to feed-time shipping and counts stay exact."""
    from phylonium_tpu.core.query_ship import QueryShipper

    n, length = 10, 700
    queries, homologies = _panel(rng, n, length)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    shipper = QueryShipper(n)
    for q in queries[:4]:
        shipper.add(q)
    assert shipper.take(0, 4) is not None
    shipper.cancel()
    for q in queries[4:]:
        shipper.add(q)  # ignored after cancel
    assert shipper.take(4, 8) is None
    # verified groups stay usable after cancel (pass-2 reuse)
    assert shipper.take(0, 4) is not None

    subs, homs = _feed_all(
        queries, homologies, length, [4, 4, 2], shipper=shipper
    )
    states = build_pileup(queries, homologies, length)
    es, eh = pair_counts_numpy(states)
    np.testing.assert_array_equal(subs, es)
    np.testing.assert_array_equal(homs, eh)


def test_early_shipped_cli_byte_identical(tmp_path, monkeypatch):
    """The full early-ship pipeline through the CLI: force engages the
    read-loop shipper (early_ship_eligible), groups ship during read,
    the feeder reuses them, stdout stays byte-identical to serial."""
    import phylonium_tpu.core.pipeline as pl
    from phylonium_tpu.cli import main

    files = _write_panel(tmp_path, 9, 2400, seed=17)

    def run():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(["--progress=never", *files])
        return rc, out.getvalue()

    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "0")
    rc0, serial = run()
    assert rc0 == 0

    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    rc1, streamed = run()
    assert rc1 == 0
    assert streamed == serial
    early = pl.LAST_RUN_INFO.get("early_ship")
    # the shipper was wired through (groups is timing-dependent on a
    # tiny panel: the worker's jax import can lose the race to the
    # whole sub-second pipeline, in which case the compare legitimately
    # cancels it at 0 — resident-group consumption is asserted
    # deterministically in test_query_shipper_groups_bit_identical)
    assert early is not None and 0 <= early["groups"] <= 3


def test_prewarm_stream_shapes(monkeypatch):
    """prewarm_stream compiles the exact chunk layouts the feeder
    produces (smoke: no exceptions for flat + blocked, tail + no-tail)."""
    from phylonium_tpu.core.stream import prewarm_stream

    prewarm_stream(12, 700, group_rows=5)
    prewarm_stream(530, 600, group_rows=256)
    prewarm_stream(128, 1000, group_rows=128)
