"""Persisted deployment calibration (utils/calibration.py) and the
measured-link dispatch gates it feeds (core/pipeline, core/query_ship).

The gates must (a) keep the static work-threshold behavior when no
measurement exists — every other test in the suite relies on that —
and (b) act on the measured figures when they do.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from phylonium_tpu.config import RunConfig
from phylonium_tpu.utils import calibration


@pytest.fixture
def calfile(tmp_path, monkeypatch):
    path = tmp_path / "calibration.json"
    monkeypatch.setenv("PHYLONIUM_TPU_CALIBRATION_FILE", str(path))
    return path


def test_record_ewma_roundtrip(calfile):
    calibration.record("link_mb_s", 10.0)
    assert calibration.link_mb_s() == 10.0
    calibration.record("link_mb_s", 30.0)
    assert calibration.link_mb_s() == 20.0  # 0.5*10 + 0.5*30
    data = json.loads(calfile.read_text())
    assert data["samples"]["link_mb_s"] == 2
    assert data["updated"] > 0


def test_corrupt_file_tolerated(calfile):
    calfile.write_text("{not json")
    assert calibration.load() == {}
    assert calibration.link_mb_s() is None
    calibration.record("link_mb_s", 5.0)  # overwrites the corrupt file
    assert calibration.link_mb_s() == 5.0


def test_rejects_garbage_samples(calfile):
    calibration.record("link_mb_s", 0.0)
    calibration.record("link_mb_s", -3.0)
    calibration.record("link_mb_s", float("nan"))
    assert calibration.link_mb_s() is None


def test_link_noise_floor(calfile):
    calibration.record_link(1 << 20, 0.5)  # 1 MB: RTT-dominated, dropped
    assert calibration.link_mb_s() is None
    calibration.record_link(8 << 20, 1.0)
    assert calibration.link_mb_s() == pytest.approx(8.389, abs=0.01)


def test_cpu_pinned_is_hermetic(monkeypatch):
    """Without the env override, CPU-pinned processes (the whole test
    suite) neither read nor write the real calibration file — gate
    behavior must not depend on the developer machine's history."""
    monkeypatch.delenv("PHYLONIUM_TPU_CALIBRATION_FILE", raising=False)
    assert calibration._path() is None
    assert calibration.load() == {}
    calibration.record("link_mb_s", 99.0)  # no-op
    assert calibration.link_mb_s() is None


def test_defaults_without_measurements(calfile):
    assert calibration.host_compare_gbps() == 25.0
    assert calibration.map_gbps() == 0.2
    snap = calibration.snapshot()
    assert snap["link_mb_s"] is None


def test_auto_prefers_host_static_without_link(calfile):
    """No link measurement -> the static work threshold decides
    (historic behavior, relied on suite-wide)."""
    from phylonium_tpu.core.pipeline import _auto_prefers_host

    cfg = RunConfig()
    assert _auto_prefers_host(29, 5_000_000, cfg)  # 2.1 Gbp < 128
    assert not _auto_prefers_host(1000, 1_000_000, cfg)  # 500 Gbp


def test_auto_prefers_host_uses_measured_link(calfile):
    """With a measured link, the serial dispatch compares predicted
    host compare time against predicted ship time."""
    from phylonium_tpu.core.pipeline import LAST_RUN_INFO, _auto_prefers_host

    cfg = RunConfig()
    # n=116 x 5 Mbp: work 33.4 Gbp.  Fast host (60 Gbp/s -> 0.56 s),
    # decent link (30 MB/s -> serial ship 290 MB ~ 9.7 s): host wins.
    calibration.record("link_mb_s", 30.0)
    calibration.record("host_compare_gbps", 60.0)
    assert _auto_prefers_host(116, 5_000_000, cfg)
    assert LAST_RUN_INFO["dispatch_model"]["link_mb_s"] == 30.0
    # Absurdly fast link (ship ~0.1 s), slow host: device wins even at
    # a scale the static threshold would keep on host.
    calibration.record("link_mb_s", 5000.0)
    calibration.record("link_mb_s", 5000.0)
    calibration.record("host_compare_gbps", 2.0)
    calibration.record("host_compare_gbps", 2.0)
    assert not _auto_prefers_host(116, 5_000_000, cfg)


def test_env_override_pins_static_rule(calfile, monkeypatch):
    from phylonium_tpu.core.pipeline import (
        _auto_prefers_host,
        _stream_predicts_win,
    )

    calibration.record("link_mb_s", 5000.0)
    monkeypatch.setenv("PHYLONIUM_TPU_AUTO_DEVICE_GBP", "128")
    cfg = RunConfig()
    assert _auto_prefers_host(116, 5_000_000, cfg)  # static again
    assert _stream_predicts_win(116, 5_000_000, cfg) is None


def test_stream_predicts_win(calfile):
    from phylonium_tpu.core.pipeline import _stream_predicts_win

    cfg = RunConfig()
    assert _stream_predicts_win(600, 1_000_000, cfg) is None  # no link
    # 600 x 1 Mbp: work 179.7 Gbp.  Host at 30 Gbp/s -> ~6 s compare.
    # 2-bit panel = 150 MB; at 30 MB/s that's 5 s, hidden under a
    # 0.6 Gbp / 0.2 Gbp/s = 3 s map window -> ~2 s unhidden < 6 s:
    # stream.
    calibration.record("link_mb_s", 30.0)
    calibration.record("host_compare_gbps", 30.0)
    assert _stream_predicts_win(600, 1_000_000, cfg) is True
    # collapse the link to 2 MB/s: 75 s ship, nowhere to hide it
    for _ in range(12):
        calibration.record("link_mb_s", 2.0)
    assert _stream_predicts_win(600, 1_000_000, cfg) is False


def test_stream_predicts_win_devd(calfile, monkeypatch):
    """With the device server on, shipped misses are the next run's
    cache hits and the devd race leg costs the host leg nothing: the
    gate ignores the link and lets the race decide every panel."""
    from phylonium_tpu.core.pipeline import LAST_RUN_INFO, _stream_predicts_win

    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    calibration.record("link_mb_s", 0.5)  # collapsed link: irrelevant
    calibration.record("host_compare_gbps", 30.0)
    cfg = RunConfig()
    assert _stream_predicts_win(600, 1_000_000, cfg) is True  # ~6 s host
    assert _stream_predicts_win(29, 5_000_000, cfg) is True  # ~0.07 s
    assert LAST_RUN_INFO["stream_model"]["devd"] is True


def test_should_stream_follows_link_prediction(calfile, monkeypatch):
    """_should_stream engages on a measured-link win even when the
    static threshold would have kept the panel on host — and stays
    serial on a measured loss."""
    import phylonium_tpu.core.pipeline as pl

    class FakeRef:
        backend_name = "native"

    monkeypatch.delenv("PHYLONIUM_TPU_STREAM", raising=False)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "0")  # the link-model path
    # pretend this is not a CPU-pinned process (the gate's last check)
    monkeypatch.setattr(pl, "_is_multiprocess", lambda: False)
    import phylonium_tpu.utils.platform as plat

    monkeypatch.setattr(plat, "cpu_pinned", lambda: False)
    # the suite's virtual 8-device CPU mesh would divert to the mesh
    # path; this test is about the single-device link gate
    monkeypatch.setattr(pl, "_device_count", lambda: 1)
    cfg = RunConfig()
    # measured win at 600 x 1 Mbp (static threshold: 179 Gbp >= 128
    # would stream anyway, so use 200 x 1 Mbp = 19.9 Gbp < 128):
    calibration.record("link_mb_s", 100.0)
    calibration.record("host_compare_gbps", 3.0)
    assert pl._should_stream(200, 1_000_000, cfg, FakeRef())
    for _ in range(14):
        calibration.record("link_mb_s", 0.5)
    assert not pl._should_stream(200, 1_000_000, cfg, FakeRef())


def test_early_ship_eligible(calfile, tmp_path, monkeypatch):
    import phylonium_tpu.utils.platform as plat
    from phylonium_tpu.core.query_ship import early_ship_eligible

    files = []
    for k in range(140):
        p = tmp_path / f"g{k}.fa"
        p.write_bytes(b">g\n" + b"A" * 1_000_000 + b"\n")
        files.append(str(p))

    monkeypatch.delenv("PHYLONIUM_TPU_STREAM", raising=False)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "0")  # the link-model path
    monkeypatch.setattr(plat, "cpu_pinned", lambda: False)
    calibration.record("link_mb_s", 100.0)
    calibration.record("host_compare_gbps", 3.0)
    assert early_ship_eligible(RunConfig(), files)
    # structural exclusions win regardless of the link
    assert not early_ship_eligible(RunConfig(mesh="2,4"), files)
    assert not early_ship_eligible(
        RunConfig(complete_deletion=True), files
    )
    assert not early_ship_eligible(
        RunConfig(count_backend="numpy"), files
    )
    assert not early_ship_eligible(RunConfig(), files[:3])  # n <= group
    # a collapsed link keeps the read loop off the device
    for _ in range(16):
        calibration.record("link_mb_s", 0.2)
    assert not early_ship_eligible(RunConfig(), files)
    # CPU-pinned (the suite itself) never early-ships without force
    monkeypatch.setattr(plat, "cpu_pinned", lambda: True)
    assert not early_ship_eligible(RunConfig(), files)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    assert early_ship_eligible(RunConfig(), files)


def test_pipeline_records_host_compare_and_map(calfile, tmp_path):
    """A host-carried run leaves measured map/compare rates behind for
    the next run's gates (library API, tiny panel, numpy-free path)."""
    import contextlib
    import io

    from phylonium_tpu.cli import main

    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, 30_000)
    files = []
    for k in range(3):
        arr = base.copy()
        idx = rng.random(arr.size) < 0.02 * (k + 1)
        arr[idx] = (arr[idx] + rng.integers(1, 4, int(idx.sum()))) % 4
        p = tmp_path / f"s{k}.fasta"
        p.write_bytes(
            b">s%d\n" % k + bytes(b"ACGT"[c] for c in arr) + b"\n"
        )
        files.append(str(p))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--progress=never", *files]) == 0
    data = calibration.load()
    # rates recorded only when phases pass the noise floor (0.2 s);
    # a 3 x 30 kbp panel maps/compares in ms — assert the file is
    # well-formed either way and no crash path was taken
    assert isinstance(data, dict)
