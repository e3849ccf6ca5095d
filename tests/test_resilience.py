"""Nothing hides the device.

Explicit device paths (``--count-backend device|pallas``, ``--mesh``,
``--map-backend hybrid``) fail the run on a device error: non-zero
exit, the error on stderr, no host fallback, no retry.  Only the
``auto`` race lets the bit-identical host count carry the run, and it
records how the device leg ended (won, lost, error, skipped) in the
run report and warns about an error on stderr.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import phylonium_tpu.core.pipeline as pipe
import phylonium_tpu.ops.device_counts as dc
from phylonium_tpu.config import ConfigError, RunConfig
from phylonium_tpu.core.pipeline import pair_counts
from phylonium_tpu.ops.match_table import pair_counts_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def states(rng):
    return rng.integers(0, 11, size=(12, 4096), dtype=np.uint8)


@pytest.fixture
def panel(tmp_path):
    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, 3000)
    files = []
    for k in range(3):
        arr = base.copy()
        idx = rng.random(arr.size) < 0.02 * (k + 1)
        arr[idx] = (arr[idx] + rng.integers(1, 4, int(idx.sum()))) % 4
        seq = bytes(b"ACGT"[c] for c in arr)
        p = tmp_path / f"R{k}.fasta"
        p.write_bytes(b">R%d\n" % k + seq + b"\n")
        files.append(str(p))
    return files


def _run(*argv):
    from phylonium_tpu.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--progress=never", *argv])
    return rc, out.getvalue()


def _boom(message):
    calls = []

    def fail(*a, **k):
        calls.append(1)
        raise RuntimeError(message)

    return fail, calls


@pytest.mark.parametrize("backend", ["device", "pallas"])
def test_explicit_device_error_fails_run(states, monkeypatch, backend):
    fail, calls = _boom("INTERNAL: kernel launch failed")
    monkeypatch.setattr(dc, "pair_counts_states", fail)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        pair_counts(states, RunConfig(count_backend=backend))
    assert calls == [1]


def test_resource_exhausted_is_not_retried_into_host(states, monkeypatch):
    """The GPU reports out-of-memory as RESOURCE_EXHAUSTED: an explicit
    device run surfaces it once — no retry, no host fallback."""
    fail, calls = _boom("RESOURCE_EXHAUSTED: Out of memory allocating")
    monkeypatch.setattr(dc, "pair_counts_states", fail)
    import phylonium_tpu.ops.bitplane_host as bh

    host_calls = []
    monkeypatch.setattr(
        bh, "pair_counts_host", lambda *a, **k: host_calls.append(1)
    )
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        pair_counts(states, RunConfig(count_backend="device"))
    assert calls == [1] and host_calls == []


def test_mesh_error_fails_run(states, monkeypatch):
    import phylonium_tpu.parallel.distributed as dist

    fail, calls = _boom("UNAVAILABLE: collective failed")
    monkeypatch.setattr(dist, "pair_counts_sharded", fail)
    with pytest.raises(RuntimeError, match="collective failed"):
        pair_counts(states, RunConfig(mesh="2,4"))
    assert calls == [1]


def test_nontransient_error_still_raises(states, monkeypatch):
    """A genuine defect in the device path keeps its traceback."""

    def boom(s, cfg, progress=None):
        raise RuntimeError("shape mismatch in dot_general")

    monkeypatch.setattr(pipe, "_pair_counts_device", boom)
    cfg = RunConfig(count_backend="device", progress="never")
    with pytest.raises(RuntimeError, match="shape mismatch"):
        pair_counts(states, cfg)


def test_cli_explicit_device_error_exits_nonzero(panel, tmp_path):
    """Through the real entry point: the failing kernel gives a non-zero
    exit and the error on stderr, and no matrix on stdout."""
    script = (
        "import runpy, sys\n"
        "import phylonium_tpu.ops.device_counts as dc\n"
        "def boom(*a, **k):\n"
        "    raise RuntimeError('RESOURCE_EXHAUSTED: injected OOM')\n"
        "dc.pair_counts_states = boom\n"
        "sys.argv = ['phylonium_tpu', *sys.argv[1:]]\n"
        "runpy.run_module('phylonium_tpu', run_name='__main__')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c", script, "--progress=never",
         "--count-backend=device", *panel],
        capture_output=True, timeout=300, env=env, text=True,
    )
    assert r.returncode != 0
    assert "RESOURCE_EXHAUSTED: injected OOM" in r.stderr
    assert r.stdout == ""


def test_hybrid_map_error_fails_run(tmp_path, monkeypatch):
    """--map-backend hybrid names the device mapper: its error fails
    the run instead of silently mapping on the host."""
    import phylonium_tpu.core.hybrid_map as hm

    rng = np.random.default_rng(11)
    base = rng.integers(0, 4, 2500)
    files = []
    for k in range(2):
        arr = base.copy()
        idx = rng.random(arr.size) < 0.03 * (k + 1)
        arr[idx] = (arr[idx] + rng.integers(1, 4, int(idx.sum()))) % 4
        p = tmp_path / f"H{k}.fasta"
        p.write_bytes(b">H%d\n" % k + bytes(b"ACGT"[c] for c in arr) + b"\n")
        files.append(str(p))
    fail, calls = _boom("ABORTED: device error")
    monkeypatch.setattr(hm, "hybrid_map_queries", fail)
    with pytest.raises(RuntimeError, match="ABORTED"):
        _run("--map-backend=hybrid", *files)
    assert calls == [1]


def test_carrier_reported_for_host_and_numpy(states):
    for backend, expect in (("host", "host"), ("numpy", "numpy")):
        cfg = RunConfig(count_backend=backend, progress="never")
        pair_counts(states, cfg)
        assert pipe.LAST_RUN_INFO["compare_carrier"] == expect


def test_explicit_device_carrier_and_interpret_on_cpu(states, monkeypatch):
    """A CPU-pinned explicit device run executes the kernel in interpret
    mode (the only place it may), bit-identically, carrier 'device'."""
    seen = []
    real = dc._panel_counts

    def spy(dev, packed, interpret):
        seen.append(interpret)
        return real(dev, packed, interpret)

    monkeypatch.setattr(dc, "_panel_counts", spy)
    subs, homs = pair_counts(states, RunConfig(count_backend="device"))
    es, eh = pair_counts_numpy(states)
    np.testing.assert_array_equal(subs, es)
    np.testing.assert_array_equal(homs, eh)
    assert seen == [True]
    assert pipe.LAST_RUN_INFO["compare_carrier"] == "device"


def test_run_report_file(panel, tmp_path, monkeypatch):
    """PHYLONIUM_TPU_RUN_REPORT dumps {compare_carrier, timings}; an
    explicit device run that succeeded reports carrier 'device'."""
    report = tmp_path / "report.json"
    monkeypatch.setenv("PHYLONIUM_TPU_RUN_REPORT", str(report))
    rc, _ = _run("--count-backend", "device", *panel)
    assert rc == 0
    info = json.loads(report.read_text())
    assert info["compare_carrier"] == "device"
    assert "compare" in info["timings"]


@pytest.fixture
def uncached_device(monkeypatch):
    """Act as a non-CPU-pinned process whose device work fails the way
    a CPU backend refuses a compiled (non-interpret) kernel, without
    touching the worker's compile-cache configuration."""
    import phylonium_tpu.utils.cache as cache
    import phylonium_tpu.utils.platform as plat

    monkeypatch.setattr(plat, "cpu_pinned", lambda: False)
    monkeypatch.setattr(cache, "_enabled", True)
    monkeypatch.setattr(pipe, "_device_count", lambda: 1)
    monkeypatch.setenv("PHYLONIUM_TPU_AUTO_DEVICE_GBP", "0")


@pytest.fixture
def host_waits_for_device(monkeypatch):
    """The race's host leg starts counting only once the device leg has
    finished (either way), so the device leg's outcome is the one the
    race sees first."""
    import phylonium_tpu.ops.bitplane_host as bh

    real_host = bh.pair_counts_host

    def slow_host(s, poll=None, progress=None):
        while poll is not None and not poll():
            pass
        return real_host(s, poll=poll, progress=progress)

    monkeypatch.setattr(bh, "pair_counts_host", slow_host)


def test_run_report_records_device_leg_error(
    panel, tmp_path, monkeypatch, capsys, uncached_device,
    host_waits_for_device,
):
    """In the auto race a failing device leg never fails the run: exit
    0, stdout byte-identical to the host run, and the run report plus a
    stderr warning (no debug variable needed) carry the error."""
    rc0, host_out = _run("--count-backend", "host", *panel)
    assert rc0 == 0
    capsys.readouterr()
    report = tmp_path / "report.json"
    monkeypatch.setenv("PHYLONIUM_TPU_RUN_REPORT", str(report))
    monkeypatch.delenv("PHYLONIUM_TPU_DEBUG", raising=False)
    rc, out = _run(*panel)
    assert rc == 0
    assert out == host_out
    info = json.loads(report.read_text())
    assert info["compare_carrier"] == "host"
    assert info["device_leg"]["outcome"] == "error"
    assert "interpret" in info["device_leg"]["error"]
    assert "device leg failed" in capsys.readouterr().err


def test_run_report_records_device_leg_won(
    panel, tmp_path, monkeypatch, uncached_device, host_waits_for_device
):
    """A device leg that finishes first is recorded as 'won'."""

    def fast_device(s):
        return pair_counts_numpy(s)

    monkeypatch.setattr(dc, "pair_counts_states", fast_device)
    report = tmp_path / "report.json"
    monkeypatch.setenv("PHYLONIUM_TPU_RUN_REPORT", str(report))
    rc, _ = _run(*panel)
    assert rc == 0
    info = json.loads(report.read_text())
    assert info["device_leg"] == {"outcome": "won"}
    assert info["compare_carrier"] == "device"


def test_devd_engaged_serial_auto_skips_device_leg(states, monkeypatch):
    """With the device server engaged, a serial (unstreamed) auto
    compare never opens the card in this process: host carrier, leg
    recorded as skipped."""
    import phylonium_tpu.utils.platform as plat

    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    monkeypatch.setattr(plat, "cpu_pinned", lambda: False)
    fail, calls = _boom("must not run")
    monkeypatch.setattr(dc, "pair_counts_states", fail)
    cfg = RunConfig(auto_device_min_gbp=0.0)
    subs, homs = pair_counts(states, cfg)
    es, eh = pair_counts_numpy(states)
    np.testing.assert_array_equal(subs, es)
    assert calls == []
    assert pipe.LAST_RUN_INFO["device_leg"] == {"outcome": "skipped"}
    assert pipe.LAST_RUN_INFO["compare_carrier"] == "host"


@pytest.mark.parametrize(
    "cfg",
    [
        RunConfig(count_backend="device"),
        RunConfig(count_backend="pallas"),
        RunConfig(mesh="2,4"),
    ],
    ids=["device", "pallas", "mesh"],
)
def test_devd_engaged_explicit_paths_refused(states, monkeypatch, cfg):
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    with pytest.raises(ConfigError, match="device server"):
        pair_counts(states, cfg)


def test_record_device_leg_first_line_only(capsys):
    cfg = RunConfig()
    pipe.record_device_leg(
        "error", ValueError("line one\nline two\nline three"), cfg
    )
    assert pipe.LAST_RUN_INFO["device_leg"] == {
        "outcome": "error",
        "error": "ValueError: line one",
    }
    err = capsys.readouterr().err
    assert "line one" in err and "line two" not in err
