"""Device server (phylonium_tpu/serve/): warm-session streaming.

A CPU-pinned daemon is spawned per module into a tmp socket; the
feeder/shipper devd transport must count bit-identically to the numpy
oracle and the CLI must stay byte-identical with the daemon carrying
the compare.  Failure paths (no daemon, daemon errors) must degrade to
the host path, never the run.
"""

from __future__ import annotations

import contextlib
import io
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from phylonium_tpu.core.homology import FORWARD, REVERSE, Homology
from phylonium_tpu.core.pileup import build_pileup
from phylonium_tpu.ops.match_table import pair_counts_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hom(direction, proj_start, iq, length):
    return Homology(
        direction=direction,
        index_reference=proj_start,
        index_reference_projected=proj_start,
        index_query=iq,
        length=length,
    )


def _panel(rng, n, ref_len):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    queries, homologies = [], []
    for g in range(n):
        qlen = ref_len + int(rng.integers(0, 60))
        q = rng.choice(acgt, qlen).astype(np.uint8)
        if g % 4 == 1 and qlen > 40:
            q[qlen // 2] = ord("!")
        hv = []
        if g % 5 != 4:
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


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """One CPU-pinned daemon for the module, on a tmp socket."""
    tmp = tmp_path_factory.mktemp("devd")
    sock = str(tmp / "devd.sock")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    env["PHYLONIUM_TPU_DEVD_SOCK"] = sock
    env["PHYLONIUM_TPU_PLATFORM"] = "cpu"
    env["PHYLONIUM_TPU_DEVD_IDLE_S"] = "600"
    log = open(tmp / "devd.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "phylonium_tpu.serve"],
        stdout=log, stderr=log, env=env,
    )
    deadline = time.time() + 30
    while time.time() < deadline and not os.path.exists(sock):
        if proc.poll() is not None:
            raise RuntimeError(
                f"daemon died rc={proc.returncode}: "
                + (tmp / "devd.log").read_bytes().decode()[-2000:]
            )
        time.sleep(0.1)
    assert os.path.exists(sock), "daemon socket never appeared"
    yield sock
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
    log.close()


@pytest.fixture
def devd_env(daemon, monkeypatch):
    """Point this process's client at the module daemon, fresh."""
    import phylonium_tpu.serve.client as cl

    monkeypatch.setenv("PHYLONIUM_TPU_DEVD_SOCK", daemon)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    monkeypatch.setattr(cl, "_client", None)
    yield daemon
    client = cl._client
    if client is not None:
        client.close()
    cl._client = None


def test_wire_roundtrip():
    from phylonium_tpu.serve.wire import recv_msg, send_msg

    a, b = socket.socketpair()
    try:
        arrays = [
            np.arange(7, dtype=np.int64),
            np.zeros((3, 4), np.uint8),
        ]
        send_msg(a, {"op": "x", "k": 1}, arrays)
        header, got = recv_msg(b)
        assert header["op"] == "x" and header["k"] == 1
        for w, g in zip(arrays, got):
            np.testing.assert_array_equal(w, g)
        # bad magic rejected
        a.sendall(b"NOPE!" + b"\x00" * 4)
        with pytest.raises(ConnectionError):
            recv_msg(b)
    finally:
        a.close()
        b.close()


def test_ping_and_spawnless_connect(devd_env):
    from phylonium_tpu.serve.client import DevdClient

    c = DevdClient(spawn=False)
    reply = c.ping(timeout=30.0)
    assert reply["ok"] and isinstance(reply["pid"], int)
    c.close()


def test_client_refuses_absent_daemon(tmp_path, monkeypatch):
    from phylonium_tpu.serve.client import DevdClient, DevdError

    monkeypatch.setenv(
        "PHYLONIUM_TPU_DEVD_SOCK", str(tmp_path / "nothing.sock")
    )
    with pytest.raises(DevdError):
        DevdClient(spawn=False)


def test_feeder_devd_matches_oracle(rng, devd_env):
    """The devd transport end to end: groups cross the socket, the
    daemon builds + counts, results equal the numpy oracle exactly."""
    from phylonium_tpu.core.stream import DeviceRowFeeder

    n, length = 13, 900
    queries, homologies = _panel(rng, n, length)
    feeder = DeviceRowFeeder(n, length)
    assert feeder._devd
    lo = 0
    for g in (5, 5, 3):
        feeder.feed(queries[lo : lo + g], homologies[lo : lo + g])
        lo += g
    subs, homs = feeder.finish()
    states = build_pileup(queries, homologies, length)
    es, eh = pair_counts_numpy(states)
    np.testing.assert_array_equal(subs, es)
    np.testing.assert_array_equal(homs, eh)
    # the daemon reports its count time; the race observability and
    # the dispatch gates read it back as the measured device tail
    assert isinstance(feeder.devd_count_s, float)


def test_prewarm_sync_blocks_until_compiled(devd_env):
    """prewarm {sync: true} (the cold-run drain's seeding hook) must
    reply only after the daemon's program family for the shape is
    compiled — the reply carries the measured compile seconds."""
    from phylonium_tpu.serve.client import DevdClient

    c = DevdClient(spawn=False)
    try:
        reply, _ = c.request(
            {"op": "prewarm", "n": 6, "ref_len": 500, "sync": True},
            timeout=120.0,
        )
        assert reply["ok"] and isinstance(reply["seconds"], float)
    finally:
        c.close()


def test_shipper_devd_and_second_pass_reuse(rng, devd_env, monkeypatch):
    """Query groups parked in the daemon by the shipper are consumed by
    reference (intervals-only group calls), including a second
    finish() on the same run id (the -2 second pass)."""
    from phylonium_tpu.core.query_ship import DevdGroup, QueryShipper
    from phylonium_tpu.core.stream import DeviceRowFeeder

    n, length = 10, 700
    queries, homologies = _panel(rng, n, length)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    shipper = QueryShipper(n)
    for q in queries:
        shipper.add(q)
    got = shipper.take(0, 4)
    assert isinstance(got, DevdGroup) and shipper.transport == "devd"

    states = build_pileup(queries, homologies, length)
    es, eh = pair_counts_numpy(states)
    for _pass in range(2):  # second pass reuses the parked qgroups
        feeder = DeviceRowFeeder(n, length, shipper=shipper)
        for lo in (0, 4, 8):
            hi = min(lo + 4, n)
            feeder.feed(queries[lo:hi], homologies[lo:hi])
        subs, homs = feeder.finish()
        np.testing.assert_array_equal(subs, es)
        np.testing.assert_array_equal(homs, eh)
        assert feeder.shipped_fraction() == 1.0

    # a NEW shipper over the same queries hits the daemon's content
    # cache: every group verifies with zero bytes shipped
    shipper2 = QueryShipper(n)
    for q in queries:
        shipper2.add(q)
    assert isinstance(shipper2.take(0, 4), DevdGroup)
    assert shipper2.take(4, 8) is not None
    assert shipper2.take(8, 10) is not None
    assert shipper2._hits == 3 and shipper2.shipped_bytes() == 0
    feeder = DeviceRowFeeder(n, length, shipper=shipper2)
    for lo in (0, 4, 8):
        hi = min(lo + 4, n)
        feeder.feed(queries[lo:hi], homologies[lo:hi])
    subs, homs = feeder.finish()
    np.testing.assert_array_equal(subs, es)
    np.testing.assert_array_equal(homs, eh)


def test_shipper_drain_parks_whole_panel(rng, devd_env, monkeypatch):
    """drain() blocks until every enqueued group is verified in the
    daemon (the cold-run seeding hook, PHYLONIUM_TPU_SHIP_DRAIN): a
    fresh shipper over the same queries must then be all cache hits."""
    from phylonium_tpu.core.query_ship import QueryShipper

    n = 9
    queries, _ = _panel(rng, n, 600)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "3")
    shipper = QueryShipper(n)
    for q in queries:
        shipper.add(q)
    assert shipper.drain(30.0) is True
    assert shipper.shipped_groups() == 3

    shipper2 = QueryShipper(n)
    for q in queries:
        shipper2.add(q)
    assert shipper2.drain(30.0) is True
    assert shipper2._hits == 3 and shipper2.shipped_bytes() == 0


def test_slow_build_never_stalls_group_replies(rng, tmp_path, monkeypatch):
    """The daemon queues group builds to a per-run worker thread: a
    slow build (first-shape compile, minutes in production) must not
    stall the `group` reply — the lowmem pipeline's 1-2 item backlog
    measurably cancelled the whole device leg on exactly that.  With a
    3 s injected build delay and max_backlog=1, every feed must be
    accepted and finish() must still return oracle-exact counts."""
    from phylonium_tpu.core.stream import DeviceRowFeeder

    sock = str(tmp_path / "devd.sock")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    env["PHYLONIUM_TPU_DEVD_SOCK"] = sock
    env["PHYLONIUM_TPU_PLATFORM"] = "cpu"
    env["PHYLONIUM_TPU_DEVD_INJECT"] = "slow_build"
    log = open(tmp_path / "devd.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "phylonium_tpu.serve"],
        stdout=log, stderr=log, env=env,
    )
    try:
        deadline = time.time() + 30
        while time.time() < deadline and not os.path.exists(sock):
            assert proc.poll() is None, "daemon died before serving"
            time.sleep(0.1)
        monkeypatch.setenv("PHYLONIUM_TPU_DEVD_SOCK", sock)
        monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
        import phylonium_tpu.serve.client as cl

        monkeypatch.setattr(cl, "_client", None)

        n, length = 9, 600
        queries, homologies = _panel(rng, n, length)
        feeder = DeviceRowFeeder(
            n, length, max_backlog=1
        )
        t0 = time.time()
        for lo in (0, 3, 6):
            feeder.feed(queries[lo : lo + 3], homologies[lo : lo + 3])
            # the worker must drain each item at socket speed (reply
            # returns before the injected 3 s build), else the bounded
            # backlog cancels the feeder
            deadline = time.time() + 10
            while feeder._q.qsize() > 0 and time.time() < deadline:
                time.sleep(0.02)
        assert not feeder._gave_up, "backlog cancelled the device leg"
        assert time.time() - t0 < 9.0, "group replies waited on builds"
        subs, homs = feeder.finish()  # joins the 3 x 3 s build queue
        states = build_pileup(queries, homologies, length)
        es, eh = pair_counts_numpy(states)
        np.testing.assert_array_equal(subs, es)
        np.testing.assert_array_equal(homs, eh)
        cl._client.close()
        cl._client = None
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
        log.close()


def test_cancel_keeps_shipper_alive_under_drain(rng, devd_env, monkeypatch):
    """A feeder cancel during a drained (seeding) run must not kill the
    query shipper: the run's whole purpose is parking the panel for the
    next run, and the backlog cancel used to erase it."""
    from phylonium_tpu.core.query_ship import QueryShipper
    from phylonium_tpu.core.stream import DeviceRowFeeder

    n = 6
    queries, _ = _panel(rng, n, 500)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "3")

    monkeypatch.delenv("PHYLONIUM_TPU_SHIP_DRAIN", raising=False)
    shipper = QueryShipper(n)
    feeder = DeviceRowFeeder(n, 500, shipper=shipper)
    feeder.cancel()
    assert shipper._cancelled, "plain cancel must stop the shipper"

    monkeypatch.setenv("PHYLONIUM_TPU_SHIP_DRAIN", "30")
    shipper2 = QueryShipper(n)
    for q in queries:
        shipper2.add(q)
    feeder2 = DeviceRowFeeder(n, 500, shipper=shipper2)
    feeder2.cancel()
    assert not shipper2._cancelled, "drain run must keep seeding"
    assert shipper2.drain(30.0) is True  # panel still parks fully


def test_devd_off_by_default(monkeypatch):
    """The CLI process opens the card itself unless PHYLONIUM_TPU_DEVD=1
    engages the device server."""
    from phylonium_tpu.serve.client import devd_enabled

    monkeypatch.delenv("PHYLONIUM_TPU_DEVD", raising=False)
    assert devd_enabled() is False
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "0")
    assert devd_enabled() is False
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    assert devd_enabled() is True


def test_devd_engaged_explicit_device_backend_refused(
    tmp_path, monkeypatch, capsys
):
    """With the device server engaged the server owns the card: an
    explicit in-process device path exits 1 with a clear error instead
    of opening the card from a second process."""
    from phylonium_tpu.cli import main

    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    files = _write_panel(tmp_path, 3, 1500, seed=2)
    rc = main(["--progress=never", "--count-backend=device", *files])
    assert rc == 1
    assert "device server" in capsys.readouterr().err


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


def test_devd_cli_byte_identical(tmp_path, devd_env, monkeypatch):
    """Full CLI with the daemon carrying the compare: byte-identical to
    the serial host run, carrier reported as device."""
    import phylonium_tpu.core.pipeline as pl
    from phylonium_tpu.cli import main

    files = _write_panel(tmp_path, 9, 2400, seed=23)

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


def test_devd_cli_process_never_imports_jax(tmp_path, devd_env):
    """One process per card: with the device server engaged, the CLI
    process itself never imports jax (so it cannot open the card) —
    streaming, the compare race and the output all go through the
    server (exit code 70 flags a jax import)."""
    files = _write_panel(tmp_path, 7, 2200, seed=41)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    env["PHYLONIUM_TPU_STREAM"] = "force"
    env["PHYLONIUM_TPU_STREAM_GROUP"] = "3"
    env["PHYLONIUM_TPU_EXPECT_NO_JAX"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "phylonium_tpu", "--progress=never", *files],
        capture_output=True, timeout=300, env=env,
    )
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    assert r.stdout.startswith(b"7\n")


def test_devd_cli_drain_seeds_and_prewarms(tmp_path, devd_env, monkeypatch):
    """A drained (cold seeding) CLI run must park the whole panel in the
    daemon AND sync-prewarm its program family before exiting — the run
    report carries both; a second drained run is then all cache hits."""
    import phylonium_tpu.core.pipeline as pl
    from phylonium_tpu.cli import main

    files = _write_panel(tmp_path, 8, 2000, seed=31)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    monkeypatch.setenv("PHYLONIUM_TPU_SHIP_DRAIN", "60")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--progress=never", *files])
    assert rc == 0
    drain = pl.LAST_RUN_INFO.get("ship_drain")
    assert drain is not None and drain["complete"] is True
    # either the race's own device finish compiled the family (carrier
    # device -> prewarm skipped) or the sync prewarm ran and reported
    if pl.LAST_RUN_INFO.get("compare_carrier") != "device":
        assert "prewarm_s" in drain, drain
    ship = pl.LAST_RUN_INFO.get("early_ship")
    assert ship is not None and ship["groups"] == 2

    # the second run drains too: on a tiny panel the host leg can finish
    # before the shipper thread has looked a group up, and the drain
    # makes the run wait for every lookup before it reports
    out2 = io.StringIO()
    with contextlib.redirect_stdout(out2):
        rc2 = main(["--progress=never", *files])
    assert rc2 == 0
    assert out2.getvalue() == out.getvalue()
    ship2 = pl.LAST_RUN_INFO.get("early_ship")
    assert ship2["cache_hits"] == 2 and ship2["mb"] == 0.0


def test_devd_failure_degrades_to_host(rng, tmp_path, monkeypatch):
    """No daemon + spawn impossible: the feeder's finish raises, the
    race covers on the host path, the CLI output stays byte-identical."""
    import phylonium_tpu.serve.client as cl
    from phylonium_tpu.cli import main

    monkeypatch.setenv(
        "PHYLONIUM_TPU_DEVD_SOCK", str(tmp_path / "void.sock")
    )
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD_SPAWN_WAIT", "1")
    monkeypatch.setattr(cl, "_client", None)
    # block spawning: the daemon must not come up
    monkeypatch.setattr(
        cl.DevdClient, "spawn_daemon", lambda self: None
    )

    files = _write_panel(tmp_path, 7, 2200, seed=31)

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
    cl._client = None
