"""The adaptive compare backend: host counting, the device race, and the
production mesh dispatch.

All counting paths must agree bit-exactly (CLAUDE.md invariant); these
tests pin the new pieces to the scalar oracle (ops/match_table.py).
"""

import numpy as np
import pytest

from phylonium_tpu.config import RunConfig
from phylonium_tpu.core.pipeline import LAST_RUN_INFO, _race_host, pair_counts
from phylonium_tpu.ops.bitplane_host import (
    pair_counts_bitplanes,
    pair_counts_host,
)
from phylonium_tpu.ops.match_table import pair_counts_numpy


@pytest.fixture
def states(rng):
    # all 11 states, ragged coverage, odd width
    return rng.integers(0, 11, size=(7, 30011), dtype=np.uint8)


def test_bitplanes_match_oracle(states):
    subs, homs = pair_counts_bitplanes(states)
    s2, h2 = pair_counts_numpy(states)
    assert (subs == s2).all() and (homs == h2).all()


def test_native_host_matches_oracle(states):
    pytest.importorskip("phylonium_tpu.native")
    subs, homs = pair_counts_host(states)
    s2, h2 = pair_counts_numpy(states)
    assert (subs == s2).all() and (homs == h2).all()


def test_native_plane_kernel_matches_byte_kernel(rng, monkeypatch):
    """The AVX-512 bitplane kernel (n >= 24 auto path) is bit-identical
    to the byte kernel for all 11 states, incl. separator-dense rows and
    column subranges.  On hosts without AVX-512VPOPCNTDQ both env values
    run the byte path, so the assertion still holds."""
    native = pytest.importorskip("phylonium_tpu.native")
    n, length = 26, 9173
    st = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
    st[rng.random((n, length)) < 0.3] += 5
    sep = rng.random((n, length)) < 0.02
    st[sep] = rng.choice([4, 9], size=int(sep.sum())).astype(np.uint8)
    st[rng.random((n, length)) < 0.1] = 10
    for lo, hi in [(0, length), (513, 7000), (100, 101)]:
        out = {}
        for kernel in ("byte", "planes"):
            monkeypatch.setenv("PHYLONIUM_TPU_HOST_KERNEL", kernel)
            subs = np.zeros((n, n), np.int64)
            homs = np.zeros((n, n), np.int64)
            native.pair_counts_range(st, lo, hi, subs, homs)
            out[kernel] = (subs, homs)
        assert (out["byte"][0] == out["planes"][0]).all()
        assert (out["byte"][1] == out["planes"][1]).all()
    monkeypatch.setenv("PHYLONIUM_TPU_HOST_KERNEL", "planes")
    s2, h2 = pair_counts_numpy(st)
    subs, homs = pair_counts_host(st)
    assert (subs == s2).all() and (homs == h2).all()


def test_host_poll_abort(states):
    assert pair_counts_host(states, poll=lambda: True) is None
    assert pair_counts_bitplanes(states, poll=lambda: True) is None


def test_host_single_column_and_two_rows(rng):
    st = rng.integers(0, 11, size=(2, 1), dtype=np.uint8)
    subs, homs = pair_counts_host(st)
    s2, h2 = pair_counts_numpy(st)
    assert (subs == s2).all() and (homs == h2).all()


def test_race_device_wins(states):
    expected = pair_counts_numpy(states)
    got = _race_host(states, lambda: expected)
    assert got[0] is expected[0]
    assert LAST_RUN_INFO["device_leg"] == {"outcome": "won"}
    assert LAST_RUN_INFO["compare_carrier"] == "device"


def test_race_host_wins(states):
    import threading

    release = threading.Event()

    def slow_device():
        release.wait(timeout=30)
        raise AssertionError("host should have won")

    subs, homs = _race_host(states, slow_device)
    release.set()
    s2, h2 = pair_counts_numpy(states)
    assert (subs == s2).all() and (homs == h2).all()
    assert LAST_RUN_INFO["device_leg"] == {"outcome": "lost"}
    assert LAST_RUN_INFO["compare_carrier"] == "host"


def test_race_device_failure_falls_back_to_host(states, capsys):
    """In the auto race a device error never fails the run: the host
    result stands, the error is recorded and warned on stderr."""

    def broken_device():
        raise RuntimeError("compile failed\nsecond line")

    subs, homs = _race_host(states, broken_device)
    s2, h2 = pair_counts_numpy(states)
    assert (subs == s2).all() and (homs == h2).all()
    leg = LAST_RUN_INFO["device_leg"]
    assert leg["outcome"] == "error"
    assert leg["error"] == "RuntimeError: compile failed"
    assert "device leg failed (RuntimeError: compile failed)" in (
        capsys.readouterr().err
    )


def test_dispatch_host_backend(states):
    cfg = RunConfig(count_backend="host")
    subs, homs = pair_counts(states, cfg)
    s2, h2 = pair_counts_numpy(states)
    assert (subs == s2).all() and (homs == h2).all()


def test_dispatch_mesh(states):
    # conftest forces 8 virtual CPU devices; auto must take the mesh
    # path and still match the oracle bit-exactly
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    cfg = RunConfig(count_backend="auto", mesh="2,4")
    subs, homs = pair_counts(states, cfg)
    s2, h2 = pair_counts_numpy(states)
    assert (subs == s2).all() and (homs == h2).all()


def test_cli_mesh_flag_byte_identical(tmp_path, rng):
    import contextlib
    import io

    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")

    from phylonium_tpu.cli import main

    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, 9000)
    files = []
    for k, p in enumerate([0.0, 0.02, 0.05]):
        arr = base.copy()
        idx = np.flatnonzero(rng.random(arr.size) < p)
        arr[idx] = acgt[(rng.integers(1, 4, idx.size) + idx) % 4]
        path = tmp_path / f"g{k}.fasta"
        path.write_bytes(b">g%d\n" % k + arr.tobytes() + b"\n")
        files.append(str(path))

    def run(*extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main([*extra, *files]) == 0
        return out.getvalue()

    meshed = run("--mesh", "2,4")
    single = run("--mesh", "1,1")
    oracle = run("--count-backend", "numpy")
    assert meshed == single == oracle


def test_auto_dispatch_thresholds():
    from phylonium_tpu.core.pipeline import _auto_prefers_host

    small = RunConfig()  # 29 x 5 Mbp = 2 Gbp of pair work
    assert _auto_prefers_host(29, 5_000_000, small)
    assert not _auto_prefers_host(1000, 1_000_000, small)  # 500 Gbp
    assert not _auto_prefers_host(29, 5_000_000, RunConfig(mesh="2,4"))
    assert not _auto_prefers_host(
        29, 5_000_000, RunConfig(count_backend="pallas")
    )
    tuned = RunConfig(auto_device_min_gbp=1.0)
    assert not _auto_prefers_host(29, 5_000_000, tuned)


def test_explicit_pallas_not_rerouted_to_mesh(states, monkeypatch):
    """--count-backend=pallas must run the named single-device path even
    when multiple devices are visible (regression: it was silently
    rerouted to the mesh)."""
    import phylonium_tpu.core.pipeline as pipe

    called = {}

    def spy_device(s, cfg, progress=None):
        called["device"] = True
        return pair_counts_numpy(s)

    def spy_mesh(s, cfg):
        called["mesh"] = True
        return pair_counts_numpy(s)

    monkeypatch.setattr(pipe, "_pair_counts_device", spy_device)
    monkeypatch.setattr(pipe, "_pair_counts_mesh", spy_mesh)
    pair_counts(states, RunConfig(count_backend="pallas"))
    assert called == {"device": True}
    called.clear()
    pair_counts(states, RunConfig(count_backend="pallas", mesh="2,4"))
    assert called == {"mesh": True}


def test_hybrid_rejects_oversized_single_query(monkeypatch):
    import phylonium_tpu.core.hybrid_map as hm

    class FakeRef:
        size = 1000
        S = np.zeros(1, np.uint8)
        SA = np.zeros(1, np.int64)

    class FakeHuge:
        def __len__(self):
            return (1 << 31) + 5

    with pytest.raises(ValueError, match="int32"):
        hm.hybrid_map_queries(FakeRef(), 20, [FakeHuge()])


def test_explicit_pallas_on_cpu_runs_interpret(states):
    """--count-backend=pallas on a CPU-pinned run must execute the
    interpret kernel (bit-identical), not crash with Pallas's
    'Only interpret mode is supported on CPU backend'."""
    import numpy as np

    subs, homs = pair_counts(
        states, RunConfig(count_backend="pallas", progress="never")
    )
    es, eh = pair_counts_numpy(states)
    np.testing.assert_array_equal(subs, es)
    np.testing.assert_array_equal(homs, eh)
