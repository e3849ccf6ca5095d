"""True multi-process sharded counting via jax.distributed.

Two OS processes, each with 4 virtual CPU devices, form a (2, 4) global
mesh ('rows' spans the process axis).  Both must compute the same
bit-exact counts as the single-process path — the multi-host simulation
tier from SURVEY.md §4.

The CLI workers write the matrix they printed to a file of their own:
the collective transport's C++ banner goes straight to file descriptor
1 from several threads at once, interleaved mid-line, so the process's
stdout is not a clean channel for a byte comparison.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(__file__))

WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")

    coordinator, pid = sys.argv[1], int(sys.argv[2])
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=2, process_id=pid
    )
    assert jax.device_count() == 8, jax.device_count()
    assert jax.process_count() == 2

    import numpy as np
    from phylonium_tpu.parallel.mesh import make_mesh
    from phylonium_tpu.parallel.distributed import pair_counts_sharded
    from phylonium_tpu.ops.match_table import pair_counts_numpy

    rng = np.random.default_rng(0)
    states = rng.integers(0, 11, size=(6, 4096)).astype(np.uint8)
    mesh = make_mesh((2, 4))
    s, h = pair_counts_sharded(states, mesh)
    s0, h0 = pair_counts_numpy(states)
    assert np.array_equal(s, s0), "subs mismatch"
    assert np.array_equal(h, h0), "homs mismatch"
    print(f"proc {pid}: ok")
    """
)


CLI_WORKER = textwrap.dedent(
    """
    import io, os, sys, contextlib
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")

    coordinator, pid, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=2, process_id=pid
    )
    assert jax.device_count() == 8 and jax.process_count() == 2

    from phylonium_tpu.cli import main

    files = sorted(
        os.path.join(tmp, f) for f in os.listdir(tmp) if f.endswith(".fasta")
    )
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["-v", "-v", *files])
    assert rc == 0
    # the full pipeline ran in both processes; only proc 0 prints
    with open(os.path.join(tmp, f"stdout_{pid}.txt"), "w") as f:
        f.write(out.getvalue())
    sys.stdout.write(f"<<proc {pid} done>>")
    """
)


def _printed(tmp_path, pid):
    """The matrix text CLI worker ``pid`` printed."""
    return (tmp_path / f"stdout_{pid}.txt").read_text()


def _launch(script_text, tmp_path, extra_args=(), nprocs=2):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    coordinator = f"localhost:{port}"

    script = tmp_path / "worker.py"
    script.write_text(script_text)

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coordinator, str(pid), *extra_args],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(nprocs)
    ]
    outs = []
    for p in procs:
        try:
            # generous: shared hosts swing ~10x under contention
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process workers timed out")
        outs.append((p.returncode, out, err))
    return outs


def test_two_process_full_cli(tmp_path, rng):
    """End-to-end CLI across 2 processes x 4 devices: mapping runs on
    every host, counting shards over the global (2, 4) mesh, and the
    coordinator's printed matrix is byte-identical to a single-process
    run — the deployment shape promised in parallel/multihost.py."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, 12_000)
    files = []
    for k, p in enumerate([0.0, 0.01, 0.04, 0.07]):
        arr = base.copy()
        idx = np.flatnonzero(rng.random(arr.size) < p)
        arr[idx] = acgt[(rng.integers(1, 4, idx.size) + arr[idx]) % 4]
        path = tmp_path / f"g{k}.fasta"
        path.write_bytes(b">g%d\n" % k + arr.tobytes() + b"\n")
        files.append(str(path))

    # single-process expectation through the scalar oracle backend
    import contextlib
    import io

    from phylonium_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--count-backend", "numpy", *files]) == 0
    expected = buf.getvalue()

    outs = _launch(CLI_WORKER, tmp_path, extra_args=(str(tmp_path),))
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {pid} failed:\n{out}\n{err[-2000:]}"
        assert f"<<proc {pid} done>>" in out
        # each host mapped only its own half of the queries
        assert f"process {pid}/2 mapped 2 of 4 queries locally" in err, err[
            -2000:
        ]
    matrix0 = _printed(tmp_path, 0)
    matrix1 = _printed(tmp_path, 1)
    assert matrix0 == expected, (
        f"multi-process stdout differs:\n{matrix0}\nvs\n{expected}"
    )
    assert matrix1 == ""  # non-coordinators stay silent


def test_two_process_mesh(tmp_path):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    coordinator = f"localhost:{port}"

    script = tmp_path / "worker.py"
    script.write_text(WORKER)

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coordinator, str(pid)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process workers timed out")
        outs.append((p.returncode, out, err))

    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err[-2000:]}"
        assert ": ok" in out


def test_two_process_cli_with_shared_checkpoint(tmp_path, rng):
    """Query-sharded mapping + a shared --checkpoint dir: per-process
    writes are content-addressed (idempotent), reruns reuse them, and
    stdout stays identical."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, 8_000)
    files = []
    for k, p in enumerate([0.0, 0.02, 0.05, 0.08]):
        arr = base.copy()
        idx = np.flatnonzero(rng.random(arr.size) < p)
        arr[idx] = acgt[(rng.integers(1, 4, idx.size) + arr[idx]) % 4]
        path = tmp_path / f"g{k}.fasta"
        path.write_bytes(b">g%d\n" % k + arr.tobytes() + b"\n")
        files.append(str(path))

    ckpt = tmp_path / "ckpt"
    worker = CLI_WORKER.replace(
        "rc = main([\"-v\", \"-v\", *files])",
        f"rc = main(['-v', '-v', '--checkpoint', {str(ckpt)!r}, *files])",
    )

    import contextlib
    import io

    from phylonium_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--count-backend", "numpy", *files]) == 0
    expected = buf.getvalue()

    for attempt in range(2):  # second run hits the checkpoint
        outs = _launch(worker, tmp_path, extra_args=(str(tmp_path),))
        for pid, (rc, out, err) in enumerate(outs):
            assert rc == 0, f"attempt {attempt} worker {pid}:\n{err[-1500:]}"
        got = _printed(tmp_path, 0)
        assert got == expected, f"attempt {attempt} differs"
        assert _printed(tmp_path, 1) == ""


POD_WORKER = textwrap.dedent(
    """
    import io, os, sys, contextlib
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax
    jax.config.update("jax_platforms", "cpu")

    coordinator, pid, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=8, process_id=pid
    )
    assert jax.device_count() == 8 and jax.process_count() == 8

    from phylonium_tpu.cli import main

    files = sorted(
        os.path.join(tmp, f) for f in os.listdir(tmp) if f.endswith(".fasta")
    )
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["-v", "-v", *files])
    assert rc == 0
    with open(os.path.join(tmp, f"stdout_{pid}.txt"), "w") as f:
        f.write(out.getvalue())
    sys.stdout.write(f"<<proc {pid} done>>")
    """
)


def test_eight_process_pod_cli(tmp_path, rng):
    """One process per device, 8 processes x 1 device each, through the
    full CLI: query-sharded mapping (each process maps 1 of 8), counting
    over the global (8, 1) mesh, stdout byte-identical to
    single-process."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, 9_000)
    files = []
    for k in range(8):
        arr = base.copy()
        idx = np.flatnonzero(rng.random(arr.size) < 0.012 * (k + 1))
        arr[idx] = acgt[(rng.integers(1, 4, idx.size) + arr[idx]) % 4]
        path = tmp_path / f"g{k}.fasta"
        path.write_bytes(b">g%d\n" % k + arr.tobytes() + b"\n")
        files.append(str(path))

    import contextlib
    import io

    from phylonium_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--count-backend", "numpy", *files]) == 0
    expected = buf.getvalue()

    outs = _launch(
        POD_WORKER, tmp_path, extra_args=(str(tmp_path),), nprocs=8
    )
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {pid} failed:\n{out}\n{err[-2000:]}"
        assert f"<<proc {pid} done>>" in out
        assert f"process {pid}/8 mapped 1 of 8 queries locally" in err, err[
            -2000:
        ]

    assert _printed(tmp_path, 0) == expected
    for pid in range(1, 8):
        assert _printed(tmp_path, pid) == ""


def test_comm_volume_account():
    """The compiled HLO's collective traffic matches the N*L/cols
    prediction exactly for every mesh shape (the communication-volume
    account promised in parallel/distributed.py)."""
    import jax

    from phylonium_tpu.parallel.distributed import comm_account
    from phylonium_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    for shape in [(2, 4), (4, 2), (8, 1), (1, 8)]:
        acc = comm_account(48, 100_000, make_mesh(shape))
        assert (
            acc["measured_gather_recv_bytes"]
            == acc["predicted_gather_recv_bytes"]
        ), acc
        assert acc["measured"].get("all-reduce", {}).get("out", 0) == (
            acc["predicted_psum_bytes"]
        ), acc


POD_STREAM_WORKER = POD_WORKER.replace(
    "from phylonium_tpu.cli import main",
    'os.environ["PHYLONIUM_TPU_STREAM"] = "force"\n'
    'os.environ["PHYLONIUM_TPU_STREAM_GROUP"] = "1"\n'
    "from phylonium_tpu.cli import main",
)


def test_eight_process_pod_streamed_cli(tmp_path, rng):
    """Streaming lifted into multi-process runs (parallel/stream_mp.py):
    each process maps its CONTIGUOUS row block, feeds its own device's
    shard during mapping, and the compare runs the collective on the
    resident shards — full CLI, byte-identical, including processes
    whose block is pure padding (n=10 over 8 row blocks of 2)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, 9_000)
    files = []
    for k in range(10):
        arr = base.copy()
        idx = np.flatnonzero(rng.random(arr.size) < 0.01 * (k + 1))
        arr[idx] = acgt[(rng.integers(1, 4, idx.size) + arr[idx]) % 4]
        path = tmp_path / f"g{k}.fasta"
        path.write_bytes(b">g%d\n" % k + arr.tobytes() + b"\n")
        files.append(str(path))

    import contextlib
    import io

    from phylonium_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--count-backend", "numpy", *files]) == 0
    expected = buf.getvalue()

    outs = _launch(
        POD_STREAM_WORKER, tmp_path, extra_args=(str(tmp_path),), nprocs=8
    )
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {pid} failed:\n{out}\n{err[-2000:]}"
        assert f"<<proc {pid} done>>" in out
        lo = min(pid * 2, 10)
        hi = min(lo + 2, 10)
        assert (
            f"pod stream: process {pid}/8 mapped+fed rows "
            f"[{pid * 2}, {hi}) of 10" in err
        ), err[-2000:]

    assert _printed(tmp_path, 0) == expected
    for pid in range(1, 8):
        assert _printed(tmp_path, pid) == ""
