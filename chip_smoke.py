#!/usr/bin/env python3
"""Smoke test of the device path on an NVIDIA GPU.

Run from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py                  # one card: phases 1-4
    python chip_smoke.py --devd           # phase 5: the device server
    python chip_smoke.py --time-kernels   # phase 6: kernel vs plain XLA
    python chip_smoke.py --four           # four cards: mesh vs one card

Phases (one card):

1. golden parity: every case of tests/golden_panel.py through
   ``python -m phylonium_tpu --count-backend device``, byte-compared
   with the reference binary's recorded output in tests/data/golden/;
2. eco29 scale: a seeded 29 x 5 Mbp panel, ``--count-backend device``
   byte-identical to ``--count-backend host``, carrier ``device``;
3. default path: a seeded 600 x 1 Mbp panel with plain flags (the
   streamed feeder above the work gate), byte-identical to host, and
   the raced device leg did not fail; then the streamed feeder's own
   counts of that panel (the device-built packed panel, whichever leg
   wins the race) exactly equal the host AVX2 kernel's;
4. kernel vs references: the device entry point's exact counts against
   the host AVX2 kernel at 29 x 5 Mbp, 116 x 5 Mbp, 600 x 1 Mbp and
   1000 x 1 Mbp (packed), against the numpy oracle at 8 x 1 Mbp, and
   on state bytes at 450 x 5 Mbp (2.7 GB padded: launched in column
   ranges) and 900 x 5 Mbp (5.4 GB: 64-bit offsets; every pair among
   32 sampled rows, the first and last included).

This process never imports jax: every phase runs in a subprocess of
its own, one at a time, and after each one ``nvidia-smi`` must show no
process left on the card.  Without ``--four`` only the first card is
visible to the phases.  Any failure, or no GPU, exits non-zero with
``"ok": false``; the last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

``--rehearse`` runs the same phases at toy sizes on the CPU (kernel in
interpret mode) to check the script itself; it always ends with
``"ok": false``, since no device was measured.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")
BUDGET_S = 1150.0  # the whole default run, compilation included
_T0 = time.time()

# (genomes, length) of each phase at full size and in rehearsal
SIZES = {
    "eco29": ((29, 5_000_000), (5, 20_000)),
    "auto600": ((600, 1_000_000), (12, 6_000)),
    "four": ((1000, 1_000_000), (12, 6_000)),
    # (genomes, length, layout, rows compared: None for all)
    "kernels": (
        [(8, 1_000_000, "packed", None), (29, 5_000_000, "packed", None),
         (116, 5_000_000, "packed", None), (600, 1_000_000, "packed", None),
         (1000, 1_000_000, "packed", None),
         (450, 5_000_000, "states", None), (900, 5_000_000, "states", 32)],
        [(8, 3_000, "packed", None), (29, 3_000, "packed", None),
         (70, 2_000, "packed", None), (40, 2_000, "states", None),
         (70, 2_000, "states", 12)],
    ),
}


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.time() - _T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def finish(ok: bool, device: dict | None = None, error: str = "") -> None:
    if ok:
        print(json.dumps({"ok": True, "device": device}), flush=True)
        sys.exit(0)
    log(f"FAILED: {error}")
    print(json.dumps({"ok": False, "error": error[:800]}), flush=True)
    sys.exit(1)


def size(name, rehearse):
    return SIZES[name][1 if rehearse else 0]


# --------------------------------------------------------------------------
# panels (numpy only: the phase that writes them never touches the card)


def write_fasta(path: str, name: str, contigs) -> None:
    import numpy as np

    with open(path, "wb") as f:
        for ci, contig in enumerate(contigs):
            f.write(b">%s_c%d\n" % (name.encode(), ci))
            arr = np.frombuffer(contig, np.uint8)
            lines = len(arr) // 80
            body = np.empty((lines, 81), np.uint8)
            body[:, :80] = arr[: lines * 80].reshape(lines, 80)
            body[:, 80] = 10
            f.write(body.tobytes())
            if len(arr) % 80:
                f.write(arr[lines * 80 :].tobytes() + b"\n")


def make_panel(dirpath: str, n: int, length: int, seed: int) -> list[str]:
    """A seeded panel: a base genome, mutants at 0.5-5% divergence, and
    (for n > 2) a last genome drafted into 5 contigs with a reversed
    segment, so '!' separators and the reverse strand are exercised.
    Reused when a previous phase of this run already wrote it."""
    import numpy as np

    stamp = os.path.join(dirpath, "panel.json")
    want = {"n": n, "length": length, "seed": seed}
    if os.path.exists(stamp):
        with open(stamp) as f:
            if json.load(f) == want:
                return sorted(
                    os.path.join(dirpath, x) for x in os.listdir(dirpath)
                    if x.endswith(".fasta")
                )
    shutil.rmtree(dirpath, ignore_errors=True)
    os.makedirs(dirpath)
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    base_codes = rng.integers(0, 4, length).astype(np.uint8)
    files = []
    for k in range(n):
        codes = base_codes
        if k:
            p = 0.005 + 0.045 * (k - 1) / max(n - 2, 1)
            hit = rng.random(length) < p
            shift = rng.integers(1, 4, length).astype(np.uint8)
            codes = np.where(hit, (base_codes + shift) % 4, base_codes)
        seq = acgt[codes]
        contigs = [seq.tobytes()]
        if k == n - 1 and n > 2:
            lo, hi = length // 3, length // 3 + length // 6
            seq = seq.copy()
            seq[lo:hi] = comp[seq[lo:hi][::-1]]
            cut = -(-length // 5)
            contigs = [
                seq[i : i + cut].tobytes() for i in range(0, length, cut)
            ]
        path = os.path.join(dirpath, f"S{k:04d}.fasta")
        write_fasta(path, f"S{k:04d}", contigs)
        files.append(path)
    with open(stamp, "w") as f:
        json.dump(want, f)
    return files


def run_cli(args, files, cwd, env=None, report=None, timeout=900):
    """``python -m phylonium_tpu`` as a user runs it; returns (stdout
    bytes, run report dict or None, seconds)."""
    env = dict(env or os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if report:
        env["PHYLONIUM_TPU_RUN_REPORT"] = report
        if os.path.exists(report):
            os.unlink(report)
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "phylonium_tpu", "--progress=never", *args,
         *files],
        capture_output=True, cwd=cwd, env=env, timeout=timeout,
    )
    dt = time.time() - t0
    if r.returncode:
        raise RuntimeError(
            f"CLI {' '.join(args)} exited {r.returncode}: "
            + r.stderr.decode(errors="replace")[-1500:]
        )
    info = None
    if report:
        with open(report) as f:
            info = json.load(f)
    return r.stdout, info, dt


# --------------------------------------------------------------------------
# phases (each runs in its own subprocess: ``--phase NAME``)


def phase_probe(rehearse):
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def phase_golden(rehearse):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from golden_panel import GOLDEN_CASES, RD_SEED, write_panel

    d = os.path.join(WORK, "golden")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    files = write_panel(d)
    golden = os.path.join(REPO, "tests", "data", "golden")
    report = os.path.join(d, "report.json")
    for name in sorted(GOLDEN_CASES):
        refpos = os.path.join(d, f"refpos_{name}.txt")
        args = [refpos if a == "REFPOS_FILE" else a
                for a in GOLDEN_CASES[name]]
        env = dict(os.environ)
        if "-b" in args:
            env["PHYLONIUM_TPU_RD_SEED"] = str(RD_SEED)
        out, info, dt = run_cli(
            ["--count-backend", "device", *args], files, d, env, report
        )
        with open(os.path.join(golden, f"{name}.stdout"), "rb") as f:
            if out != f.read():
                raise AssertionError(f"golden case {name}: stdout differs")
        if "REFPOS_FILE" in GOLDEN_CASES[name]:
            with open(refpos, "rb") as a, open(
                os.path.join(golden, f"{name}.refpos"), "rb"
            ) as b:
                if a.read() != b.read():
                    raise AssertionError(f"golden case {name}: -p differs")
        if info.get("compare_carrier") != "device":
            raise AssertionError(f"golden case {name}: carrier {info}")
        log(f"golden {name}: identical ({dt:.1f}s)")
    return {"cases": len(GOLDEN_CASES), "identical": True}


def _device_vs_host(name, rehearse, device_args, seed):
    n, length = size(name, rehearse)
    d = os.path.join(WORK, f"panel_{n}x{length}")
    t0 = time.time()
    files = make_panel(d, n, length, seed)
    log(f"{name}: {n} x {length} panel ready ({time.time() - t0:.1f}s)")
    report = os.path.join(d, "report.json")
    out_dev, info, t_dev = run_cli(device_args, files, d, report=report)
    out_host, _, t_host = run_cli(
        ["--count-backend", "host"], files, d
    )
    if out_dev != out_host:
        raise AssertionError(f"{name}: device stdout differs from host")
    log(f"{name}: identical to host (device run {t_dev:.1f}s, host run "
        f"{t_host:.1f}s, report {json.dumps(info)})")
    return {
        "panel": [n, length],
        "identical": True,
        "cli_s": round(t_dev, 3),
        "host_cli_s": round(t_host, 3),
        "report": info,
    }


def phase_eco29(rehearse):
    res = _device_vs_host(
        "eco29", rehearse, ["--count-backend", "device"], seed=29
    )
    if res["report"].get("compare_carrier") != "device":
        raise AssertionError(f"eco29: carrier {res['report']}")
    return res


def phase_auto600(rehearse):
    env = {}
    if rehearse:
        # the toy panel is below the work gate and the CPU never races:
        # force the streamed path so the rehearsal drives its code
        env = {"PHYLONIUM_TPU_STREAM": "force", "PHYLONIUM_TPU_STREAM_GROUP": "4"}
    os.environ.update(env)
    res = _device_vs_host("auto600", rehearse, [], seed=600)
    rep = res["report"]
    if not rehearse:
        leg = rep.get("device_leg")
        if not leg or leg.get("outcome") not in ("won", "lost"):
            raise AssertionError(f"auto600: device leg {leg}")
    if "map+pileup+feed" not in rep.get("timings", {}):
        raise AssertionError(f"auto600: not the streamed path: {rep}")
    return res


def phase_stream600(rehearse):
    """The streamed path's device leg on its own: phase 3's panel
    mapped, piled up and fed group by group as the CLI's default run
    does (core/pipeline.process), then the feeder's device counts
    compared exactly with the host AVX2 kernel on the same pileup."""
    import numpy as np

    from phylonium_tpu.config import RunConfig
    from phylonium_tpu.core.anchor_stats import min_anchor_length
    from phylonium_tpu.core.reference_pick import pick_first_pass
    from phylonium_tpu.core.stream import DeviceRowFeeder, map_pileup_streamed
    from phylonium_tpu.data.sequence import gc_content, join
    from phylonium_tpu.index.esa import ESAIndex
    from phylonium_tpu.io.fasta import read_genome
    from phylonium_tpu.ops.bitplane_host import pair_counts_host

    n, length = size("auto600", rehearse)
    files = make_panel(os.path.join(WORK, f"panel_{n}x{length}"), n,
                       length, 600)
    cfg = RunConfig(progress="never")
    queries = [join(read_genome(f)) for f in files]
    subject = queries[pick_first_pass(queries)]
    ref = ESAIndex(subject, backend=cfg.esa_backend)
    gc = gc_content(subject.nucl)
    threshold = min_anchor_length(cfg.anchor_p_value, gc, ref.size)
    t0 = time.time()
    feeder = DeviceRowFeeder(n, len(subject))
    _, states = map_pileup_streamed(
        ref, threshold, queries, cfg, feeder,
        group_rows=4 if rehearse else None,
    )
    t_map = time.time() - t0
    t0 = time.time()
    subs, homs = feeder.finish()
    t_dev = time.time() - t0
    ref_subs, ref_homs = pair_counts_host(states)
    if not (np.array_equal(subs, ref_subs) and np.array_equal(homs, ref_homs)):
        raise AssertionError("stream600: feeder counts differ from host")
    log(f"stream600: feeder counts exact vs host_avx2 (map+pileup+feed "
        f"{t_map:.2f}s, finish {t_dev:.2f}s)")
    return {"panel": [n, length], "exact_vs": "host_avx2",
            "map_pileup_feed_s": t_map, "finish_s": t_dev}


def phase_kernels(rehearse):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from phylonium_tpu.ops.bitplane_host import pair_counts_host
    from phylonium_tpu.ops.device_counts import (
        pair_counts_chunks,
        pair_counts_states,
    )
    from phylonium_tpu.ops.match_table import pair_counts_numpy
    from phylonium_tpu.ops.shapes import pack_states, pad_rows, packed_width
    from phylonium_tpu.utils.platform import device_setup

    device_setup()
    out = {"precision": "int8 one-hot operands, int32 accumulation (exact)"}
    for n, length, layout, sampled in size("kernels", rehearse):
        rng = np.random.default_rng(n * 7 + length)
        # all 11 states: both strands of A C G T and '!', plus INVALID
        states = rng.integers(0, 11, size=(n, length), dtype=np.uint8)
        t0 = time.time()
        if layout == "packed":
            packed = pack_states(states, pad_rows(n), packed_width(length))
            dev = jnp.asarray(packed)
            del packed
            subs, homs = pair_counts_chunks((dev,), n, packed=True)
            del dev
        else:
            subs, homs = pair_counts_states(states)
        t_dev = time.time() - t0
        rows = np.arange(n)
        if sampled:
            # the first and last rows sit at the lowest and highest
            # offsets of the operand
            rows = np.unique(np.concatenate([
                [0, n - 1], rng.choice(n, sampled - 2, replace=False)
            ]))
            states = states[rows]
        t0 = time.time()
        if n <= 8:
            ref, ref_name = pair_counts_numpy(states), "numpy"
        else:
            ref, ref_name = pair_counts_host(states), "host_avx2"
        t_ref = time.time() - t0
        pick = np.ix_(rows, rows)
        if not (np.array_equal(subs[pick], ref[0])
                and np.array_equal(homs[pick], ref[1])):
            raise AssertionError(f"kernel {n} x {length} {layout}: counts "
                                 f"differ from {ref_name}")
        what = f"{len(rows)} rows" if sampled else "all rows"
        log(f"kernel {n} x {length} {layout}: exact vs {ref_name}, {what} "
            f"(device {t_dev:.2f}s incl. transfer and compile, reference "
            f"{t_ref:.1f}s)")
        out[f"{n}x{length}_{layout}"] = {"exact_vs": ref_name,
                                         "rows_compared": len(rows)}
        del states
    jax.clear_caches()
    return out


def _median(fn, reps):
    import numpy as np

    import jax

    jax.block_until_ready(fn())  # compile / warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_timing(rehearse):
    """The kernel alone (device-resident panel, packed and state-byte
    layouts) against what XLA makes of the plain one-hot formulation
    (ops/match_matrix.block_counts, its column block sized to fit the
    free device memory), and the compare from host state arrays the way
    the serial pipeline runs it (transfer, pad, count, fetch) against
    the plain formulation from the same host arrays."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from phylonium_tpu.core.pileup import INVALID
    from phylonium_tpu.ops.device_counts import (
        concat_pad,
        panel_counts,
        panel_shape,
    )
    from phylonium_tpu.ops.match_matrix import block_counts
    from phylonium_tpu.ops.shapes import pack_states, packed_width
    from phylonium_tpu.utils.platform import device_setup

    device_setup()
    stats = jax.devices()[0].memory_stats() or {}
    free = stats.get("bytes_limit", 8 << 30) - stats.get("bytes_in_use", 0)
    out = {}
    shapes = [s[:2] for s in size("kernels", rehearse)[1:5]]
    for n, length in shapes:
        rng = np.random.default_rng(n * 7 + length)
        states = rng.integers(0, 11, size=(n, length), dtype=np.uint8)
        n_pad, pwidth = panel_shape(n, packed_width(length))
        _, uwidth = panel_shape(n, length)

        dev = jnp.asarray(pack_states(states, n_pad, pwidth))
        t_packed = _median(lambda: panel_counts(dev, True), 5)
        del dev
        udev = concat_pad((jnp.asarray(states),), n_pad, uwidth, INVALID)
        t_bytes = _median(lambda: panel_counts(udev, False), 5)
        del udev

        def serial_from_host():
            d = concat_pad((jnp.asarray(states),), n_pad, uwidth, INVALID)
            return panel_counts(d, False)

        t_serial = _median(serial_from_host, 3)

        # plain XLA: [N, B, 10] bf16 planes twice per block, ~40 B per
        # genome-column; the block takes at most a third of free memory
        block = 1 << int(np.log2(max(256, min(free / 3 / (40 * n), length))))
        l_pad = -(-length // block) * block

        @jax.jit
        def plain(x):
            x = jnp.pad(x, ((0, 0), (0, l_pad - length)), constant_values=10)
            blocks = x.reshape(n, l_pad // block, block).transpose(1, 0, 2)

            def step(c, blk):
                m, h = block_counts(blk)
                return (c[0] + m, c[1] + h), None

            z = jnp.zeros((n, n), jnp.int32)
            (m, h), _ = jax.lax.scan(step, (z, z), blocks)
            return jnp.stack((m, h))

        udev = jnp.asarray(states)
        t_plain = _median(lambda: plain(udev), 3)
        del udev
        t_plain_host = _median(lambda: plain(jnp.asarray(states)), 3)
        # the two must agree exactly (the plain path is the reference)
        k = np.asarray(serial_from_host())
        p = np.asarray(plain(jnp.asarray(states)))
        if not np.array_equal(k[:, :n, :n], p):
            raise AssertionError(f"timing {n} x {length}: kernel != plain")
        rec = {
            "kernel_packed_s": t_packed,
            "kernel_bytes_s": t_bytes,
            "plain_xla_s": t_plain,
            "serial_from_host_s": t_serial,
            "plain_xla_from_host_s": t_plain_host,
            "plain_block_cols": block,
        }
        log(f"timing {n} x {length}: {json.dumps(rec)}")
        out[f"{n}x{length}"] = rec
        jax.clear_caches()
    return out


def phase_devd(rehearse):
    """Cold then warm run of phase 3's panel through the device server:
    byte-identical, the CLI process never imports jax, and one process
    (the server) holds the card."""
    n, length = size("auto600", rehearse)
    d = os.path.join(WORK, f"panel_{n}x{length}")
    files = make_panel(d, n, length, 600)
    sock = os.path.join(WORK, "devd.sock")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PHYLONIUM_TPU_DEVD_SOCK"] = sock
    logf = open(os.path.join(WORK, "devd.log"), "wb")
    daemon = subprocess.Popen(
        [sys.executable, "-m", "phylonium_tpu.serve"], env=env,
        stdout=logf, stderr=logf,
    )
    try:
        deadline = time.time() + 120
        while not os.path.exists(sock):
            if daemon.poll() is not None or time.time() > deadline:
                raise RuntimeError("device server did not come up")
            time.sleep(0.2)
        cli_env = dict(env)
        cli_env["PHYLONIUM_TPU_DEVD"] = "1"
        cli_env["PHYLONIUM_TPU_EXPECT_NO_JAX"] = "1"
        if rehearse:
            cli_env["PHYLONIUM_TPU_STREAM"] = "force"
            cli_env["PHYLONIUM_TPU_STREAM_GROUP"] = "4"
        report = os.path.join(WORK, "devd_report.json")
        cold, rep_cold, t_cold = run_cli([], files, d, cli_env, report)
        warm, rep_warm, t_warm = run_cli([], files, d, cli_env, report)
        if cold != warm:
            raise AssertionError("devd: warm stdout differs from cold")
        apps = gpu_apps()
        if apps is not None and len(apps) > 1:
            raise AssertionError(f"devd: {len(apps)} processes on the card")
        log(f"devd: cold {t_cold:.1f}s, warm {t_warm:.1f}s, identical")
        return {"cold_s": round(t_cold, 3), "warm_s": round(t_warm, 3),
                "identical": True, "cold": rep_cold, "warm": rep_warm,
                "processes_on_card": None if apps is None else len(apps)}
    finally:
        daemon.terminate()
        try:
            daemon.wait(timeout=30)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait()
        logf.close()


def phase_four(rehearse):
    """The multi-device path: the CLI with four cards visible (auto mesh,
    whose raced device leg may lose to the host), with --mesh 1,4 (the
    shape the auto mesh takes: one row of four, each card counting its
    column shard of the whole panel) and with --mesh 2,2 (rows gathered
    across cards), byte-compared with a one-card run and with the host.
    The runs share a mapping checkpoint, so only the first one maps; the
    compare is what differs."""
    n, length = size("four", rehearse)
    d = os.path.join(WORK, f"panel_{n}x{length}")
    t0 = time.time()
    files = make_panel(d, n, length, 1000)
    log(f"four: {n} x {length} panel ready ({time.time() - t0:.1f}s)")
    ckpt = ["--checkpoint", os.path.join(d, "ckpt")]
    report = os.path.join(d, "report.json")
    host, _, t_host = run_cli(["--count-backend", "host", *ckpt], files, d)
    auto, rep_auto, t_auto = run_cli(ckpt, files, d, report=report)
    mesh14, rep_mesh14, t_mesh14 = run_cli(
        ["--mesh", "1,4", *ckpt], files, d, report=report
    )
    mesh, rep_mesh, t_mesh = run_cli(
        ["--mesh", "2,2", *ckpt], files, d, report=report
    )
    one_env = dict(os.environ)
    one_env["CUDA_VISIBLE_DEVICES"] = "0"
    one, rep_one, t_one = run_cli(
        ["--count-backend", "device", *ckpt], files, d, one_env, report
    )
    for label, out in (("auto mesh", auto), ("--mesh 1,4", mesh14),
                       ("--mesh 2,2", mesh), ("one card", one)):
        if out != host:
            raise AssertionError(f"four: {label} stdout differs from host")
    for label, rep in (("--mesh 1,4", rep_mesh14), ("--mesh 2,2", rep_mesh)):
        if rep.get("compare_carrier") != "mesh":
            raise AssertionError(f"four: {label} carrier {rep}")
    leg = rep_auto.get("device_leg") or {}
    if not rehearse and leg.get("outcome") not in ("won", "lost"):
        raise AssertionError(f"four: auto device leg {leg}")
    res = {
        "panel": [n, length],
        "identical": True,
        "host_s": round(t_host, 3),
        "auto_s": round(t_auto, 3),
        "mesh14_s": round(t_mesh14, 3),
        "mesh22_s": round(t_mesh, 3),
        "one_card_s": round(t_one, 3),
        "auto_report": rep_auto,
        "mesh14_report": rep_mesh14,
        "mesh22_report": rep_mesh,
        "one_card_report": rep_one,
    }
    log(f"four: {json.dumps(res)}")
    return res


PHASES = {
    "probe": phase_probe,
    "golden": phase_golden,
    "eco29": phase_eco29,
    "auto600": phase_auto600,
    "stream600": phase_stream600,
    "kernels": phase_kernels,
    "timing": phase_timing,
    "devd": phase_devd,
    "four": phase_four,
}


# --------------------------------------------------------------------------
# driver (never imports jax)


def nvidia_smi(*query) -> list[str] | None:
    try:
        r = subprocess.run(
            ["nvidia-smi", *query, "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode:
        return None
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def gpu_apps() -> list[str] | None:
    return nvidia_smi("--query-compute-apps=pid")


def run_phase(name: str, env: dict, rehearse: bool) -> dict:
    left = BUDGET_S - (time.time() - _T0) - 20
    if left < 30:
        raise RuntimeError(f"no time left for phase {name}")
    cmd = [sys.executable, os.path.abspath(__file__), "--phase", name]
    if rehearse:
        cmd.append("--rehearse")
    log(f"phase {name} ...")
    try:
        r = subprocess.run(
            cmd, env=env, stdout=subprocess.PIPE, timeout=left, cwd=REPO
        )
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"phase {name} timed out after {left:.0f}s")
    lines = r.stdout.decode(errors="replace").strip().splitlines()
    if r.returncode or not lines:
        raise RuntimeError(f"phase {name} failed (exit {r.returncode})")
    result = json.loads(lines[-1])
    if not rehearse:
        apps = gpu_apps()
        if apps:
            raise RuntimeError(
                f"after phase {name}: processes left on the card: {apps}"
            )
    log(f"phase {name} passed")
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path and its checks")
    ap.add_argument("--devd", action="store_true",
                    help="run only the device-server phase (5)")
    ap.add_argument("--time-kernels", action="store_true",
                    help="run only the kernel timing phase (6)")
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on the CPU; never reports ok")
    ap.add_argument("--phase", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.phase:
        # a phase subprocess: the only process that may open the card
        sys.path.insert(0, REPO)
        print(json.dumps(PHASES[args.phase](args.rehearse)), flush=True)
        return

    if not os.path.isfile(os.path.join(REPO, "phylonium_tpu", "cli.py")):
        finish(False, error="the phylonium_tpu package is not beside "
               "chip_smoke.py (run it from the root of a checkout)")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PHYLONIUM_TPU_DEVD", None)
    if args.rehearse:
        env["JAX_PLATFORMS"] = "cpu"
        env["PHYLONIUM_TPU_PLATFORM"] = "cpu"
        if args.four:
            env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    else:
        card = nvidia_smi("--query-gpu=name,power.limit")
        if not card:
            finish(False, error="nvidia-smi finds no GPU")
        print(f"card: {card[0]}", flush=True)
        if not args.four:
            env["CUDA_VISIBLE_DEVICES"] = "0"
    os.makedirs(WORK, exist_ok=True)

    if args.four:
        phases = ["four"]
    elif args.devd or args.time_kernels:
        phases = (["devd"] if args.devd else []) + (
            ["timing"] if args.time_kernels else []
        )
    else:
        phases = ["golden", "eco29", "auto600", "stream600", "kernels"]
    try:
        probe = run_phase("probe", env, args.rehearse)
        if probe["platform"] != "gpu" and not args.rehearse:
            finish(False, error=f"JAX finds no GPU (platform "
                   f"{probe['platform']!r})")
        results = {}
        for name in phases:
            results[name] = run_phase(name, env, args.rehearse)
        if not args.rehearse:
            summary = os.path.join(
                REPO, "chiprun_out", f"chip_smoke_{'_'.join(phases)}.json"
            )
            os.makedirs(os.path.dirname(summary), exist_ok=True)
            with open(summary, "w") as f:
                json.dump({"probe": probe, "results": results}, f, indent=1)
    except Exception as e:  # noqa: BLE001 — reported as ok: false
        finish(False, error=f"{type(e).__name__}: {e}")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    if args.rehearse:
        finish(False, error="rehearsal on the CPU: no device was measured")
    expected = 4 if args.four else 1
    if probe["count"] != expected:
        finish(False, error=f"expected {expected} visible devices, found "
               f"{probe['count']}")
    finish(True, {"platform": probe["platform"], "kind": probe["kind"],
                  "count": probe["count"]})


if __name__ == "__main__":
    main()
