"""The core pipeline: index -> map -> pileup -> all-pairs counts.

Equivalent of the reference's ``process()`` (`src/process.cxx:408-556`)
with the comparison phase redesigned for an accelerator:

1. build the ESA over subject + '#' + revcomp (index backend: C++ or
   numpy);
2. compute the minimum anchor length from the subject's GC content
   (src/process.cxx:416-417);
3. map every query: anchor chaining -> sort by projected start ->
   max-chain overlap filter (src/process.cxx:433-458);
4. optional complete deletion (core genome) and ``-p`` segsite output;
5. **pileup**: project every genome onto reference columns
   (core/pileup.py) and compute all-pairs substitution/homolog counts
   with the fused device kernel (ops/device_counts.py), the host kernel
   (ops/bitplane_host.py) or the numpy oracle (--count-backend numpy).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from phylonium_tpu.config import ConfigError, RunConfig
from phylonium_tpu.core.anchor_stats import min_anchor_length
from phylonium_tpu.core.anchors import anchor_homologies
from phylonium_tpu.core.complete_deletion import complete_delete
from phylonium_tpu.core.filter import filter_overlaps_max
from phylonium_tpu.core.homology import Homology
from phylonium_tpu.core.pileup import build_pileup
from phylonium_tpu.core.segsites import write_refpos
from phylonium_tpu.data.sequence import Sequence, gc_content
from phylonium_tpu.index.esa import ESAIndex
from phylonium_tpu.model.evo import EvoCounts

# Which leg actually produced the pair counts in the most recent
# process() run: "host" | "device" | "mesh" | "numpy".  Results are
# bit-identical across carriers by construction — this is
# observability so callers (bench, -v -v, PHYLONIUM_TPU_RUN_REPORT)
# can report the dispatch that REALLY happened, not the one that was
# planned (the auto race can hand a planned device run to the host).
# ``device_leg`` records how the raced device leg ended: won, lost,
# error (with the error's first line) or skipped.
LAST_RUN_INFO: dict = {}


def _set_carrier(kind: str) -> None:
    LAST_RUN_INFO["compare_carrier"] = kind


def record_device_leg(outcome: str, error: BaseException | None = None,
                      cfg: RunConfig | None = None) -> None:
    """Record the raced device leg's outcome in the run report; an
    error is also warned on stderr (the host result stands)."""
    leg: dict = {"outcome": outcome}
    if error is not None:
        first = (str(error).splitlines() or [""])[0]
        leg["error"] = f"{type(error).__name__}: {first}"[:300]
        msg = (
            f"device leg failed ({leg['error']}); the host count "
            "carried the run"
        )
        if cfg is not None:
            cfg.warn(msg)
        else:
            from phylonium_tpu.config import PROG

            print(f"{PROG}: {msg}", file=sys.stderr)
    LAST_RUN_INFO["device_leg"] = leg


def _in_process_device(what: str) -> None:
    """Gate of every in-process device path: with the device server
    engaged the server owns the card, so this process must not open it;
    otherwise apply the platform pin and the compile cache."""
    from phylonium_tpu.serve.client import devd_enabled

    if devd_enabled():
        raise ConfigError(
            f"{what} runs on the device in this process, which cannot "
            "share the card with the device server (unset "
            "PHYLONIUM_TPU_DEVD)"
        )
    from phylonium_tpu.utils.platform import device_setup

    device_setup()


def map_queries(
    ref: ESAIndex,
    threshold: int,
    queries: list[Sequence],
    cfg: RunConfig,
) -> list[list[Homology]]:
    """Anchor-map every query against the index ("Mapping" phase).

    Progress is live (per completed query) on every backend — the native
    batch mapper exposes an atomic counter a poll thread watches while
    the C++/OpenMP call runs (the reference updates in-loop the same
    way, src/process.cxx:445-456).
    """
    from phylonium_tpu.utils.progress import ProgressBar

    n = len(queries)
    homologies: list[list[Homology]] = [None] * n  # type: ignore

    bar = ProgressBar(
        f"Mapping {n} sequences", n, enabled=cfg.progress_enabled
    )

    # Checkpoint: reuse previously mapped queries (content-addressed).
    ckpt = None
    keys = [None] * n
    todo = list(range(n))
    if cfg.checkpoint_dir:
        from phylonium_tpu.utils.checkpoint import (
            MappingCheckpoint,
            query_key,
            subject_key,
        )

        ckpt = MappingCheckpoint(cfg.checkpoint_dir)
        skey = subject_key(ref.subject.nucl, threshold)
        todo = []
        for j in range(n):
            keys[j] = query_key(skey, queries[j].name, queries[j].nucl)
            cached = ckpt.load(keys[j])
            if cached is None:
                todo.append(j)
            else:
                homologies[j] = cached
    # multi-host: map only this process's queries (round-robin split of
    # the reference's data-parallel-over-queries axis), exchange after.
    from phylonium_tpu.utils.platform import distributed_state

    nproc, pid = distributed_state()
    if nproc > 1:
        todo = [j for j in todo if j % nproc == pid]

    done_base = n - len(todo)
    bar.update(done_base)

    map_backend = cfg.map_backend
    if map_backend == "auto":
        map_backend = "native" if ref.backend_name == "native" else "python"
    elif map_backend == "native" and ref.backend_name != "native":
        raise ConfigError(
            "--map-backend=native requires the native suffix index, but "
            f"the '{ref.backend_name}' ESA backend is in use (pick "
            "--esa-backend=native or another map backend)"
        )

    if map_backend == "hybrid":
        # host chain state machine + device anchor extension (stage 4);
        # an explicit device path: a device error fails the run
        from phylonium_tpu.core.hybrid_map import hybrid_map_queries

        _in_process_device("--map-backend hybrid")
        raw = hybrid_map_queries(
            ref,
            threshold,
            [queries[j].as_array() for j in todo],
            progress=lambda d: bar.update(done_base + d),
        )
        for k, j in enumerate(todo):
            hv = raw[k]
            hv.sort(key=lambda h: h.start())
            homologies[j] = filter_overlaps_max(hv)
    elif map_backend == "native":
        # Native backend maps entire batches in C++/OpenMP; the shared
        # helper relays its atomic per-query counter to the bar.
        from phylonium_tpu.core.map_native import map_batch_native

        native_out = map_batch_native(
            ref._native,
            [queries[j].as_array() for j in todo],
            threshold,
            bar,
            done_base,
        )
        for k, j in enumerate(todo):
            homologies[j] = native_out[k]
    else:
        for k, j in enumerate(todo):
            hv = anchor_homologies(ref, threshold, queries[j])
            hv.sort(key=lambda h: h.start())
            homologies[j] = filter_overlaps_max(hv)
            bar.update(done_base + k + 1)

    if ckpt is not None:
        for j in todo:
            ckpt.save(keys[j], homologies[j])

    if nproc > 1:
        from phylonium_tpu.parallel.map_shard import exchange_homologies

        owned = [j for j in range(n) if j % nproc == pid]
        homologies = exchange_homologies(homologies, owned)
        if cfg.verbose >= 2:
            print(
                f"mapping sharded: process {pid}/{nproc} mapped "
                f"{len(todo)} of {n} queries locally",
                file=sys.stderr,
            )

    bar.finish()
    return homologies


def _is_multiprocess() -> bool:
    """True in a multi-process (jax.distributed) run — read WITHOUT
    jax.process_count(), which may start the backend, and without any
    import (utils/platform.distributed_state)."""
    from phylonium_tpu.utils.platform import distributed_state

    return distributed_state()[0] > 1


def _auto_prefers_host(n: int, ref_len: int, cfg: RunConfig) -> bool:
    """Small-panel fast path: with 'auto' counting, panels whose host
    compare is predicted to beat the device path never touch the device
    runtime at all (no backend init, no kernel compile, no transfer —
    each of which costs seconds and steals CPU from the mapping phase).

    Once a verified link bandwidth exists (utils/calibration.py,
    recorded by earlier runs' transfers), the decision compares the
    predicted host compare time against the predicted ship time of the
    nibble-packed panel.  Before the first measurement (or under an
    explicit PHYLONIUM_TPU_AUTO_DEVICE_GBP) the static work threshold
    decides.  Explicit backends, --mesh, and multi-process runs always
    take their requested path."""
    if cfg.count_backend != "auto" or cfg.mesh:
        return False
    if _is_multiprocess():
        return False
    work_gbp = n * (n - 1) / 2 * ref_len / 1e9
    if not os.environ.get("PHYLONIUM_TPU_AUTO_DEVICE_GBP"):
        from phylonium_tpu.utils import calibration

        link = calibration.link_mb_s()
        if link is not None:
            t_host = work_gbp / calibration.host_compare_gbps()
            # serial path ships the nibble-packed panel (N*L/2 bytes)
            # unhidden at compare time
            t_dev = n * ref_len / 2 / 1e6 / link
            LAST_RUN_INFO["dispatch_model"] = {
                "link_mb_s": round(link, 2),
                "t_host_s": round(t_host, 3),
                "t_device_s": round(t_dev, 3),
            }
            return t_host < t_dev
    return work_gbp < cfg.auto_device_min_gbp


def _stream_predicts_win(n: int, ref_len: int, cfg: RunConfig):
    """Measured-link prediction whether a STREAMED device compare beats
    the host compare: the 2-bit query panel (N*L/4 bytes) ships hidden
    under the mapping window, so the device pays only the unhidden ship
    remainder.  Returns None when no link measurement exists (caller
    falls back to the static threshold) or an explicit
    PHYLONIUM_TPU_AUTO_DEVICE_GBP pins the static rule."""
    if os.environ.get("PHYLONIUM_TPU_AUTO_DEVICE_GBP"):
        return None
    from phylonium_tpu.utils import calibration

    link = calibration.link_mb_s()
    if link is None:
        return None
    work_gbp = n * (n - 1) / 2 * ref_len / 1e9
    t_host = work_gbp / calibration.host_compare_gbps()

    from phylonium_tpu.serve.client import devd_enabled

    if devd_enabled():
        # the device server's content cache makes shipping an
        # amortized-zero cost (groups already parked there ship 0
        # bytes), and the devd race leg is socket waits, so engaging
        # costs the host leg ~nothing: the race settles each run
        LAST_RUN_INFO["stream_model"] = {
            "link_mb_s": round(link, 2),
            "t_host_s": round(t_host, 3),
            "devd": True,
        }
        return True
    total_bp = n * ref_len
    ship_s = total_bp / 4 / (link * 1e6)
    overlap_s = total_bp / (calibration.map_gbps() * 1e9)
    unhidden = max(0.0, ship_s - overlap_s)
    LAST_RUN_INFO["stream_model"] = {
        "link_mb_s": round(link, 2),
        "t_host_s": round(t_host, 3),
        "unhidden_ship_s": round(unhidden, 3),
    }
    return unhidden < t_host


def _device_count() -> int:
    """Devices this process sees (initializes the backend)."""
    from phylonium_tpu.utils.platform import apply_platform_override

    apply_platform_override()
    import jax

    return len(jax.devices())


def _mesh_device_count(cfg: RunConfig) -> int:
    """Devices the counting mesh would span (0 = single-device path)."""
    if cfg.count_backend in ("numpy", "host"):
        return 0
    if cfg.mesh:
        rows, _, cols = cfg.mesh.partition(",")
        return int(rows) * int(cols or "1")
    n = _device_count()
    return n if n > 1 else 0


def _pair_counts_device(states: np.ndarray, cfg: RunConfig, progress=None):
    """Single-device counting through the one device entry point."""
    _in_process_device("device counting")
    from phylonium_tpu.ops.device_counts import pair_counts_states

    result = pair_counts_states(states)
    if progress is not None:
        progress(1.0)
    return result


def _pair_counts_mesh(states: np.ndarray, cfg: RunConfig):
    """Production multi-device counting over a ('rows','cols') mesh.

    The analogue of the reference's omp-parallel compare loop
    (src/process.cxx:524): pair blocks are data-parallel across every
    device; exact int32 partials merge with a psum, so the matrix is
    bit-identical to the single-device path for any mesh shape.
    """
    _in_process_device("mesh counting")
    import jax

    from phylonium_tpu.parallel.distributed import pair_counts_sharded
    from phylonium_tpu.parallel.mesh import make_mesh

    if cfg.mesh:
        rows, _, cols = cfg.mesh.partition(",")
        shape = (int(rows), int(cols or "1"))
        devices = jax.devices()
        if shape[0] * shape[1] > len(devices):
            raise ConfigError(
                f"--mesh {cfg.mesh} needs {shape[0] * shape[1]} devices; "
                f"the runtime has {len(devices)}"
            )
        mesh = make_mesh(shape, devices=devices[: shape[0] * shape[1]])
    else:
        from phylonium_tpu.parallel.multihost import make_pod_mesh

        mesh = make_pod_mesh()
    return pair_counts_sharded(states, mesh)


def race(host_fn, device_fn, cfg: RunConfig | None = None):
    """Run ``device_fn`` on a thread while ``host_fn(poll)`` counts on
    the host; return whichever finishes first (results are bit-identical
    by construction) and record the device leg's outcome.

    ``host_fn`` polls between column chunks and returns None once the
    device finished.  A device error never fails the run: the host
    result stands, and the error is warned on stderr and recorded.
    """
    import threading

    outcome: dict = {}
    done = threading.Event()

    def device_work():
        try:
            outcome["result"] = device_fn()
        except Exception as e:  # noqa: BLE001 — recorded, host carries
            outcome["error"] = e
        finally:
            done.set()

    threading.Thread(
        target=device_work, daemon=True, name="compare-device"
    ).start()
    host_result = host_fn(done.is_set)
    if host_result is not None and "result" not in outcome:
        if "error" in outcome:
            record_device_leg("error", outcome["error"], cfg)
        else:
            record_device_leg("lost")
        _set_carrier("host")
        return host_result
    done.wait()
    if "result" in outcome:
        record_device_leg("won")
        _set_carrier("device")
        return outcome["result"]
    # the device failed after the host leg stopped polling: redo on host
    record_device_leg("error", outcome["error"], cfg)
    _set_carrier("host")
    return host_fn(None)


def _race_host(states, device_fn, progress=None, cfg=None):
    """The compare race on a host state matrix: the native AVX2 kernel
    (ops/bitplane_host.py) against ``device_fn``.  The host leg carries
    cold starts (first compile of a shape); once the persistent compile
    cache holds the kernel the device wins and the host leg stops after
    at most one column chunk."""
    from phylonium_tpu.ops.bitplane_host import pair_counts_host

    return race(
        lambda poll: pair_counts_host(states, poll=poll, progress=progress),
        device_fn,
        cfg,
    )


def _host_counts(states, progress=None):
    from phylonium_tpu.ops.bitplane_host import pair_counts_host

    _set_carrier("host")
    return pair_counts_host(states, progress=progress)


def pair_counts(
    states: np.ndarray, cfg: RunConfig, progress=None
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (substitutions, homologs) — the production dispatch.

    numpy    scalar oracle (tiny inputs, tests)
    host     native AVX2 / bitplane popcount on the host
    mesh     every visible device via shard_map + psum (--mesh R,C, or
             auto whenever the runtime exposes more than one device)
    device   single-device fused kernel (--count-backend device|pallas)
    auto     the device path raced against the host, so a first compile
             never blocks a run

    Explicit device paths (device, pallas, --mesh) fail the run on a
    device error; only the auto race lets the host carry.
    ``progress`` (optional) receives a completed fraction in [0, 1].
    """
    backend = cfg.count_backend
    if backend == "numpy":
        from phylonium_tpu.ops.match_table import pair_counts_numpy

        _set_carrier("numpy")
        return pair_counts_numpy(states)
    if backend == "host" or _auto_prefers_host(
        states.shape[0], states.shape[1], cfg
    ):
        return _host_counts(states, progress)

    # an explicit --mesh names the collective path (its device count is
    # the mesh shape); an explicit 'pallas'/'device' names the
    # single-device path and must actually run it
    if (cfg.mesh and _mesh_device_count(cfg) > 1) or (
        backend == "auto" and _is_multiprocess()
    ):
        result = _pair_counts_mesh(states, cfg)
        _set_carrier("mesh")
        if progress is not None:
            progress(1.0)
        return result

    if backend == "auto":
        from phylonium_tpu.serve.client import devd_enabled
        from phylonium_tpu.utils.platform import cpu_pinned

        if cpu_pinned():
            # the "device" IS this CPU: racing it against the host
            # kernel would split the cores for nothing
            return _host_counts(states, progress)
        if devd_enabled():
            # the device server owns the card; this serial (unstreamed)
            # panel has no server-side path
            record_device_leg("skipped")
            return _host_counts(states, progress)

        used_mesh = []

        def device_leg():
            if _device_count() > 1:
                used_mesh.append(True)
                return _pair_counts_mesh(states, cfg)
            return _pair_counts_device(states, cfg)

        result = _race_host(states, device_leg, progress, cfg)
        if used_mesh and LAST_RUN_INFO.get("compare_carrier") == "device":
            _set_carrier("mesh")
        if progress is not None:
            progress(1.0)
        return result
    result = _pair_counts_device(states, cfg, progress)
    _set_carrier("device")
    return result


def prewarm_counts(n: int, ref_len: int, cfg: RunConfig):
    """Start compiling the counting kernel in the background.

    The kernel shapes are fully determined by (n, ref_len) thanks to
    shape bucketing, so compilation overlaps the host-side index build
    and mapping phases.  Everything jax-related (including backend
    init) happens on the worker thread.  Returns the thread (daemon;
    safe to ignore), or None when nothing is compiled in this process.
    """
    import threading

    if cfg.count_backend not in ("auto", "pallas", "device") or cfg.mesh:
        return None
    if _auto_prefers_host(n, ref_len, cfg) and not (
        getattr(cfg, "_query_shipper", None) is not None
        or _stream_predicts_win(n, ref_len, cfg)
    ):
        return None  # panel stays on the host; don't spin up the device
    from phylonium_tpu.serve.client import devd_enabled
    from phylonium_tpu.utils.platform import cpu_pinned

    if devd_enabled() or cpu_pinned():
        # the device server compiles in its own session; CPU compiles
        # are local and fast
        return None

    def work():
        try:
            from phylonium_tpu.utils.platform import device_setup

            device_setup()
            if _device_count() > 1:
                return  # the mesh path compiles its own program
            from phylonium_tpu.core.stream import (
                effective_group_rows,
                prewarm_stream,
            )
            from phylonium_tpu.ops.device_counts import prewarm

            # the streamed feeders ship the packed layout, the serial
            # path the state bytes: warm the program this run will use
            streamed = (
                cfg.count_backend == "auto"
                and n > effective_group_rows(n)
                and not cfg.complete_deletion
                and not cfg.print_positions
                and not cfg.checkpoint_dir
            )
            prewarm(n, ref_len, packed=streamed)
            if streamed:
                prewarm_stream(n, ref_len)
        except Exception:
            pass  # prewarm is best-effort; the real call will compile

    t = threading.Thread(target=work, daemon=True, name="prewarm-counts")
    t.start()
    return t


def _should_stream(n: int, ref_len: int, cfg: RunConfig, ref) -> bool:
    """Streamed map→pileup→transfer overlap (core/stream.py) applies to
    the plain 'auto' single-device production path on panels the
    work-based dispatch sends to the device.  Paths that need the whole
    homology set before the pileup (complete deletion, '-p'), explicit
    backends (which name exact code paths), checkpointing, meshes, and
    multi-process runs keep the serial phases.

    PHYLONIUM_TPU_STREAM=0 disables; =force enables regardless of
    platform/threshold (tests run the full streamed pipeline on CPU in
    kernel-interpret mode this way).
    """
    env = os.environ.get("PHYLONIUM_TPU_STREAM", "")
    if env == "0":
        return False
    if cfg.count_backend != "auto" or cfg.mesh:
        return False
    from phylonium_tpu.core.stream import effective_group_rows

    group = effective_group_rows(n)
    if n <= group and env != "force":
        # a single feed group only finishes mapping when mapping is
        # over — nothing can overlap, and the serial path's host race
        # handles this panel class strictly better
        return False
    if cfg.complete_deletion or cfg.print_positions or cfg.checkpoint_dir:
        return False
    if cfg.map_backend not in ("auto", "native"):
        return False
    if ref.backend_name != "native":
        return False
    if _is_multiprocess():
        return False
    if env == "force":
        return True
    shipper = getattr(cfg, "_query_shipper", None)
    if shipper is not None and not shipper._cancelled:
        # the CLI's early-ship gate already decided (with measured link
        # bandwidth and actual file sizes) that this panel's device
        # compare is worth it — and the 2-bit codes are already
        # shipping; bailing out here would waste them
        pass
    else:
        win = _stream_predicts_win(n, ref_len, cfg)
        if win is None:
            if _auto_prefers_host(n, ref_len, cfg):
                return False
        elif not win:
            return False
    from phylonium_tpu.serve.client import devd_enabled
    from phylonium_tpu.utils.platform import cpu_pinned

    if cpu_pinned():
        return False
    if devd_enabled():
        return True  # the server's single device counts the panel
    # a multi-device runtime routes to the mesh instead
    return _device_count() == 1


def _should_stream_mp(n: int, ref_len: int, cfg: RunConfig, ref) -> bool:
    """Streamed resident-shard pipeline for multi-process runs
    (parallel/stream_mp.py): each process maps its contiguous genome
    block and feeds its own device's shard during mapping; the compare
    is the usual collective on resident data.  Applies to the plain
    'auto' path with ONE local device per process; every process
    evaluates the same deterministic inputs, so the engage decision is
    collective-consistent."""
    if not _is_multiprocess():
        return False
    env = os.environ.get("PHYLONIUM_TPU_STREAM", "")
    if env == "0":
        return False
    if cfg.count_backend != "auto" or cfg.mesh:
        return False
    if cfg.complete_deletion or cfg.print_positions or cfg.checkpoint_dir:
        return False
    if cfg.map_backend not in ("auto", "native"):
        return False
    if ref.backend_name != "native":
        return False
    import jax

    if jax.local_device_count() != 1:
        return False
    from phylonium_tpu.core.stream import effective_group_rows

    if env == "force":
        return True
    if n <= effective_group_rows(n):
        return False
    from phylonium_tpu.utils.platform import cpu_pinned

    return not cpu_pinned()


def process(
    subject: Sequence, queries: list[Sequence], cfg: RunConfig
) -> EvoCounts:
    import time

    LAST_RUN_INFO.clear()
    timings: dict[str, float] = {}
    n = len(queries)

    if cfg.count_backend == "auto" and not cfg.mesh:
        # the estimates this run's dispatch decisions act on (None
        # before the first measured transfer) — run-report observability
        try:
            from phylonium_tpu.utils import calibration

            LAST_RUN_INFO["calibration"] = calibration.snapshot()
        except Exception:
            pass

    # start compiling the counting kernel while the host builds the index
    # and maps queries (shapes are fixed by (n, |subject|) via bucketing)
    prewarm_counts(n, len(subject), cfg)

    t0 = time.time()
    ref = ESAIndex(subject, backend=cfg.esa_backend)
    timings["index"] = time.time() - t0
    gc = gc_content(subject.nucl)
    threshold = min_anchor_length(cfg.anchor_p_value, gc, ref.size)

    if cfg.verbose:
        print(f"ref: {subject.name}", file=sys.stderr)

    if _should_stream_mp(n, len(subject), cfg, ref):
        from phylonium_tpu.parallel.stream_mp import (
            map_pileup_count_streamed_mp,
        )

        t0 = time.time()
        subs, homs = map_pileup_count_streamed_mp(
            ref, threshold, queries, cfg
        )
        timings["map+feed+compare"] = time.time() - t0
        _set_carrier("mesh")
        LAST_RUN_INFO["timings"] = {
            k: round(v, 3) for k, v in timings.items()
        }
        if cfg.verbose >= 2:
            phases = "  ".join(
                f"{k}={v:.3f}s" for k, v in timings.items()
            )
            print(
                f"phase timings ({ref.backend_name} index, "
                f"{cfg.count_backend} counts, mesh carried, pod "
                f"streamed): {phases}",
                file=sys.stderr,
            )
        return EvoCounts(subs, homs)

    from phylonium_tpu.core.lowmem import should_lowmem

    if should_lowmem(n, sum(len(q) for q in queries), cfg, ref):
        from phylonium_tpu.core.lowmem import map_count_lowmem
        from phylonium_tpu.utils import calibration

        subs, homs, lm_timings = map_count_lowmem(
            ref, threshold, queries, cfg
        )
        timings.update(lm_timings)
        calibration.record_map(
            sum(len(q) for q in queries) / 1e9,
            lm_timings.get("map+feed", 0.0),
        )
        if LAST_RUN_INFO.get("compare_carrier") == "host":
            calibration.record_host_compare(
                n * (n - 1) / 2 * len(subject) / 1e9,
                lm_timings.get("compare", 0.0),
            )
        LAST_RUN_INFO["timings"] = {
            k: round(v, 3) for k, v in timings.items()
        }
        if cfg.verbose >= 2:
            phases = "  ".join(
                f"{k}={v:.3f}s" for k, v in timings.items()
            )
            carrier = LAST_RUN_INFO.get("compare_carrier", "?")
            print(
                f"phase timings ({ref.backend_name} index, "
                f"{cfg.count_backend} counts, {carrier} carried, "
                f"low-mem): {phases}",
                file=sys.stderr,
            )
        return EvoCounts(subs, homs)

    shipper = getattr(cfg, "_query_shipper", None)
    feeder = None
    if _should_stream(n, len(subject), cfg, ref):
        from phylonium_tpu.core.stream import (
            DeviceRowFeeder,
            map_pileup_streamed,
        )

        try:
            feeder = DeviceRowFeeder(n, len(subject), shipper=shipper)
        except Exception:
            feeder = None  # feeder construction is best-effort

    if feeder is None and shipper is not None:
        # the run went elsewhere (host dispatch, mesh, a non-streamable
        # late condition): stop spending link bandwidth on query codes
        # nobody will count on
        shipper.cancel()

    if feeder is not None:
        from phylonium_tpu.utils import calibration

        t0 = time.time()
        homologies, states = map_pileup_streamed(
            ref, threshold, queries, cfg, feeder
        )
        t_map = time.time() - t0
        timings["map+pileup+feed"] = t_map
        # the measured overlap window (mapping with the feed's CPU
        # steal folded in) — exactly what the early-ship gate predicts
        calibration.record_map(
            sum(len(q) for q in queries) / 1e9, t_map
        )
        return _compare_and_finish(
            subject, queries, cfg, ref, states, homologies, timings,
            feeder,
        )

    t0 = time.time()
    homologies = map_queries(ref, threshold, queries, cfg)
    timings["map"] = time.time() - t0
    if (
        cfg.map_backend in ("auto", "native")
        and ref.backend_name == "native"
        and not cfg.checkpoint_dir  # partial mapping skews the rate
        and not _is_multiprocess()  # each process maps only its shard
    ):
        from phylonium_tpu.utils import calibration

        calibration.record_map(
            sum(len(q) for q in queries) / 1e9, timings["map"]
        )

    if cfg.complete_deletion:
        homologies = complete_delete(homologies)

    t0 = time.time()
    query_arrays = [q.as_array() for q in queries]
    states = build_pileup(query_arrays, homologies, len(subject))
    timings["pileup"] = time.time() - t0

    if cfg.print_positions:
        write_refpos(
            cfg.refpos_file_name, subject.nucl, states, homologies[0]
        )

    return _compare_and_finish(
        subject, queries, cfg, ref, states, homologies, timings, None
    )


def finish_ship_accounting(feeder, n: int, ref_len: int) -> None:
    """Cold-run seeding + early-ship observability, shared by the
    standard and low-memory pipelines.

    Under ``PHYLONIUM_TPU_SHIP_DRAIN`` (the bench's cold-run hook) the
    run stays alive until the whole panel is parked in the device
    server's content cache — and, when the device never carried a count
    at this shape, until the daemon's program family is compiled
    (synchronous ``prewarm``), so the NEXT run of the same panel races
    hot with zero bytes shipped.  Always records the early-ship stats
    (groups / MB / MB/s / cache hits) into LAST_RUN_INFO."""
    import time

    if feeder is None or feeder._shipper is None:
        return
    drain_env = os.environ.get("PHYLONIUM_TPU_SHIP_DRAIN")
    if drain_env:
        # a seeding run must not skip its drain because the run ended
        # before the shipper's connection was up
        feeder._shipper.ready.wait(float(drain_env))
    if (
        drain_env
        and feeder._shipper.transport == "devd"
        and not feeder._shipper._cancelled
    ):
        t_dr = time.time()
        budget = float(drain_env)
        complete = feeder._shipper.drain(budget)
        drain_info = {
            "complete": complete,
            "s": round(time.time() - t_dr, 2),
        }
        left = budget - (time.time() - t_dr)
        if (
            complete
            and left > 30.0
            and LAST_RUN_INFO.get("compare_carrier") != "device"
        ):
            # content is parked but the daemon never finished a count
            # at this shape (the race's abandoned device leg may still
            # be compiling): block until its jit cache is hot, so the
            # NEXT run's device leg starts with zero compiles instead
            # of losing the race to them
            try:
                from phylonium_tpu.serve.client import get_client

                reply, _ = get_client().request(
                    {
                        "op": "prewarm",
                        "n": n,
                        "ref_len": int(ref_len),
                        # the run's actual feeding-group layout (the
                        # lowmem pipeline sizes groups from its RSS
                        # budget; the build programs are per-layout)
                        "group_rows": feeder._shipper.group_rows,
                        "sync": True,
                    },
                    timeout=left,
                )
                drain_info["prewarm_s"] = reply.get("seconds")
            except Exception as e:  # noqa: BLE001 — best-effort
                drain_info["prewarm_error"] = repr(e)[:120]
        LAST_RUN_INFO["ship_drain"] = drain_info
    mb_s = feeder._shipper.achieved_mb_s()
    LAST_RUN_INFO["early_ship"] = {
        "groups": feeder._shipper.shipped_groups(),
        "mb": round(feeder._shipper.shipped_bytes() / 1e6, 1),
        "mb_s": round(mb_s, 2) if mb_s else None,
        "cache_hits": feeder._shipper._hits,
    }


def race_grace_if_warm(feeder) -> None:
    """On fully cache-warm device-server runs (every group was a daemon
    content hit), wait briefly for the feeder to dispatch the tail
    group BEFORE the host race leg claims the core: the ~0.1-0.4 s of
    host-side prep left in the queue otherwise stretches 3-4x under
    single-core contention, inflating the device leg's observed tail."""
    import time

    shipper = feeder._shipper
    if not (
        feeder._devd
        and shipper is not None
        and shipper._enqueued > 0
        and shipper._hits == shipper._enqueued
    ):
        return
    _g0 = time.time()
    ok = feeder.wait_dispatched(
        float(os.environ.get("PHYLONIUM_TPU_RACE_GRACE_S", "3.0"))
    )
    if os.environ.get("PHYLONIUM_TPU_DEBUG"):
        print(
            f"race grace: waited {time.time() - _g0:.2f}s drained={ok}",
            file=sys.stderr,
        )


def _compare_and_finish(
    subject, queries, cfg, ref, states, homologies, timings, feeder
) -> EvoCounts:
    """Shared compare phase: the production dispatch, or — when the
    streamed pipeline already shipped the panel — the resident-device
    count raced against the host (a failed or slow device leg still
    finishes at host speed, bit-identically)."""
    import time

    from phylonium_tpu.utils.progress import ProgressBar

    n = len(queries)
    num_comparisons = (n * n - n) // 2
    bar = ProgressBar(
        "Comparing the sequences",
        num_comparisons,
        enabled=cfg.progress_enabled,
    )
    progress = lambda frac: bar.update(int(frac * num_comparisons))  # noqa: E731

    t0 = time.time()
    if feeder is not None:
        race_grace_if_warm(feeder)
        subs, homs = _race_host(
            states, lambda: feeder.finish(progress), progress, cfg
        )
        if feeder.devd_count_s is not None:
            # daemon-side count time of a COMPLETED device finish —
            # the measured warm tail the dispatch gates care about
            LAST_RUN_INFO["devd_count_s"] = feeder.devd_count_s
    else:
        subs, homs = pair_counts(states, cfg, progress=progress)
    timings["compare"] = time.time() - t0
    bar.finish()

    finish_ship_accounting(feeder, n, states.shape[1])

    if LAST_RUN_INFO.get("compare_carrier") == "host":
        from phylonium_tpu.utils import calibration

        calibration.record_host_compare(
            n * (n - 1) / 2 * states.shape[1] / 1e9, timings["compare"]
        )

    LAST_RUN_INFO["timings"] = {k: round(v, 3) for k, v in timings.items()}
    if cfg.verbose >= 2:
        phases = "  ".join(f"{k}={v:.3f}s" for k, v in timings.items())
        carrier = LAST_RUN_INFO.get("compare_carrier", "?")
        print(
            f"phase timings ({ref.backend_name} index, "
            f"{cfg.count_backend} counts, {carrier} carried): {phases}",
            file=sys.stderr,
        )

    counts = EvoCounts(subs, homs)
    return counts
