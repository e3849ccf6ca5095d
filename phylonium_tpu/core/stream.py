"""Streamed map → pileup → device-transfer pipeline.

The reference runs its phases strictly serially: map every query, then
compare every pair (`src/process.cxx:433-458` then `:524-549`).  The
device compare needs the pileup ON the device, and the host→device
shipment of hundreds of MB would sit on the critical path after mapping
finished.  This module overlaps them: as each row group of
queries finishes mapping, its pileup rows are built (native pass),
nibble-packed, and shipped to the device on a background worker while
the host maps the next group.  By compare time the panel is already
resident and the device path costs only kernel execution plus one fetch.

Bit-exactness: the packed row groups concatenate on device to exactly
the array the one-shot path would have shipped, and the same kernels run
on it (tests/test_stream.py asserts equality against the serial path for
every chunking).

A device error inside the feeder surfaces at ``finish()`` — the caller
races it against the host counting path, records the device leg's
error in the run report and warns on stderr; the host result stands.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from phylonium_tpu.config import ConfigError, RunConfig
from phylonium_tpu.core.homology import Homology
from phylonium_tpu.index.esa import ESAIndex

# rows per mapping/feeding group: large enough that per-transfer fixed
# costs stay negligible, small enough to start shipping early in the
# mapping phase
DEFAULT_GROUP_ROWS = 128


def effective_group_rows(n: int) -> int:
    """Feeding-group size for an ``n``-genome panel: the 128-row default
    capped so every panel splits into at least ~4 groups (a single
    group would finish mapping exactly when mapping ends — nothing to
    overlap; observed at the 116-genome tier, which the fixed default
    silently excluded from streaming).  The 8-row floor keeps per-group
    fixed costs amortized.
    ``PHYLONIUM_TPU_STREAM_GROUP`` pins an explicit size."""
    env = os.environ.get("PHYLONIUM_TPU_STREAM_GROUP")
    if env:
        return int(env)
    return min(DEFAULT_GROUP_ROWS, max(8, -(-n // 4)))


class DeviceRowFeeder:
    """Ships pileup row groups to the device as queries finish mapping.

    ``feed(queries, homologies)`` enqueues a mapped group; a single
    worker thread ships it as 2-bit-packed query codes + interval
    records (~L/4 bytes per genome) and dispatches the fused
    build-and-nibble-pack program (ops/pileup_device.build_packed_
    rows_device), so a slow transfer stalls the worker, never the
    mapping loop.  ``finish()`` counts the resulting chunks through the
    one device entry point (ops/device_counts.pair_counts_chunks); it
    raises whatever the worker hit, which the caller records via the
    host race.
    """

    def _init_shapes(self, n: int, ref_len: int) -> None:
        # jax-free shape math: the devd transport must not pay the
        # jax import (~1.8 s, ~400 MB RSS) just to derive shapes
        from phylonium_tpu.ops.shapes import pad_rows, packed_width

        self.n = n
        self.ref_len = ref_len
        self.n_pad = pad_rows(n)
        self.l2 = -(-max(ref_len, 1) // 2)
        # width bucketed up front: the chunks concatenate to exactly
        # the kernel's input with zero device-side padding ops
        self.width = packed_width(ref_len)

    def __init__(
        self,
        n: int,
        ref_len: int,
        shipper=None,
        max_backlog: int | None = None,
    ):
        from phylonium_tpu.serve.client import devd_enabled

        # device-server transport (serve/): the daemon's warm resident
        # session replaces this process's jax session — this process
        # never opens the card
        self._devd = devd_enabled()
        if not self._devd:
            from phylonium_tpu.utils.platform import device_setup

            device_setup()
        self._init_shapes(n, ref_len)
        # early query shipper (core/query_ship.py): groups whose 2-bit
        # codes already shipped during the read/index phases need only
        # their interval records here
        self._shipper = shipper
        self._rows_done = 0
        self._chunks: list = []
        self._shipped = 0
        self._enqueued = 0
        self._closed = False
        self._gave_up = False
        self._error: BaseException | None = None
        self.devd_count_s = None  # daemon-side finish time (devd runs)
        # unbounded by default: groups are views into the host states
        # matrix (no copies), and a slow transfer must stall the worker
        # only — never the mapping loop behind a full queue.  The
        # low-memory pipeline passes ``max_backlog``: its groups are
        # RECONSTRUCTED copies, so a lagging device leg must give up
        # (host path owns the run) rather than accumulate the whole
        # panel in the queue.
        self._max_backlog = max_backlog
        self._q: queue.Queue = queue.Queue()
        self._run_id = (
            shipper.run_id
            if shipper is not None
            else f"feeder-{id(self):x}"
        )
        self._worker = threading.Thread(
            target=self._drain_devd if self._devd else self._drain,
            daemon=True,
            name="row-feeder",
        )
        self._worker.start()

    def _drain(self) -> None:
        import jax

        from phylonium_tpu.ops.pileup_device import (
            build_packed_rows_device,
        )

        # double-buffered: keep one group's transfer in flight while
        # syncing the previous one, so shipping group k+1 does not wait
        # behind the residency check of group k
        pending: list = []
        stopping = False
        while True:
            if len(pending) < 2 and not stopping:
                try:
                    item = self._q.get(block=not pending)
                    if item is None:
                        stopping = True
                    else:
                        lo, queries, homologies, pad_rows = item
                        try:
                            if self._error is None and not self._gave_up:
                                resident = (
                                    self._shipper.take(
                                        lo, lo + len(queries)
                                    )
                                    if self._shipper is not None
                                    else None
                                )
                                if not isinstance(resident, tuple):
                                    # a DevdGroup (daemon-resident) is
                                    # unreachable from the in-process
                                    # session; re-ship locally
                                    resident = None
                                chunk = build_packed_rows_device(
                                    queries, homologies, self.ref_len,
                                    self.l2, self.width,
                                    pad_rows=pad_rows,
                                    resident=resident,
                                )
                                self._chunks.append(chunk)
                                pending.append(chunk)
                        except BaseException as e:  # noqa: BLE001
                            self._error = e  # raised in finish()
                    self._q.task_done()
                    continue
                except queue.Empty:
                    pass
            if pending:
                if self._closed:
                    # finish() took over: stop syncing (its counting
                    # fetch forces residency anyway) but keep draining
                    # dispatches so q.join() completes
                    pending.clear()
                    continue
                # wait for real completion: it makes
                # ``shipped_fraction`` an honest signal for the
                # compare-time race decision
                chunk = pending.pop(0)
                try:
                    jax.block_until_ready(chunk)
                    self._shipped += 1
                except BaseException as e:  # noqa: BLE001
                    if self._error is None:
                        self._error = e
            elif stopping:
                return

    def _drain_devd(self) -> None:
        """Worker loop over the device-server transport: intervals (and
        packed codes, unless the query shipper already parked them in
        the daemon) cross a local socket; the daemon builds each chunk
        in its warm session and replies only after verifying residency
        — so the reply itself IS the shipped signal, and the per-group
        double buffering of the in-process path is unnecessary."""
        from phylonium_tpu.core.query_ship import DevdGroup
        from phylonium_tpu.ops.pileup_prep import (
            build_overlay,
            group_payload,
            prep_intervals,
        )

        import time

        debug = os.environ.get("PHYLONIUM_TPU_DEBUG")

        def trace(msg):
            if debug:
                import sys

                print(f"row feeder: {msg}", file=sys.stderr)

        try:
            from phylonium_tpu.serve.client import get_client

            client = get_client()
        except Exception as e:  # noqa: BLE001 — surfaced at finish()
            client = None
            if self._error is None:
                self._error = e
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                lo, queries, homologies, pad_rows = item
                if (
                    client is None
                    or self._error is not None
                    or self._gave_up
                ):
                    continue
                resident = (
                    self._shipper.take(lo, lo + len(queries))
                    if self._shipper is not None
                    else None
                )
                header = {
                    "op": "group",
                    "run": self._run_id,
                    # per-feeder generation: a -2 second pass reuses the
                    # run id (resident qgroups) but must reset the
                    # daemon's builder state (see daemon._handle 'group')
                    "gen": id(self),
                    "seq": lo,
                    "ref_len": self.ref_len,
                    "l2": self.l2,
                    "width": self.width,
                }
                from phylonium_tpu.ops.pileup_prep import (
                    _MAX_GROUP_BASES,
                )

                limit = _MAX_GROUP_BASES - 2 * self.ref_len - 1
                if sum(len(q) for q in queries) > limit:
                    raise ConfigError(
                        "device pileup group exceeds int32 indexing; "
                        "use smaller row groups"
                    )
                if isinstance(resident, DevdGroup):
                    header["gidx"] = resident.gidx
                    bases, seps = resident.bases, resident.seps
                    extra = []
                else:
                    packed, bases, seps = group_payload(queries)
                    extra = [packed]
                t0 = time.time()
                intervals = prep_intervals(
                    homologies, bases, self.ref_len, pad_rows
                )
                orow, ocol, oval = build_overlay(
                    intervals, queries, bases, seps, self.ref_len
                )
                t1 = time.time()
                client.request(
                    header, [intervals, orow, ocol, oval, *extra]
                )
                trace(
                    f"group @{lo} prep {t1 - t0:.2f}s "
                    f"request {time.time() - t1:.2f}s"
                )
                self._shipped += 1
            except BaseException as e:  # noqa: BLE001
                if self._error is None:
                    self._error = e  # raised in finish()
            finally:
                self._q.task_done()

    def shipped_fraction(self) -> float:
        """Fraction of enqueued groups verifiably resident on device."""
        return self._shipped / max(self._enqueued, 1)

    def wait_dispatched(self, timeout_s: float) -> bool:
        """Wait briefly for the worker queue to drain (typically just
        the tail group's interval prep + build dispatch).  Called
        BEFORE the compare race's host leg starts on warm device-server
        runs: the ~1 s of host-side prep left in the queue would
        otherwise stretch 3-4x under single-core contention with the
        host leg, inflating the device leg's observed tail."""
        import time

        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self._error is not None or self._gave_up:
                return False
            if self._q.unfinished_tasks == 0:
                return True
            time.sleep(0.02)
        return False

    def feed(self, queries: list, homologies: list) -> None:
        """Enqueue a mapped group: the next ``len(queries)`` genomes'
        byte arrays and their (filtered, disjoint) homologies, in
        order."""
        if self._gave_up:
            return
        if (
            self._max_backlog is not None
            and self._q.qsize() >= self._max_backlog
        ):
            # memory-bounded mode and the worker can't keep up: the
            # device leg is dead for this run (finish() raises; the
            # host path carries) — never stall mapping, never hoard
            self.cancel()
            return
        rows = len(queries)
        lo = self._rows_done
        self._rows_done += rows
        pad_rows = 0
        if self._rows_done >= self.n:
            # last group: pad straight to the kernel's row shape so the
            # device concat is exactly the one-shot packed array
            pad_rows = self.n_pad - self._rows_done
        self._enqueued += 1
        self._q.put((lo, queries, homologies, pad_rows))

    def finish(self, progress=None) -> tuple[np.ndarray, np.ndarray]:
        """Block until every group is shipped, then count on device
        through the one device entry point.

        The kernel import stays INSIDE the in-process branch: the devd
        transport never touches jax, and importing the kernel module
        pulls jax in (seconds of GIL-held CPU the host leg needs).
        """
        self._closed = True  # worker stops syncing; counting syncs all
        self._q.join()  # all groups dispatched (chunks list complete)
        self._q.put(None)  # worker exits
        if self._error is not None:
            raise self._error
        if self._gave_up:
            raise RuntimeError(
                "feeder gave up: shipping fell behind the mapping "
                "(bounded backlog full)"
            )
        if self._rows_done != self.n:
            raise RuntimeError(
                f"feeder got {self._rows_done} rows for {self.n} genomes"
            )
        if self._devd:
            import time

            from phylonium_tpu.serve.client import get_client

            t0 = time.time()
            reply, (subs, homs) = get_client().request(
                {
                    "op": "finish",
                    "run": self._run_id,
                    "n": self.n,
                }
            )
            if os.environ.get("PHYLONIUM_TPU_DEBUG"):
                import sys

                print(
                    f"row feeder: finish wire {time.time() - t0:.2f}s "
                    f"(daemon {reply.get('seconds')}s)",
                    file=sys.stderr,
                )
            # daemon-side count time (forces builds + kernels + fetch);
            # the carrier report separates it from client socket waits
            self.devd_count_s = reply.get("seconds")
            if progress is not None:
                progress(1.0)
            return subs, homs
        from phylonium_tpu.ops.device_counts import pair_counts_chunks

        result = pair_counts_chunks(
            self._chunks, self.n, packed=True
        )
        if progress is not None:
            progress(1.0)
        return result

    def cancel(self) -> None:
        """The compare went to the host: stop building/shipping the
        remaining groups (they would waste link bandwidth and CPU the
        host path needs) and let the worker drain out.

        Under ``PHYLONIUM_TPU_SHIP_DRAIN`` (a cold seeding run) the
        QUERY shipper stays alive: this run's compare went to the host,
        but the drain at exit still parks the whole panel in the device
        server so the NEXT run counts it — a backlog cancel (the lowmem
        pipeline's bounded queue filling behind a first-shape daemon
        compile) must not erase the seeding the run exists for."""
        self._gave_up = True
        self._closed = True
        if self._shipper is not None and not os.environ.get(
            "PHYLONIUM_TPU_SHIP_DRAIN"
        ):
            self._shipper.cancel()  # already-verified groups stay usable
        try:
            self._q.put(None)
        except Exception:
            pass


def prewarm_stream(
    n: int, ref_len: int, group_rows: int | None = None
) -> None:
    """Compile (and persist) the streamed pipeline's program family for
    a uniform (n, ref_len) panel: the fused build-and-pack program per
    group layout and the chunk concat.  Abstract-shape lowering only —
    no data, no transfers."""
    import jax
    import jax.numpy as jnp

    from phylonium_tpu.ops.device_counts import concat_pad
    from phylonium_tpu.ops.pileup_device import _bucket, _build_packed
    from phylonium_tpu.ops.shapes import _PACKED_PAD

    if group_rows is None:
        group_rows = effective_group_rows(n)
    probe = DeviceRowFeeder.__new__(DeviceRowFeeder)
    DeviceRowFeeder._init_shapes(probe, n, ref_len)

    # chunk row counts exactly as the feeder will produce them: full
    # groups, a tail group, and row padding on the last
    reals = [group_rows] * (n // group_rows)
    if n % group_rows:
        reals.append(n % group_rows)
    counts = list(reals)
    counts[-1] += probe.n_pad - n
    u8 = jnp.uint8
    ref_pad = _bucket(ref_len)
    for real, rows in dict.fromkeys(zip(reals, counts)):
        # a padded last group ships fewer real genomes than its rows
        bases = real * ref_len
        packed = jax.ShapeDtypeStruct(
            (_bucket(-(-bases // 4)) // 4,), jnp.uint32
        )
        ivals = jax.ShapeDtypeStruct(
            (rows, _bucket(1, lo=16), 4), jnp.int64
        )
        ob = _bucket(0, lo=16)
        orow = jax.ShapeDtypeStruct((ob,), jnp.int32)
        ocol = jax.ShapeDtypeStruct((ob,), jnp.int32)
        oval = jax.ShapeDtypeStruct((ob,), u8)
        _build_packed.lower(
            packed, ivals, orow, ocol, oval,
            ref_pad, probe.l2, probe.width,
        ).compile()

    chunk_layout = tuple(
        jax.ShapeDtypeStruct((c, probe.width), u8) for c in counts
    )
    concat_pad.lower(
        chunk_layout, probe.n_pad, probe.width, _PACKED_PAD
    ).compile()


def prewarm_panel(
    n: int, ref_len: int, group_rows: int | None = None
) -> None:
    """Compile the full streamed program family for an (n, ref_len)
    panel: the counting program at its exact shape plus the build and
    concat programs (:func:`prewarm_stream`).  Used by the device
    server's 'prewarm' op; in-process callers go through
    core/pipeline.prewarm_counts (which owns the cfg gating).
    ``group_rows`` pins the feeding-group layout when the run's groups
    are not the default size (the low-memory pipeline sizes them from
    its RSS budget) — the build programs are shape-per-layout."""
    from phylonium_tpu.ops.device_counts import prewarm

    prewarm(n, ref_len, packed=True)
    prewarm_stream(n, ref_len, group_rows=group_rows)


def map_pileup_streamed(
    ref: ESAIndex,
    threshold: int,
    queries: list,
    cfg: RunConfig,
    feeder: DeviceRowFeeder,
    group_rows: int | None = None,
) -> tuple[list[list[Homology]], np.ndarray]:
    """Map queries in row groups, building + feeding pileup rows as each
    group completes.  Returns (homologies, full host states matrix) —
    the host matrix backs the compare race and the coverage statistics.
    """
    from phylonium_tpu.core.map_native import map_batch_native
    from phylonium_tpu.native import build_pileup_native
    from phylonium_tpu.utils.bigalloc import empty as big_empty
    from phylonium_tpu.utils.progress import ProgressBar

    if group_rows is None:
        group_rows = effective_group_rows(len(queries))
    n = len(queries)
    ref_len = len(ref.subject)
    states = big_empty((n, ref_len), np.uint8)
    homologies: list[list[Homology]] = [None] * n  # type: ignore

    bar = ProgressBar(
        f"Mapping {n} sequences", n, enabled=cfg.progress_enabled
    )
    for lo in range(0, n, group_rows):
        hi = min(lo + group_rows, n)
        batch = [queries[j].as_array() for j in range(lo, hi)]
        out = map_batch_native(ref._native, batch, threshold, bar, lo)
        homologies[lo:hi] = out
        # host rows back the compare race's host leg; the feeder
        # ships the same group as 2-bit queries + intervals
        build_pileup_native(batch, out, ref_len, out=states[lo:hi])
        feeder.feed(batch, out)
        bar.update(hi)
    bar.finish()
    return homologies, states
