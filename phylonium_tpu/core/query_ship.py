"""Early query shipping: upload 2-bit genome codes during READ/index.

The streamed pipeline (core/stream.py) overlaps host->device shipping
with the mapping phase, but its feeder only starts once the first row
group has MAPPED — the read and index phases (seconds on large panels)
were dead time on the link.  Where the link limits device counting,
those seconds decide whether the device or the host carries the
compare.

This module ships each row group's 2-bit-packed query codes + contig
separators the moment the group finishes READING — before the reference
is even chosen (the codes are reference-independent; only the tiny
interval records depend on the mapping).  By feed time the feeder finds
the group resident (``take()``) and ships only intervals, so
``shipped_fraction`` reflects work the link did during read+index+map,
and the compare-time race starts with the panel already on the device.

Every verified group transfer records measured bandwidth into
utils/calibration.py, which future runs' gates read back.

Groups use the SAME row boundaries and the SAME pack+pad helper
(ops/pileup_device.padded_pack) as the feeder, so a resident group is
bit-identical to one packed at feed time (asserted in
tests/test_stream.py).

Reference contrast: the reference has no device and reads everything
before processing (`src/phylonium.cxx:272-287`); this overlap exists
because an accelerator adds a link to hide.
"""

from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np

# '!' contig separator byte (data/sequence.join; unrepresentable in the
# 2-bit packing, carried as the sparse overlay)
_SEP_BYTE_ = ord("!")


def early_ship_eligible(cfg, file_names: list[str]) -> bool:
    """Should the CLI start shipping query codes DURING the read phase?

    Mirrors core/pipeline._should_stream's structural conditions (the
    ones knowable before reading), then predicts from MEASURED link
    bandwidth + actual file sizes whether the streamed device compare
    is worth spending link bandwidth and CPU on.  Without a
    link measurement yet, falls back to the static work threshold.
    ``PHYLONIUM_TPU_STREAM=force`` engages unconditionally (tests).
    """
    env = os.environ.get("PHYLONIUM_TPU_STREAM", "")
    if env == "0":
        return False
    if cfg.count_backend != "auto" or cfg.mesh:
        return False
    if cfg.complete_deletion or cfg.print_positions or cfg.checkpoint_dir:
        return False
    if cfg.map_backend not in ("auto", "native"):
        return False
    if cfg.esa_backend not in (None, "auto", "native"):
        return False
    from phylonium_tpu.core.pipeline import _is_multiprocess

    if _is_multiprocess():
        return False
    from phylonium_tpu.utils.platform import cpu_pinned

    if env == "force":
        return True
    if cpu_pinned():
        return False
    from phylonium_tpu.core.stream import effective_group_rows

    n = len(file_names)
    if n <= effective_group_rows(n):
        return False
    try:
        total_bytes = sum(os.path.getsize(f) for f in file_names)
    except OSError:
        return False
    # FASTA is ~1.02 bytes per base (headers + newlines); the estimate
    # only feeds a dispatch prediction, not any exact shape
    est_ref_len = int(total_bytes / max(n, 1) * 0.98)
    from phylonium_tpu.core.pipeline import (
        _auto_prefers_host,
        _stream_predicts_win,
    )

    win = _stream_predicts_win(n, est_ref_len, cfg)
    if win is not None:
        return win
    return not _auto_prefers_host(n, est_ref_len, cfg)


_link_warmed = False


def warm_link() -> None:
    """One small verified transfer, so the backend's first-transfer
    set-up is not charged to (or timed as) the first real group.
    Idempotent; safe to call from any device-bound thread."""
    global _link_warmed
    if _link_warmed:
        return
    try:
        import jax

        rng = np.random.default_rng(0)
        d = jax.device_put(rng.integers(0, 256, 1 << 20).astype(np.uint8))
        jax.block_until_ready(d)
        _link_warmed = True
    except Exception:
        pass  # best-effort; the first group then pays the warmup


def _payload_from_compacted(seqs):
    """(packed32, bases, seps, key) for a group of COMPACTED Sequences.

    Each genome's existing 2-bit pack is reused verbatim, 4-base-aligned
    in the concatenation (``bases[k+1] = bases[k] + 4*len(pack_k)``) so
    no repacking happens and no raw bytes are pinned; the alignment gap
    codes are zeros that no covered column ever indexes.  Groups are
    self-contained, so this layout coexists freely with the raw-bytes
    layout of uncompacted groups.  The content key hashes the packs
    (4x less data than raw) under a distinct domain prefix.
    """
    import hashlib

    from phylonium_tpu.ops.pileup_prep import _bucket

    h = hashlib.blake2b(digest_size=16)
    h.update(b"packed4\0")
    bases = np.zeros(len(seqs) + 1, np.int64)
    parts, seps_parts = [], []
    for k, s in enumerate(seqs):
        p = s._packed
        h.update(len(s).to_bytes(8, "little"))
        h.update(p)
        parts.append(p)
        if len(s._seps):
            seps_parts.append(s._seps + bases[k])
        bases[k + 1] = bases[k] + 4 * len(p)
    packed = (
        np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    )
    packed = np.pad(packed, (0, _bucket(len(packed)) - len(packed)))
    seps = (
        np.concatenate(seps_parts).astype(np.int64)
        if seps_parts
        else np.zeros(0, np.int64)
    )
    return packed.view(np.uint32), bases, seps, h.hexdigest()


class DevdGroup:
    """A group resident in the DEVICE SERVER's session (serve/): the
    feeder references it by index; ``bases`` and the raw separator
    positions (for the sparse overlay) stay host-side."""

    __slots__ = ("gidx", "bases", "seps")

    def __init__(self, gidx: int, bases: np.ndarray, seps: np.ndarray):
        self.gidx = gidx
        self.bases = bases
        self.seps = seps


class QueryShipper:
    """Ships 2-bit query-code groups to the device as reads complete.

    ``add(arr)`` is called once per genome in final query order (the
    CLI's read loop); every ``group_rows`` genomes — the streamed
    feeder's row-group size — the worker packs the group (native 2-bit
    pass), uploads it, and sync-verifies residency.  ``take(lo, hi)``
    hands a verified group to the feeder, or None (group still in
    flight, failed, or boundary mismatch) — the feeder then ships that
    group itself, bit-identically.

    Transport: the device server (serve/client.py) when enabled — the
    warm resident session makes shipping start immediately instead of
    behind this process's backend start-up — otherwise the in-process
    jax session.  ``take`` returns a
    (packed, sep, bases) device triple for the in-process transport, a
    :class:`DevdGroup` reference for the daemon one.
    """

    def __init__(self, n: int, group_rows: int | None = None):
        from phylonium_tpu.core.stream import effective_group_rows

        if group_rows is None:
            group_rows = effective_group_rows(n)
        self.n = n
        self.group_rows = group_rows
        self.run_id = f"{os.getpid()}-{id(self):x}"
        self.transport = "local"  # set to 'devd' by the worker
        self._pending: list[np.ndarray] = []
        self._added = 0
        self._groups: dict[int, tuple] = {}  # gidx -> (packed, sep, bases)
        self._verified: set[int] = set()
        self._enqueued = 0
        self._bytes = 0
        self._seconds = 0.0
        self._hits = 0  # daemon content-cache hits (0 bytes shipped)
        self._cancelled = False
        # set once the worker chose its transport (or gave up)
        self.ready = threading.Event()
        self._t0 = time.time()
        self._q: queue.Queue = queue.Queue()
        self._worker = threading.Thread(
            target=self._drain, daemon=True, name="query-shipper"
        )
        self._worker.start()

    def add(self, arr: np.ndarray) -> None:
        """One genome's byte array, in query order (no copy kept beyond
        the group boundary)."""
        self._push(arr)

    def add_seq(self, seq) -> None:
        """One COMPACTED Sequence (low-memory mode): the group payload
        is assembled zero-copy from the per-genome 2-bit packs (each
        genome 4-base-aligned in the concatenation), so the queue never
        pins raw byte views — the exact backlog that blew the RSS bound
        when raw views waited behind a contended pack worker."""
        self._push(seq)

    def _push(self, item) -> None:
        if self._cancelled:
            return
        self._pending.append(item)
        self._added += 1
        if len(self._pending) == self.group_rows or self._added == self.n:
            gidx = (self._added - 1) // self.group_rows
            self._enqueued += 1
            self._q.put((gidx, self._pending))
            self._pending = []

    def _drain(self) -> None:
        from phylonium_tpu.utils import calibration
        from phylonium_tpu.utils.platform import device_setup

        debug = os.environ.get("PHYLONIUM_TPU_DEBUG")

        def trace(msg):
            if debug:
                import sys

                print(
                    f"query shipper [+{time.time() - self._t0:.2f}s]: "
                    f"{msg}",
                    file=sys.stderr,
                )

        client = None
        from phylonium_tpu.serve.client import devd_enabled

        if devd_enabled():
            # the server owns the card: never fall back to opening it
            # in this process
            try:
                from phylonium_tpu.serve.client import get_client

                client = get_client()
                self.transport = "devd"
                trace("device server connected")
            except Exception as e:  # noqa: BLE001
                trace(f"device server unavailable ({e!r}); cancelled")
                self._cancelled = True
                self.ready.set()
                return
        if client is None:
            try:
                device_setup()  # device chokepoint (idempotent)
                import jax

                trace("jax imported")
                warm_link()
                trace("link warmed")
            except Exception:
                self._cancelled = True
                self.ready.set()
                return
        self.ready.set()
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._cancelled:
                    continue
                gidx, items = item
                from phylonium_tpu.ops.pileup_prep import group_payload

                t_pack = time.time()
                packed = None
                if items and not isinstance(items[0], np.ndarray):
                    # compacted Sequences (low-memory mode): zero-copy
                    # payload from the per-genome 2-bit packs
                    packed, bases, seps, key = _payload_from_compacted(
                        items
                    )
                elif client is not None:
                    # content key over the RAW group bytes: a daemon
                    # cache hit (re-run of a panel, -2 second pass,
                    # bootstrap sweep) skips the pack AND the ship —
                    # hashing is ~10x cheaper than packing
                    import hashlib

                    h = hashlib.blake2b(digest_size=16)
                    bases = np.zeros(len(items) + 1, np.int64)
                    seps_parts = []
                    for k, a in enumerate(items):
                        h.update(len(a).to_bytes(8, "little"))
                        h.update(a)
                        sp = np.flatnonzero(a == _SEP_BYTE_)
                        if len(sp):
                            seps_parts.append(sp + bases[k])
                        bases[k + 1] = bases[k] + len(a)
                    key = h.hexdigest()
                    seps = (
                        np.concatenate(seps_parts).astype(np.int64)
                        if seps_parts
                        else np.zeros(0, np.int64)
                    )
                else:
                    packed, bases, seps = group_payload(items)
                    key = None
                if client is not None:
                    reply, _ = client.request(
                        {
                            "op": "qhave",
                            "run": self.run_id,
                            "gidx": gidx,
                            "key": key,
                        }
                    )
                    if reply.get("have"):
                        self._groups[gidx] = DevdGroup(gidx, bases, seps)
                        self._verified.add(gidx)
                        self._hits += 1
                        trace(f"group {gidx} cache hit (0 bytes)")
                        continue
                    if packed is None:
                        packed, _b2, _s2 = group_payload(items)
                    nbytes = packed.nbytes
                    t0 = time.time()
                    # the daemon replies only after the transfer is
                    # resident; its reported seconds are the pure device
                    # leg (socket copy excluded from the link figure)
                    reply, _ = client.request(
                        {
                            "op": "qgroup",
                            "run": self.run_id,
                            "gidx": gidx,
                            "key": key,
                        },
                        [packed],
                    )
                    dt = float(reply.get("seconds") or time.time() - t0)
                    self._groups[gidx] = DevdGroup(gidx, bases, seps)
                else:
                    nbytes = packed.nbytes
                    t0 = time.time()
                    pd = jax.device_put(packed)
                    jax.block_until_ready(pd)
                    dt = time.time() - t0
                    self._groups[gidx] = (pd, bases, seps)
                trace(
                    f"group {gidx} pack {t0 - t_pack:.2f}s ship "
                    f"{nbytes / 1e6:.1f} MB in {dt:.2f}s"
                )
                calibration.record_link(nbytes, dt)
                self._verified.add(gidx)
                self._bytes += nbytes
                self._seconds += dt
            except BaseException as e:  # noqa: BLE001 — best-effort
                # any failure (out of memory, compile error) simply
                # reverts the run to feed-time shipping; never raises
                # into the read loop
                if os.environ.get("PHYLONIUM_TPU_DEBUG"):
                    import sys
                    import traceback

                    print(
                        f"query shipper: giving up ({e!r})",
                        file=sys.stderr,
                    )
                    traceback.print_exc()
                self._cancelled = True
            finally:
                self._q.task_done()

    def take(self, lo: int, hi: int):
        """The resident (packed, sep, bases) triple for rows [lo, hi),
        or None when this exact group cannot be verifiably on device.

        An ENQUEUED group still in flight is waited for (on the feeder's
        worker thread — whose job is to wait for shipping anyway):
        re-shipping it at feed time would send the same bytes twice."""
        if lo % self.group_rows:
            return None
        gidx = lo // self.group_rows
        if hi != min(lo + self.group_rows, self.n):
            return None
        while (
            gidx not in self._verified
            and gidx < self._enqueued
            and not self._cancelled
        ):
            time.sleep(0.05)
        if gidx not in self._verified:
            return None
        return self._groups.get(gidx)

    def shipped_groups(self) -> int:
        return len(self._verified)

    def shipped_bytes(self) -> int:
        return self._bytes

    def achieved_mb_s(self) -> float | None:
        """This run's verified transfer rate (None before any group)."""
        if not self._bytes or self._seconds <= 0:
            return None
        return self._bytes / 1e6 / self._seconds

    def drain(self, timeout_s: float) -> bool:
        """Block until every enqueued group is verified on the device,
        the shipper gives up, or the deadline passes; returns whether
        the whole panel made it.

        This is the cold-run seeding hook (PHYLONIUM_TPU_SHIP_DRAIN):
        normally a run exits the moment the host leg wins the compare
        race, killing this daemon thread mid-queue — so on a slow link
        the device server's content cache fills only a couple of groups
        per run.  A drained run stays alive until the whole
        panel is parked in the daemon, making the NEXT run of the same
        panel ship 0 bytes (content keys are run-independent)."""
        stall_s = float(
            os.environ.get("PHYLONIUM_TPU_SHIP_DRAIN_STALL", 90.0)
        )
        deadline = time.time() + timeout_s
        last_progress = time.time()
        last_done = len(self._verified)
        while time.time() < deadline and not self._cancelled:
            if not self._pending and len(self._verified) >= self._enqueued:
                return True
            done = len(self._verified)
            if done != last_done:
                last_done, last_progress = done, time.time()
            elif time.time() - last_progress > stall_s:
                # no group verified for stall_s.  A daemon this run
                # spawned may simply still be paying its once-per-
                # lifetime warmup — that is exactly what a seeding run
                # should wait out, so the stall clock only counts
                # against a daemon that REPORTS warm; an unreachable or
                # warm-but-stuck daemon seeds nothing in the rest of
                # the timeout.
                still_warming = False
                if self.transport == "devd":
                    # an in-flight request on the shared client (a
                    # race-abandoned finish still compiling, or this
                    # shipper's own qgroup) means the daemon is busy
                    # with OUR work — progress, not a stall
                    import phylonium_tpu.serve.client as _cl

                    if _cl._client is not None and _cl._client.inflight:
                        still_warming = True
                    else:
                        try:
                            # own connection: the shared client's
                            # socket is serialized behind the very
                            # request that is waiting out the warmup
                            from phylonium_tpu.serve.client import (
                                DevdClient,
                            )

                            probe = DevdClient(spawn=False)
                            try:
                                still_warming = not probe.ping(
                                    timeout=10.0
                                ).get("warm")
                            finally:
                                probe.close()
                        except Exception:  # noqa: BLE001
                            still_warming = False
                if not still_warming:
                    return False
                last_progress = time.time()  # warmup in progress: wait
            time.sleep(0.25)
        return not self._pending and len(self._verified) >= self._enqueued

    def cancel(self) -> None:
        """Stop packing/shipping (the run went elsewhere: host-only
        dispatch, mesh handoff, or a non-streamable flag combination)."""
        self._cancelled = True
        self._q.put(None)
