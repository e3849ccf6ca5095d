"""Hybrid mapping: host chain state machine + device anchor extension.

Build-plan stage 4 (SURVEY.md §7): the per-byte work of the mapping
phase — lucky-anchor LCP extension (`src/process.cxx:227-242`, ``lcp()``
`src/process.cxx:171-184`) — runs on the device via
:func:`phylonium_tpu.ops.anchor_extend.diagonal_neq`, while the cheap,
irregular chaining decisions stay on host.

Key amortization: along one diagonal, the mismatch *positions* determine
every lucky-anchor run length the chain will ever evaluate there
(each successful step ends exactly at a mismatch and resumes one byte
after it).  So the host fetches one mismatch bitmap per
(query, diagonal, chunk) — not per anchor — and *replays* the chain with
vectorized run consumption.  Device round trips are batched across all
queries in lockstep rounds.  ESA anchor queries at homology breaks
(`src/process.cxx:219-225`) remain host-side (native C++ index).

Exactness: produces homology lists bit-identical to the Python oracle
(core/anchors.py) and the native C++ backend — asserted in
tests/test_hybrid_map.py.

Deployment note: with a strong host (many cores) or a high-latency
host<->device link, the pure-host native backend wins the mapping phase;
the hybrid path wins when host compute is scarce relative to the device.
Select with ``--map-backend``.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu.config import ConfigError
from phylonium_tpu.core.homology import Homology
from phylonium_tpu.index.esa import ESAIndex

# query-positions fetched per (query, diagonal) device request
DEFAULT_CHUNK = 1 << 19
_TILE = 2048


class _NeedBitmap(Exception):
    """Raised inside a machine when it blocks on diagonal data."""


class _Machine:
    """Chain state machine for one query (exact oracle semantics)."""

    __slots__ = (
        "ref", "q", "qlen", "threshold", "border", "SA", "hv",
        "prev_q", "prev_s", "prev_len", "merged",
        "cursor", "open_seg", "diag", "mm", "fs", "fe",
        "request", "done",
    )

    def __init__(self, ref: ESAIndex, q: np.ndarray, threshold: int):
        self.ref = ref
        self.q = q
        self.qlen = len(q)
        self.threshold = threshold
        self.border = ref.size // 2
        self.SA = ref.SA
        self.hv: list[Homology] = []
        self.prev_q = 0
        self.prev_s = 0
        self.prev_len = 0
        self.merged = False
        self.cursor = 0
        self.open_seg = Homology.at(0, 0)
        # cached mismatch positions for one diagonal, covering [fs, fe)
        self.diag: int | None = None
        self.mm: np.ndarray | None = None
        self.fs = 0
        self.fe = 0
        self.request: tuple[int, int] | None = None
        self.done = False

    # -- diagonal bitmap cache ------------------------------------------

    def _next_mm(self, d: int, p: int) -> int:
        """First mismatch position >= p on diagonal d (query coords)."""
        if self.diag != d or p < self.fs or p >= self.fe:
            self.request = (d, p)
            raise _NeedBitmap
        i = int(np.searchsorted(self.mm, p))
        if i == len(self.mm):
            # run extends past coverage; extend it (fe <= qlen here:
            # covered fetches always mark position qlen as a mismatch)
            self.request = (d, self.fe)
            raise _NeedBitmap
        return int(self.mm[i])

    def feed(self, row: np.ndarray) -> None:
        d, start = self.request
        mm = (start + np.flatnonzero(row)).astype(np.int64)
        if d == self.diag and start == self.fe:
            self.mm = np.concatenate([self.mm, mm])
        else:
            self.diag = d
            self.mm = mm
            self.fs = start
        self.fe = start + len(row)
        self.request = None

    # -- chain events (oracle semantics, src/process.cxx:245-295) -------

    def _accept_seed(self, seed_s: int, seed_len: int) -> None:
        end_S = self.prev_s + self.prev_len
        end_Q = self.prev_q + self.prev_len
        if (
            seed_s > end_S
            and self.cursor - end_Q == seed_s - end_S
            and (seed_s < self.border) == (self.prev_s < self.border)
        ):
            self.open_seg.extend(self.cursor - end_Q + seed_len)
            self.merged = True
        else:
            if self.merged or self.prev_len // 2 >= self.threshold:
                self.open_seg.reverse_eh(self.border)
                self.hv.append(self.open_seg)
            self.open_seg = Homology.at(
                seed_s, self.cursor, seed_len
            )
            self.merged = False
        self.prev_q = self.cursor
        self.prev_s = seed_s
        self.prev_len = seed_len

    def _probe_diagonal(self):
        """Lucky anchor via the diagonal bitmap; None = failed/inapplicable."""
        advance = self.cursor - self.prev_q
        gap = advance - self.prev_len
        diag_s = self.prev_s + advance
        if diag_s >= self.ref.size or gap > self.threshold:
            return None
        d = self.prev_s - self.prev_q
        nm = self._next_mm(d, self.cursor)
        seed_len = nm - self.cursor
        if seed_len >= self.threshold:
            return diag_s, seed_len
        return None

    def _consume_runs(self) -> None:
        """Batch-apply consecutive lucky successes along the diagonal.

        After any success, the next probe is at ``last end + 1`` with
        gap 1; its LCP is the gap to the next mismatch.  All such steps
        until the first sub-threshold run are right anchors (except a
        single possible '#'-border crossing, handled as the left anchor
        it is) — applied here without per-step Python/device work.
        """
        thr = self.threshold
        while True:
            p0 = self.cursor
            if p0 >= self.qlen:
                return
            d = self.prev_s - self.prev_q
            if d + p0 >= self.ref.size:
                return
            self._next_mm(d, p0)  # ensure coverage (may raise)
            i0 = int(np.searchsorted(self.mm, p0))
            M = self.mm[i0:]
            if len(M) == 0:
                return  # re-handled via _next_mm on the next diagonal probe
            p_arr = np.empty(len(M), np.int64)
            p_arr[0] = p0
            p_arr[1:] = M[:-1] + 1
            runs = M - p_arr
            ok = (
                (runs >= thr)
                & (d + p_arr < self.ref.size)
                & (p_arr < self.qlen)
            )
            n_ok = int(np.argmin(ok)) if not ok.all() else len(ok)
            if n_ok == 0:
                return
            # '#'-border crossing: s-positions increase, so the side
            # flips at most once; steps before the flip are right
            # anchors, the flip step is a left anchor.
            side0 = self.prev_s < self.border
            sides = (d + p_arr[:n_ok]) < self.border
            flip = (
                int(np.argmax(sides != side0))
                if bool((sides != side0).any())
                else n_ok
            )
            b = min(n_ok, flip) if flip > 0 else 0
            if b > 0:
                # right-anchor batch [0, b)
                end_Q = self.prev_q + self.prev_len
                self.open_seg.extend(int(M[b - 1]) - end_Q)
                self.merged = True
                self.prev_q = int(p_arr[b - 1])
                self.prev_s = d + int(p_arr[b - 1])
                self.prev_len = int(runs[b - 1])
                self.cursor = int(M[b - 1]) + 1
            if b < n_ok:
                # the border-crossing step: left anchor
                self.cursor = int(p_arr[b])
                self._accept_seed(d + int(p_arr[b]), int(runs[b]))
                self.cursor += int(runs[b]) + 1
            elif b < len(ok):
                return  # next step's run is sub-threshold -> slow path
            # else: coverage exhausted; loop refetches via _next_mm

    def _finish(self) -> None:
        if self.prev_len >= self.qlen:
            # identical-sequence special case (src/process.cxx:284-287)
            self.open_seg = Homology.at(self.prev_s, 0, self.qlen)
        if self.merged or self.prev_len // 2 >= self.threshold:
            self.open_seg.reverse_eh(self.border)
            self.hv.append(self.open_seg)

    def run(self) -> bool:
        """Advance until finished (True) or blocked on a bitmap (False)."""
        if self.done:
            return True
        try:
            while self.cursor < self.qlen:
                res = self._probe_diagonal()
                if res is not None:
                    ts, tl = res
                    self._accept_seed(ts, tl)
                    self.cursor += tl + 1
                    self._consume_runs()
                else:
                    l, i, j = self.ref.longest_match(
                        self.q, self.cursor, self.qlen - self.cursor
                    )
                    tl = max(l, 0)
                    if i == j and tl >= self.threshold:
                        self._accept_seed(int(self.SA[i]), tl)
                        self.cursor += tl + 1
                        self._consume_runs()
                    else:
                        self.cursor += tl + 1
            self._finish()
            self.done = True
            return True
        except _NeedBitmap:
            return False


def hybrid_map_queries(
    ref: ESAIndex,
    threshold: int,
    queries: list[np.ndarray],
    chunk: int = DEFAULT_CHUNK,
    progress=None,
) -> list[list[Homology]]:
    """Map every query; device round trips batched across queries.

    Returns raw (unsorted, unfiltered) homology lists per query, like
    core/anchors.anchor_homologies.
    """
    from phylonium_tpu.utils.platform import device_setup

    device_setup()  # device chokepoint (idempotent)
    import jax.numpy as jnp

    from phylonium_tpu.ops.anchor_extend import diagonal_neq, pad_text

    # device offsets are int32: guard the index text and chunk the query
    # batch so concatenated bases stay addressable (same bound the
    # device pileup builder enforces via _MAX_GROUP_BASES)
    # headroom covers the furthest lane a bitmap fetch can address:
    # a request at the guard boundary still advances by up to `chunk`
    # rounds plus a tile before the past-limit masks take over
    max_i32 = (1 << 31) - 1 - chunk - _TILE
    if ref.size > max_i32:
        raise ConfigError(
            "hybrid map backend addresses the index with int32 offsets; "
            f"reference of {ref.size} bases needs the native backend"
        )
    if queries and max(len(q) for q in queries) > max_i32:
        # a single query beyond int32 cannot be offset-addressed at all
        raise ConfigError(
            "hybrid map backend addresses queries with int32 offsets; "
            f"a {max(len(q) for q in queries)}-base query needs the "
            "native backend"
        )
    total = sum(len(q) for q in queries)
    if total > max_i32:
        out: list[list[Homology]] = []
        done = 0

        def group_progress(d, base):
            if progress is not None:
                progress(base + d)

        group: list[np.ndarray] = []
        group_bases = 0
        for q in queries:
            if group and group_bases + len(q) > max_i32:
                base = done
                out.extend(
                    hybrid_map_queries(
                        ref, threshold, group, chunk,
                        progress=lambda d, b=base: group_progress(d, b),
                    )
                )
                done += len(group)
                group, group_bases = [], 0
            group.append(q)
            group_bases += len(q)
        if group:
            base = done
            out.extend(
                hybrid_map_queries(
                    ref, threshold, group, chunk,
                    progress=lambda d, b=base: group_progress(d, b),
                )
            )
        return out

    # PHYLONIUM_TPU_SHARDED_EXTEND=1 splits the doubled index text
    # across every device of a 1-D mesh (ops/anchor_extend_sharded):
    # the beyond-HBM index capability, reachable through the CLI via
    # --map-backend hybrid.  Bit-identical to the single-device op.
    import os

    shard_mesh = None
    if os.environ.get("PHYLONIUM_TPU_SHARDED_EXTEND") == "1":
        import jax

        from phylonium_tpu.ops.anchor_extend_sharded import shard_text

        devices = jax.devices()
        if len(devices) > 1:
            shard_mesh = jax.sharding.Mesh(np.array(devices), ("x",))
            s_shards = shard_text(
                pad_text(ref.S, "a", _TILE), len(devices), _TILE
            )
    if shard_mesh is None:
        s_dev = jnp.asarray(pad_text(ref.S, "a", _TILE))
    lengths = [len(q) for q in queries]
    bases = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    qcat = (
        np.concatenate(queries)
        if queries
        else np.zeros(0, np.uint8)
    )
    q_dev = jnp.asarray(pad_text(qcat, "b", _TILE))

    machines = [_Machine(ref, q, threshold) for q in queries]
    nq = len(machines)
    active = list(range(nq))
    while active:
        blocked = [k for k in active if not machines[k].run()]
        if progress is not None:
            progress(nq - len(blocked))
        if not blocked:
            break
        # fixed-size batch (pad with repeats) so the jitted bitmap op
        # compiles once per (chunk, batch) shape
        # pad the request batch to a power-of-two bucket so the jitted
        # bitmap op's shape does not vary per run/panel size (remote
        # compiles are minutes; CLAUDE.md: never add per-run-varying
        # static shapes)
        bucket = 1 << max(3, (len(blocked) - 1).bit_length())
        batch = blocked + [blocked[-1]] * (bucket - len(blocked))
        off_a = np.array(
            [machines[k].request[0] + machines[k].request[1] for k in batch],
            np.int32,
        )
        off_b = np.array(
            [bases[k] + machines[k].request[1] for k in batch], np.int32
        )
        lim_b = np.array([bases[k] + lengths[k] for k in batch], np.int32)
        if shard_mesh is not None:
            from phylonium_tpu.ops.anchor_extend_sharded import (
                diagonal_neq_sharded,
            )

            rows = diagonal_neq_sharded(
                s_shards, q_dev, off_a, off_b,
                np.int32(ref.size), lim_b, chunk, shard_mesh, _TILE,
            )
        else:
            rows = diagonal_neq(
                s_dev, q_dev, off_a, off_b, ref.size, lim_b, chunk,
                tile=_TILE,
            )
        for slot, k in enumerate(blocked):
            machines[k].feed(rows[slot])
        active = blocked
    return [m.hv for m in machines]
