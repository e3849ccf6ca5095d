"""Streamed map → pileup → resident-shard pipeline for multi-process runs.

The serial multi-process path maps queries round-robin, exchanges every
homology list, builds the FULL [N, L] pileup on every process, and only
then ships each device its shard (parallel/distributed.py).  With one
process per device that serializes the panel shipment behind the
mapping phase and costs every host the whole panel in RAM, where the
reference's OpenMP compare loop (`src/process.cxx:524-549`) has no such
wall.

This module overlaps them: process ``p`` owns the CONTIGUOUS genome
block its device will hold under the ``('rows','cols')`` sharding, maps
it group by group, builds + ships each group's pileup rows to its local
device while the next group maps, and the compare runs the exact same
collective program (`distributed._sharded_counts`) on the already
resident shards — no exchange, no full-panel host build, no post-mapping
shipment.  Per-process host memory peaks at one row GROUP, not N*L.

Bit-exactness: the feeder-built shards equal `pack_states` of the host
pileup (tests/test_stream.py), the collective is exact-integer for any
mesh (tests/test_parallel.py), and the full CLI across 8 real processes
is byte-compared in tests/test_multiprocess.py.

Engaged by `core/pipeline._should_stream_mp`: multi-process runs with
one local device per process, plain 'auto' backends,
and no feature that needs the whole homology set before the pileup.
Multi-process runs keep collective discipline: any feeder error raises
(a lone process falling back to the host would desync its peers), the
same contract as the serial `_pair_counts_mesh` path.
"""

from __future__ import annotations

import os
import queue
import sys
import threading

import numpy as np

from phylonium_tpu.config import RunConfig
from phylonium_tpu.core.stream import DEFAULT_GROUP_ROWS
from phylonium_tpu.index.esa import ESAIndex


class PodShardFeeder:
    """Ships one process's pileup row groups to its local device.

    The shard geometry (`distributed.sharded_shape`) is the one the
    collective counting program expects, so ``finish()`` can assemble
    the global array directly from the fed chunks via
    ``jax.make_array_from_single_device_arrays``.
    """

    def __init__(self, n: int, ref_len: int, mesh):
        import jax

        from phylonium_tpu.parallel.distributed import sharded_shape
        from phylonium_tpu.utils.platform import device_setup

        device_setup()
        self.n = n
        self.ref_len = ref_len
        self.mesh = mesh
        self.n_rows = mesh.shape["rows"]
        self.n_cols = mesh.shape["cols"]
        self.plen, self.n_pad, self.l_pad = sharded_shape(
            n, ref_len, self.n_rows, self.n_cols, True
        )
        self.rows_per_block = self.n_pad // self.n_rows
        pid = jax.process_index()
        self.row_lo = pid * self.rows_per_block
        self.row_hi = min(self.row_lo + self.rows_per_block, n)
        self._rows_fed = 0
        self._chunks: list = []
        self._error: BaseException | None = None
        self._q: queue.Queue = queue.Queue()
        self._worker = threading.Thread(
            target=self._drain, daemon=True, name="pod-feeder"
        )
        self._worker.start()

    # -- shipping ---------------------------------------------------------

    def _ship(self, queries: list, homologies: list, pad_rows: int):
        """Build + place one group's rows on the local device: 2-bit
        queries + intervals, fused on-device build in the split-nibble
        layout (ops/pileup_device)."""
        from phylonium_tpu.ops.pileup_device import (
            build_packed_rows_device,
        )

        return build_packed_rows_device(
            queries, homologies, self.ref_len, self.plen,
            self.l_pad, pad_rows=pad_rows,
        )

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            queries, homologies, pad_rows = item
            try:
                if self._error is None:
                    self._chunks.append(
                        self._ship(queries, homologies, pad_rows)
                    )
            except BaseException as e:  # noqa: BLE001 — raised in finish()
                self._error = e
            finally:
                self._q.task_done()

    def feed(self, queries: list, homologies: list) -> None:
        """Enqueue the next mapped group of THIS process's row block."""
        self._rows_fed += len(queries)
        pad_rows = 0
        real = max(self.row_hi - self.row_lo, 0)
        if self._rows_fed >= real:
            # last group of the block: pad to the shard's row count
            pad_rows = self.rows_per_block - real
        self._q.put((queries, homologies, pad_rows))

    def finish(self) -> tuple[np.ndarray, np.ndarray]:
        """Assemble the resident global shard and run the collective
        count.  COLLECTIVE: every process must call this (feeder errors
        raise — a silent per-process fallback would desync the pod)."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from phylonium_tpu.ops.device_counts import concat_pad
        from phylonium_tpu.ops.shapes import _PACKED_PAD
        from phylonium_tpu.parallel.distributed import (
            _sharded_counts,
            gathered_counts,
        )

        if self.row_hi <= self.row_lo and self._rows_fed == 0:
            # a process beyond the real genome count still owes its
            # all-pad shard to the collective
            self.feed([], [])
        self._q.join()
        self._q.put(None)
        if self._error is not None:
            raise self._error
        fed = self._rows_fed
        if fed != max(self.row_hi - self.row_lo, 0):
            raise RuntimeError(
                f"pod feeder got {fed} rows for block "
                f"[{self.row_lo}, {self.row_hi})"
            )
        local = concat_pad(
            tuple(self._chunks), self.rows_per_block, self.l_pad,
            _PACKED_PAD,
        )
        global_arr = jax.make_array_from_single_device_arrays(
            (self.n_pad, self.l_pad),
            NamedSharding(self.mesh, P("rows", "cols")),
            [local],
        )
        m, h = _sharded_counts(global_arr, self.mesh, self.n_rows, True)
        return gathered_counts(m, h, self.n)


def map_pileup_count_streamed_mp(
    ref: ESAIndex,
    threshold: int,
    queries: list,
    cfg: RunConfig,
) -> tuple[np.ndarray, np.ndarray]:
    """The full streamed pod pipeline: map this process's contiguous
    row block group by group, feed each group's rows to the local
    device, then count collectively on the resident shards.

    Returns host int64 (substitutions, homologs) — bit-identical to the
    serial path (any disjoint-and-complete mapping split computes
    identical homologies; the collective is exact).
    """
    import jax

    from phylonium_tpu.core.map_native import map_batch_native
    from phylonium_tpu.parallel.multihost import make_pod_mesh
    from phylonium_tpu.utils.progress import ProgressBar

    mesh = make_pod_mesh()
    feeder = PodShardFeeder(len(queries), len(ref.subject), mesh)
    group_rows = int(
        os.environ.get("PHYLONIUM_TPU_STREAM_GROUP") or DEFAULT_GROUP_ROWS
    )
    n = len(queries)
    lo_own, hi_own = feeder.row_lo, feeder.row_hi

    bar = ProgressBar(
        f"Mapping {n} sequences", max(hi_own - lo_own, 1),
        enabled=cfg.progress_enabled,
    )
    for lo in range(lo_own, hi_own, group_rows):
        hi = min(lo + group_rows, hi_own)
        batch = [queries[j].as_array() for j in range(lo, hi)]
        out = map_batch_native(
            ref._native, batch, threshold, bar, lo - lo_own
        )
        feeder.feed(batch, out)
        bar.update(hi - lo_own)
    bar.finish()
    if cfg.verbose >= 2:
        print(
            f"pod stream: process {jax.process_index()}/"
            f"{jax.process_count()} mapped+fed rows "
            f"[{lo_own}, {hi_own}) of {n}",
            file=sys.stderr,
        )

    num_comparisons = (n * n - n) // 2
    cbar = ProgressBar(
        "Comparing the sequences", num_comparisons,
        enabled=cfg.progress_enabled,
    )
    subs, homs = feeder.finish()
    cbar.update(num_comparisons)
    cbar.finish()
    return subs, homs
