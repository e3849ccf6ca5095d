"""Low-memory pipeline: bounded peak RSS at 1000 x 5 Mbp scale.

The standard pipeline follows the reference's memory model — every
genome resident as raw bytes (`src/phylonium.cxx:272-287`) plus, here,
the full [N, ref_len] pileup byte matrix and its packed copy: at
1000 x 5 Mbp that is ~5 GB of sequences + 5 GB of states + 2.5 GB
packed, far beyond this class of host.  The reference itself never hits
the states wall (it streams per-pair homology lists,
`src/process.cxx:566-611`) but still holds the 5 GB of sequences.

This pipeline bounds everything:

- sequences are 2-bit-COMPACTED at read time (data/sequence.compact;
  1.25 GB for the panel), unpacked transiently per mapping group;
- homologies stay as [H, 5] int64 arrays (the native mapper's raw
  rows, ~40 B each) instead of ~400-B Python objects;
- the host compare never materializes the [N, ref_len] matrix: column
  windows of the pileup are built on the fly from the compacted
  queries + interval arrays (exactly core/pileup.build_pileup_row's
  semantics, asserted bit-identical) and fed to the same native
  counting kernel, window by window — counts are column-separable
  integer sums, so any split is exact;
- the device compare needs no big host arrays at all: the streamed
  feeder ships 2-bit codes + interval records per group (device memory
  holds the 2.5 GB nibble panel), racing the windowed host count.

Peak RSS ~= packed sequences + index + one mapping group + one column
window.

Engages automatically on the plain auto path when the panel's raw
bytes exceed PHYLONIUM_TPU_LOWMEM_BYTES (default 2 GB; '0' disables,
'force' engages for tests).  Paths needing the whole byte matrix or
object homologies (-p, --complete-deletion, checkpoints, meshes,
multi-process, non-native backends) keep the standard pipeline.
"""

from __future__ import annotations

import os
import time

import numpy as np

from phylonium_tpu.config import RunConfig
from phylonium_tpu.core.pileup import INVALID, N_BASE
from phylonium_tpu.data.sequence import Sequence

# default panel-bytes threshold: above this the full byte pipeline
# would not fit this host class comfortably
_DEFAULT_BYTES = 2 << 30

# host column-window width cap (bytes of one [N, W] chunk)
_WINDOW_BYTES = 256 << 20


def lowmem_budget() -> int:
    raw = os.environ.get("PHYLONIUM_TPU_LOWMEM_BYTES")
    if raw in (None, "", "force", "0"):
        return _DEFAULT_BYTES
    try:
        return int(float(raw))
    except ValueError:
        return _DEFAULT_BYTES


def should_lowmem(n: int, total_bp: int, cfg: RunConfig, ref=None) -> bool:
    """Engage the bounded-memory pipeline?  Deterministic in the run's
    inputs (no clock, no link state) so -2 second passes and re-runs
    decide identically."""
    env = os.environ.get("PHYLONIUM_TPU_LOWMEM", "")
    if env == "0":
        return False
    if cfg.count_backend not in ("auto", "host") or cfg.mesh:
        return False
    if cfg.complete_deletion or cfg.print_positions or cfg.checkpoint_dir:
        return False
    if cfg.map_backend not in ("auto", "native"):
        return False
    if ref is not None and ref.backend_name != "native":
        return False
    from phylonium_tpu.core.pipeline import _is_multiprocess

    if _is_multiprocess():
        return False
    if env == "force":
        return True
    return total_bp > lowmem_budget()


def group_rows_for(n: int, avg_len: int) -> int:
    """Mapping-group size capped so one group's unpacked bytes stay
    within ~1/16 of the budget (a group exists as the batch list PLUS
    the native mapper's contiguous copy, and the feeder may hold two
    more in its bounded queue)."""
    from phylonium_tpu.core.stream import effective_group_rows

    cap = max(4, int(lowmem_budget() // 16) // max(avg_len, 1))
    return max(4, min(effective_group_rows(n), cap))


def _window_slices(hv: np.ndarray):
    """Precompute per-genome sorted interval columns for windowing."""
    if not len(hv):
        z = np.zeros(0, np.int64)
        return z, z, z, z, z
    d, irp, iq, ln = hv[:, 0], hv[:, 2], hv[:, 3], hv[:, 4]
    keep = ln > 0
    d, irp, iq, ln = d[keep], irp[keep], iq[keep], ln[keep]
    order = np.argsort(irp, kind="stable")
    # disjoint intervals sorted by start => ends sorted too
    return (
        irp[order], (irp + ln)[order], iq[order], ln[order], d[order]
    )


def build_window(
    queries: list[Sequence],
    pre: list,
    c0: int,
    c1: int,
    out: np.ndarray,
) -> None:
    """Fill ``out`` ([N, c1-c0] uint8) with pileup states for reference
    columns [c0, c1) — bit-identical to
    ``build_pileup(...)[:, c0:c1]`` (core/pileup.build_pileup_row
    semantics, clipped to the window)."""
    out[:] = INVALID
    for g, (starts, ends, iqs, lens, dirs) in enumerate(pre):
        if not len(starts):
            continue
        i0 = int(np.searchsorted(ends, c0, side="right"))
        i1 = int(np.searchsorted(starts, c1, side="left"))
        seq = queries[g]
        for k in range(i0, i1):
            s, e = int(starts[k]), int(ends[k])
            cs, ce = max(s, c0), min(e, c1)
            if cs >= ce:
                continue
            iq = int(iqs[k])
            if dirs[k]:  # REVERSE: column c reads query iq + (e-1-c)
                codes = seq.codes_slice(iq + e - ce, iq + e - cs)
                out[g, cs - c0 : ce - c0] = codes[::-1] + N_BASE
            else:
                codes = seq.codes_slice(iq + cs - s, iq + ce - s)
                out[g, cs - c0 : ce - c0] = codes


def pair_counts_windowed(
    queries: list[Sequence],
    harrs: list[np.ndarray],
    ref_len: int,
    poll=None,
    progress=None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """All-pairs (substitutions, homologs) without ever materializing
    the [N, ref_len] matrix: build one column window at a time from the
    compacted queries + interval arrays and run the native counting
    kernel on it.  ``poll`` aborts between windows (the compare race's
    host leg)."""
    from phylonium_tpu.native import pair_counts_range

    n = len(queries)
    subs = np.zeros((n, n), dtype=np.int64)
    homs = np.zeros((n, n), dtype=np.int64)
    window = max(1 << 16, (_WINDOW_BYTES // max(n, 1)) & ~4095)
    pre = [_window_slices(hv) for hv in harrs]
    chunk = np.empty((n, min(window, max(ref_len, 1))), dtype=np.uint8)
    for c0 in range(0, max(ref_len, 1), window):
        if poll is not None and poll():
            return None
        c1 = min(c0 + window, ref_len)
        view = chunk[:, : c1 - c0]
        build_window(queries, pre, c0, c1, view)
        pair_counts_range(
            np.ascontiguousarray(view), 0, c1 - c0, subs, homs
        )
        if progress is not None:
            progress(c1 / max(ref_len, 1))
    return subs, homs


def map_count_lowmem(
    ref, threshold: int, queries: list[Sequence], cfg: RunConfig
) -> tuple[np.ndarray, np.ndarray, dict]:
    """The bounded-memory map -> feed -> compare pipeline.

    Maps in memory-capped row groups (unpacking each group
    transiently), keeps homologies as raw arrays, feeds the device
    feeder group by group (2-bit codes + intervals — no host matrix),
    then races the device count against the windowed host count.
    Returns (subs, homs, timings).
    """
    from phylonium_tpu.core.map_native import map_batch_native
    from phylonium_tpu.utils.progress import ProgressBar

    timings: dict = {}
    n = len(queries)
    ref_len = len(ref.subject)
    avg_len = max(1, sum(len(q) for q in queries) // max(n, 1))

    feeder = None
    env_stream = os.environ.get("PHYLONIUM_TPU_STREAM", "")
    if cfg.count_backend == "auto" and env_stream != "0":
        from phylonium_tpu.core.stream import DeviceRowFeeder
        from phylonium_tpu.utils.platform import cpu_pinned

        if env_stream == "force" or not cpu_pinned():
            try:
                feeder = DeviceRowFeeder(
                    n, ref_len,
                    shipper=getattr(cfg, "_query_shipper", None),
                    max_backlog=2,  # groups here are copies, not views
                )
            except Exception:
                feeder = None

    shipper = getattr(cfg, "_query_shipper", None)
    # the early shipper's group boundaries win (its groups were sized
    # from file-size estimates at read time; matching them keeps every
    # take() a boundary hit)
    group = (
        shipper.group_rows
        if shipper is not None
        else group_rows_for(n, avg_len)
    )
    harrs: list = [None] * n
    bar = ProgressBar(
        f"Mapping {n} sequences", n, enabled=cfg.progress_enabled
    )
    t0 = time.time()
    for lo in range(0, n, group):
        hi = min(lo + group, n)
        batch = [queries[j].as_array() for j in range(lo, hi)]
        out = map_batch_native(
            ref._native, batch, threshold, bar, lo, raw=True
        )
        harrs[lo:hi] = out
        if feeder is not None:
            feeder.feed(batch, out)
        bar.update(hi)
        del batch  # the group's unpacked bytes die here
    bar.finish()
    timings["map+feed"] = time.time() - t0

    num_comparisons = (n * n - n) // 2
    cbar = ProgressBar(
        "Comparing the sequences",
        num_comparisons,
        enabled=cfg.progress_enabled,
    )
    progress = lambda f: cbar.update(int(f * num_comparisons))  # noqa: E731

    from phylonium_tpu.core.pipeline import (
        LAST_RUN_INFO,
        _set_carrier,
        finish_ship_accounting,
        race,
        race_grace_if_warm,
    )

    t0 = time.time()
    if feeder is not None:
        race_grace_if_warm(feeder)
        result = race(
            lambda poll: pair_counts_windowed(
                queries, harrs, ref_len, poll=poll, progress=progress
            ),
            feeder.finish,
            cfg,
        )
        if LAST_RUN_INFO.get("compare_carrier") == "device" and (
            feeder.devd_count_s is not None
        ):
            LAST_RUN_INFO["devd_count_s"] = feeder.devd_count_s
    else:
        result = pair_counts_windowed(
            queries, harrs, ref_len, progress=progress
        )
        _set_carrier("host")
    timings["compare"] = time.time() - t0
    cbar.finish()
    # cold-run seeding + early-ship stats (shared with the standard
    # pipeline): a drained lowmem run parks the whole compacted panel
    # in the device server and prewarms its program family, so the
    # next run of the same panel is device-carried from cache
    finish_ship_accounting(feeder, n, ref_len)
    LAST_RUN_INFO["lowmem"] = {
        "group_rows": group,
        "homologies": int(sum(len(h) for h in harrs)),
    }
    subs, homs = result
    return subs, homs, timings
