"""Persisted deployment calibration feeding the dispatch gates.

Whether the device wins the compare depends on the host->device link
and on the host kernels' speed on this machine, neither knowable from
specs.  Every production run therefore RECORDS what it measured —
verified link bandwidth, host compare throughput, and effective mapping
throughput — as byte-weighted EWMAs in a small JSON file, and the next
run's gates read them back:

- ``core/pipeline._auto_prefers_host`` compares a predicted host compare
  time against a predicted ship time instead of the static work-Gbp
  threshold;
- the CLI's early-ship gate predicts whether the 2-bit query panel can
  ship inside the read+index+map overlap window before spending link
  bandwidth and CPU on it.

The file lives in the checkout's state directory
(``<checkout>/.state/calibration.json``);
``PHYLONIUM_TPU_CALIBRATION_FILE`` overrides (tests point it into tmp).
CPU-pinned processes (tests, forced host runs) neither read nor write
the real file unless that override is set — a CPU "link" sample would
poison the device gate, and gate behavior in tests must not depend on
the developer machine's history.

No reference analog: the reference binary is single-host CPU-only and
has nothing to calibrate (its only dispatch is the ifunc CPU-feature
probe, ``libs/seqcmp.c:32-69``).
"""

from __future__ import annotations

import json
import os
import time

_ENV = "PHYLONIUM_TPU_CALIBRATION_FILE"

# EWMA weight of a new sample (per-key); heavy enough to track a link
# that changes by the minute, light enough that one degraded probe does
# not erase a stable history
_ALPHA = 0.5

# keys -> minimum sample magnitude worth recording (noise floors)
_MIN_BYTES = 4 << 20  # link samples below 4 MB are RTT-dominated
_MIN_SECONDS = 0.2  # throughput samples shorter than this are noise


def _path() -> str | None:
    override = os.environ.get(_ENV)
    if override:
        return override
    from phylonium_tpu.utils.platform import cpu_pinned

    if cpu_pinned():
        return None  # hermetic: tests never touch the real file
    from phylonium_tpu.utils.cache import state_dir

    return os.path.join(state_dir(), "calibration.json")


def load() -> dict:
    """The persisted calibration dict ({} when absent/none/corrupt)."""
    path = _path()
    if not path:
        return {}
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _store(data: dict) -> None:
    path = _path()
    if not path:
        return
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)  # atomic: concurrent writers last-win
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def record(key: str, value: float) -> None:
    """Fold one measured sample into the persisted EWMA for ``key``."""
    if not (value > 0.0) or value != value:  # reject 0/negative/nan
        return
    data = load()
    old = data.get(key)
    if isinstance(old, (int, float)) and old > 0:
        value = (1 - _ALPHA) * old + _ALPHA * value
    data[key] = round(float(value), 4)
    counts = data.setdefault("samples", {})
    if isinstance(counts, dict):
        counts[key] = int(counts.get(key, 0)) + 1
    data["updated"] = int(time.time())
    _store(data)


def record_link(nbytes: int, seconds: float) -> None:
    """Record one VERIFIED host->device transfer (bytes actually fetched
    back through a cached program — device_put/block_until_ready lie on
    this deployment)."""
    if nbytes < _MIN_BYTES or seconds <= 0:
        return
    record("link_mb_s", nbytes / 1e6 / seconds)


def record_host_compare(work_gbp: float, seconds: float) -> None:
    """Record one host-carried compare phase (pair work in Gbp)."""
    if seconds >= _MIN_SECONDS:
        record("host_compare_gbps", work_gbp / seconds)


def record_map(total_gbp: float, seconds: float) -> None:
    """Record one mapping phase's effective throughput (query Gbp/s;
    streamed runs fold the feed's CPU steal in — exactly the overlap
    window the early-ship gate wants to predict)."""
    if seconds >= _MIN_SECONDS:
        record("map_gbps", total_gbp / seconds)


def link_mb_s() -> float | None:
    """Measured link bandwidth estimate (MB/s), or None before the
    first verified transfer."""
    v = load().get("link_mb_s")
    return float(v) if isinstance(v, (int, float)) and v > 0 else None


# conservative priors for rates that have a sane floor even unmeasured
# (used only to ESTIMATE; dispatch without a link measurement keeps the
# static work threshold)
_DEFAULT_HOST_COMPARE_GBPS = 25.0  # AVX2 bitplane floor on this host
_DEFAULT_MAP_GBPS = 0.2  # native mapper floor on this host


def host_compare_gbps() -> float:
    v = load().get("host_compare_gbps")
    if isinstance(v, (int, float)) and v > 0:
        return float(v)
    return _DEFAULT_HOST_COMPARE_GBPS


def map_gbps() -> float:
    v = load().get("map_gbps")
    if isinstance(v, (int, float)) and v > 0:
        return float(v)
    return _DEFAULT_MAP_GBPS


def snapshot() -> dict:
    """The estimates a dispatch decision acted on (for run reports)."""
    return {
        "link_mb_s": link_mb_s(),
        "host_compare_gbps": round(host_compare_gbps(), 2),
        "map_gbps": round(map_gbps(), 3),
    }
