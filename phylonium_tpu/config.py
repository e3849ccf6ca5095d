"""Run configuration and soft-error tracking.

The reference uses a global FLAGS bitfield plus assorted globals
(`src/global.h:7-23`); here the same knobs live in one dataclass that is
threaded through the pipeline.  ``soft_error`` mirrors the ``soft_errx``
macro (`src/global.h:29-43`): warn on stderr and force a failing exit
code at the end.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

PROG = "phylonium-tpu"


class ConfigError(ValueError):
    """A user-facing configuration/limit error from the pipeline.

    The CLI catches exactly this (a clean one-line exit, like the
    reference's errx paths) — any other exception is a defect and
    keeps its traceback.
    """


def _env_float(name: str, default: float) -> float:
    import os

    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        print(
            f"{PROG}: ignoring malformed {name}={raw!r} "
            f"(expected a number); using {default}",
            file=sys.stderr,
        )
        return default


@dataclass
class RunConfig:
    distance: str = "jc"  # 'jc' | 'raw' | 'ani' (estimator choice)
    # The reference accumulates --distance choices as STICKY flag bits
    # (src/phylonium.cxx:147-158, src/global.h:14-15): the estimator
    # takes raw > ani > jc precedence, while the FORMATTER keys on the
    # ani bit alone (src/io.cxx:149) — so '--distance=ani
    # --distance=raw' prints raw values in defaultfloat.  The CLI sets
    # these bits and derives `distance`; library callers may keep
    # setting `distance` directly.
    dist_raw: bool = False
    dist_ani: bool = False
    bootstrap: int = 0  # number of *extra* matrices printed
    complete_deletion: bool = False
    print_positions: bool = False
    refpos_file_name: str = ""
    verbose: int = 0  # 0 / 1 / 2 (-v -v)
    progress: str = "auto"  # 'auto' | 'always' | 'never'
    threads: int = 0  # 0 = all
    two_pass: bool = False
    reference_name: str = ""
    anchor_p_value: float = 0.025
    esa_backend: str | None = None  # None/'auto' | 'native' | 'numpy'
    # 'auto' | 'pallas' | 'device' | 'host' | 'numpy'
    count_backend: str = "auto"
    map_backend: str = "auto"  # 'auto' | 'native' | 'python' | 'hybrid'
    mesh: str = ""  # 'R,C' device mesh for counting ('' = all devices)
    # 'auto' counting sends panels with at least this much pair work
    # (pairs x columns, in Gbp) to the device; below it the host AVX2
    # path is expected to win because the device path's fixed costs
    # (backend init, kernel compile, transfer) exceed the seconds the
    # kernel saves.  The value is provisional until it is re-derived
    # from GPU per-layer measurements (ROADMAP Speed 5).  Tune per
    # deployment: PHYLONIUM_TPU_AUTO_DEVICE_GBP.
    auto_device_min_gbp: float = field(
        default_factory=lambda: _env_float(
            "PHYLONIUM_TPU_AUTO_DEVICE_GBP", 128.0
        )
    )
    checkpoint_dir: str = ""  # reuse/persist mapping results here
    profile_dir: str = ""  # write a jax.profiler trace here
    return_code: int = 0
    _progress_enabled: bool | None = field(default=None, repr=False)
    # runtime handle: the CLI's early query shipper
    # (core/query_ship.QueryShipper), set while reading so 2-bit query
    # codes ship to the device before the pipeline even starts
    _query_shipper: object | None = field(
        default=None, repr=False, compare=False
    )

    def soft_error(self, msg: str) -> None:
        self.return_code |= 1
        print(f"{PROG}: {msg}", file=sys.stderr)

    def warn(self, msg: str) -> None:
        print(f"{PROG}: {msg}", file=sys.stderr)

    @property
    def progress_enabled(self) -> bool:
        if self._progress_enabled is None:
            if self.progress == "always":
                self._progress_enabled = True
            elif self.progress == "never":
                self._progress_enabled = False
            else:
                self._progress_enabled = sys.stderr.isatty()
        return self._progress_enabled
