"""Evolutionary substitution model — matrix-wide counts and estimators.

Where the reference keeps one ``evo_model`` (a pair of counters,
`src/evo_model.h:16-19`) per matrix cell and estimates per cell, the device
build keeps the whole N x N matrix as two integer arrays and estimates
vectorized.  Semantics per cell mirror `src/evo_model.cxx`:

- ``estimate_raw``: substitutions / homologs; NaN (or 0) on empty
  (src/evo_model.cxx:100-107).
- ``estimate_ani``: (1 - raw) * 100 (src/evo_model.cxx:112-119).
- ``estimate_jc``: -0.75 * ln(1 - 4/3 * raw), negatives clamped to 0, NaN
  propagates (src/evo_model.cxx:124-131).
- ``bootstrap``: substitutions resampled ~ Binomial(homologs, rate) per
  Klötzl & Haubold 2016 (src/evo_model.cxx:136-147); the reference seeds
  from ``std::random_device`` so only distributional equivalence holds.
- ``coverage``: homologs / sequence length (src/evo_model.cxx:152-155).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class EvoCounts:
    """N x N substitution / homolog counts (symmetric, zero diagonal)."""

    substitutions: np.ndarray  # [N, N] int64
    homologs: np.ndarray  # [N, N] int64

    @classmethod
    def zeros(cls, n: int) -> "EvoCounts":
        return cls(
            np.zeros((n, n), dtype=np.int64),
            np.zeros((n, n), dtype=np.int64),
        )

    @property
    def n(self) -> int:
        return self.substitutions.shape[0]

    def total(self) -> np.ndarray:
        return self.homologs

    def estimate_raw(self, zero_on_error: bool = False) -> np.ndarray:
        homs = self.homologs.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            raw = self.substitutions / homs
        empty = self.homologs == 0
        raw[empty] = 0.0 if zero_on_error else np.nan
        return raw

    def estimate_ani(self, zero_on_error: bool = False) -> np.ndarray:
        raw = self.estimate_raw(zero_on_error)
        return (1.0 - raw) * 100.0

    def estimate_jc(self, zero_on_error: bool = False) -> np.ndarray:
        raw = self.estimate_raw(zero_on_error)
        with np.errstate(invalid="ignore", divide="ignore"):
            arg = 1.0 - (4.0 / 3.0) * raw
            d = -0.75 * np.log(arg)
            # glibc's log(x < 0) returns a NEGATIVE-signed NaN, the
            # -0.75 multiply forwards it sign-preserved, and printf
            # renders it "-nan" (reachable: raw > 3/4 from spurious
            # anchors between unrelated genomes).  numpy's NaN sign
            # here is platform noise — pin it to the reference's.
            d = np.where(arg < 0, np.copysign(np.nan, -1.0), d)
            # fix negative zero / negative estimates; NaN passes through
            # (NaN <= 0 is False, same as the C++ comparison)
            return np.where(d <= 0.0, 0.0, d)

    def coverage(self, lengths: np.ndarray) -> np.ndarray:
        """Per-cell homologs / length-of-row-genome: coverage[i, j] uses
        queries[i].size, mirroring matrix[index].coverage(queries[i].size())
        at src/io.cxx:126-127."""
        return self.homologs / lengths[:, None].astype(np.float64)

    def bootstrap(self, rng: np.random.Generator) -> "EvoCounts":
        homs = self.homologs
        safe = np.maximum(homs, 1)
        rate = self.substitutions / safe.astype(np.float64)
        rate = np.clip(rate, 0.0, 1.0)
        # Binomial(0, p) == 0, matching std::binomial_distribution with t=0
        subs = rng.binomial(homs, rate)
        return EvoCounts(subs.astype(np.int64), homs.copy())


@dataclass
class PairStats:
    """Verbose-run metadata carried alongside the matrix."""

    reference_index: int = 0
    reference_name: str = ""
    extras: dict = field(default_factory=dict)
