"""Byte-level pairwise comparison oracle (host, numpy).

This module re-implements the reference's pair-comparison path exactly —
the merge sweep over two sorted homology lists (`src/process.cxx:566-611`)
and the per-overlap trim + strand dispatch (`src/process.cxx:620-658`) with
the seqcmp / revseqcmp counting rules (`libs/seqcmp.h:14`,
`libs/revseqcmp.h:19-23`):

- forward/forward and reverse/reverse: count bytes that differ;
- mixed strands: count positions where ``begin[i]`` is NOT the complement
  of ``other[len-1-i]``, complement test ``((a ^ b) & 6) == 4`` on ASCII.

It exists to validate the device pileup path (which must produce bit-equal
counts) and to serve small inputs without a device.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu.core.homology import Homology


def seqcmp(a: np.ndarray, b: np.ndarray) -> int:
    """Number of mismatching bytes (libs/seqcmp.c:13-28)."""
    return int(np.count_nonzero(a != b))


def revseqcmp(begin: np.ndarray, other: np.ndarray) -> int:
    """Positions where begin[i] is not the complement of other[len-1-i]
    (libs/revseqcmp.c:15-30)."""
    x = begin ^ other[::-1]
    return int(np.count_nonzero((x & 6) != 4))


def compare_overlap(
    sa: np.ndarray, ha: Homology, sb: np.ndarray, hb: Homology
) -> tuple[int, int]:
    """(substitutions, homologs) for one overlapping homology pair."""
    if not ha.overlaps(hb):
        return 0, 0

    common_start = max(ha.start(), hb.start())
    common_end = min(ha.end(), hb.end())
    if common_start >= common_end:
        # zero-width touch (equal starts with zero length); no counts
        return 0, 0
    length = common_end - common_start

    hat = ha.trim(common_start, common_end)
    hbt = hb.trim(common_start, common_end)

    from phylonium_tpu.core.homology import REVERSE

    if ha.direction == hb.direction:
        # same strand: plain byte comparison, no double complement needed
        subs = seqcmp(
            sa[hat.start_query() : hat.start_query() + length],
            sb[hbt.start_query() : hbt.start_query() + length],
        )
    elif hb.direction == REVERSE:
        subs = revseqcmp(
            sa[hat.start_query() : hat.start_query() + length],
            sb[hbt.end_query() - length : hbt.end_query()],
        )
    else:  # ha is reverse
        subs = revseqcmp(
            sb[hbt.start_query() : hbt.start_query() + length],
            sa[hat.end_query() - length : hat.end_query()],
        )

    return subs, length


def compare_pair(
    sa: np.ndarray,
    ha: list[Homology],
    sb: np.ndarray,
    hb: list[Homology],
) -> tuple[int, int]:
    """(substitutions, homologs) over all overlapping homology pairs.

    Linear merge sweep with an active pile, mirroring
    src/process.cxx:566-611.
    """
    subs_total = 0
    homs_total = 0

    right_ptr = 0
    pile: list[Homology] = []

    for homo in ha:
        # drop pile entries that end left of homo
        pile = [o for o in pile if not o.ends_left_of(homo)]

        # skip hb elements entirely left of homo
        while right_ptr < len(hb) and hb[right_ptr].ends_left_of(homo):
            right_ptr += 1

        # add newly overlapping hb elements
        far = right_ptr
        while far < len(hb) and hb[far].overlaps(homo):
            pile.append(hb[far])
            far += 1
        right_ptr = far

        for other in pile:
            s, h = compare_overlap(sa, homo, sb, other)
            subs_total += s
            homs_total += h

    return subs_total, homs_total
