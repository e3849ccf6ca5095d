"""Reference-projected pileup — the accelerator-native representation.

This is the central data-structure redesign of this framework.  The
reference compares every genome *pair* by intersecting homology interval
lists and running SIMD byte loops over the intersections
(`src/process.cxx:524-549`, `libs/seqcmp*.c`) — O(N^2 * L) byte work with
zero reuse.  Here each genome is instead projected **once** onto reference
coordinates as a row of per-column states; all-pairs counting then becomes
dense integer matmuls (see phylonium_tpu/ops/pallas_match.py)
with O(N * L) preparation and massive reuse.

State encoding (uint8):
    state = base_code + 5 * strand      for covered columns
    state = INVALID (= 10)              for uncovered columns
with base_code A=0 C=1 G=2 T=3 '!'=4 and strand 0=forward 1=reverse.

Exactness: after overlap filtering each genome's homologies are disjoint
on the reference, so genome g defines a partial map column -> (query byte,
strand).  For any pair the reference's per-overlap counting rules are
*positional* in reference coordinates (derivation in ops/match_table.py),
hence
    homologs[a,b]  = sum_r valid_a(r) * valid_b(r)
    matches[a,b]   = sum_r MATCH_TABLE[state_a(r), state_b(r)]
    substitutions  = homologs - matches
reproduce the reference's counts bit-exactly (tested against
core/compare_numpy.py).
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu.core.homology import REVERSE, Homology

N_BASE = 5  # A C G T '!'
N_STATES = 10  # base x strand
INVALID = 10  # uncovered column
N_PLANES = N_STATES + 1  # + validity plane

# ASCII byte for each base code (order defines the code space)
BASE_BYTES = np.frombuffer(b"ACGT!", dtype=np.uint8)

_CODE_OF_BYTE = np.full(256, -1, dtype=np.int16)
for _code, _byte in enumerate(BASE_BYTES):
    _CODE_OF_BYTE[_byte] = _code


def byte_to_code(arr: np.ndarray) -> np.ndarray:
    codes = _CODE_OF_BYTE[arr]
    if (codes < 0).any():
        bad = arr[codes < 0][0]
        raise ValueError(f"unexpected byte {bad!r} in filtered sequence")
    return codes.astype(np.uint8)


def build_pileup_row(
    query: np.ndarray, homologies: list[Homology], ref_len: int
) -> np.ndarray:
    """Project one genome onto reference columns.

    ``query`` is the genome's joined byte array; ``ref_len`` the subject's
    length (projected coordinates live in [0, ref_len)).
    """
    row = np.full(ref_len, INVALID, dtype=np.uint8)
    # code (and validate) the query once, not per homology — even with
    # zero homologies, so malformed bytes raise identically to the
    # native pass (which validates every query up front)
    qcodes = byte_to_code(query)
    if not homologies:
        return row
    for h in homologies:
        start, end = h.start(), h.end()
        if h.length <= 0:
            continue
        codes = qcodes[h.index_query : h.index_query + h.length]
        if h.direction == REVERSE:
            # ref column start+s aligns with query byte iq + len-1-s
            row[start:end] = codes[::-1] + N_BASE
        else:
            row[start:end] = codes
    return row


def build_pileup(
    queries: list[np.ndarray],
    homologies: list[list[Homology]],
    ref_len: int,
) -> np.ndarray:
    """[N, ref_len] uint8 state matrix.

    One native pass when available (per-homology numpy slice
    assignments cost ~6 s at 1000 x 1 Mbp; the C++ fill is ~1 s and
    OpenMP-parallel over genomes); the per-row numpy builder below is
    the behavioral oracle (tests assert bit-equality).
    """
    n = len(queries)
    try:
        from phylonium_tpu.native import build_pileup_native

        return build_pileup_native(queries, homologies, ref_len)
    except ImportError:
        pass
    except ValueError:
        raise
    except Exception:
        pass
    states = np.empty((n, ref_len), dtype=np.uint8)
    for g in range(n):
        states[g] = build_pileup_row(queries[g], homologies[g], ref_len)
    return states
