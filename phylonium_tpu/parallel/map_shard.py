"""Multi-host query-sharded mapping.

The mapping phase is host-bound (anchor chaining over the suffix index,
memory-latency limited — see ARCHITECTURE.md), so on a multi-host
deployment each process maps only the queries it owns (round-robin by
index, the same data-parallel-over-queries axis the reference threads
with OpenMP, src/process.cxx:433) and the resulting homology lists are
exchanged with two ``process_allgather`` collectives.  Homologies are
tiny (5 ints each; ~18k records for an eco29-scale panel), so the
exchange is microseconds of network traffic while the mapping work itself
scales ~linearly with the host count.

Determinism: every process would compute identical homologies for any
query (pure function of (subject, query, threshold)), so ownership is
purely a work split and the exchanged result is bit-identical to
single-host mapping.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu.core.homology import Homology

_FIELDS = 6  # query_index + the 5 Homology fields


def owner_of(query_index: int, process_count: int) -> int:
    return query_index % process_count


def exchange_homologies(
    homologies: list[list[Homology] | None],
    owned: list[int],
) -> list[list[Homology]]:
    """Allgather per-query homology lists across jax processes.

    ``homologies[j]`` must be filled for every ``j in owned`` (this
    process's queries); other entries are ignored and replaced by their
    owners' results.  Collective: every process must call this with the
    same query count and a disjoint-and-complete ownership split.
    """
    from jax.experimental import multihost_utils

    n = len(homologies)
    rows: list[tuple] = []
    for j in owned:
        for h in homologies[j]:
            rows.append(
                (
                    j,
                    h.direction,
                    h.index_reference,
                    h.index_reference_projected,
                    h.index_query,
                    h.length,
                )
            )
    flat = np.array(rows, dtype=np.int64).reshape(-1, _FIELDS)

    totals = multihost_utils.process_allgather(
        np.array([flat.shape[0]], dtype=np.int64)
    ).reshape(-1)
    cap = max(int(totals.max()), 1)
    padded = np.zeros((cap, _FIELDS), dtype=np.int64)
    padded[: flat.shape[0]] = flat
    gathered = np.asarray(
        multihost_utils.process_allgather(padded)
    ).reshape(len(totals), cap, _FIELDS)

    out: list[list[Homology]] = [[] for _ in range(n)]
    for p in range(len(totals)):
        for rec in gathered[p][: int(totals[p])]:
            out[int(rec[0])].append(
                Homology(
                    int(rec[1]),
                    int(rec[2]),
                    int(rec[3]),
                    int(rec[4]),
                    int(rec[5]),
                )
            )
    return out
