"""Exactness of the pileup counting path vs the byte-level oracle.

The pileup + match-table formulation must reproduce the reference's
per-pair substitution/homolog counts bit-exactly (derivation in
ops/match_table.py).  We verify it against an independent implementation
of the reference's merge sweep + seqcmp/revseqcmp (core/compare_numpy.py)
on randomized homology structures, including reverse strands, contig
separators, and the XLA device path.
"""

import numpy as np
import pytest

from phylonium_tpu.core.anchor_stats import min_anchor_length
from phylonium_tpu.core.anchors import anchor_homologies
from phylonium_tpu.core.compare_numpy import compare_pair, revseqcmp, seqcmp
from phylonium_tpu.core.filter import filter_overlaps_max
from phylonium_tpu.core.pileup import build_pileup
from phylonium_tpu.data.sequence import Sequence, gc_content, revcomp
from phylonium_tpu.index.esa import ESAIndex
from phylonium_tpu.ops.device_counts import pair_counts_states
from phylonium_tpu.ops.match_table import MATCH_TABLE, pair_counts_numpy
from tests.conftest import mutate, random_genome


def test_seqcmp_and_revseqcmp():
    a = np.frombuffer(b"ACGTACGT", dtype=np.uint8)
    b = np.frombuffer(b"ACCTACGA", dtype=np.uint8)
    assert seqcmp(a, b) == 2

    fwd = np.frombuffer(b"ACGT", dtype=np.uint8)
    rc = np.frombuffer(revcomp(b"ACGT"), dtype=np.uint8)
    assert revseqcmp(fwd, rc) == 0
    # the '!'^'T' ASCII quirk: '!' vs 'T' passes the complement test
    # (libs/revseqcmp.h:19-23); reproduce deliberately
    bang = np.frombuffer(b"!", dtype=np.uint8)
    assert revseqcmp(bang, np.frombuffer(b"T", dtype=np.uint8)) == 0
    assert revseqcmp(bang, np.frombuffer(b"A", dtype=np.uint8)) == 1
    assert revseqcmp(bang, bang) == 1


def test_match_table_symmetry():
    assert (MATCH_TABLE == MATCH_TABLE.T).all()
    assert MATCH_TABLE[10].sum() == 0 and MATCH_TABLE[:, 10].sum() == 0


def _full_panel(rng, n_genomes=4, length=3000, with_inversion=True):
    ref = random_genome(rng, length)
    genomes = [ref]
    for k in range(n_genomes - 1):
        g = mutate(ref, 0.01 * (k + 1), rng)
        if with_inversion and k == 1:
            third = length // 3
            g = g[:third] + revcomp(g[third : 2 * third]) + b"!" + g[2 * third :]
        genomes.append(g)

    sref = Sequence("g0", ref)
    esa = ESAIndex(sref, backend="numpy")
    thr = min_anchor_length(0.025, gc_content(ref), esa.size)
    homs = []
    for g in genomes:
        hv = anchor_homologies(esa, thr, Sequence("q", g))
        hv.sort(key=lambda h: h.start())
        homs.append(filter_overlaps_max(hv))
    arrs = [np.frombuffer(g, np.uint8) for g in genomes]
    return ref, arrs, homs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pileup_equals_oracle(seed):
    rng = np.random.default_rng(seed)
    ref, arrs, homs = _full_panel(rng)
    n = len(arrs)

    subs_o = np.zeros((n, n), np.int64)
    homs_o = np.zeros((n, n), np.int64)
    for i in range(n):
        for j in range(i + 1, n):
            s, h = compare_pair(arrs[i], homs[i], arrs[j], homs[j])
            subs_o[i, j] = subs_o[j, i] = s
            homs_o[i, j] = homs_o[j, i] = h

    states = build_pileup(arrs, homs, len(ref))
    s1, h1 = pair_counts_numpy(states)
    assert np.array_equal(s1, subs_o)
    assert np.array_equal(h1, homs_o)

    s2, h2 = pair_counts_states(states)
    assert np.array_equal(s2, subs_o)
    assert np.array_equal(h2, homs_o)


def test_device_path_odd_sizes():
    # lengths that don't divide the block, tiny N
    rng = np.random.default_rng(7)
    states = rng.integers(0, 11, size=(3, 1037)).astype(np.uint8)
    s1, h1 = pair_counts_numpy(states)
    s2, h2 = pair_counts_states(states)
    assert np.array_equal(s1, s2)
    assert np.array_equal(h1, h2)


def test_native_pileup_matches_row_oracle(rng):
    """The C++ pileup fill must be bit-identical to the per-row numpy
    oracle, including reverse rows, '!' separators, and zero-length
    homologies."""
    import pytest

    pytest.importorskip("phylonium_tpu.native")
    from phylonium_tpu.core.homology import FORWARD, REVERSE, Homology
    from phylonium_tpu.core.pileup import build_pileup, build_pileup_row
    from phylonium_tpu.native import build_pileup_native

    acgtx = np.frombuffer(b"ACGT!", np.uint8)
    queries, homologies = [], []
    ref_len = 900
    for g in range(5):
        q = rng.choice(acgtx, 1100)
        hv = [
            Homology(FORWARD, 10 * g, 10 * g, 5, 200),
            Homology(REVERSE, 400, 400, 300, 150),
            Homology(FORWARD, 700, 700, 600, 0),  # skipped
        ]
        queries.append(q)
        homologies.append(hv)
    native = build_pileup_native(queries, homologies, ref_len)
    for g in range(5):
        oracle = build_pileup_row(queries[g], homologies[g], ref_len)
        np.testing.assert_array_equal(native[g], oracle)
    # dispatcher returns the same thing
    np.testing.assert_array_equal(
        build_pileup(queries, homologies, ref_len), native
    )


def test_native_pileup_bad_byte(rng):
    import pytest

    pytest.importorskip("phylonium_tpu.native")
    from phylonium_tpu.core.homology import FORWARD, Homology
    from phylonium_tpu.native import build_pileup_native

    q = np.frombuffer(b"ACGTNACGT", np.uint8).copy()
    with pytest.raises(ValueError, match="unexpected byte"):
        build_pileup_native([q], [[Homology(FORWARD, 0, 0, 0, 4)]], 10)


def test_pileup_row_validates_with_zero_homologies():
    """The numpy oracle validates query bytes even when a genome has no
    homologies, matching the native pass (which validates up front)."""
    import numpy as np
    import pytest

    from phylonium_tpu.core.pileup import build_pileup_row

    bad = np.frombuffer(b"ACGTZ", dtype=np.uint8)
    with pytest.raises(ValueError, match="unexpected byte"):
        build_pileup_row(bad, [], 10)
