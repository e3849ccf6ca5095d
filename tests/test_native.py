"""Native C++ backend parity with the numpy oracles."""

import os

import numpy as np
import pytest

try:
    from phylonium_tpu.native import (
        NativeESA,
        build_sa,
        num_procs,
        revseqcmp,
        seqcmp,
        set_threads,
    )

    NATIVE = True
except Exception:  # pragma: no cover - build environments without g++
    NATIVE = False

pytestmark = pytest.mark.skipif(not NATIVE, reason="native backend unavailable")


def brute_sa(s: bytes):
    return sorted(range(len(s)), key=lambda i: s[i:])


@pytest.mark.parametrize("seed", range(6))
def test_sa_is_matches_bruteforce(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 500))
    s = rng.choice(np.frombuffer(b"ACGT!#", np.uint8), n)
    assert build_sa(s).tolist() == brute_sa(s.tobytes())


def test_sa_is_handles_nul_bytes():
    # the u8 fast path requires NUL-free input; NUL falls back to widening
    s = np.array([65, 0, 67, 0, 65], dtype=np.uint8)
    assert build_sa(s).tolist() == brute_sa(bytes(s))


@pytest.mark.parametrize("seed", range(4))
def test_longest_match_matches_numpy(seed):
    from phylonium_tpu.index.esa_numpy import NumpySuffixIndex

    rng = np.random.default_rng(50 + seed)
    n = int(rng.integers(50, 800))
    S = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
    ne = NativeESA(S)
    np_idx = NumpySuffixIndex(S.copy())
    assert ne.SA.tolist() == np_idx.SA.tolist()
    for _ in range(40):
        m = int(rng.integers(1, 60))
        if rng.random() < 0.6 and n > m:
            st = int(rng.integers(0, n - m))
            q = S[st : st + m].copy()
        else:
            q = rng.choice(np.frombuffer(b"ACGT", np.uint8), m)
        assert ne.longest_match(q, 0, m) == np_idx.longest_match(q, 0, m)


def test_map_query_matches_python_chain(rng):
    from phylonium_tpu.core.anchor_stats import min_anchor_length
    from phylonium_tpu.core.anchors import anchor_homologies
    from phylonium_tpu.core.filter import filter_overlaps_max
    from phylonium_tpu.data.sequence import Sequence, gc_content, revcomp
    from phylonium_tpu.index.esa import ESAIndex
    from tests.conftest import mutate, random_genome

    ref = random_genome(rng, 20_000)
    q = mutate(ref, 0.02, rng)
    q = q[:7000] + revcomp(q[7000:14000]) + b"!" + q[14000:]

    sref = Sequence("r", ref)
    esa_np = ESAIndex(sref, backend="numpy")
    esa_nat = ESAIndex(sref, backend="native")
    thr = min_anchor_length(0.025, gc_content(ref), esa_nat.size)

    hv = anchor_homologies(esa_np, thr, Sequence("q", q))
    hv.sort(key=lambda h: h.start())
    py = filter_overlaps_max(hv)
    nat = esa_nat._native.map_query(np.frombuffer(q, np.uint8), thr)

    key = lambda h: (  # noqa: E731
        h.direction,
        h.index_reference,
        h.index_reference_projected,
        h.index_query,
        h.length,
    )
    assert [key(h) for h in nat] == [key(h) for h in py]


def test_scalar_kernels():
    a = np.frombuffer(b"ACGTACGT", np.uint8)
    b = np.frombuffer(b"ACCTACGA", np.uint8)
    assert seqcmp(a, b) == 2
    fwd = np.frombuffer(b"ACGT", np.uint8)
    assert revseqcmp(fwd, fwd) == 0  # ACGT is its own revcomp
    assert revseqcmp(np.frombuffer(b"!", np.uint8),
                     np.frombuffer(b"T", np.uint8)) == 0  # ASCII quirk


def test_thread_controls():
    assert num_procs() >= 1
    set_threads(1)  # must not raise
    set_threads(0)  # ignored


def test_mapper_parity_across_kmer_widths(rng, monkeypatch):
    """Bucket width must never change mapping output: a non-empty
    width-w bucket holds every max-lcp attainer, and an empty primary
    falls back to the one-base-narrower secondary (capped at 10;
    phylonium_native.cpp build_buckets).  PHYLONIUM_TPU_KMER is read
    per index build, so
    in-process forcing per index works.  Covers non-ACGT query/subject
    bytes (matches may span equal non-ACGT bytes only via the
    full-range path)."""
    import numpy as np

    from phylonium_tpu.data.sequence import Sequence
    from phylonium_tpu.index.esa import ESAIndex

    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, 60_000).tobytes()
    sub = base[:20_000] + b"N" + base[20_000:40_000] + b"!" + base[40_000:]
    queries = []
    for k in range(5):
        arr = np.frombuffer(base, np.uint8).copy()
        idx = rng.random(arr.size) < [0.01, 0.04, 0.09, 0.2, 0.02][k]
        arr[idx] = acgt[(arr[idx] + rng.integers(1, 4, int(idx.sum()))) % 4]
        g = arr.tobytes()
        if k == 4:
            g = g[:30_000] + b"NN!" + g[30_000:]
        queries.append(np.frombuffer(g, np.uint8))

    def run(kmer):
        monkeypatch.setenv("PHYLONIUM_TPU_KMER", kmer)
        ref = ESAIndex(Sequence("ref", sub), backend="native")
        out = ref._native.map_queries(queries, 21)
        return [
            [
                (h.direction, h.index_reference,
                 h.index_reference_projected, h.index_query, h.length)
                for h in hs
            ]
            for hs in out
        ]

    results = {k: run(k) for k in ("8", "10", "11", "12", "13")}
    baseline = results["10"]
    assert any(len(hs) > 0 for hs in baseline)
    for k, r in results.items():
        assert r == baseline, f"kmer={k} diverged"


def test_interleaved_mapper_matches_scalar(rng, monkeypatch):
    """The interleaved (memory-level-parallel) batch mapper emits
    exactly the scalar per-query loop's homologies for a diverse panel
    (forward/reverse, draft contigs, unmappable junk)."""
    import numpy as np

    from phylonium_tpu.data.sequence import Sequence, revcomp
    from phylonium_tpu.index.esa import ESAIndex

    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, 20_000).tobytes()
    queries = []
    for k in range(23):
        arr = np.frombuffer(base, np.uint8).copy()
        idx = rng.random(arr.size) < 0.01 * (k % 7 + 1)
        arr[idx] = acgt[(arr[idx] + rng.integers(1, 4, int(idx.sum()))) % 4]
        g = arr.tobytes()
        if k % 3 == 0:
            third = len(g) // 3
            g = g[:third] + revcomp(g[third : 2 * third]) + g[2 * third :]
        if k % 5 == 0:
            g = g[: len(g) // 2] + b"!" + g[len(g) // 2 :]
        if k == 7:
            g = rng.choice(acgt, 5_000).tobytes()  # unrelated
        queries.append(np.frombuffer(g, np.uint8))

    ref = ESAIndex(Sequence("ref", base), backend="native")
    threshold = 14

    monkeypatch.setenv("PHYLONIUM_TPU_MAP_ILP", "0")
    scalar = ref._native.map_queries(queries, threshold)
    monkeypatch.setenv("PHYLONIUM_TPU_MAP_ILP", "1")
    ilp = ref._native.map_queries(queries, threshold)
    assert len(scalar) == len(ilp)
    for s_h, i_h in zip(scalar, ilp):
        assert [
            (h.direction, h.index_reference, h.index_reference_projected,
             h.index_query, h.length)
            for h in s_h
        ] == [
            (h.direction, h.index_reference, h.index_reference_projected,
             h.index_query, h.length)
            for h in i_h
        ]


def test_gomp_link_args_fall_back_to_the_system_runtime(tmp_path):
    """A compiler that knows no libgomp of its own links the system's
    OpenMP runtime by soname."""
    import ctypes.util

    from phylonium_tpu.native.build import _gomp_link_args

    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\necho libgomp.so\n")
    fake.chmod(0o755)
    system = ctypes.util.find_library("gomp")
    want = [f"-l:{system}"] if system else ["-lgomp"]
    assert _gomp_link_args(str(fake)) == want
    assert _gomp_link_args(str(tmp_path / "missing")) == want


def test_build_links_openmp_and_leaves_no_temporaries(tmp_path, monkeypatch):
    """Compile and link run as two steps under process-private names;
    only the finished library is left in the build directory."""
    import ctypes

    import phylonium_tpu.native.build as nb

    monkeypatch.setattr(nb, "BUILD_DIR", tmp_path)
    path = nb.build()
    assert [p.name for p in tmp_path.iterdir()] == [nb.LIB_NAME]
    lib = ctypes.CDLL(str(path))
    lib.phy_num_procs.restype = ctypes.c_int
    # the OpenMP runtime answers (a build without it reports 1)
    assert lib.phy_num_procs() == len(os.sched_getaffinity(0))


def test_concurrent_threads_build_one_working_library(tmp_path, monkeypatch):
    """Threads of one process that all find the library missing build
    it once, and every one of them gets a complete library."""
    import ctypes
    import threading

    import phylonium_tpu.native.build as nb

    monkeypatch.setattr(nb, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def worker():
        try:
            paths.append(nb.ensure_built())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [nb.LIB_NAME]
    assert hasattr(ctypes.CDLL(str(paths[0])), "phy_index_build")
