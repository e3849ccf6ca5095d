"""ctypes bindings for the native host library.

Provides:
- ``NativeESA``: index build + longest_match + batch query mapping
  (the C++ counterpart of index/esa_numpy.py + core/anchors.py).
- ``build_sa``: standalone SA-IS for oracle tests.
- ``seqcmp`` / ``revseqcmp``: scalar mismatch kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np

from phylonium_tpu.core.homology import Homology
from phylonium_tpu.native.build import NativeBuildError, ensure_built

_lib = None


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = ensure_built()
        lib = ctypes.CDLL(str(path))

        lib.phy_index_build.restype = ctypes.c_void_p
        lib.phy_index_build.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        lib.phy_index_free.argtypes = [ctypes.c_void_p]
        lib.phy_index_size.restype = ctypes.c_int64
        lib.phy_index_size.argtypes = [ctypes.c_void_p]
        lib.phy_index_sa.restype = ctypes.POINTER(ctypes.c_int64)
        lib.phy_index_sa.argtypes = [ctypes.c_void_p]
        lib.phy_longest_match.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.phy_probe_unique.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.phy_map_query.restype = ctypes.c_int64
        lib.phy_map_query.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ]
        lib.phy_map_queries.restype = ctypes.c_int64
        lib.phy_map_queries.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.phy_free.argtypes = [ctypes.c_void_p]
        lib.phy_build_sa.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.phy_filter_nucl.restype = ctypes.c_int64
        lib.phy_filter_nucl.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.phy_fasta_scan.restype = ctypes.c_int64
        lib.phy_fasta_scan.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.phy_fasta_filter.restype = ctypes.c_int64
        lib.phy_fasta_filter.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.phy_seqcmp.restype = ctypes.c_int64
        lib.phy_seqcmp.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        lib.phy_revseqcmp.restype = ctypes.c_int64
        lib.phy_revseqcmp.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        lib.phy_set_threads.argtypes = [ctypes.c_int]
        lib.phy_num_procs.restype = ctypes.c_int
        lib.phy_build_pileup.restype = ctypes.c_int
        lib.phy_build_pileup.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.phy_pack_states.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.phy_pair_counts.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.phy_pack2.restype = ctypes.c_int64
        lib.phy_pack2.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        _lib = lib
    return _lib


def set_threads(n: int) -> None:
    """Cap the native backend's OpenMP thread count (the -t flag)."""
    if n > 0:
        try:
            get_lib().phy_set_threads(n)
        except Exception:
            pass


def num_procs() -> int:
    try:
        return int(get_lib().phy_num_procs())
    except Exception:
        return 1


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def build_sa(s: np.ndarray) -> np.ndarray:
    lib = get_lib()
    s = np.ascontiguousarray(s, dtype=np.uint8)
    out = np.empty(s.size, dtype=np.int64)
    lib.phy_build_sa(_u8ptr(s), s.size, _i64ptr(out))
    return out


def filter_nucl_native(raw: bytes) -> bytes:
    """One-pass ACGT filter + uppercase (data-model contract in
    data/sequence.filter_nucl)."""
    lib = get_lib()
    src = np.frombuffer(raw, dtype=np.uint8)
    dst = np.empty(max(src.size, 1), dtype=np.uint8)
    kept = int(
        lib.phy_filter_nucl(_u8ptr(src), src.size, _u8ptr(dst))
    )
    return dst[:kept].tobytes()


def fasta_filter_native(chunk: bytes) -> tuple[bytes, int, int]:
    """Fused FASTA body pass: (ACGT-filtered uppercased bytes, newline
    count, non-whitespace count) — the read-path contract in
    io/fasta.read_fasta; one traversal replaces strip + join + filter."""
    lib = get_lib()
    src = np.frombuffer(chunk, dtype=np.uint8)
    dst = np.empty(max(src.size, 1), dtype=np.uint8)
    nl = ctypes.c_int64(0)
    nonws = ctypes.c_int64(0)
    kept = int(
        lib.phy_fasta_filter(
            _u8ptr(src), src.size, _u8ptr(dst),
            ctypes.byref(nl), ctypes.byref(nonws),
        )
    )
    return dst[:kept].tobytes(), int(nl.value), int(nonws.value)


def fasta_scan_native(chunk: bytes) -> tuple[bytes, int]:
    """One pass over a FASTA body span: (whitespace-stripped bytes,
    newline count) — the parser contract in io/fasta._Parser.feed."""
    lib = get_lib()
    src = np.frombuffer(chunk, dtype=np.uint8)
    dst = np.empty(max(src.size, 1), dtype=np.uint8)
    nl = ctypes.c_int64(0)
    kept = int(
        lib.phy_fasta_scan(
            _u8ptr(src), src.size, _u8ptr(dst), ctypes.byref(nl)
        )
    )
    return dst[:kept].tobytes(), int(nl.value)


def seqcmp(a: np.ndarray, b: np.ndarray) -> int:
    lib = get_lib()
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    return int(lib.phy_seqcmp(_u8ptr(a), _u8ptr(b), a.size))


def revseqcmp(a: np.ndarray, b: np.ndarray) -> int:
    lib = get_lib()
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    return int(lib.phy_revseqcmp(_u8ptr(a), _u8ptr(b), a.size))


def build_pileup_native(
    queries: list[np.ndarray],
    homologies: list,
    ref_len: int,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Fill the [N, ref_len] state matrix in one native pass (OpenMP
    over genomes); layout contract in core/pileup.py.

    ``out`` (optional) writes into a caller-provided C-contiguous
    [N, ref_len] uint8 buffer — the streaming pipeline builds row
    groups directly into one big matrix this way."""
    lib = get_lib()
    n = len(queries)
    queries = [np.ascontiguousarray(q, dtype=np.uint8) for q in queries]
    qptrs = (ctypes.POINTER(ctypes.c_uint8) * max(n, 1))(
        *[_u8ptr(q) for q in queries]
    )
    qlens = np.array([q.size for q in queries], dtype=np.int64).reshape(n)
    counts = np.array([len(hv) for hv in homologies], dtype=np.int64)
    recs = np.zeros((int(counts.sum()), 4), dtype=np.int64)
    w = 0
    for hv in homologies:
        for h in hv:
            recs[w] = (
                h.direction,
                h.index_query,
                h.index_reference_projected,
                h.length,
            )
            w += 1
    if out is None:
        from phylonium_tpu.utils.bigalloc import empty as big_empty

        out = big_empty((n, ref_len), np.uint8)
    else:
        assert (
            out.shape == (n, ref_len)
            and out.dtype == np.uint8
            and out.flags.c_contiguous
        ), (out.shape, out.dtype)
    bad = np.zeros(1, dtype=np.int64)
    rc = lib.phy_build_pileup(
        qptrs,
        _i64ptr(qlens),
        _i64ptr(recs),
        _i64ptr(counts),
        n,
        ref_len,
        _u8ptr(out),
        _i64ptr(bad),
    )
    if rc:
        raise ValueError(
            f"unexpected byte {bytes([int(bad[0])])!r} in filtered sequence"
        )
    return out


def pack_states_native(
    states: np.ndarray, n_pad: int, width: int
) -> np.ndarray:
    """Split-layout nibble packing in one native pass (see
    ops/shapes.pack_states for the layout contract)."""
    lib = get_lib()
    from phylonium_tpu.utils.bigalloc import empty as big_empty

    states = np.ascontiguousarray(states, dtype=np.uint8)
    n, length = states.shape
    out = big_empty((n_pad, width), np.uint8)
    lib.phy_pack_states(
        _u8ptr(states), n, length, n_pad, width, _u8ptr(out)
    )
    return out


def pack2_native(
    queries: list[np.ndarray],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-pass 2-bit pack of concatenated queries (+ '!' separator
    positions and per-query base offsets) — the host side of the
    streamed device-pileup shipping path; layout contract in
    ops/pileup_device.pack_queries."""
    lib = get_lib()
    n = len(queries)
    queries = [np.ascontiguousarray(q, dtype=np.uint8) for q in queries]
    qptrs = (ctypes.POINTER(ctypes.c_uint8) * max(n, 1))(
        *[_u8ptr(q) for q in queries]
    )
    qlens = np.array([q.size for q in queries], dtype=np.int64)
    bases = np.zeros(n + 1, np.int64)
    if n:
        np.cumsum(qlens, out=bases[1:])
    total = int(bases[-1])
    if total == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64), bases
    packed = np.zeros(-(-total // 4), dtype=np.uint8)
    sep_cap = 4096
    while True:
        sep = np.zeros(max(sep_cap, 1), dtype=np.int64)
        nsep = lib.phy_pack2(
            qptrs, _i64ptr(qlens), n, _u8ptr(packed), packed.size,
            _i64ptr(sep), sep_cap,
        )
        if nsep <= sep_cap:
            return packed, sep[:nsep].copy(), bases
        sep_cap = int(nsep)


def pair_counts_range(
    states: np.ndarray,
    col_lo: int,
    col_hi: int,
    subs: np.ndarray,
    homs: np.ndarray,
) -> None:
    """Accumulate all-pairs (substitutions, homologs) over a column range.

    AVX2 nibble-shuffle kernel with OpenMP over pairs; the host-side
    counterpart of ops/pallas_match.py used by the adaptive compare
    backend while the device kernel compiles.  ``subs``/``homs`` are
    [n, n] int64 accumulators the caller zeroes once; chunking columns
    lets the caller poll for a faster backend between calls.
    """
    lib = get_lib()
    assert states.dtype == np.uint8 and states.flags.c_contiguous
    n, stride = states.shape
    lib.phy_pair_counts(
        _u8ptr(states),
        n,
        stride,
        col_lo,
        col_hi,
        _i64ptr(subs),
        _i64ptr(homs),
    )


def _decode_homologies(
    buf, counts: np.ndarray, raw: bool = False
) -> list:
    """Per-genome homology lists from the mapper's flat int64 buffer.

    ``raw=True`` returns [H, 5] int64 arrays (columns: direction,
    index_reference, index_reference_projected, index_query, length —
    HOMOLOGY_DTYPE order) instead of Homology objects: the low-memory
    pipeline keeps millions of homologies as 40 bytes each instead of
    ~400-byte Python objects.
    """
    total = int(counts.sum())
    flat = np.ctypeslib.as_array(buf, shape=(total * 5,)).copy()
    flat = flat.reshape(total, 5)
    out: list = []
    pos = 0
    for c in counts:
        rows = flat[pos : pos + int(c)]
        if raw:
            out.append(rows.copy())
        else:
            out.append(
                [
                    Homology(
                        int(r[0]), int(r[1]), int(r[2]), int(r[3]),
                        int(r[4]),
                    )
                    for r in rows
                ]
            )
        pos += int(c)
    return out


class NativeESA:
    """C++ suffix index over the doubled text S."""

    def __init__(self, S: np.ndarray):
        self._lib = get_lib()
        S = np.ascontiguousarray(S, dtype=np.uint8)
        self._S = S  # keep alive
        self._handle = self._lib.phy_index_build(_u8ptr(S), S.size)
        if not self._handle:
            raise NativeBuildError("index build failed")
        n = int(self._lib.phy_index_size(self._handle))
        sa_ptr = self._lib.phy_index_sa(self._handle)
        self.SA = np.ctypeslib.as_array(sa_ptr, shape=(n,))

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.phy_index_free(self._handle)
                self._handle = None
        except Exception:
            pass

    def longest_match(self, q: np.ndarray, qs: int, qlen: int
                      ) -> tuple[int, int, int]:
        out = np.empty(3, dtype=np.int64)
        sub = np.ascontiguousarray(q[qs : qs + qlen], dtype=np.uint8)
        self._lib.phy_longest_match(
            self._handle, _u8ptr(sub), sub.size, _i64ptr(out)
        )
        return int(out[0]), int(out[1]), int(out[2])

    def probe_unique(
        self, q: np.ndarray, min_len: int = 0
    ) -> tuple[int, int, bool]:
        """(len, text_pos, unique) — the chain loop's lean probe."""
        out = np.empty(3, dtype=np.int64)
        sub = np.ascontiguousarray(q, dtype=np.uint8)
        self._lib.phy_probe_unique(
            self._handle, _u8ptr(sub), sub.size, min_len, _i64ptr(out)
        )
        return int(out[0]), int(out[1]), bool(out[2])

    def map_query(self, q: np.ndarray, threshold: int) -> list[Homology]:
        q = np.ascontiguousarray(q, dtype=np.uint8)
        buf = ctypes.POINTER(ctypes.c_int64)()
        n = self._lib.phy_map_query(
            self._handle, _u8ptr(q), q.size, threshold, ctypes.byref(buf)
        )
        counts = np.array([n], dtype=np.int64)
        out = _decode_homologies(buf, counts)[0]
        self._lib.phy_free(buf)
        return out

    def map_queries(
        self,
        queries: list[np.ndarray],
        threshold: int,
        progress_out: np.ndarray | None = None,
        raw: bool = False,
    ) -> list:
        """Batch-map ``queries``; ``progress_out`` (shape-[1] int64) is
        incremented per completed query for live progress polling.

        The native call is chunked (default 32 queries): the wrapper
        copies the batch's text into one buffer BEFORE mapping starts,
        so chunks that fit in L3 are still cache-resident when the
        latency-bound chain probes read them, while a whole-panel copy
        is long evicted by the time the mapper reaches its tail —
        measured ~2x at every driver scale (600x1M single call
        14.7-16.5 s vs 8.0-8.4 s; 116x5M 18.5-19.7 s vs 9.9-10.8 s).
        Outputs are identical for any chunking (the mapper is
        per-query); tunable via PHYLONIUM_TPU_MAP_BATCH, 0 = one call.
        """
        import os

        try:
            batch = int(os.environ.get("PHYLONIUM_TPU_MAP_BATCH", "32"))
        except ValueError:
            batch = 32
        if batch > 0 and len(queries) > batch:
            out: list = []
            for lo in range(0, len(queries), batch):
                out.extend(
                    self.map_queries(
                        queries[lo : lo + batch],
                        threshold,
                        progress_out=progress_out,
                        raw=raw,
                    )
                )
            return out
        from phylonium_tpu.utils.bigalloc import empty as big_empty

        offsets = np.zeros(len(queries) + 1, dtype=np.int64)
        np.cumsum([q.size for q in queries], out=offsets[1:])
        qdata = big_empty((int(offsets[-1]),), np.uint8)
        for q, lo, hi in zip(queries, offsets, offsets[1:]):
            qdata[lo:hi] = np.ascontiguousarray(q, dtype=np.uint8)
        counts = np.zeros(len(queries), dtype=np.int64)
        buf = ctypes.POINTER(ctypes.c_int64)()
        self._lib.phy_map_queries(
            self._handle,
            _u8ptr(qdata),
            _i64ptr(offsets),
            len(queries),
            threshold,
            _i64ptr(counts),
            ctypes.byref(buf),
            _i64ptr(progress_out) if progress_out is not None else None,
        )
        out = _decode_homologies(buf, counts, raw=raw)
        self._lib.phy_free(buf)
        return out
