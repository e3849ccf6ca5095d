"""Sharded all-pairs counting over a device mesh.

The pileup ``[N, L]`` (state bytes, or nibble-packed ``[N, L/2]`` when
the streamed multi-process feeder built it on the devices) is sharded
``P('rows', 'cols')``:

- each device holds a genome block x column block;
- it ``all_gather``s the other genome blocks' states *for its own column
  shard only* (communication rides the ``rows`` axis, volume
  N*width/cols per device);
- computes its [N_loc, N] block of per-column-shard counts with the
  same fused kernel as the single-device path (ops/device_counts);
- ``psum`` over ``cols`` merges the exact integer partials.

Counts are commutative integer sums, so the result is bit-identical to
the single-device path for any mesh shape — asserted in
tests/test_parallel.py on an 8-device CPU mesh.  The collectives are
plain ``all_gather`` and ``psum``; every device reaches every other at
the same rate, so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from phylonium_tpu.core.pileup import INVALID
from phylonium_tpu.ops.shapes import (
    COL_CHUNK,
    _PACKED_PAD,
    pad_rows,
    tile_for,
)


def _local_counts(states_local: jnp.ndarray, symmetric: bool,
                  packed: bool, interpret: bool):
    """Shard counts: my rows x all rows of my column shard.

    The 'rows'-axis all_gather is the path's only bulk inter-device
    data movement.  On a one-row mesh (``symmetric``) the gathered block
    IS the local one, and the kernel computes only the upper triangle.
    """
    from phylonium_tpu.ops.device_counts import cross_counts

    fill = _PACKED_PAD if packed else INVALID

    def pad_to(x, rows):
        return jnp.pad(
            x, ((0, rows - x.shape[0]), (0, 0)), constant_values=fill
        )

    # the kernel's row tiles are padded here, inside the shard, so the
    # row blocks themselves (and each process's mapping share) stay
    # ceil(N / rows) genomes
    na = states_local.shape[0]
    na_pad = pad_rows(na)
    mine = pad_to(states_local, na_pad)
    if symmetric:
        everyone, nb = mine, na
    else:
        gathered = jax.lax.all_gather(states_local, "rows", axis=0, tiled=True)
        nb = gathered.shape[0]
        tile = tile_for(na_pad)
        everyone = pad_to(gathered, -(-nb // tile) * tile)
    m, h = cross_counts(
        mine, everyone, packed=packed, symmetric=symmetric,
        interpret=interpret,
    )
    m, h = m[:na, :nb], h[:na, :nb]
    return jax.lax.psum(m, "cols"), jax.lax.psum(h, "cols")


@functools.partial(
    jax.jit, static_argnames=("mesh", "n_rows", "packed", "interpret"),
)
def _sharded_counts_jit(states, mesh, n_rows, packed, interpret):
    local = functools.partial(
        _local_counts, symmetric=n_rows == 1, packed=packed,
        interpret=interpret,
    )
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P("rows", "cols"),
        out_specs=(P("rows", None), P("rows", None)),
        # pallas_call out_shapes carry no varying-mesh-axes annotation
        check_vma=False,
    )
    return fn(states)


def _sharded_counts(states, mesh, n_rows: int, packed: bool):
    """(matches, homs) [N_pad, N_pad] of a sharded panel; the kernel
    runs in interpret mode only on CPU-pinned runs (tests)."""
    from phylonium_tpu.utils.platform import cpu_pinned

    return _sharded_counts_jit(states, mesh, n_rows, packed, cpu_pinned())


def sharded_shape(
    n: int, length: int, n_rows: int, n_cols: int, packed: bool
) -> tuple[int, int, int]:
    """Single source of truth for the sharded counting call geometry.

    Returns ``(plen, n_pad, l_pad)`` — the column count of the shipped
    layout (half the pileup width when nibble-packed), padded genome
    count (a whole number of rows per row shard) and padded column
    count (a whole number of kernel column chunks per column shard) —
    shared by the host-shipped path (:func:`pair_counts_sharded`), the
    resident-shard streamed path (parallel/stream_mp.py) and the
    communication account, so the feeder-built shards are
    bit-compatible with what the collective program expects.
    """
    plen = -(-max(length, 1) // 2) if packed else max(length, 1)
    n_pad = n + (-n) % n_rows
    step = n_cols * COL_CHUNK
    l_pad = -(-plen // step) * step
    return plen, n_pad, l_pad


def gathered_counts(m, h, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Collect sharded [N_pad, N_pad]-block (matches, homolog) outputs
    into full host int64 (substitutions, homologs) matrices."""
    if not m.is_fully_addressable:
        from jax.experimental import multihost_utils

        m = multihost_utils.process_allgather(m, tiled=True)
        h = multihost_utils.process_allgather(h, tiled=True)
    m = np.asarray(m, dtype=np.int64)[:n, :n]
    h = np.asarray(h, dtype=np.int64)[:n, :n]
    subs = h - m
    np.fill_diagonal(subs, 0)
    np.fill_diagonal(h, 0)
    return subs, h


_HLO_DTYPE_BYTES = {
    "pred": 1, "u8": 1, "s8": 1, "u16": 2, "s16": 2, "bf16": 2,
    "f16": 2, "u32": 4, "s32": 4, "f32": 4, "u64": 8, "s64": 8,
    "f64": 8,
}


def _shape_bytes(shape_text: str) -> int:
    """Bytes of one HLO shape literal like ``u8[48,512]``."""
    import re

    m = re.match(r"(\w+)\[([\d,]*)\]", shape_text)
    if not m:
        return 0
    dtype, dims = m.groups()
    size = _HLO_DTYPE_BYTES.get(dtype, 0)
    for d in dims.split(","):
        if d:
            size *= int(d)
    return size


def collective_bytes(hlo_text: str) -> dict[str, dict[str, int]]:
    """Per-collective traffic in a compiled HLO module.

    Returns {op: {"out": bytes, "in": bytes, "count": n}} summed over
    every all-gather / all-reduce / reduce-scatter / all-to-all /
    collective-permute instruction.  For an all-gather, the bytes a
    device actually RECEIVES over the interconnect are out - in (its
    own shard is local).
    """
    import re

    ops = (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute",
    )
    out: dict[str, dict[str, int]] = {}
    pat = re.compile(
        r"=\s+(\([^)]*\)|\w+\[[\d,]*\])\S*\s+(%s)\(([^)]*)\)"
        % "|".join(ops)
    )
    shape_pat = re.compile(r"\w+\[[\d,]*\]")
    for m in pat.finditer(hlo_text):
        result, op, operands = m.groups()
        rec = out.setdefault(op, {"out": 0, "in": 0, "count": 0})
        rec["count"] += 1
        rec["out"] += sum(
            _shape_bytes(s) for s in shape_pat.findall(result)
        )
        rec["in"] += sum(
            _shape_bytes(s) for s in shape_pat.findall(operands)
        )
    return out


def comm_account(
    n: int,
    length: int,
    mesh: jax.sharding.Mesh,
) -> dict:
    """Predicted vs compiled per-device communication volume for one
    sharded counting run (no execution — abstract lowering only).

    Prediction (module docstring): the only bulk movement is the
    'rows'-axis all_gather of genome-block states for this device's
    column shard — each device RECEIVES (rows-1)/rows * N * Lc bytes,
    Lc = ceil(L / cols) — plus two [N_loc, N] int32 psums.
    The measured side parses the compiled HLO's collective
    instructions, so the account reflects what XLA actually emits.
    """
    from phylonium_tpu.utils.platform import cpu_pinned

    n_rows = mesh.shape["rows"]
    n_cols = mesh.shape["cols"]
    plen, n_pad, l_pad = sharded_shape(n, length, n_rows, n_cols, False)

    sharding = NamedSharding(mesh, P("rows", "cols"))
    spec = jax.ShapeDtypeStruct((n_pad, l_pad), np.uint8, sharding=sharding)
    hlo = (
        _sharded_counts_jit.lower(spec, mesh, n_rows, False, cpu_pinned())
        .compile()
        .as_text()
    )
    measured = collective_bytes(hlo)
    gather = measured.get("all-gather", {"out": 0, "in": 0})
    # HLO may print operands as bare %names (no shape): the gathered
    # output then stands in — a 'rows'-group gather receives
    # (rows-1)/rows of it over the interconnect, the rest is local
    recv = (
        gather["out"] - gather["in"]
        if gather["in"]
        else gather["out"] * (n_rows - 1) // max(n_rows, 1)
    )
    lc = l_pad // n_cols
    predicted_gather = (n_rows - 1) * (n_pad // n_rows) * lc
    predicted_psum = 2 * (n_pad // n_rows) * n_pad * 4
    return {
        "mesh": (n_rows, n_cols),
        "panel": (n, length),
        "sharded_bytes_per_device": n_pad * l_pad // (n_rows * n_cols),
        "predicted_gather_recv_bytes": predicted_gather,
        "measured_gather_recv_bytes": recv,
        "predicted_psum_bytes": predicted_psum,
        "measured": measured,
    }


def pair_counts_sharded(
    states: np.ndarray,
    mesh: jax.sharding.Mesh,
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (substitutions, homologs) over a ('rows','cols') mesh."""
    n, length = states.shape
    n_rows = mesh.shape["rows"]
    n_cols = mesh.shape["cols"]
    plen, n_pad, l_pad = sharded_shape(n, length, n_rows, n_cols, False)
    # state bytes ship as they are: on local cards the transfer costs
    # less than nibble-packing on the host (PERF.md)
    if (n_pad, l_pad) != states.shape:
        states = np.pad(
            states, ((0, n_pad - n), (0, l_pad - length)),
            constant_values=INVALID,
        )

    sharding = NamedSharding(mesh, P("rows", "cols"))
    if jax.process_count() > 1:
        # multi-host: every process holds the full states array; hand
        # each device its addressable shard
        states_dev = jax.make_array_from_callback(
            states.shape, sharding, lambda idx: states[idx]
        )
    else:
        states_dev = jax.device_put(states, sharding)
    m, h = _sharded_counts(states_dev, mesh, n_rows, False)
    return gathered_counts(m, h, n)
