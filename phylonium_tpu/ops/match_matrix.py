"""Plain XLA reference of the device counting kernel.

Converts a pileup state block into one-hot planes in device memory and
contracts them with ordinary einsums.  For a column block ``blk`` of
shape [N, B]:

    P[n, b, s] = 1{blk[n, b] == s}                (10 state planes, bf16)
    Q[m, b, s] = MATCH_TABLE[s, blk[m, b]]        (applied by matmul)
    matches   += einsum('nbs,mbs->nm', P, Q)      (one [N, 10B] x [10B, N])
    homologs  += einsum('nb,mb->nm', V, V)        (validity plane)

Exactness: all inputs are 0/1 (exact in bf16) and each block contributes
at most B <= 2^22 to any f32 accumulator cell, well inside the 2^24 exact
-integer range of f32.

The fused kernel (ops/pallas_match.py) computes the same counts without
writing the ~40 bytes per genome-column these planes take; it replaced
this formulation on the device path because it is faster at every panel
shape measured (PERF.md).  This stays as the plain reference the kernel
is tested and timed against.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from phylonium_tpu.core.pileup import INVALID, N_STATES
from phylonium_tpu.ops.match_table import MATCH_TABLE


def block_counts(blk: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(matches, homologs) int32 [N, N] for one column block [N, B]."""
    # the valid 10x10 corner of the match table
    mt = jnp.asarray(
        MATCH_TABLE[:N_STATES, :N_STATES].astype(np.float32),
        dtype=jnp.bfloat16,
    )
    valid = (blk != INVALID).astype(jnp.bfloat16)  # [N, B]
    planes = (
        blk[..., None] == jnp.arange(N_STATES, dtype=blk.dtype)
    ).astype(jnp.bfloat16)  # [N, B, 10]
    # apply the match table by matmul, not gather: per-element gathers
    # of a tiny table are slow
    q = jnp.einsum(
        "nbt,st->nbs", planes, mt, preferred_element_type=jnp.bfloat16
    )  # [N, B, 10], values 0/1

    matches = jnp.einsum(
        "nbs,mbs->nm", planes, q, preferred_element_type=jnp.float32
    )
    homs = jnp.einsum(
        "nb,mb->nm", valid, valid, preferred_element_type=jnp.float32
    )
    return matches.astype(jnp.int32), homs.astype(jnp.int32)
