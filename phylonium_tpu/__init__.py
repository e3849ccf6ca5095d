"""phylonium-tpu: accelerated alignment-free evolutionary distance engine.

A brand-new JAX/XLA/Pallas framework with the capabilities of
EvolBioInf/phylonium (reference: /root/reference): estimation of pairwise
evolutionary distances between closely related genomes without alignment.

Architecture (accelerator-first, not a port):

- Host (C++ / numpy): FASTA streaming, suffix-array construction (SA-IS),
  ESA longest-match queries, anchor chaining, homology interval algebra.
- Device (XLA / Pallas): the O(N^2 * L) pairwise mismatch counting is
  recast as a *reference-projected pileup*: each genome becomes a row of
  per-reference-column states (base x strand); all-pairs substitution /
  homolog counts are then exact integer matmuls over one-hot planes --
  tensor-core work instead of the reference's SIMD byte loops
  (libs/seqcmp*.c, libs/revseqcmp*.c).
- Mesh: pileup column blocks are data-parallel over a `jax.sharding.Mesh`;
  per-block integer counts merge with `psum` (exact, order-independent).
"""

__version__ = "0.1.0"

from phylonium_tpu.data.sequence import Sequence, Genome  # noqa: F401
from phylonium_tpu.api import DistanceResult, distance_matrix  # noqa: F401
