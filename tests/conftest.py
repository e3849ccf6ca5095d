"""Test configuration: force an 8-device virtual CPU mesh.

All tests run on the CPU backend with 8 virtual devices so sharding /
collective tests exercise real multi-device paths without a GPU (the
Pallas kernel runs in interpret mode).  The device path on a real card
is checked by ``chip_smoke.py``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# pin the platform through the config API too, so a visible
# accelerator never takes precedence over the virtual CPU mesh
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def random_genome(rng, length: int) -> bytes:
    return bytes(b"ACGT"[int(c)] for c in rng.integers(0, 4, length))


def mutate(seq: bytes, p: float, rng) -> bytes:
    """Substitute a fraction p of positions (never to the same base)."""
    q = bytearray(seq)
    positions = np.where(rng.random(len(seq)) < p)[0]
    for i in positions:
        q[i] = b"ACGT"[(b"ACGT".index(q[i]) + int(rng.integers(1, 4))) % 4]
    return bytes(q)


@pytest.fixture
def make_genome():
    return random_genome


@pytest.fixture
def make_mutant():
    return mutate
