"""Sharded counting on an 8-device virtual CPU mesh.

Counts are exact integer sums, so every mesh shape must give bit-identical
results to the single-device path.
"""

import jax
import numpy as np
import pytest

from phylonium_tpu.ops.device_counts import pair_counts_states
from phylonium_tpu.ops.match_table import pair_counts_numpy
from phylonium_tpu.parallel.distributed import pair_counts_sharded
from phylonium_tpu.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(0)
    # 6 genomes x 5000 columns with realistic state distribution
    s = rng.integers(0, 11, size=(6, 5000)).astype(np.uint8)
    # sprinkle invalid stretches
    s[2, 1000:2000] = 10
    return s


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2), (8, 1), (1, 1)])
def test_sharded_equals_single(states, shape):
    if shape == (1, 1):
        mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    else:
        mesh = make_mesh(shape)
    s_ref, h_ref = pair_counts_numpy(states)
    s, h = pair_counts_sharded(states, mesh)
    assert np.array_equal(s, s_ref)
    assert np.array_equal(h, h_ref)


def test_ragged_padding(states):
    # N not divisible by rows, L not divisible by cols*block
    mesh = make_mesh((4, 2))
    odd = states[:5, :4999]
    s_ref, h_ref = pair_counts_numpy(odd)
    s, h = pair_counts_sharded(odd, mesh)
    assert np.array_equal(s, s_ref)
    assert np.array_equal(h, h_ref)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_sharded_pallas_kernel_equals_single(states, shape):
    """The fused-kernel shard body (interpret mode on CPU) against the
    single-device entry point."""
    mesh = make_mesh(shape)
    s_ref, h_ref = pair_counts_states(states)
    s, h = pair_counts_sharded(states, mesh)
    assert np.array_equal(s, s_ref)
    assert np.array_equal(h, h_ref)


def test_pod_mesh_helpers(states):
    from phylonium_tpu.parallel.multihost import make_pod_mesh, pair_counts_pod

    mesh = make_pod_mesh()
    assert mesh.shape["rows"] * mesh.shape["cols"] == 8
    s, h = pair_counts_pod(states)
    s_ref, h_ref = pair_counts_numpy(states)
    assert np.array_equal(s, s_ref)
    assert np.array_equal(h, h_ref)
