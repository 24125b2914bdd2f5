"""The port's brick-sharded fusion (``reconplan_tpu_torch.parallel``)
against its own single-grid path and against ``reconplan_tpu.parallel.brick``
on the 8 host devices that ``conftest.py`` forces.

Scene: the 128x256 sphere, 2 views, on a 32^3 grid (32 bricks, 4 per
shard), as in ``test_brick_sharded_matches_single_device``. Every shard
of the port lies on the CPU, so K3 runs as its plain version. Against
JAX the tolerances of ``test_torch_brick_k3.py`` hold (weights equal but
for the TPU kernel's window tail, sdf within two ulps of z over trunc);
against the port's own single grid the planes are bit-identical.
"""

import jax
import numpy as np
import pytest
import torch

from reconplan_tpu.parallel import brick as jpb
from reconplan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.parallel import (
    gather_brick_grid,
    make_mesh,
    make_sharded_brick_grid,
    sharded_brick_grid_from_numpy,
    sharded_brick_grid_to_numpy,
    sharded_integrate_frames_bricked,
)
from test_torch_brick_k3 import SDF_TOL
from test_tsdf_marching import make_sphere_depths
from torch_parity import same_inverse

torch.set_num_threads(2)

DIMS = (32, 32, 32)
ORIGIN = (-0.15,) * 3
VOX = 0.3 / 31
CPU8 = ["cpu"] * 8


def _mesh(n=8):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def scene():
    return make_sphere_depths(n_views=2, H=128, W=256, fx=120.0, fy=120.0)


@pytest.fixture(scope="module")
def port_sharded(scene):
    depths, poses, K = scene
    g_nbl = make_sharded_brick_grid(DIMS, ORIGIN, VOX, mesh=_mesh())
    assert g_nbl[1] == 4 and len(g_nbl[0].sdf) == 8
    return sharded_integrate_frames_bricked(
        g_nbl, depths, poses, *K, max_active_per_device=64)


def test_sharded_matches_single_grid_bitexact(scene, port_sharded):
    depths, poses, K = scene
    g_nbl, na = port_sharded
    sdf_s, w_s = tb.to_dense(gather_brick_grid(g_nbl))
    bg = tb.make_brick_grid(DIMS, ORIGIN, VOX, device="cpu")
    bg, na1 = tb.integrate_frames_bricked(bg, depths, poses, *K,
                                          dilate_active=False)
    sdf_1, w_1 = tb.to_dense(bg)
    assert int(na) == na1 > 0
    assert torch.equal(sdf_s, sdf_1) and torch.equal(w_s, w_1)
    assert w_s.max() > 0


def test_sharded_matches_jax_sharded(scene, port_sharded):
    depths, poses, K = scene
    mesh = jax_make_mesh(8)
    gj = jpb.make_sharded_brick_grid(DIMS, ORIGIN, VOX, mesh=mesh)
    with same_inverse():
        gj, na_j = jpb.sharded_integrate_frames_bricked(
            gj, depths, poses, *K, mesh=mesh, max_active_per_device=64,
            interpret=True)
    g_nbl, na = port_sharded
    assert int(na) == int(na_j)
    port = sharded_brick_grid_to_numpy(g_nbl)
    ref_sdf, ref_w = np.asarray(gj[0].sdf), np.asarray(gj[0].weight)
    assert port["sdf"].shape == ref_sdf.shape == (8 * 5, 8, 128)
    assert (port["weight"] != ref_w).mean() <= 0.001
    same = (port["weight"] == ref_w) & (ref_w > 0)
    assert same.sum() > 5000
    diff = np.abs(port["sdf"] - ref_sdf)[same]
    assert diff.max() <= SDF_TOL, (diff.max(), SDF_TOL)


def test_sharded_state_carries_from_jax():
    """A JAX sharded grid, gathered to numpy, becomes a port sharded grid
    plane for plane, and both gather to the same single grid."""
    mesh = jax_make_mesh(8)
    rng = np.random.default_rng(5)
    gj, nbl = jpb.make_sharded_brick_grid(DIMS, ORIGIN, VOX, mesh=mesh)
    sdf = rng.uniform(-1, 1, gj.sdf.shape).astype(np.float32)
    w = rng.integers(0, 5, gj.weight.shape).astype(np.float32)
    gj = gj._replace(sdf=jax.device_put(sdf, gj.sdf.sharding),
                     weight=jax.device_put(w, gj.weight.sharding))
    g_nbl = sharded_brick_grid_from_numpy(
        np.asarray(gj.sdf), np.asarray(gj.weight), gj.dims,
        np.asarray(gj.origin), gj.voxel_size, gj.trunc, _mesh())
    assert g_nbl[1] == nbl
    back = sharded_brick_grid_to_numpy(g_nbl)
    np.testing.assert_array_equal(back["sdf"], sdf)
    np.testing.assert_array_equal(back["weight"], w)
    assert back["dims"] == DIMS and back["trunc"] == gj.trunc
    ref = jpb.gather_brick_grid((gj, nbl), mesh=mesh)
    got = gather_brick_grid(g_nbl)
    np.testing.assert_array_equal(got.sdf.numpy(), np.asarray(ref.sdf))
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(ref.weight))


def test_shard_cap_drops_bricks_and_count_stays_unclamped(scene,
                                                         port_sharded):
    depths, poses, K = scene
    g_nbl = make_sharded_brick_grid(DIMS, ORIGIN, VOX, mesh=_mesh())
    g_nbl, na = sharded_integrate_frames_bricked(
        g_nbl, depths, poses, *K, max_active_per_device=1)
    assert int(na) == int(port_sharded[1])
    touched = [int((w[:-1].reshape(4, -1) > 0).any(1).sum())
               for w in g_nbl[0].weight]
    assert max(touched) <= 1 < int(na)
    for w in g_nbl[0].weight:  # the scratch rows stay empty
        assert not w[-1].any()


def test_bricks_must_divide_into_shards():
    with pytest.raises(ValueError, match="divisible"):
        make_sharded_brick_grid(DIMS, ORIGIN, VOX, mesh=_mesh(5))
