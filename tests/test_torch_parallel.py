"""The port's z-sharded dense fusion and sharded IK
(``reconplan_tpu_torch.parallel``): twins of ``tests/test_parallel.py``
on ``make_mesh(devices=["cpu"] * 8)``, against the port's one-device
runs bit for bit and against ``reconplan_tpu.parallel`` on the 8 host
devices that ``conftest.py`` forces.

Against JAX the dense grids are held as ``tests/test_torch_tsdf.py``
holds them (the JAX side op by op with PyTorch's inverse): weights equal,
sdf and color within 1e-6 (measured: 0 at 64^3 and, with color, at
32^3). Sharded IK against the JAX ``sharded_ik_solve`` (jitted): success
equal, configs within ``CFG_TOL`` = 1e-4 (measured: 0, 16 of 16 solved).

The two-chunk cases: a (272, 256, 256) grid is 17.8M voxels, so the
dense engine cuts it into 2 z-chunks of 136 rows (it cuts only above
2^24 voxels). Over 8 shards the slabs of chunk 1 need that chunk's z0;
over 17 the slab of rows 128-144 spans the boundary at 136. The sphere
sits on that boundary. A slab that shifted its origin or cut chunks of
its own would round some voxel's z otherwise and part from the one
grid.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.io.config import load_problem as jax_load_problem
from reconplan_tpu.kin import robot as jrobot
from reconplan_tpu.parallel import fusion as jfusion
from reconplan_tpu.parallel import ik as jik
from reconplan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from reconplan_tpu_torch.io.config import load_problem
from reconplan_tpu_torch.kin import robot as trobot
from reconplan_tpu_torch.kin.ik import dls_ik_batch
from reconplan_tpu_torch.ops import tsdf as ttsdf
from reconplan_tpu_torch.parallel import (
    gather_grid,
    make_mesh,
    make_sharded_grid,
    replicate,
    shard_grid,
    sharded_grid_from_numpy,
    sharded_grid_to_numpy,
    sharded_ik_solve,
    sharded_integrate_frames,
)
from reconplan_tpu_torch.parallel.mesh import shard_batch
from test_parallel import _sphere_frames

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8
CFG_TOL = 1e-4


def _color_frames(depths):
    F, H, W = depths.shape
    colors = np.zeros((F, H, W, 3), np.float32)
    colors[..., 0] = np.linspace(0, 1, W)[None, None, :]
    colors[..., 2] = 0.5
    return colors


def _port_both(dims, origin, vox, n_shards, depths, poses, K, colors=None):
    """(one grid, gathered sharded grid) of the port on the CPU."""
    with_color = colors is not None
    one = ttsdf.integrate_frames(
        ttsdf.make_grid(dims, origin, vox, with_color=with_color,
                        device="cpu"), depths, poses, *K, colors=colors)
    mesh = make_mesh(devices=["cpu"] * n_shards)
    g = make_sharded_grid(dims, origin, vox, mesh=mesh, with_color=with_color)
    g = sharded_integrate_frames(g, depths, poses, *K, mesh=mesh,
                                 colors=colors)
    assert len(g.slabs) == n_shards and g.shape == tuple(dims)
    return one, gather_grid(g)


def _assert_same(a, b):
    assert torch.equal(a.sdf, b.sdf) and torch.equal(a.weight, b.weight)
    assert torch.equal(a.color, b.color)


def _assert_like_jax(port, jgrid):
    """Weights equal, sdf and color within 1e-6."""
    np.testing.assert_array_equal(port.weight.numpy(),
                                  np.asarray(jgrid.weight))
    assert np.abs(port.sdf.numpy() - np.asarray(jgrid.sdf)).max() <= 1e-6
    if port.has_color:
        cdiff = np.abs(port.color.numpy() - np.asarray(jgrid.color))
        assert cdiff.max() <= 1e-6, cdiff.max()


@contextlib.contextmanager
def jax_eager_sharded():
    """``torch_parity.jax_eager`` for sharded arrays: op by op, with
    PyTorch's inverse taken on the host as an uncommitted array (the
    ``pure_callback`` of ``jax_eager`` gives a one-device sharding that
    an eager gather over the sharded grid refuses)."""
    orig = jnp.linalg.inv
    jnp.linalg.inv = lambda p: jnp.asarray(
        torch.linalg.inv(torch.from_numpy(np.array(p))).numpy())
    try:
        with jax.disable_jit():
            yield
    finally:
        jnp.linalg.inv = orig


def _jax_sharded(dims, origin, vox, depths, poses, K, colors=None, grid=None):
    mesh = jax_make_mesh(8)
    if grid is None:
        grid = jfusion.make_sharded_grid(dims, origin, vox, mesh=mesh,
                                         with_color=colors is not None)
    with jax_eager_sharded():
        return jfusion.gather_grid(jfusion.sharded_integrate_frames(
            grid, depths, poses, *K, mesh=mesh, colors=colors))


class TestZShardedFusion:
    def test_z_sharded_matches_single_device(self):
        depths, poses, K = _sphere_frames()
        dims, vox, origin = (64, 64, 64), 0.5 / 63, (-0.25,) * 3
        one, got = _port_both(dims, origin, vox, 8, depths, poses, K)
        _assert_same(got, one)
        assert (got.weight > 0).sum() > 100
        _assert_like_jax(got, _jax_sharded(dims, origin, vox, depths, poses,
                                           K))

    def test_z_sharded_color_matches_single(self):
        depths, poses, K = _sphere_frames()
        colors = _color_frames(depths)
        dims, vox, origin = (32, 32, 32), 0.5 / 31, (-0.25,) * 3
        one, got = _port_both(dims, origin, vox, 8, depths, poses, K, colors)
        _assert_same(got, one)
        assert got.has_color and got.color.shape == (32, 32, 32, 3)
        _assert_like_jax(got, _jax_sharded(dims, origin, vox, depths, poses,
                                           K, colors))


@pytest.fixture(scope="module")
def two_chunk_one_grid():
    """The one grid of the two-chunk case: rows 0-135 and 136-271, the
    sphere of radius 0.1 around row 136 (4 mm voxels)."""
    depths, poses, K = _sphere_frames()
    dims, vox = (272, 256, 256), 0.004
    origin = (-0.5, -0.5, -136 * vox)
    assert ttsdf._chunking(*dims) == (2, 136)
    one = ttsdf.integrate_frames(
        ttsdf.make_grid(dims, origin, vox, device="cpu"), depths, poses, *K)
    w = one.weight
    assert (w[:136] > 0).sum() > 10_000 and (w[136:] > 0).sum() > 10_000
    return (dims, origin, vox, depths, poses, K), one


@pytest.mark.parametrize("n_shards", [8, 17])
def test_two_chunk_slabs_match_single_grid(two_chunk_one_grid, n_shards):
    (dims, origin, vox, depths, poses, K), one = two_chunk_one_grid
    mesh = make_mesh(devices=["cpu"] * n_shards)
    g = make_sharded_grid(dims, origin, vox, mesh=mesh)
    g = sharded_integrate_frames(g, depths, poses, *K)
    assert g.slabs[0].shape[0] == 272 // n_shards
    _assert_same(gather_grid(g), one)


def test_sharded_state_carries_from_jax():
    """A JAX sharded grid with two frames fused, taken to numpy, becomes a
    port sharded grid; a third and fourth frame into both agree."""
    depths, poses, K = _sphere_frames(n_views=4)
    colors = _color_frames(depths)
    dims, vox, origin = (32, 32, 32), 0.5 / 31, (-0.25,) * 3
    mesh = jax_make_mesh(8)
    gj = jfusion.make_sharded_grid(dims, origin, vox, mesh=mesh,
                                   with_color=True)
    with jax_eager_sharded():
        gj = jfusion.sharded_integrate_frames(
            gj, depths[:2], poses[:2], *K, mesh=mesh, colors=colors[:2])
    fields = {k: np.asarray(getattr(gj, k)) for k in (
        "sdf", "weight", "color", "origin", "voxel_size", "trunc")}
    gt = sharded_grid_from_numpy(**fields, mesh=make_mesh(devices=CPU8))
    back = sharded_grid_to_numpy(gt)
    for k in ("sdf", "weight", "color", "origin"):
        np.testing.assert_array_equal(back[k], fields[k])
    gt = sharded_integrate_frames(gt, depths[2:], poses[2:], *K,
                                  colors=colors[2:])
    jg = _jax_sharded(dims, origin, vox, depths[2:], poses[2:], K,
                      colors[2:], grid=gj)
    _assert_like_jax(gather_grid(gt), jg)


def test_grid_depth_must_divide_into_shards():
    with pytest.raises(ValueError, match="divisible"):
        make_sharded_grid((30, 8, 8), (0, 0, 0), 0.01,
                          mesh=make_mesh(devices=CPU8))
    with pytest.raises(ValueError, match="divisible"):
        jfusion.make_sharded_grid((30, 8, 8), (0, 0, 0), 0.01,
                                  mesh=jax_make_mesh(8))


def test_placements_put_rows_and_copies():
    """``shard_grid`` / ``shard_batch`` give each shard its rows,
    ``replicate`` one copy a distinct device; an axis that does not divide
    or a foreign axis name raises, as ``jax.device_put`` does."""
    mesh = make_mesh(devices=["cpu"] * 4)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    rows = shard_batch(mesh).put(x)
    assert [r.tolist() for r in rows] == [x[2 * i:2 * i + 2].tolist()
                                          for i in range(4)]
    copies = replicate(mesh).put(x)
    assert all(c is copies[0] for c in copies) and torch.equal(copies[0], x)
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(mesh).put(x[:6])
    with pytest.raises(ValueError):
        shard_grid(mesh).put(x)  # a (D, H, W) spec on a 2-D tensor
    with pytest.raises(ValueError):
        shard_batch(mesh, "batch")
    assert mesh.size == 4 and mesh.first_shard == 0 and mesh.group is None
    assert make_mesh(2, devices=["cpu"] * 4).size == 2


@pytest.fixture(scope="module")
def ur10s():
    """(JAX UR10, port UR10 on the CPU) of ``rot_free``, with the JAX
    test's 16 seeds and their FK targets."""
    opts = load_problem("ur10", "rot_free")
    assert opts == jax_load_problem("ur10", "rot_free")
    tr = trobot.make_robot(opts, device="cpu")
    seeds = tr.sample(16, rng=np.random.default_rng(3))
    targets = tr.fk_point_batch(seeds)[:, :3].numpy()
    return jrobot.make_robot(opts), tr, seeds, targets


class TestShardedIK:
    def test_sharded_ik_matches_unsharded(self, ur10s):
        jr, tr, seeds, targets = ur10s
        pos, rotm, use_rot = tr._ik_targets(targets)
        ref = dls_ik_batch(tr.model, tr._active_tuple, tr.ee_link, pos, rotm,
                           torch.as_tensor(seeds), tr._q_rest, max_iters=100,
                           tolerance=1e-3, use_rotation=use_rot)
        q, ok = sharded_ik_solve(tr, targets, seeds,
                                 mesh=make_mesh(devices=CPU8))
        assert torch.equal(ok, ref.success) and torch.equal(q, ref.config)
        assert ok.float().mean() > 0.8
        qj, okj = jik.sharded_ik_solve(jr, targets, seeds,
                                       mesh=jax_make_mesh(8))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
        assert np.abs(q.numpy() - np.asarray(qj)).max() <= CFG_TOL

    def test_sharded_ik_rejects_bad_batch(self, ur10s):
        jr, tr, _, _ = ur10s
        bad = (np.zeros((7, 3), np.float32),
               np.zeros((7, tr.num_joints), np.float32))
        with pytest.raises(ValueError, match="not divisible"):
            sharded_ik_solve(tr, *bad, mesh=make_mesh(devices=CPU8))
        with pytest.raises(ValueError, match="not divisible"):
            jik.sharded_ik_solve(jr, *bad, mesh=jax_make_mesh(8))


def test_the_slice_as_a_whole(ur10s):
    """Mesh, z-sharded fusion and sharded IK through the package's
    exports, on one 8-shard mesh: the same answers as the JAX package."""
    jr, tr, seeds, targets = ur10s
    mesh = make_mesh(devices=CPU8)
    depths, poses, K = _sphere_frames()
    dims, vox, origin = (32, 32, 32), 0.5 / 31, (-0.25,) * 3
    g = sharded_integrate_frames(make_sharded_grid(dims, origin, vox,
                                                   mesh=mesh),
                                 depths, poses, *K, mesh=mesh)
    _assert_like_jax(gather_grid(g), _jax_sharded(dims, origin, vox, depths,
                                                  poses, K))
    q, ok = sharded_ik_solve(tr, targets, seeds, mesh=mesh)
    qj, okj = jik.sharded_ik_solve(jr, targets, seeds, mesh=jax_make_mesh(8))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    assert np.abs(q.numpy() - np.asarray(qj)).max() <= CFG_TOL
