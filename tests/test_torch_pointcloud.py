"""``reconplan_tpu_torch.ops.pointcloud`` against the JAX package on the
CPU, and port-only twins of ``tests/test_ops_pointcloud.py``.

The same numpy inputs go through the JAX function (jitted, on the CPU)
and its port with ``device="cpu"``.

Tolerances and why:
* ``backproject_depth``: bit-equal points, mask and colors (the port
  orders the pinhole arithmetic as XLA compiles it).
* ``voxel_downsample``: valid slots equal, means within 1e-6 m; the
  points whose cell differs between the packages (a point within an ulp
  of a cell wall can round into the other cell) are counted, and 0 are
  expected on these inputs.
* ``estimate_normals``: |n . n'| > 1 - 1e-5 on every valid point (the
  batched 3x3 ``eigh`` of the two libraries differs in the last bits; the
  orientation toward the origin removes the sign).
* ``remove_statistical_outliers``: masks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.ops import pointcloud as jpc
from reconplan_tpu_torch.ops import pointcloud as tpc

torch.set_num_threads(2)


def _cloud_arrays(seed=0, n=5000, holes=0.1):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.1 + [0.3, -0.2, 0.9]).astype(
        np.float32)
    valid = rng.uniform(size=n) > holes
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, valid, cols, nrm


def _both(pts, **kw):
    """The same cloud in both packages."""
    return jpc.make_cloud(pts, **kw), tpc.make_cloud(pts, device="cpu", **kw)


@pytest.mark.parametrize("color", ["none", "uint8", "unit"])
def test_backproject_depth_is_bit_equal(color):
    rng = np.random.default_rng(1)
    H, W = 120, 160
    depth = rng.uniform(300, 3500, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.1] = 0
    depth[0, :4] = 3000.0  # at the truncation: invalid
    img = {"none": None,
           "uint8": rng.integers(0, 255, (H, W, 3)).astype(np.uint8),
           "unit": rng.uniform(size=(H, W, 3)).astype(np.float32)}[color]
    K = (100.0, 101.0, 80.0, 60.0)
    jc = jpc.backproject_depth(
        jnp.asarray(depth), *K,
        color=None if img is None else jnp.asarray(img))
    tc = tpc.backproject_depth(depth, *K, color=img, device="cpu")
    np.testing.assert_array_equal(tc.points.numpy(), np.asarray(jc.points))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    np.testing.assert_array_equal(tc.colors.numpy(), np.asarray(jc.colors))
    assert tc.has_colors == jc.has_colors == (img is not None)


def _jax_voxel_ids(cloud, voxel_size, grid_extent=None):
    """The JAX package's quantisation (``voxel_downsample`` steps 1)."""
    inv = 1.0 / voxel_size
    cells = 1 << 10
    if grid_extent is not None:
        center = jnp.zeros(3, dtype=jnp.float32)
    else:
        w = cloud.valid.astype(jnp.float32)
        center = jnp.sum(cloud.points * w[:, None], axis=0) / jnp.maximum(
            jnp.sum(w), 1.0)
        center = jnp.round(center * inv) * voxel_size
    half_span = (cells // 2) * voxel_size
    q = jnp.clip(jnp.floor((cloud.points - center + half_span) * inv)
                 .astype(jnp.int32), 0, cells - 1)
    ids = (q[:, 0] << 20) | (q[:, 1] << 10) | q[:, 2]
    return jnp.where(cloud.valid, ids, jnp.int32(2**31 - 1))


@pytest.mark.parametrize("voxel,extent", [(0.01, None), (0.02, 1.0),
                                          (0.004, None)])
def test_voxel_downsample_matches_jax(voxel, extent):
    pts, valid, cols, nrm = _cloud_arrays()
    jc, tc = _both(pts, colors=cols, normals=nrm, valid=valid)
    jd = jpc.voxel_downsample(jc, voxel, grid_extent=extent)
    td = tpc.voxel_downsample(tc, voxel, grid_extent=extent)
    moved = int((tpc._voxel_ids(tc, voxel, extent).numpy() != np.asarray(
        jax.jit(_jax_voxel_ids, static_argnums=(1, 2))(jc, voxel, extent))
                 ).sum())
    assert moved == 0, f"{moved} points changed cell"
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    v = td.valid.numpy()
    assert 100 < v.sum() < len(pts)
    for got, want in ((td.points, jd.points), (td.colors, jd.colors),
                      (td.normals, jd.normals)):
        np.testing.assert_allclose(got.numpy()[v], np.asarray(want)[v],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [12, 30])
def test_estimate_normals_matches_jax(k):
    pts, valid, _, _ = _cloud_arrays(seed=2, n=3000)
    jc, tc = _both(pts, valid=valid)
    jn = np.asarray(jpc.estimate_normals(jc, k=k).normals)
    tn = tpc.estimate_normals(tc, k=k).normals.numpy()
    dot = np.abs((jn * tn).sum(-1))[valid]
    assert dot.min() > 1 - 1e-5, dot.min()
    # the orientation toward the origin fixes the sign on both sides
    assert ((jn * tn).sum(-1)[valid] > 0).all()


@pytest.mark.parametrize("nb,std", [(20, 2.0), (8, 1.0)])
def test_remove_statistical_outliers_matches_jax(nb, std):
    pts, valid, _, _ = _cloud_arrays(seed=3, n=3000)
    pts[:20] += 2.0  # a far cluster
    jc, tc = _both(pts, valid=valid)
    jo = jpc.remove_statistical_outliers(jc, nb, std)
    to = tpc.remove_statistical_outliers(tc, nb, std)
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    assert 0 < (valid & ~to.valid.numpy()).sum() < 0.2 * valid.sum()


def test_cloud_count_and_compact():
    pts, valid, cols, _ = _cloud_arrays(n=50)
    c = tpc.make_cloud(pts, colors=cols, valid=valid, device="cpu")
    assert c.count() == valid.sum() and c.has_colors and not c.has_normals
    p, col, nrm = c.compact()
    np.testing.assert_array_equal(p, pts[valid])
    np.testing.assert_array_equal(col, cols[valid])
    assert nrm.shape == (0, 3)
    # a tensor keeps its device whatever ``device`` says
    assert tpc.make_cloud(torch.zeros(3, 3)).points.device.type == "cpu"


class TestBackprojection:
    """Twins of ``tests/test_ops_pointcloud.py::TestBackprojection``."""

    def test_pinhole_roundtrip(self):
        fx, fy, cx, cy = 615.67, 615.96, 326.06, 240.56
        H, W = 480, 640
        depth = np.full((H, W), 1500.0, np.float32)
        cloud = tpc.backproject_depth(depth, fx, fy, cx, cy, device="cpu")
        pts = cloud.points.numpy().reshape(H, W, 3)
        assert np.allclose(pts[..., 2], 1.5, atol=1e-5)
        np.testing.assert_allclose(pts[int(cy), int(cx), :2], [0, 0],
                                   atol=2e-3)
        u, v = 400, 100
        np.testing.assert_allclose(pts[v, u, 0], (u - cx) * 1.5 / fx,
                                   atol=1e-5)

    def test_truncation_and_invalid(self):
        depth = np.array([[0.0, 500.0], [4000.0, 2999.0]], np.float32)
        cloud = tpc.backproject_depth(depth, 1.0, 1.0, 0.5, 0.5,
                                      depth_scale=1000.0, depth_trunc=3.0,
                                      device="cpu")
        np.testing.assert_array_equal(cloud.valid.numpy(),
                                      [False, True, False, True])

    def test_colors_normalized(self):
        depth = np.full((4, 4), 1000.0, np.float32)
        color = np.full((4, 4, 3), 128.0, np.float32)
        cloud = tpc.backproject_depth(depth, 1.0, 1.0, 2.0, 2.0, color=color,
                                      device="cpu")
        assert cloud.has_colors
        np.testing.assert_allclose(cloud.colors.numpy(), 128 / 255.0,
                                   atol=1e-6)


class TestVoxelDownsample:
    """Twins of ``tests/test_ops_pointcloud.py::TestVoxelDownsample``."""

    def test_means_within_voxels(self):
        a = np.array([[0.01, 0.01, 0.01], [0.02, 0.03, 0.01],
                      [0.03, 0.02, 0.04], [0.04, 0.04, 0.02]], np.float32)
        b = a + 1.0
        out = tpc.voxel_downsample(
            tpc.make_cloud(np.vstack([a, b]), device="cpu"), 0.1)
        pts = out.points.numpy()[out.valid.numpy()]
        assert len(pts) == 2
        got = pts[np.argsort(pts[:, 0])]
        np.testing.assert_allclose(got[0], a.mean(0), atol=1e-6)
        np.testing.assert_allclose(got[1], b.mean(0), atol=1e-6)

    def test_invalid_points_excluded(self):
        pts = np.array([[0.0, 0, 0], [0.05, 0, 0], [5.0, 5, 5]], np.float32)
        valid = np.array([True, True, False])
        out = tpc.voxel_downsample(
            tpc.make_cloud(pts, valid=valid, device="cpu"), 0.1)
        kept = out.points.numpy()[out.valid.numpy()]
        assert len(kept) == 1
        np.testing.assert_allclose(kept[0], [0.025, 0, 0], atol=1e-6)

    def test_matches_open3d_voxel_structure(self):
        pts = np.array([[0.019, 0, 0], [0.021, 0, 0]], np.float32)
        out = tpc.voxel_downsample(tpc.make_cloud(pts, device="cpu"), 0.02)
        assert int(out.valid.sum()) == 2  # straddle the boundary


class TestNormals:
    """Twins of ``tests/test_ops_pointcloud.py::TestNormals``."""

    def test_plane_normals(self):
        rng = np.random.default_rng(0)
        pts = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
        pts[:, 2] = 1.0  # plane at z=1, viewpoint at origin below
        normals = tpc.estimate_normals(
            tpc.make_cloud(pts, device="cpu"), k=12).normals.numpy()
        assert np.abs(normals[:, 2]).min() > 0.999
        assert (normals[:, 2] < 0).all()

    def test_sphere_normals_radial(self):
        d = np.random.default_rng(1).normal(size=(512, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pts = d.astype(np.float32) + np.array([0, 0, 3], np.float32)
        normals = tpc.estimate_normals(
            tpc.make_cloud(pts, device="cpu"), k=10).normals.numpy()
        radial = pts - np.array([0, 0, 3], np.float32)
        align = np.abs(np.sum(normals * radial, axis=-1))
        assert np.quantile(align, 0.1) > 0.9


class TestOutliers:
    """Twin of ``tests/test_ops_pointcloud.py::TestOutliers``."""

    def test_far_outlier_removed(self):
        pts = np.random.default_rng(2).uniform(0, 0.5, (200, 3)).astype(
            np.float32)
        pts[0] = [50.0, 50.0, 50.0]
        valid = tpc.remove_statistical_outliers(
            tpc.make_cloud(pts, device="cpu"), 20, 2.0).valid.numpy()
        assert not valid[0]
        assert valid[1:].mean() > 0.9
