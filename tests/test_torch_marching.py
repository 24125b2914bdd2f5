"""The port's table marching cubes against ``reconplan_tpu.ops.marching``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.ops import marching as jmc
from reconplan_tpu.ops import tsdf as jtsdf
from reconplan_tpu_torch.ops import marching as tmc
from reconplan_tpu_torch.ops import tsdf as ttsdf
from test_tsdf_marching import make_sphere_depths
from torch_parity import jax_eager

torch.set_num_threads(2)


def _sphere_sdf(n=64, r=0.1):
    vox = 0.3 / (n - 1)
    zi, yi, xi = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    coords = np.stack([xi, yi, zi], -1) * vox + np.array([-0.15] * 3)
    return (np.linalg.norm(coords, axis=-1) - r).astype(np.float32), vox


def _both_grids(sdf, weight, vox, trunc=1.0):
    n = sdf.shape
    gj = jtsdf.make_grid(n, (-0.15,) * 3, vox, trunc=trunc)._replace(
        sdf=jnp.asarray(sdf), weight=jnp.asarray(weight))
    gt = ttsdf.make_grid(n, (-0.15,) * 3, vox, trunc=trunc,
                         device="cpu")._replace(
        sdf=torch.as_tensor(sdf), weight=torch.as_tensor(weight))
    return gj, gt


def _sorted_tris(tris):
    """Triangles as rows of 9 floats, each rotated to start at its
    lexicographically smallest vertex (winding kept), rows sorted."""
    tris = np.asarray(tris, np.float64).reshape(-1, 3, 3)
    rolled = np.stack([
        np.roll(t, -min(range(3), key=lambda i: tuple(t[i])), axis=0)
        for t in tris
    ])
    flat = rolled.reshape(len(tris), 9)
    return flat[np.lexsort(flat.T[::-1])]


def test_table_identical_to_jax():
    np.testing.assert_array_equal(tmc._MC_TRI_TABLE, jmc._MC_TRI_TABLE)
    np.testing.assert_array_equal(tmc._MC_NTRIS, jmc._MC_NTRIS)
    assert tmc.MAX_TRIS_TABLE == 5


@pytest.mark.parametrize("n", [32, 64])
def test_analytic_sphere_same_triangles(n):
    sdf, vox = _sphere_sdf(n)
    gj, gt = _both_grids(sdf, np.ones_like(sdf), vox)
    with jax_eager():
        tj = jmc.marching_cubes(gj, variant="table")
    tt = tmc.marching_cubes(gt).numpy()
    assert len(tt) == len(tj) > 100
    np.testing.assert_allclose(_sorted_tris(tt), _sorted_tris(tj),
                               rtol=0, atol=1e-6)


def test_fused_sphere_same_triangles():
    """A fused grid (partial observation, weight_min masking) through both."""
    depths, poses, K = make_sphere_depths(n_views=3)
    with jax_eager():
        gj = jtsdf.integrate_frames(
            jtsdf.make_grid((48,) * 3, (-0.15,) * 3, 0.3 / 47),
            jnp.asarray(depths), jnp.asarray(poses), *K)
        tj = jmc.marching_cubes(gj, weight_min=1.0)
    gt = ttsdf.integrate_frames(
        ttsdf.make_grid((48,) * 3, (-0.15,) * 3, 0.3 / 47, device="cpu"),
        depths, poses, *K)
    tt = tmc.marching_cubes(gt, weight_min=1.0).numpy()
    assert len(tt) == len(tj) > 100
    np.testing.assert_allclose(_sorted_tris(tt), _sorted_tris(tj),
                               rtol=0, atol=1e-6)


def test_empty_grid_no_triangles():
    g = ttsdf.make_grid((16, 16, 16), (0, 0, 0), 0.01, device="cpu")
    tris = tmc.marching_cubes(g)
    assert tris.shape == (0, 3, 3)


def test_table_variant_watertight_bitwise():
    """Every edge shared by exactly two triangles, with bitwise-identical
    shared vertices (canonical edge interpolation)."""
    sdf, vox = _sphere_sdf()
    _, gt = _both_grids(sdf, np.ones_like(sdf), vox)
    tris = tmc.marching_cubes(gt).numpy()
    _, inv = np.unique(tris.reshape(-1, 3), axis=0, return_inverse=True)
    f = inv.reshape(-1, 3)
    E = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]),
                axis=1)
    _, cnt = np.unique(E, axis=0, return_counts=True)
    assert (cnt == 2).all(), int((cnt != 2).sum())


def test_winding_outward():
    sdf, vox = _sphere_sdf(48)
    _, gt = _both_grids(sdf, np.ones_like(sdf), vox)
    tris = tmc.marching_cubes(gt).numpy().astype(np.float64)
    c = tris.mean(axis=1)
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    assert (np.sum(nrm * c, -1) > 0).all()


def test_tetra_tables_identical_to_jax():
    for name in ("_TETS", "_TET_EDGES", "_TET_TRIS"):
        np.testing.assert_array_equal(getattr(tmc, name), getattr(jmc, name))
    assert tmc.MAX_TRIS_PER_CUBE == jmc.MAX_TRIS_PER_CUBE == 12


@pytest.mark.parametrize("n", [32, 48])
def test_tetra_same_triangles_as_jax(n):
    """The twin of ``test_table_vs_tetra_accuracy_and_count``: the port's
    tetra variant against JAX's, triangle for triangle, and the table
    variant's two-fold saving at equal accuracy."""
    sdf, vox = _sphere_sdf(n)
    gj, gt = _both_grids(sdf, np.ones_like(sdf), vox)
    with jax_eager():
        tj = jmc.marching_cubes(gj, variant="tetra")
    tt = tmc.marching_cubes(gt, variant="tetra").numpy()
    assert len(tt) == len(tj) > 100
    np.testing.assert_allclose(_sorted_tris(tt), _sorted_tris(tj),
                               rtol=0, atol=1e-6)
    t_table = tmc.marching_cubes(gt).numpy()
    assert len(t_table) * 2 <= len(tt)
    for tris in (t_table, tt):
        r = np.linalg.norm(tris.reshape(-1, 3), axis=-1)
        assert np.abs(r - 0.1).max() < 0.35 * vox


@pytest.mark.parametrize("variant", ["table", "tetra"])
def test_max_cubes_matches_jax(variant):
    sdf, vox = _sphere_sdf(32)
    gj, gt = _both_grids(sdf, np.ones_like(sdf), vox)
    with jax_eager():
        tj = jmc.marching_cubes(gj, max_cubes=300, variant=variant)
    tt = tmc.marching_cubes(gt, max_cubes=300, variant=variant).numpy()
    assert 0 < len(tt) == len(tj) < len(tmc.marching_cubes(gt,
                                                           variant=variant))
    np.testing.assert_allclose(_sorted_tris(tt), _sorted_tris(tj),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="variant"):
        tmc.marching_cubes(gt, variant="dual")


@pytest.mark.parametrize("variant", ["table", "tetra"])
def test_cube_valid_masks_cubes_as_jax(variant):
    """``cube_valid`` masks padding cubes out
    (``reconplan_tpu/ops/marching.py:228`` and ``:318``); None keeps all."""
    n = 12
    z, y, x = np.meshgrid(*[np.arange(n, dtype=np.float32)] * 3,
                          indexing="ij")
    sdf = (np.sqrt((x - 5.5) ** 2 + (y - 5.5) ** 2 + (z - 5.5) ** 2)
           - 3.7).astype(np.float32) / 5.0
    gj = jtsdf.make_grid((n,) * 3, (0, 0, 0), 1.0)._replace(
        sdf=jnp.asarray(sdf), weight=jnp.ones((n,) * 3, jnp.float32))
    gt = ttsdf.tsdf_grid_from_numpy(sdf, np.ones((n,) * 3, np.float32),
                                    np.zeros((0, 0, 0, 3), np.float32),
                                    (0, 0, 0), 1.0, 5.0, device="cpu")
    idx = np.flatnonzero(np.asarray(jmc.active_cubes(gj)).reshape(-1))
    valid = np.random.default_rng(0).uniform(size=len(idx)) < 0.6
    fj = {"table": jmc.triangulate_cubes_table, "tetra": jmc.triangulate_cubes}
    ft = {"table": tmc.triangulate_cubes_table, "tetra": tmc.triangulate_cubes}
    vj, okj = fj[variant](gj, jnp.asarray(idx), jnp.asarray(valid))
    vt, okt = ft[variant](gt, torch.as_tensor(idx), torch.as_tensor(valid))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert not okt[~torch.as_tensor(valid)].any() and okt.any()
    np.testing.assert_allclose(vt.numpy()[okt.numpy()],
                               np.asarray(vj)[np.asarray(okj)], atol=1e-6)
    _, ok_all = ft[variant](gt, torch.as_tensor(idx))
    _, ok_ones = ft[variant](gt, torch.as_tensor(idx),
                             torch.ones(len(idx), dtype=torch.bool))
    assert torch.equal(ok_all, ok_ones) and ok_all.sum() > okt.sum()
