"""The port's nearest neighbours, Chamfer metrics and mesh IO against the
JAX package (``ops.nn``, ``recon.metrics``, ``io.meshio``)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.io import meshio as jmeshio
from reconplan_tpu.ops import nn as jnn
from reconplan_tpu.recon import metrics as jmetrics
from reconplan_tpu_torch.io import meshio as tmeshio
from reconplan_tpu_torch.ops import nn as tnn
from reconplan_tpu_torch.recon import metrics as tmetrics

torch.set_num_threads(2)

BANANA = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                      "data/objects/011_banana/tsdf/nontextured.ply")


def _clouds(seed=0, n_a=3000, n_b=2500):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(n_a, 3)) * 0.05 + [0.3, -0.2, 0.5]).astype(np.float32)
    b = (rng.normal(size=(n_b, 3)) * 0.05 + [0.3, -0.2, 0.5]).astype(np.float32)
    return a, b


def test_nearest_neighbor_matches_jax():
    q, p = _clouds()
    dj, ij = jnn.nearest_neighbor(jnp.asarray(q), jnp.asarray(p),
                                  row_chunk=1024)
    dt, it = tnn.nearest_neighbor(torch.as_tensor(q), torch.as_tensor(p),
                                  row_chunk=1024)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)


def test_pairwise_sqdist_matches_jax():
    q, p = _clouds(1, 500, 400)
    dj = np.asarray(jnn.pairwise_sqdist(jnp.asarray(q), jnp.asarray(p)))
    dt = tnn.pairwise_sqdist(torch.as_tensor(q), torch.as_tensor(p)).numpy()
    # the matmul identity's cancellation error scales with |x||y| (~1e-2
    # here after centring), so small distances agree to ~1e-8 absolute
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_distance_matches_jax(masked):
    a, b = _clouds(2)
    rng = np.random.default_rng(3)
    va = rng.uniform(size=len(a)) > 0.3 if masked else None
    vb = rng.uniform(size=len(b)) > 0.3 if masked else None
    cj = jmetrics.chamfer_distance(a, b, va, vb)
    ct = tmetrics.chamfer_distance(torch.as_tensor(a), torch.as_tensor(b),
                                   va, vb)
    for x, y in zip(ct, cj):
        np.testing.assert_allclose(float(x), float(y), rtol=1e-6)


def test_load_and_sample_banana_identical():
    vj, fj = jmeshio.load_mesh(BANANA)
    vt, ft = tmeshio.load_mesh(BANANA)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    pj, nj = jmeshio.sample_mesh_surface(vj, fj, 5000, seed=4)
    pt, nt = tmeshio.sample_mesh_surface(vt, ft, 5000, seed=4)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(nt, nj)


def test_chamfer_to_mesh_matches_jax():
    v, f = tmeshio.load_mesh(BANANA)
    pts, _ = tmeshio.sample_mesh_surface(v, f, 4000, seed=7)
    pts = (pts + 1e-3).astype(np.float32)
    cj = jmetrics.chamfer_to_mesh(pts, v, f, n_surface_samples=20_000)
    ct = tmetrics.chamfer_to_mesh(torch.as_tensor(pts), v, f,
                                  n_surface_samples=20_000)
    np.testing.assert_allclose(ct, cj, rtol=1e-6)
    assert 1e-4 < ct[0] < 5e-3


@pytest.mark.parametrize("k", [1, 5, 16])
def test_knn_matches_jax(k):
    q, p = _clouds(4, 700, 900)
    dj, ij = jnn.knn(jnp.asarray(q), jnp.asarray(p), k, row_chunk=256)
    dt, it = tnn.knn(torch.as_tensor(q), torch.as_tensor(p), k,
                     row_chunk=256)
    assert it.shape == (700, k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    expected = np.sort(np.linalg.norm(q[:, None] - p[None], axis=-1), 1)[:, :k]
    np.testing.assert_allclose(dt.numpy(), expected, atol=1e-6)


def test_knn_respects_valid_mask():
    pts = np.zeros((10, 3), np.float32)
    pts[5] = [10, 10, 10]
    valid = np.zeros(10, bool)
    valid[5] = True  # only point 5 valid
    args = (np.zeros((1, 3), np.float32), pts, 1)
    _, ij = jnn.knn(*map(jnp.asarray, args[:2]), 1,
                    valid=jnp.asarray(valid))
    _, it = tnn.knn(*map(torch.as_tensor, args[:2]), 1,
                    valid=torch.as_tensor(valid))
    assert int(it[0, 0]) == int(ij[0, 0]) == 5


def _se3_points(seed, n):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([rng.normal(size=(n, 3)) * 0.3, q],
                          -1).astype(np.float32)


def test_se3_pairwise_matches_jax():
    a, b = _se3_points(6, 200), _se3_points(7, 150)
    dj = np.asarray(jnn.se3_pairwise(jnp.asarray(a), jnp.asarray(b)))
    dt = tnn.se3_pairwise(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    # the position term carries the matmul identity's cancellation error
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-6)
    pos = tnn.se3_pairwise(torch.as_tensor(a[:, :3]), torch.as_tensor(b))
    np.testing.assert_allclose(
        pos.numpy(), np.asarray(jnn.se3_pairwise(jnp.asarray(a[:, :3]),
                                                 jnp.asarray(b))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dim", [3, 7])
def test_se3_knn_matches_jax(dim):
    """The twin of ``test_se3_knn_matches_reference_metric``, with the
    port against JAX and both against the numpy metric."""
    pts = _se3_points(8, 600)[:, :dim]
    q = pts[::7]
    dj, ij = jnn.se3_knn(jnp.asarray(q), jnp.asarray(pts), 3, row_chunk=64)
    dt, it = tnn.se3_knn(torch.as_tensor(q), torch.as_tensor(pts), 3,
                         row_chunk=64)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=1e-7)
    ref = np.linalg.norm(q[:, None, :3] - pts[None, :, :3], axis=-1)
    if dim == 7:
        ref = ref + 0.3 * (1 - np.abs(q[:, 3:] @ pts[:, 3:].T))
    np.testing.assert_array_equal(it.numpy(), np.argsort(ref, 1)[:, :3])
    np.testing.assert_allclose(dt.numpy(), np.sort(ref, 1)[:, :3], atol=1e-5)


def _sphere_soup(nt=40, n_phi=80):
    """A dense lat/long sphere of radius 0.2 m: small uniform triangles."""
    th = np.linspace(1e-3, np.pi - 1e-3, nt)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    V = 0.2 * np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                        np.cos(tt)], -1).reshape(-1, 3).astype(np.float32)
    F = []
    for i in range(nt - 1):
        for j in range(n_phi):
            a, b = i * n_phi + j, i * n_phi + (j + 1) % n_phi
            F += [[a, a + n_phi, b], [a + n_phi, b + n_phi, b]]
    return V[np.asarray(F)]


def test_closest_point_on_triangles_matches_jax():
    """All seven Voronoi regions are reached by points scattered around
    random triangles."""
    import jax

    rng = np.random.default_rng(12)
    tri = rng.normal(size=(64, 3, 3)).astype(np.float32)
    p = (rng.normal(size=(300, 3)) * 2).astype(np.float32)
    ref = np.asarray(jax.vmap(
        lambda x: jmetrics._closest_point_on_triangles(x, jnp.asarray(tri))
    )(jnp.asarray(p)))
    got = tmetrics._closest_point_on_triangles(
        torch.as_tensor(p), torch.as_tensor(tri)[None].expand(300, -1, -1,
                                                               -1))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_points_to_mesh_distance_matches_jax():
    """The twin of ``test_points_to_mesh_distance_exact``: the port against
    JAX, and the kNN-pruned distance against an all-triangles brute
    force."""
    tris = _sphere_soup()
    rng = np.random.default_rng(11)
    q = rng.normal(size=(256, 3))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q = (q * (0.2 + 0.003 * rng.normal(size=(256, 1)))).astype(np.float32)
    dj = jmetrics.points_to_mesh_distance(q, tris, k=8, row_chunk=128)
    dt = tmetrics.points_to_mesh_distance(q, tris, k=8, row_chunk=128,
                                          device="cpu")
    assert dt.shape == (256,) and dt.dtype == torch.float32
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=1e-7)
    brute = torch.sqrt(tmetrics._closest_point_on_triangles(
        torch.as_tensor(q), torch.as_tensor(tris)[None].expand(
            256, -1, -1, -1)).min(-1).values)
    np.testing.assert_allclose(dt.numpy(), brute.numpy(), atol=1e-7)
    assert 1e-4 < float(dt.mean()) < 1e-2
