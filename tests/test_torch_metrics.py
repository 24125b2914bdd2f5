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
