"""``reconplan_tpu_torch.recon.poisson`` and the close gate of
``apps/scan`` (``free_space_refuted``, ``close_gate_signals``) against
the JAX package on the CPU, and port-only twins of ``TestPoisson`` and
``TestCloseGate`` of ``tests/test_recon_io.py``.

The same numpy inputs go through the JAX function (jitted, on the CPU)
and its port with ``device="cpu"``.

Tolerances and why:
* ``_trilinear_splat``: equal (both add in input order on the CPU);
  ``_trilinear_gather`` within 1e-7.
* ``_poisson_indicator``: chi within 1e-5 max|chi|; the two libraries'
  complex64 FFTs round apart by ~5e-6 of the field's peak. iso, the
  mean of chi at the samples, within 1e-5 max|chi| too: its value is a
  third of the peak, so relative to itself it parts by ~3e-6, and the
  JAX package's own jitted and op-by-op isos part by 2e-6.
* ``_sample_iso_field``: within 1e-5 of its peak at the samples; far
  from every sample the field is a ratio of two smoothed splats whose
  denominator falls to its 1e-3 floor, which scales the FFT rounding up
  to ~4e-4 of the peak there, so 1e-3 of the peak holds everywhere.
* ``poisson_reconstruct``: triangle counts within 0.5%, and each mesh's
  vertices within a mean 0.01 voxel of the other mesh.
* the close gate: the same decision, the same hole, refuted and
  unobserved fractions, and the distances within 1e-4 relative (exact
  point-to-triangle distances that sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.apps import scan as jscan
from reconplan_tpu.io.frames import FrameSet
from reconplan_tpu.recon import poisson as jpoisson
from reconplan_tpu_torch.apps import scan as tscan
from reconplan_tpu_torch.ops import pointcloud as tpc
from reconplan_tpu_torch.recon import metrics as tmetrics
from reconplan_tpu_torch.recon import poisson as tpoisson

torch.set_num_threads(2)


def sphere(n=4000, r=0.1, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (r * d).astype(np.float32), d.astype(np.float32)


def _box(pts, depth, padding=0.2):
    """``poisson_reconstruct``'s grid: (origin, voxel)."""
    lo, hi = pts.min(0), pts.max(0)
    extent = float((hi - lo).max())
    pad = extent * padding
    return (lo - pad).astype(np.float32), np.float32(
        (extent + 2 * pad) / (depth - 1))


def test_trilinear_splat_and_gather_match_jax():
    pts, nrm = sphere(3000)
    origin, voxel = _box(pts, 32)
    idx_f = (pts - origin) / voxel
    sj = np.asarray(jpoisson._trilinear_splat((32, 32, 32),
                                              jnp.asarray(idx_f),
                                              jnp.asarray(nrm)))
    st = tpoisson._trilinear_splat((32, 32, 32), torch.as_tensor(idx_f),
                                   torch.as_tensor(nrm)).numpy()
    np.testing.assert_array_equal(st, sj)
    vol = sj[..., 0]
    gj = np.asarray(jpoisson._trilinear_gather(jnp.asarray(vol),
                                               jnp.asarray(idx_f)))
    gt = tpoisson._trilinear_gather(torch.as_tensor(vol.copy()),
                                    torch.as_tensor(idx_f)).numpy()
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-7)


@pytest.mark.parametrize("screen", [0.0, 4.0])
def test_poisson_indicator_matches_jax(screen):
    pts, nrm = sphere()
    origin, voxel = _box(pts, 64)
    cj, ij = jpoisson._poisson_indicator(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(origin),
        jnp.float32(voxel), 64, screen=screen)
    ct, it = tpoisson._poisson_indicator(
        torch.as_tensor(pts), torch.as_tensor(nrm), torch.as_tensor(origin),
        torch.tensor(voxel), 64, screen=screen)
    cj = np.asarray(cj)
    peak = np.abs(cj).max()
    assert ct.dtype == torch.float32 and ct.shape == (64, 64, 64)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-5 * peak)
    assert float(it) == pytest.approx(float(ij), abs=1e-5 * peak)


def test_sample_iso_field_matches_jax():
    pts, nrm = sphere()
    origin, voxel = _box(pts, 32)
    chi, _ = jpoisson._poisson_indicator(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(origin),
        jnp.float32(voxel), 32, screen=4.0)
    idx_f = (pts - origin) / voxel
    bj = np.asarray(jpoisson._sample_iso_field(chi, jnp.asarray(idx_f), 32))
    bt = tpoisson._sample_iso_field(torch.as_tensor(np.array(chi)),
                                    torch.as_tensor(idx_f), 32)
    peak = np.abs(bj).max()
    # at the samples, where the surface passes
    np.testing.assert_allclose(
        tpoisson._trilinear_gather(bt, torch.as_tensor(idx_f)).numpy(),
        np.asarray(jpoisson._trilinear_gather(jnp.asarray(bj),
                                              jnp.asarray(idx_f))),
        rtol=0, atol=1e-5 * peak)
    # far from every sample the ratio divides FFT rounding by ~eps
    np.testing.assert_allclose(bt.numpy(), bj, rtol=0, atol=1e-3 * peak)


def _mesh_gap(a, b):
    """Mean distance of each mesh's vertices to the other mesh (port's
    exact point-to-triangle distance, on the CPU)."""
    da = tmetrics.points_to_mesh_distance(a.reshape(-1, 3), b,
                                          device="cpu").numpy()
    db = tmetrics.points_to_mesh_distance(b.reshape(-1, 3), a,
                                          device="cpu").numpy()
    return da.mean(), db.mean()


@pytest.mark.parametrize("local_iso", [False, True])
def test_poisson_reconstruct_matches_jax(local_iso):
    pts, nrm = sphere()
    tj = np.asarray(jpoisson.poisson_reconstruct(pts, nrm, depth=48,
                                                 local_iso=local_iso))
    tt, grid = tpoisson.poisson_reconstruct(pts, nrm, depth=48,
                                            local_iso=local_iso,
                                            return_grid=True, device="cpu")
    tt = tt.numpy()
    assert abs(len(tt) - len(tj)) <= 0.005 * len(tj)
    voxel = float(grid.voxel_size)
    ab, ba = _mesh_gap(tt, tj)
    assert max(ab, ba) < 0.01 * voxel, (ab / voxel, ba / voxel)


class TestPoisson:
    """Twins of ``tests/test_recon_io.py::TestPoisson``."""

    def test_sphere_reconstruction_submillimeter(self):
        pts, d = sphere(seed=1)
        tris = tpoisson.poisson_reconstruct(pts, d, depth=64,
                                            device="cpu").numpy()
        assert len(tris) > 1000
        r = np.linalg.norm(tris.reshape(-1, 3), axis=-1)
        assert abs(r.mean() - 0.1) < 5e-4, r.mean()
        assert r.std() < 2e-3

    def test_winding_outward_consistent(self):
        pts, d = sphere(seed=2)
        tris = tpoisson.poisson_reconstruct(pts, d, depth=64,
                                            device="cpu").numpy()
        c = tris.mean(axis=1)
        nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        radial = c / np.linalg.norm(c, axis=-1, keepdims=True)
        assert float((np.sum(nrm * radial, -1) > 0).mean()) > 0.99

    def test_chamfer_vs_input_points(self):
        rng = np.random.default_rng(3)
        d = rng.normal(size=(8000, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        r = 0.2 + 0.05 * np.sin(5 * d[:, 0]) + 0.04 * np.cos(7 * d[:, 1])
        pts = (d * r[:, None]).astype(np.float32)
        cl = tpc.estimate_normals(tpc.make_cloud(pts, device="cpu"), k=16)
        nrm = cl.normals.numpy().copy()
        nrm *= np.where(np.sum(nrm * d, -1) < 0, -1.0, 1.0)[:, None]
        tris = tpoisson.poisson_reconstruct(pts, nrm.astype(np.float32),
                                            depth=96, device="cpu").numpy()
        verts = tris.reshape(-1, 3)
        sub = verts[rng.choice(len(verts), 3000)]
        _, _, pts_to_mesh = tmetrics.chamfer_distance(sub, pts, device="cpu")
        assert float(pts_to_mesh) < 0.012

    def test_bumpy_exact_residual_submillimeter(self):
        """The exact analytic residual |G(v)| / |grad G| of the mesh
        vertices, and the coverage of the analytic surface, at the JAX
        twin's depth 128 (marked slow there; about 12 s here)."""
        r0, a, b = 0.2, 0.05, 0.04

        def f_dir(d):
            return r0 + a * torch.sin(5 * d[..., 0]) + b * torch.cos(
                7 * d[..., 1])

        def G(p):
            n = torch.linalg.norm(p, dim=-1)
            return n - f_dir(p / n[..., None])

        def grad_G(p):
            p = torch.as_tensor(p).clone().requires_grad_(True)
            (g,) = torch.autograd.grad(G(p).sum(), p)
            return p.detach(), g

        rng = np.random.default_rng(3)
        d = torch.as_tensor(rng.normal(size=(20000, 3)), dtype=torch.float32)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        pts, g = grad_G(d * f_dir(d)[:, None])
        nrm = g / torch.linalg.norm(g, dim=-1, keepdim=True)
        tris = tpoisson.poisson_reconstruct(pts, nrm, depth=128,
                                            device="cpu")
        verts, gv = grad_G(torch.unique(tris.reshape(-1, 3), dim=0))
        resid = (G(verts).abs() / torch.linalg.norm(gv, dim=-1)).numpy()
        mean_mm, q95_mm = resid.mean() * 1e3, np.quantile(resid, 0.95) * 1e3
        assert mean_mm < 1.0 and q95_mm < 2.0, (mean_mm, q95_mm)
        d2 = torch.as_tensor(rng.normal(size=(20000, 3)), dtype=torch.float32)
        d2 = d2 / torch.linalg.norm(d2, dim=-1, keepdim=True)
        cd = tmetrics.points_to_mesh_distance(d2 * f_dir(d2)[:, None], tris,
                                              device="cpu").numpy()
        assert cd.mean() * 1e3 < 1.0, cd.mean()
        assert (cd > 2e-3).mean() < 0.005, (cd > 2e-3).mean()


def uv_sphere_tris(r=0.05, n_lat=24, n_lon=32, z_min=None):
    """UV-sphere triangle soup (T, 3, 3); drop triangles whose centroid
    sits below ``z_min`` to simulate an unobserved underside hole."""
    th = np.linspace(0, np.pi, n_lat + 1)
    ph = np.linspace(0, 2 * np.pi, n_lon + 1)
    v = np.stack([r * np.outer(np.sin(th), np.cos(ph)),
                  r * np.outer(np.sin(th), np.sin(ph)),
                  r * np.outer(np.cos(th), np.ones_like(ph))], axis=-1)
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b, c, d = v[i, j], v[i + 1, j], v[i + 1, j + 1], v[i, j + 1]
            tris.append([a, b, c])
            tris.append([a, c, d])
    tris = np.asarray(tris, np.float32)
    if z_min is not None:
        tris = tris[tris.mean(axis=1)[:, 2] >= z_min]
    return tris


def _obs(r=0.05, n=4000, z_min=-0.02):
    d = np.random.default_rng(3).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = (r * d).astype(np.float32)
    return pts[pts[:, 2] >= z_min]


def _frame_looking_down(eye_z=0.3, depth_m=None, depth=None):
    """One synthetic camera at +z looking straight down at the origin
    (camera +z axis = world -z), full-frame depth (constant, or given)."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    T[2, 3] = eye_z
    if depth is None:
        depth = np.full((480, 640), (depth_m or 0.0) * 1000, np.float32)
    return FrameSet(depth=depth[None], color=None, poses=T[None],
                    depth_scale=1000.0,
                    intrinsics=(615.67, 615.96, 326.06, 240.56))


def test_free_space_refuted_matches_jax():
    rng = np.random.default_rng(5)
    depth = rng.uniform(200, 320, (480, 640)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    fr = _frame_looking_down(depth=depth)
    samples = rng.uniform([-0.2, -0.2, -0.1], [0.2, 0.2, 0.2],
                          (20000, 3)).astype(np.float32)
    for miss in (True, False):
        want = jscan.free_space_refuted(samples, fr, miss_is_free=miss)
        got = tscan.free_space_refuted(samples, fr, miss_is_free=miss)
        np.testing.assert_array_equal(got, want)
        assert 0.05 < got.mean() < 0.95


@pytest.mark.parametrize("case", ["hole", "inflated", "balloon"])
def test_close_gate_signals_match_jax(case):
    obs = _obs(z_min=-0.0499 if case == "inflated" else -0.02)
    open_tris = uv_sphere_tris(z_min=-0.0499 if case == "inflated"
                               else -0.02)
    closed_tris = {"hole": uv_sphere_tris(),
                   "inflated": uv_sphere_tris(r=0.054)}.get(case)
    kw = dict(n_samples=4000, hole_tau=0.004)
    if case == "balloon":
        balloon = uv_sphere_tris(r=0.15)
        closed_tris = np.concatenate([
            uv_sphere_tris(z_min=-0.02),
            balloon[balloon.mean(axis=1)[:, 2] < -0.06]])
        kw.update(frames=_frame_looking_down(depth_m=0.0),
                  volume_bounds=([-0.1, -0.1, -0.05], [0.1, 0.1, 0.1]))
    want = jscan.close_gate_signals(open_tris, closed_tris, obs, **kw)
    got = tscan.close_gate_signals(open_tris, closed_tris, obs,
                                   device="cpu", **kw)
    assert got["best"] == want["best"]
    for k in ("hole_frac", "refuted_frac", "unobserved_frac"):
        assert got[k] == want[k], k
    for k in ("fit_open_mm", "fit_closed_mm", "hole_mean_open_mm",
              "refuted_mean_mm", "proxy_open_mm", "proxy_closed_mm"):
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-9), k


class TestCloseGate:
    """Twins of ``tests/test_recon_io.py::TestCloseGate``."""

    def test_picks_closed_when_hole_dominates(self):
        g = tscan.close_gate_signals(
            uv_sphere_tris(z_min=-0.02), uv_sphere_tris(), _obs(z_min=-0.02),
            n_samples=4000, hole_tau=0.004, device="cpu")
        assert g["best"] == "closed", g
        assert g["hole_frac"] > 0.05, g

    def test_picks_open_when_closure_fights_observations(self):
        g = tscan.close_gate_signals(
            uv_sphere_tris(z_min=-0.0499), uv_sphere_tris(r=0.054),
            _obs(z_min=-0.0499), n_samples=4000, hole_tau=0.004,
            device="cpu")
        assert g["best"] == "open", g
        assert g["fit_closed_mm"] > g["fit_open_mm"], g

    def test_free_space_refuted_by_depth_and_miss_rays(self):
        pts = np.array([[0, 0, 0.2], [0, 0, -0.1], [0, 0, 0.051]],
                       np.float32)
        ref = tscan.free_space_refuted(pts, _frame_looking_down(depth_m=0.25),
                                       margin=0.004)
        assert ref.tolist() == [True, False, False], ref
        fr0 = _frame_looking_down(depth_m=0.0)
        assert tscan.free_space_refuted(pts, fr0, miss_is_free=True).all()
        assert not tscan.free_space_refuted(pts, fr0,
                                            miss_is_free=False).any()

    def test_refuted_closure_charged_to_closed_mesh(self):
        obs = _obs(z_min=-0.02)
        open_tris = uv_sphere_tris(z_min=-0.02)
        balloon = uv_sphere_tris(r=0.15)
        balloon = balloon[balloon.mean(axis=1)[:, 2] < -0.06]
        closed_tris = np.concatenate([uv_sphere_tris(z_min=-0.02), balloon])
        kw = dict(n_samples=4000, hole_tau=0.004, device="cpu")
        g_old = tscan.close_gate_signals(open_tris, closed_tris, obs, **kw)
        assert g_old["best"] == "closed", g_old
        g = tscan.close_gate_signals(open_tris, closed_tris, obs,
                                     frames=_frame_looking_down(depth_m=0.0),
                                     **kw)
        assert g["refuted_frac"] > 0.2, g
        assert g["best"] == "open", g
