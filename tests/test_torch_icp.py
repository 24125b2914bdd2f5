"""``reconplan_tpu_torch.ops.icp`` and ``ops.features`` against the JAX
package on the CPU, and port-only twins of ``tests/test_ops_icp.py`` and
``TestFeatures`` of ``tests/test_recon_io.py``.

The same numpy inputs go through the JAX function (jitted, on the CPU)
and its port with ``device="cpu"``.

Tolerances and why:
* ``register_kabsch`` and the three ICPs: the same iteration count
  (it decides T), T within 1e-5, fitness and rmse within 1e-6. The
  cross-covariance and the normal equations sum in another order than
  XLA's dot, which moves T by ~1e-8 on these inputs.
* zero inliers: S = 0 and K = 0, and both libraries' ``eigh`` of the
  zero 4x4 returns the unit basis with the last column (0, 0, 0, 1),
  the quaternion of a half turn about z: both packages return
  diag(-1, -1, 1, 1), by value.
* ``color_gradients`` and ``fpfh``: within 1e-5. An FPFH histogram
  entry moves only when an angle sits on a bin edge within the rounding
  of the two packages; the share of entries that moved is counted (0 on
  these inputs).
* RANSAC: the picks are drawn with JAX's own keys and fed to both
  scorers. The best hypothesis is the same, and on every hypothesis
  whose Horn matrix K has a clear top eigenvalue the score is equal and
  T agrees within 1e-5. Picks that repeat a correspondence (drawn with
  replacement) leave two eigenvalues of K tied, so each library returns
  its own vector of that plane, and T and score part (one of the 64
  hypotheses here, 32 inliers against 3): those are counted, not held
  by value.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.core import maths as jmaths
from reconplan_tpu.ops import features as jfeat
from reconplan_tpu.ops import icp as jicp
from reconplan_tpu.ops import pointcloud as jpc
from reconplan_tpu.ops.nn import nearest_neighbor as jnn
from reconplan_tpu_torch.core import maths as tmaths
from reconplan_tpu_torch.ops import features as tfeat
from reconplan_tpu_torch.ops import icp as ticp
from reconplan_tpu_torch.ops import pointcloud as tpc

torch.set_num_threads(2)


def random_transform(rng, angle_scale=0.1, trans_scale=0.05):
    rv = rng.normal(size=3) * angle_scale
    R = tmaths.quat_to_matrix(tmaths.rotvec_to_quat(torch.as_tensor(
        rv, dtype=torch.float32))).numpy()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(size=3) * trans_scale
    return T


def surface_points(rng, n=2000, r0=0.5):
    """Random points on a bumpy sphere (registration-friendly geometry)."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = r0 + 0.05 * np.sin(5 * d[:, 0]) + 0.04 * np.cos(7 * d[:, 1])
    return (d * r[:, None]).astype(np.float32)


def moved(pts, T):
    return (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)


def transform_error(T_got, T_true):
    delta = T_got @ np.linalg.inv(T_true)
    rot_err = np.arccos(np.clip((np.trace(delta[:3, :3]) - 1) / 2, -1, 1))
    return rot_err, np.linalg.norm(delta[:3, 3])


def _clouds(pts, **kw):
    return jpc.make_cloud(pts, **kw), tpc.make_cloud(pts, device="cpu", **kw)


def assert_same_result(rj, rt):
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.transformation.numpy(),
                               np.asarray(rj.transformation), rtol=0,
                               atol=1e-5)
    assert float(rt.fitness) == pytest.approx(float(rj.fitness), abs=1e-6)
    assert float(rt.inlier_rmse) == pytest.approx(float(rj.inlier_rmse),
                                                  abs=1e-6)


@pytest.mark.parametrize("case", ["all", "weighted", "none"])
def test_register_kabsch_matches_jax(case):
    rng = np.random.default_rng(0)
    pts = surface_points(rng, 100)
    dst = moved(pts, random_transform(rng, 0.5, 0.3))
    w = np.ones(100, np.float32)
    if case == "weighted":
        dst[:10] += 5.0
        w[:10] = 0.0
    elif case == "none":
        w[:] = 0.0
    Tj = np.asarray(jicp.register_kabsch(jnp.asarray(pts), jnp.asarray(dst),
                                         jnp.asarray(w)))
    Tt = ticp.register_kabsch(torch.as_tensor(pts), torch.as_tensor(dst),
                              torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-5)
    if case == "none":
        # eigh(0) is the unit basis in both libraries: a half turn about z
        np.testing.assert_array_equal(np.diag(Tt), [-1, -1, 1, 1])


def test_register_kabsch_batches():
    """Leading dimensions batch (RANSAC scores its hypotheses at once)."""
    rng = np.random.default_rng(1)
    src = torch.as_tensor(np.stack([surface_points(rng, 30)
                                    for _ in range(4)]))
    dst = torch.as_tensor(np.stack([moved(s.numpy(), random_transform(rng))
                                    for s in src]))
    w = torch.rand(4, 30, generator=torch.Generator().manual_seed(0))
    Ts = ticp.register_kabsch(src, dst, w)
    for b in range(4):
        np.testing.assert_array_equal(
            Ts[b].numpy(), ticp.register_kabsch(src[b], dst[b], w[b]).numpy())


def test_se3_exp_matches_jax():
    xi = np.random.default_rng(2).normal(size=6).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        ticp._se3_exp(torch.as_tensor(xi)).numpy(),
        np.asarray(jicp._se3_exp(jnp.asarray(xi))), rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def bumpy_pair():
    rng = np.random.default_rng(42)
    pts = surface_points(rng, 1500)
    dst = moved(pts, random_transform(rng, 0.08, 0.03))
    jd, td = _clouds(dst)
    return (pts, dst, jpc.estimate_normals(jd, k=12),
            tpc.estimate_normals(td, k=12))


def test_icp_point_to_point_matches_jax(bumpy_pair):
    pts, dst, _, _ = bumpy_pair
    js, ts = _clouds(pts)
    jd, td = _clouds(dst)
    rj = jicp.icp_point_to_point(js, jd, 0.1)
    rt = ticp.icp_point_to_point(ts, td, 0.1)
    assert 2 < int(rt.iterations) < 30
    assert_same_result(rj, rt)


def test_icp_point_to_plane_matches_jax(bumpy_pair):
    pts, _, jd, td = bumpy_pair
    js, ts = _clouds(pts)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.01, -0.005, 0.0]
    rj = jicp.icp_point_to_plane(js, jd, 0.1, init=jnp.asarray(init),
                                 max_iteration=12)
    rt = ticp.icp_point_to_plane(ts, td, 0.1, init=init, max_iteration=12)
    assert_same_result(rj, rt)


def _textured_plane(n=4000, shift=0.04):
    rng = np.random.default_rng(7)
    xy = rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
    pts = np.concatenate([xy, np.ones((n, 1), np.float32)], -1)
    col = 0.5 + 0.5 * np.sin(3 * xy[:, :1]) * np.cos(4 * xy[:, 1:2])
    colors = np.repeat(col, 3, axis=1).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = shift  # pure in-plane shift
    return pts, colors, moved(pts, T), T


def test_color_gradients_and_colored_icp_match_jax():
    pts, colors, dst, _ = _textured_plane()
    jd, td = _clouds(dst, colors=colors)
    jd, td = jpc.estimate_normals(jd, k=12), tpc.estimate_normals(td, k=12)
    gj, gt = jicp.color_gradients(jd), ticp.color_gradients(td)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-5)
    js, ts = _clouds(pts, colors=colors)
    assert_same_result(jicp.colored_icp(js, jd, gj, 0.1),
                       ticp.colored_icp(ts, td, gt, 0.1))


def test_zero_inlier_icp_matches_jax(bumpy_pair):
    """No source point within the distance: every weight is 0, so each
    step solves Kabsch on nothing (see the module docstring)."""
    pts, dst, _, _ = bumpy_pair
    js, ts = _clouds(pts)
    jd, td = _clouds(dst + 10.0)
    rj = jicp.icp_point_to_point(js, jd, 0.1)
    rt = ticp.icp_point_to_point(ts, td, 0.1)
    assert_same_result(rj, rt)
    assert int(rt.iterations) == 2 and float(rt.fitness) == 0.0
    np.testing.assert_array_equal(np.diag(rt.transformation.numpy()),
                                  [-1, -1, 1, 1])


def test_icp_stops_on_the_host_only_every_few_iterations(bumpy_pair):
    """The frozen iterations past convergence change nothing: a loop
    that looks at the live flag after every step gives the same result."""
    pts, dst, _, _ = bumpy_pair
    src, dst = tpc.make_cloud(pts, device="cpu"), tpc.make_cloud(
        dst, device="cpu")
    every = ticp.icp_point_to_point(src, dst, 0.1)
    orig = ticp.CHECK_EVERY
    ticp.CHECK_EVERY = 1
    try:
        each = ticp.icp_point_to_point(src, dst, 0.1)
    finally:
        ticp.CHECK_EVERY = orig
    for a, b in zip(every, each):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.fixture(scope="module")
def feature_pair():
    rng = np.random.default_rng(0)
    pts = surface_points(rng, 800)
    rv = np.array([0.3, -0.2, 0.4])
    R = np.asarray(jmaths.quat_to_matrix(jmaths.rotvec_to_quat(
        jnp.asarray(rv))))
    t = np.array([0.2, -0.1, 0.3])
    dst = (pts @ R.T + t).astype(np.float32)
    js, ts = _clouds(pts)
    jd, td = _clouds(dst)
    # the same normals on both sides, so that fpfh is held on its own
    js = jpc.estimate_normals(js, k=16)
    jd = jpc.estimate_normals(jd, k=16)
    ts = tpc.make_cloud(pts, normals=np.asarray(js.normals), device="cpu")
    td = tpc.make_cloud(dst, normals=np.asarray(jd.normals), device="cpu")
    return js, jd, ts, td, R, t


def test_fpfh_matches_jax(feature_pair):
    js, _, ts, _, _, _ = feature_pair
    fj = np.asarray(jfeat.fpfh(js))
    ft = tfeat.fpfh(ts).numpy()
    assert ft.shape == (800, 33)
    moved_entries = float((np.abs(fj - ft) > 1e-6).mean())
    assert moved_entries == 0.0, f"{moved_entries:.2%} entries moved"
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-5)


def _horn_gap(src, dst, w):
    """Relative gap between K's two largest eigenvalues (float64)."""
    w = w / w.sum()
    ms, md = (src * w[:, None]).sum(0), (dst * w[:, None]).sum(0)
    S = ((src - ms) * w[:, None]).T @ (dst - md)
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = S
    K = np.array([
        [sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
        [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
        [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
        [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]])
    ev = np.linalg.eigvalsh(K)
    return (ev[-1] - ev[-2]) / max(abs(ev[-1]), 1e-30)


def test_ransac_scores_jax_drawn_picks_alike(feature_pair):
    js, jd, ts, td, _, _ = feature_pair
    fs, fd = jfeat.fpfh(js), jfeat.fpfh(jd)
    _, fwd = jnn(fs, fd, valid=jd.valid)
    _, bwd = jnn(fd, fs, valid=js.valid)
    cv = js.valid & (jnp.arange(800) == bwd[fwd])
    H = 64
    keys = jax.random.split(jax.random.PRNGKey(0), H)
    logits = jnp.where(cv, 0.0, -1e9)
    picks = np.array(jax.vmap(
        lambda k: jax.random.categorical(k, logits, shape=(3,)))(keys))

    def hypothesis(sel):  # the body of the JAX ``_ransac_core``
        T = jicp.register_kabsch(js.points[sel], jd.points[fwd[sel]],
                                 cv[sel].astype(jnp.float32) + 1e-3)
        mv = jnp.matmul(js.points, T[:3, :3].T,
                        precision=jax.lax.Precision.HIGHEST) + T[:3, 3]
        err = jnp.linalg.norm(mv - jd.points[fwd], axis=-1)
        return T, jnp.sum((err < 0.05) & cv)

    Tj, sj = (np.asarray(a) for a in jax.jit(jax.vmap(hypothesis))(
        jnp.asarray(picks)))
    Tt, st, best = tfeat._score_hypotheses(
        ts.points, td.points, torch.as_tensor(np.array(fwd)).long(),
        torch.as_tensor(np.array(cv)), torch.as_tensor(picks).long(), 0.05)
    assert int(best) == int(np.argmax(sj))
    src, dst = np.asarray(js.points, np.float64), np.asarray(jd.points,
                                                              np.float64)
    w = np.asarray(cv)[picks] + 1e-3
    gaps = np.array([_horn_gap(src[p], dst[np.asarray(fwd)[p]], ww)
                     for p, ww in zip(picks, w)])
    clear = gaps > 0.05
    tied = int((~clear).sum())
    assert tied <= H // 8, f"{tied} of {H} hypotheses tied"
    np.testing.assert_array_equal(st.numpy()[clear], sj[clear])
    np.testing.assert_allclose(Tt.numpy()[clear], Tj[clear], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(Tt[best].numpy(), Tj[int(best)], rtol=0,
                               atol=1e-5)
    # the JAX core itself picks the same best from the same key
    Tbj, sbj = jfeat._ransac_core(js.points, jd.points, fwd, cv,
                                  jax.random.PRNGKey(0), 0.05, H)
    assert int(sbj) == int(st[best])
    np.testing.assert_allclose(Tt[best].numpy(), np.asarray(Tbj), rtol=0,
                               atol=1e-5)


def test_ransac_falls_back_to_identity_with_nothing_valid():
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(surface_points(rng, 50))
    gen = torch.Generator().manual_seed(0)
    T, score = tfeat._ransac_core(pts, pts, torch.arange(50),
                                  torch.zeros(50, dtype=torch.bool), gen,
                                  0.05, 16)
    np.testing.assert_array_equal(T.numpy(), np.eye(4))
    assert int(score) == 0
    Tj, sj = jfeat._ransac_core(jnp.asarray(pts.numpy()),
                                jnp.asarray(pts.numpy()), jnp.arange(50),
                                jnp.zeros(50, bool), jax.random.PRNGKey(0),
                                0.05, 16)
    np.testing.assert_array_equal(np.asarray(Tj), np.eye(4))
    assert int(sj) == 0


def test_ransac_color_gate_drops_disagreeing_colors():
    rng = np.random.default_rng(4)
    pts = torch.as_tensor(surface_points(rng, 64))
    cols = torch.as_tensor(rng.uniform(size=(64, 3)).astype(np.float32))
    idx = torch.arange(64)
    valid = torch.ones(64, dtype=torch.bool)
    gate = tfeat._color_gate(cols, 1.0 - cols, idx, valid, 0.25)
    want = np.linalg.norm(2 * cols.numpy() - 1.0, axis=-1) < 0.25
    np.testing.assert_array_equal(gate.numpy(), want)
    assert tfeat._color_gate(None, cols, idx, valid, 0.25) is valid


class TestKabsch:
    """Twins of ``tests/test_ops_icp.py::TestKabsch``."""

    def test_exact_recovery(self):
        rng = np.random.default_rng(10)
        pts = surface_points(rng, 100)
        T = random_transform(rng, 0.5, 0.3)
        T_got = ticp.register_kabsch(torch.as_tensor(pts),
                                     torch.as_tensor(moved(pts, T)),
                                     torch.ones(100)).numpy()
        rot_err, trans_err = transform_error(T_got, T)
        assert rot_err < 1e-5 and trans_err < 1e-5

    def test_weighted(self):
        rng = np.random.default_rng(11)
        pts = surface_points(rng, 100)
        T = random_transform(rng, 0.3, 0.2)
        dst = moved(pts, T)
        dst[:10] += 5.0
        w = np.ones(100, np.float32)
        w[:10] = 0.0
        T_got = ticp.register_kabsch(torch.as_tensor(pts),
                                     torch.as_tensor(dst),
                                     torch.as_tensor(w)).numpy()
        rot_err, trans_err = transform_error(T_got, T)
        assert rot_err < 1e-5 and trans_err < 1e-5


class TestICP:
    """Twins of ``tests/test_ops_icp.py::TestICP``."""

    def _pair(self, seed, n, a, t):
        rng = np.random.default_rng(seed)
        pts = surface_points(rng, n)
        T = random_transform(rng, a, t)
        return pts, T

    def test_point_to_point_recovers_pose(self):
        pts, T = self._pair(20, 1500, 0.08, 0.03)
        res = ticp.icp_point_to_point(
            tpc.make_cloud(pts, device="cpu"),
            tpc.make_cloud(moved(pts, T), device="cpu"),
            max_correspondence_distance=0.1)
        rot_err, trans_err = transform_error(res.transformation.numpy(), T)
        assert rot_err < 5e-3 and trans_err < 2e-3
        assert float(res.fitness) > 0.95

    def test_point_to_plane_recovers_pose(self):
        pts, T = self._pair(21, 1500, 0.08, 0.03)
        dst = tpc.estimate_normals(
            tpc.make_cloud(moved(pts, T), device="cpu"), k=12)
        res = ticp.icp_point_to_plane(tpc.make_cloud(pts, device="cpu"), dst,
                                      max_correspondence_distance=0.1)
        rot_err, trans_err = transform_error(res.transformation.numpy(), T)
        assert rot_err < 5e-3 and trans_err < 2e-3

    def test_icp_with_partial_overlap(self):
        pts, T = self._pair(22, 2000, 0.05, 0.02)
        src = tpc.make_cloud(pts[pts[:, 0] > -0.1], device="cpu")
        dst = tpc.make_cloud(moved(pts[pts[:, 0] < 0.3], T), device="cpu")
        res = ticp.icp_point_to_point(src, dst,
                                      max_correspondence_distance=0.1)
        rot_err, trans_err = transform_error(res.transformation.numpy(), T)
        assert rot_err < 0.02 and trans_err < 0.01

    def test_identity_when_aligned(self):
        pts, _ = self._pair(23, 500, 0.0, 0.0)
        src = tpc.make_cloud(pts, device="cpu")
        res = ticp.icp_point_to_point(src, src,
                                      max_correspondence_distance=0.05)
        rot_err, trans_err = transform_error(res.transformation.numpy(),
                                             np.eye(4))
        assert rot_err < 1e-4 and trans_err < 1e-4
        assert float(res.fitness) > 0.999


class TestColoredICP:
    """Twin of ``tests/test_ops_icp.py::TestColoredICP``."""

    def test_color_breaks_geometric_ambiguity(self):
        pts, colors, dst_pts, T = _textured_plane()
        src = tpc.make_cloud(pts, colors=colors, device="cpu")
        dst = tpc.estimate_normals(
            tpc.make_cloud(dst_pts, colors=colors, device="cpu"), k=12)
        res = ticp.colored_icp(src, dst, ticp.color_gradients(dst),
                               max_correspondence_distance=0.1)
        _, trans_err = transform_error(res.transformation.numpy(), T)
        assert trans_err < 0.01, trans_err
        res_geo = ticp.icp_point_to_plane(src, dst,
                                          max_correspondence_distance=0.1)
        _, trans_err_geo = transform_error(res_geo.transformation.numpy(), T)
        assert trans_err_geo > trans_err


class TestFeatures:
    """Twin of ``tests/test_recon_io.py::TestFeatures``."""

    def test_fpfh_ransac_recovers_pose(self, feature_pair):
        _, _, _, _, R, t = feature_pair
        pts = surface_points(np.random.default_rng(0), 800)
        src = tpc.estimate_normals(tpc.make_cloud(pts, device="cpu"), k=16)
        dst = tpc.estimate_normals(tpc.make_cloud(
            (pts @ R.T + t).astype(np.float32), device="cpu"), k=16)
        T, score = tfeat.ransac_global_registration(
            src, dst, tfeat.fpfh(src), tfeat.fpfh(dst), inlier_threshold=0.05,
            n_hypotheses=256)
        assert isinstance(T, np.ndarray) and score > 200
        rot_err = np.arccos(np.clip((np.trace(T[:3, :3] @ R.T) - 1) / 2, -1,
                                    1))
        assert rot_err < 0.05
        assert np.linalg.norm(T[:3, 3] - t) < 0.02


# ``ops/icp``'s point-to-plane and colored solves as they stood before
# their steps went behind ``ops/kernels/icp_step`` (the plain loop, step
# bodies and result, word for word): the solves on CPU tensors must keep
# these bits
def _before_solve(step, T0, max_iteration, relative_rmse):
    T = T0
    rmse = torch.tensor(1e30)
    prev = torch.tensor(0.0)
    iters = torch.zeros((), dtype=torch.int32)
    live = torch.ones((), dtype=torch.bool)
    for it in range(max_iteration):
        live = live & ((prev - rmse).abs()
                       > relative_rmse * torch.clamp(rmse, min=1e-12))
        if it and it % ticp.CHECK_EVERY == 0 and not bool(live):
            break
        T_new, rmse_new = step(T)
        T = torch.where(live, T_new, T)
        prev = torch.where(live, rmse, prev)
        rmse = torch.where(live, rmse_new, rmse)
        iters = iters + live.to(torch.int32)
    return T, iters


def _before_final(T, source, target, max_dist, iters):
    _, _, d, w = ticp._correspondences(T, source.points, source.valid,
                                       target.points, target.valid, max_dist)
    n_src = torch.clamp(source.valid.to(torch.float32).sum(), min=1.0)
    n_in = torch.clamp(w.sum(), min=1.0)
    return ticp.ICPResult(T, w.sum() / n_src,
                          torch.sqrt((w * d * d).sum() / n_in), iters)


def _before_point_to_plane(source, target, dist, init, max_iteration=30,
                           relative_rmse=1e-6):
    def step(T):
        moved, idx, _, w = ticp._correspondences(
            T, source.points, source.valid, target.points, target.valid,
            dist)
        q = target.points[idx]
        n = target.normals[idx]
        r = (n * (moved - q)).sum(dim=-1)
        A = torch.cat([ticp._cross(moved, n), n], dim=-1)
        xi = ticp._gauss_newton_step(A, r, w)
        T_new = ticp._matmul4(ticp._se3_exp(xi), T)
        n_in = torch.clamp(w.sum(), min=1.0)
        return T_new, torch.sqrt((w * r * r).sum() / n_in)

    T, iters = _before_solve(step, ticp._init(init, "cpu"), max_iteration,
                             relative_rmse)
    return _before_final(T, source, target, dist, iters)


def _before_colored(source, target, target_gradients, dist, init,
                    max_iteration=50, lambda_geometric=0.968,
                    relative_rmse=1e-6):
    T0 = ticp._init(init, "cpu")
    lg = torch.tensor(lambda_geometric, dtype=torch.float32)
    sqrt_lg = torch.sqrt(lg)
    sqrt_lc = torch.sqrt(1.0 - lg)
    c_src = ticp._intensity(source.colors)
    c_tgt = ticp._intensity(target.colors)

    def step(T):
        moved, idx, _, w = ticp._correspondences(
            T, source.points, source.valid, target.points, target.valid,
            dist)
        q = target.points[idx]
        n = target.normals[idx]
        grad = target_gradients[idx]
        cq = c_tgt[idx]
        r_g = (n * (moved - q)).sum(dim=-1)
        A_g = torch.cat([ticp._cross(moved, n), n], dim=-1) * sqrt_lg
        dpq = moved - q
        proj = moved - (dpq * n).sum(dim=-1, keepdim=True) * n
        c_proj = cq + (grad * (proj - q)).sum(dim=-1)
        r_c = c_src - c_proj
        M = grad - (grad * n).sum(dim=-1, keepdim=True) * n
        A_c = torch.cat([ticp._cross(moved, -M), -M], dim=-1) * sqrt_lc
        A = torch.cat([A_g, A_c], dim=0)
        r = torch.cat([r_g * sqrt_lg, r_c * sqrt_lc], dim=0)
        xi = ticp._gauss_newton_step(A, r, torch.cat([w, w], dim=0))
        T_new = ticp._matmul4(ticp._se3_exp(xi), T)
        n_in = torch.clamp(w.sum(), min=1.0)
        rmse = torch.sqrt(((w * r_g ** 2).sum() * lg
                           + (w * r_c ** 2).sum() * (1 - lg)) / n_in)
        return T_new, rmse

    T, iters = _before_solve(step, T0, max_iteration, relative_rmse)
    return _before_final(T, source, target, dist, iters)


@pytest.fixture(scope="module")
def colored_pair():
    """A bumpy sphere with a color pattern and its moved copy, the target
    with normals and intensity gradients."""
    rng = np.random.default_rng(5)
    pts = surface_points(rng, 1500)
    dst = moved(pts, random_transform(rng, 0.06, 0.02))
    cols = np.repeat(0.5 + 0.5 * np.sin(7 * pts[:, :1]), 3, 1).astype(
        np.float32)
    valid = rng.uniform(size=len(pts)) > 0.3
    return pts, dst, cols, valid


@pytest.mark.parametrize("case", ["overlap", "scattered", "zero_inliers",
                                  "no_valid_source", "iteration_cap"])
@pytest.mark.parametrize("kind", ["point_to_plane", "colored"])
def test_plain_solves_keep_their_bits(colored_pair, kind, case):
    """On CPU tensors the solves through ``ops/kernels/icp_step``'s plain
    version equal, bit for bit, the loop they ran before: T, fitness,
    inlier rmse and iterations, including a solve with no inlier, one
    with no valid source point and one stopped by its iteration cap."""
    pts, dst, cols, valid = colored_pair
    src_valid = {"scattered": valid,
                 "no_valid_source": np.zeros_like(valid)}.get(case)
    src = tpc.make_cloud(pts, colors=cols, valid=src_valid, device="cpu")
    tgt = tpc.estimate_normals(tpc.make_cloud(
        dst + (10.0 if case == "zero_inliers" else 0.0), colors=cols,
        valid=valid if case == "scattered" else None, device="cpu"), k=12)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.01, -0.005, 0.0]
    kw = {"max_iteration": 3} if case == "iteration_cap" else {}
    if kind == "point_to_plane":
        got = ticp.icp_point_to_plane(src, tgt, 0.1, init=init, **kw)
        want = _before_point_to_plane(src, tgt, 0.1, init, **kw)
    else:
        grads = ticp.color_gradients(tgt)
        got = ticp.colored_icp(src, tgt, grads, 0.1, init=init, **kw)
        want = _before_colored(src, tgt, grads, 0.1, init, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (g, w)
    assert int(got.iterations) == {"zero_inliers": 2, "no_valid_source": 2,
                                   "iteration_cap": 3}.get(
        case, int(got.iterations))


def test_icp_step_wrapper_reads_the_kernels_layout():
    """The wrapper's kinds, buffer sizes and state words are the kernel's
    own constants (``csrc/icp_step.cu``)."""
    import re
    from pathlib import Path

    k9 = importlib.import_module(
        "reconplan_tpu_torch.ops.kernels.icp_step")

    src = (Path(k9.__file__).parents[2] / "csrc" / "icp_step.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kPointToPlane"], consts["kColored"],
            consts["kResult"]) == (k9.POINT_TO_PLANE, k9.COLORED,
                                   k9._RESULT)
    assert consts["kSourcesPerBlock"] == k9.SOURCES_PER_BLOCK
    assert consts["kStateWords"] == k9.STATE_WORDS
    assert consts["kPartialWords"] == k9.PARTIAL_WORDS
    assert (consts["kT"], consts["kRmse"], consts["kPrev"], consts["kIters"],
            consts["kLive"], consts["kFitness"], consts["kInlierRmse"]) == (
        0, k9._RMSE, k9._PREV, k9._ITERS, k9._LIVE, k9._FITNESS,
        k9._INLIER_RMSE)


def test_icp_solves_on_the_cpu_launch_nothing(colored_pair):
    """CPU tensors take the plain version: the steps are counted in
    ``icp.steps`` and none in ``kernel.icp_step``; the wrapper refuses an
    unknown kind and an empty cloud."""
    k9 = importlib.import_module(
        "reconplan_tpu_torch.ops.kernels.icp_step")
    from reconplan_tpu_torch.utils import profiling

    pts, dst, cols, _ = colored_pair
    src = tpc.make_cloud(pts, colors=cols, device="cpu")
    tgt = tpc.estimate_normals(tpc.make_cloud(dst, colors=cols,
                                              device="cpu"), k=12)
    with profiling.recording() as rec:
        res = ticp.colored_icp(src, tgt, ticp.color_gradients(tgt), 0.1,
                               max_iteration=6)
    assert rec.counters["icp.steps"] == int(res.iterations) == 6
    assert not any(k.startswith("kernel.") for k in rec.counters)
    with pytest.raises(ValueError, match="unknown kind 2"):
        k9.icp_solve(k9._RESULT, src, tgt, torch.eye(4), 0.1, 1e-6, None,
                     None)
    empty = tpc.make_cloud(np.zeros((0, 3), np.float32), device="cpu")
    with pytest.raises(ValueError, match="needs a source and a target"):
        k9.icp_solve(k9.POINT_TO_PLANE, empty, tgt, torch.eye(4), 0.1, 1e-6,
                     None, None)
