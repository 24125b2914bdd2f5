"""``reconplan_tpu_torch.recon.stitcher``, ``viz.html_export`` and
``apps.stitch`` against the JAX package on the CPU, and port-only twins
of ``TestStitcher`` of ``tests/test_recon_io.py``.

The scene is the banana of ``TestStitcher`` seen by a 160x120 camera
(fx = 100) from three nearby eyes, rendered once by the port's splat
camera; both packages stitch the same numpy pictures with the scan's
settings (4 mm voxel, 0.02 m distance) and 2,048 model slots. The JAX
stitch runs once, in a module fixture (its ``lax.scan`` step takes
seconds to compile).

Tolerances and why:
* one registration (``_register_j``: coarse point-to-plane, colored
  ICP, fine point-to-plane) from the same model, frame and pose: T
  within 1e-5, fitness within 1e-6.
* the whole pose-seeded sequence: model counts within 1%, the two
  models within 0.2 mm of each other (Chamfer), and each
  ``last_transforms`` within 1e-3 m and 3e-3 rad. On this smooth object
  every ICP of the sequence ends in a two-cycle at its iteration cap
  (the rmse alternates between two values and never settles), so the
  last step's T moves with any rounding: the JAX package's own stitch
  (jitted inside its ``lax.scan``) and its own ``_register_j`` called
  from the same state part by 1.35e-3 rad, as much as the two packages.
  The 1e-5 of the single registration above is what the packages agree
  to when each runs the same operations outside a fused program.
* the fixed-capacity compaction (``jnp.nonzero(size=, fill_value=0)``
  in the JAX package): the same indices.
* ``export_cloud_html``: the same page, byte for byte.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.ops import pointcloud as jpc
from reconplan_tpu.recon import stitcher as jst
from reconplan_tpu.viz import html_export as jhtml
from reconplan_tpu_torch.apps import stitch as tstitch_app
from reconplan_tpu_torch.io.render import SplatCamera
from reconplan_tpu_torch.ops import pointcloud as tpc
from reconplan_tpu_torch.recon import metrics as tmetrics
from reconplan_tpu_torch.recon import stitcher as tst
from reconplan_tpu_torch.viz import html_export as thtml

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANANA = os.path.join(REPO, "data/objects/011_banana/poisson/nontextured.ply")
OBJ = np.array([0.75, 0.75, 0.0])
K = (160, 120, 100, 100, 80, 60)


def _camera():
    cam = SplatCamera(width=160, height=120, fx=100, fy=100, cx=80, cy=60,
                      samples_per_mesh=300_000, device="cpu")
    cam.add_mesh_file(BANANA, translate=tuple(OBJ))
    return cam


def _pictures(cam, eyes):
    frames = [cam.take_picture(e, OBJ) for e in eyes]
    return ([f[1].numpy() for f in frames], [f[0].numpy() for f in frames],
            np.stack([f[2] for f in frames]).astype(np.float32))


@pytest.fixture(scope="module")
def scene():
    return _pictures(_camera(), [[0.45, 0.45, 0.3], [0.48, 0.43, 0.31],
                                 [0.5, 0.42, 0.32]])


def _setup(st, cap=2048):
    st.voxel_size = 0.004
    st.distance_threshold = 0.02
    st.model_capacity = cap
    return st


@pytest.fixture(scope="module")
def stitched(scene):
    colors, depths, poses = scene
    sj = _setup(jst.RGBDStitcher(jst.PinholeIntrinsic(*K)))
    cj = sj.stitch_sequence(colors, depths, poses=poses)
    stt = _setup(tst.RGBDStitcher(tst.PinholeIntrinsic(*K), device="cpu"))
    ct = stt.stitch_sequence(colors, depths, poses=poses)
    return sj, cj, stt, ct


def _angle(R):
    """Rotation angle of R, exact near 0 too (arctan2 of sin and cos)."""
    R = np.asarray(R, np.float64)
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]]) / 2
    return np.arctan2(s, (np.trace(R) - 1) / 2)


def test_pose_seeded_stitch_matches_jax(stitched, scene):
    sj, cj, stt, ct = stitched
    pj, colj, _ = cj.compact()
    pt, colt, _ = ct.compact()
    assert len(pt) > 400 and abs(len(pt) - len(pj)) <= 0.01 * len(pj)
    assert colt.shape == pt.shape  # the model keeps its colors
    assert stt.last_transforms.shape == (2, 4, 4)
    assert stt.last_scores.shape == (2, 2) and (stt.last_scores == 1).all()
    np.testing.assert_allclose(stt.last_fits, sj.last_fits, rtol=0,
                               atol=1e-6)
    for Tt, Tj in zip(stt.last_transforms, sj.last_transforms):
        assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 1e-3
        assert _angle(Tt[:3, :3] @ Tj[:3, :3].T) < 3e-3
    ch, _, _ = tmetrics.chamfer_distance(pt, pj, device="cpu")
    assert float(ch) < 2e-4


def test_one_registration_matches_jax(scene, stitched):
    """Frame 1 against the model of frame 0, from its pose: the same
    steps as the stitch, each package outside a fused program."""
    colors, depths, poses = scene
    sj = _setup(jst.RGBDStitcher(jst.PinholeIntrinsic(*K)))
    stt = _setup(tst.RGBDStitcher(tst.PinholeIntrinsic(*K), device="cpu"))
    cap = sj.model_capacity
    empty_j = jpc.PointCloud(jnp.zeros((cap, 3)), jnp.zeros(cap, bool),
                             jnp.zeros((cap, 3)), jnp.zeros((0, 3)))
    empty_t = tpc.PointCloud(torch.zeros((cap, 3)),
                             torch.zeros(cap, dtype=torch.bool),
                             torch.zeros((cap, 3)), torch.zeros((0, 3)))
    mj, oj = sj._model_append(
        empty_j, sj.create_point_cloud_from_rgbd(colors[0], depths[0]),
        jnp.asarray(poses[0]))
    mt, ot = stt._model_append(
        empty_t, stt.create_point_cloud_from_rgbd(colors[0], depths[0]),
        torch.as_tensor(poses[0]))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    np.testing.assert_allclose(mt.points.numpy(), np.asarray(mj.points),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(mt.colors.numpy(), np.asarray(mj.colors),
                               rtol=0, atol=1e-6)
    assert int(ot) == int(oj) == 0

    dj = jpc.voxel_downsample(
        sj.create_point_cloud_from_rgbd(colors[1], depths[1]), 0.004)
    (cidx,) = jnp.nonzero(dj.valid, size=cap, fill_value=0)
    cur_j = jpc.PointCloud(dj.points[cidx], jnp.arange(cap) < jnp.sum(
        dj.valid), dj.colors[cidx], dj.normals)
    dt = tpc.voxel_downsample(
        stt.create_point_cloud_from_rgbd(colors[1], depths[1]), 0.004)
    idx, count = tst._gather_slots(dt.valid, cap)
    cur_t = tst._take(dt, idx, count, cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(cidx))

    Tj, fj = sj._register_j(cur_j, mj, jnp.asarray(poses[1]))
    Tt, ft = stt._register_j(cur_t, mt, torch.as_tensor(poses[1]))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-5)
    assert float(ft) == pytest.approx(float(fj), abs=1e-6)
    assert float(stt._tight_score_j(cur_t, mt, Tt)) == pytest.approx(
        float(sj._tight_score_j(cur_j, mj, Tj)), abs=1e-3)
    # the JAX package's own stitch took frame 1 through the same steps,
    # jitted inside its lax.scan: at the ICPs' two-cycle it lands 1.35e-3
    # rad from this registration, and the port's stitch is no further
    # from it than that spread, twice over
    sj_seq, _, st_seq, _ = stitched
    R_seq = sj_seq.last_transforms[0][:3, :3]
    jax_self = _angle(np.asarray(Tj)[:3, :3] @ R_seq.T)
    assert 1e-4 < jax_self < 3e-3
    assert _angle(st_seq.last_transforms[0][:3, :3] @ R_seq.T) \
        <= 2 * jax_self


@pytest.mark.parametrize("cap", [16, 300, 1000])
def test_gather_slots_match_jnp_nonzero(cap):
    valid = np.random.default_rng(cap).uniform(size=600) < 0.5
    (want,) = jnp.nonzero(jnp.asarray(valid), size=cap, fill_value=0)
    idx, count = tst._gather_slots(torch.as_tensor(valid), cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    assert int(count) == valid.sum()


def test_model_overflow_warns_once(scene):
    colors, depths, poses = scene
    st = _setup(tst.RGBDStitcher(tst.PinholeIntrinsic(*K), device="cpu"),
                cap=64)
    with pytest.warns(RuntimeWarning, match="overflowed"):
        cloud = st.stitch_sequence(colors[:1], depths[:1], poses=poses[:1])
    assert cloud.count() == 64 and not hasattr(st, "last_fits")


def test_export_cloud_html_writes_the_jax_page(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    for kw in ({}, {"colors": cols}, {"max_points": 100}):
        want = jhtml.export_cloud_html(pts, str(tmp_path / "j.html"), **kw)
        got = thtml.export_cloud_html(pts, str(tmp_path / "t.html"), **kw)
        assert open(got).read() == open(want).read()


class _SmallStitcher(tst.RGBDStitcher):
    """The CLI's stitcher with 2,048 model slots: the default 32,768
    make every nearest-neighbour pass a 32,768^2 product, minutes on the
    CPU, for the ~50 voxels a banana fills at the default 2 cm voxel."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.model_capacity = 2048


def test_stitch_cli_on_a_png_capture(tmp_path, scene, monkeypatch):
    import PIL.Image

    monkeypatch.setattr(tstitch_app, "RGBDStitcher", _SmallStitcher)
    colors, depths, _ = scene
    for sub in ("rgb", "depth"):
        os.makedirs(tmp_path / "cap" / sub)
    for i, (c, d) in enumerate(zip(colors[:2], depths[:2])):
        PIL.Image.fromarray(c).save(tmp_path / "cap" / "rgb" / f"{i:03d}.png")
        PIL.Image.fromarray(d.astype(np.uint16)).save(
            tmp_path / "cap" / "depth" / f"{i:03d}.png")
    out = tmp_path / "cloud.ply"
    tstitch_app.main([str(tmp_path / "cap"), "--out", str(out),
                      "--width", "160", "--height", "120",
                      "--device", "cpu"])
    from reconplan_tpu_torch.io.meshio import load_mesh

    v, _ = load_mesh(str(out))
    assert 10 < len(v) < 2000


class TestStitcher:
    """Twins of ``tests/test_recon_io.py::TestStitcher``."""

    def test_stitch_two_synthetic_frames(self, scene):
        """At the reference's defaults, but 2,048 model slots (the JAX
        twin's 32,768 cost it 72 s and the slow mark)."""
        colors, depths, poses = scene
        st = _SmallStitcher(tst.PinholeIntrinsic(*K), device="cpu")
        cloud = st.stitch_sequence(colors[:2], depths[:2], poses=poses[:2])
        pts, _, _ = cloud.compact()
        assert 30 < len(pts) < 500
        assert abs(pts[:, 0].mean() - 0.75) < 0.1
        assert abs(pts[:, 1].mean() - 0.75) < 0.1

    def test_visualize_registration_writes_overlay(self, tmp_path):
        st = tst.RGBDStitcher(tst.PinholeIntrinsic(*K), device="cpu")
        rng = np.random.default_rng(0)
        src = tpc.make_cloud(rng.normal(size=(40, 3)), device="cpu")
        tgt = tpc.make_cloud(rng.normal(size=(50, 3)),
                             colors=rng.uniform(size=(50, 3)), device="cpu")
        moved = tpc.make_cloud(rng.normal(size=(30, 3)), device="cpu")
        out = st.visualize_registration(src, tgt, transformed=moved,
                                        path=str(tmp_path / "reg.html"))
        html = open(out).read()
        assert html.count("rgb(255,0,0)") == 40
        assert html.count("rgb(0,0,255)") == 30
        assert "points" in html

    def test_pose_free_stitch_survives_viewpoint_jump(self):
        """The JAX twin's scene and bounds (six frames, a ~60 degree
        azimuth jump between two clusters), at 1,024 model slots, which
        the banana's ~900 occupied 4 mm voxels fit, to keep it fast."""
        cam = _camera()
        r, h = 0.35, 0.25
        eyes = [OBJ + [r * np.cos(a), r * np.sin(a), h]
                for a in (2.0, 2.1, 2.2, 3.2, 3.3, 3.4)]
        colors, depths, poses = _pictures(cam, eyes)
        st = _setup(tst.RGBDStitcher(tst.PinholeIntrinsic(*K), device="cpu"),
                    cap=1024)
        cloud = st.stitch_sequence(colors, depths, poses=None)
        pts, _, _ = cloud.compact()
        world = pts @ poses[0][:3, :3].T + poses[0][:3, 3]
        center_err = np.linalg.norm(world.mean(axis=0)[:2] - OBJ[:2])
        assert center_err < 0.03, f"stitched center off by {center_err:.3f} m"
        spread = np.linalg.norm(world - world.mean(axis=0), axis=1).max()
        assert spread < 0.2, f"cloud spread {spread:.3f} m (divergence)"
        # the jump frame collapses when chained and is rescued
        chained, accepted = st.last_scores.T
        assert (accepted >= st.integrate_score_floor).all()
        assert (chained < st.global_rescue_score).any()
