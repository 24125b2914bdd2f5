"""The port's dense TSDF engine against ``reconplan_tpu.ops.tsdf``.

Same inputs (the analytic sphere of ``test_tsdf_marching``) through both
packages; the JAX side runs op by op with the same w2c poses
(``torch_parity.jax_eager``), so the two agree to the last bit.
"""

import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.ops import tsdf as jtsdf
from reconplan_tpu_torch.apps import redundancy as tredundancy
from reconplan_tpu_torch.apps import scan as tscan
from reconplan_tpu_torch.core import grids as tgrids
from reconplan_tpu_torch.grr import nearest_neighbors as tnn
from reconplan_tpu_torch.grr import resolution as tres
from reconplan_tpu_torch.grr import solver as tsolver
from reconplan_tpu_torch.grr import workspace as tws
from reconplan_tpu_torch.grr import paths as tpaths
from reconplan_tpu_torch.io import render as trender
from reconplan_tpu_torch.io.config import load_problem
from reconplan_tpu_torch.io.frames import FrameSet
from reconplan_tpu_torch.kin import chain as tchain
from reconplan_tpu_torch.kin import robot as trobot
from reconplan_tpu_torch.kin.rob_parser import parse_rob
from reconplan_tpu_torch.ops import pointcloud as tpc
from reconplan_tpu_torch.ops import tsdf as ttsdf
from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.parallel import make_sharded_brick_grid
from reconplan_tpu_torch.recon import fusion as tfusion
from reconplan_tpu_torch.recon import metrics as tmetrics
from reconplan_tpu_torch.recon import poisson as tpoisson
from reconplan_tpu_torch.recon import stitcher as tstitcher
from reconplan_tpu_torch.utils import device as tdevice
from test_tsdf_marching import make_sphere_depths
from torch_parity import jax_eager

torch.set_num_threads(2)

DIMS = (96, 96, 96)
ORIGIN = (-0.15, -0.15, -0.15)
VOX = 0.3 / 95


@pytest.fixture(scope="module")
def scene():
    depths, poses, K = make_sphere_depths()
    rng = np.random.default_rng(0)
    colors = rng.uniform(size=depths.shape + (3,)).astype(np.float32)
    return depths, poses, K, colors


def _fuse_both(depths, poses, K, colors=None, dims=DIMS):
    with_color = colors is not None
    with jax_eager():
        gj = jtsdf.make_grid(dims, ORIGIN, VOX, with_color=with_color)
        gj = jtsdf.integrate_frames(
            gj, jnp.asarray(depths), jnp.asarray(poses), *K,
            colors=None if colors is None else jnp.asarray(colors),
        )
    gt = ttsdf.make_grid(dims, ORIGIN, VOX, with_color=with_color,
                         device="cpu")
    gt = ttsdf.integrate_frames(gt, depths, poses, *K, colors=colors)
    return gj, gt


def test_dense_integration_matches_jax(scene):
    depths, poses, K, _ = scene
    gj, gt = _fuse_both(depths, poses, K)
    wj, wt = np.asarray(gj.weight), gt.weight.numpy()
    np.testing.assert_array_equal(wt, wj)
    both = (wj > 0) & (wt > 0)
    assert both.sum() > 100_000
    diff = np.abs(np.asarray(gj.sdf) - gt.sdf.numpy())
    assert diff.max() <= 1e-6, diff.max()


def test_dense_color_matches_jax(scene):
    depths, poses, K, colors = scene
    gj, gt = _fuse_both(depths[:4], poses[:4], K, colors[:4], dims=(48,) * 3)
    np.testing.assert_array_equal(gt.weight.numpy(), np.asarray(gj.weight))
    assert np.abs(np.asarray(gj.sdf) - gt.sdf.numpy()).max() <= 1e-6
    cdiff = np.abs(np.asarray(gj.color) - gt.color.numpy())
    assert cdiff.max() <= 1e-6, cdiff.max()
    assert gt.has_color and gt.color.shape == (48, 48, 48, 3)


def test_extract_surface_points_masks_identical(scene):
    depths, poses, K, _ = scene
    gj, gt = _fuse_both(depths, poses, K)
    with jax_eager():
        pj, mj = jtsdf.extract_surface_points(gj)
    pt, mt = ttsdf.extract_surface_points(gt)
    mj = np.asarray(mj)
    np.testing.assert_array_equal(mt.numpy(), mj)
    assert mj.sum() > 500
    np.testing.assert_array_equal(pt.numpy()[mj], np.asarray(pj)[mj])


def test_state_carries_from_jax_grid(scene):
    """4 frames in JAX, convert the grid, 4 more frames in both."""
    depths, poses, K, _ = scene
    with jax_eager():
        gj = jtsdf.make_grid(DIMS, ORIGIN, VOX)
        gj = jtsdf.integrate_frames(
            gj, jnp.asarray(depths[:4]), jnp.asarray(poses[:4]), *K)
    gt = ttsdf.tsdf_grid_from_numpy(
        np.asarray(gj.sdf), np.asarray(gj.weight), np.asarray(gj.color),
        np.asarray(gj.origin), float(gj.voxel_size), float(gj.trunc),
        device="cpu")
    back = ttsdf.tsdf_grid_to_numpy(gt)
    np.testing.assert_array_equal(back["sdf"], np.asarray(gj.sdf))
    assert back["trunc"] == float(gj.trunc)
    with jax_eager():
        gj = jtsdf.integrate_frames(
            gj, jnp.asarray(depths[4:]), jnp.asarray(poses[4:]), *K)
    gt = ttsdf.integrate_frames(gt, depths[4:], poses[4:], *K)
    np.testing.assert_array_equal(gt.weight.numpy(), np.asarray(gj.weight))
    assert np.abs(np.asarray(gj.sdf) - gt.sdf.numpy()).max() <= 1e-6


def test_resolve_device_never_substitutes_cpu(monkeypatch):
    """The card is the default: with none present, no device and "cuda"
    both raise (and say how to ask for the CPU), and "cpu" resolves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tdevice.resolve_device("cuda")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tdevice.resolve_device(None)
    assert tdevice.resolve_device("cpu").type == "cpu"
    assert tdevice.resolve_device(torch.device("cpu")).type == "cpu"


def test_resolve_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdevice.resolve_device(None) == torch.device("cuda")
    assert tdevice.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert tdevice.resolve_device("cpu").type == "cpu"


_SMALL = ((16, 16, 16), (0.0, 0.0, 0.0), 0.01)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PLANAR_ROB = os.path.join(_REPO, "data", "robots", "planar_5.rob")


def _small_frames():
    return FrameSet(depth=np.zeros((1, 8, 8), np.float32),
                    poses=np.eye(4, dtype=np.float32)[None],
                    intrinsics=(10.0, 10.0, 4.0, 4.0))


_ARC = (np.array([0.4, 0.1, 0.3, 0.0, 0.0, 0.0, 1.0]),
        np.array([0.0, 0.0, 0.0, 0.0, 0.0, np.pi / 2]))


def _planar():
    """The five-link planar arm on the CPU, for the roadmap classes (each
    takes the robot's device, and raises when asked for another)."""
    return trobot.Planar("planar_5", [[-0.5, 0.5], [-0.5, 0.5], [0, 0]],
                         [0, 0, 1], device="cpu")


def _build_roadmap(**kw):
    with tempfile.TemporaryDirectory() as out:
        return tredundancy.build_roadmap(
            "ur10", "rot_free", n_pos_points=4, seeds="json", out_dir=out,
            verbose=False, **kw)


def _run_scan(**kw):
    with tempfile.TemporaryDirectory() as out:
        return tscan.run_scan(
            roadmap_dir=os.path.join(_REPO, "graph", "ur10", "rot_free"),
            n_waypoints=2, n_images=1, grid_dim=16, reconstruct="fuse",
            close_mesh=False, out_dir=out, verbose=False, **kw)


def _numpy_out(result):
    """For an entry point that takes and returns numpy: nothing of the
    result is left on a device, so the CPU call only has to run."""
    first = result[0][1] if isinstance(result, list) else result
    first = first[0] if isinstance(first, tuple) else first
    assert isinstance(first, np.ndarray)
    return torch.device("cpu")


_planes = lambda v, dt: np.full((5, 8, 128), v, dt)  # noqa: E731


def _ball(n=200):
    """Points of a unit sphere and their outward normals, numpy."""
    d = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d, d.copy()


def _gate(**kw):
    tris = np.random.default_rng(1).normal(size=(20, 3, 3)).astype(
        np.float32)
    return tscan.close_gate_signals(tris[:10], tris, _ball()[0],
                                    n_samples=100, **kw)


def _dict_out(result):
    """For an entry point that returns a dict of floats."""
    assert isinstance(result, dict)
    return torch.device("cpu")

def _servo(**kw):
    from reconplan_tpu_torch.kin.dynamics import ServoExecutor

    return ServoExecutor(**kw)


def _relaxed(**kw):
    from reconplan_tpu_torch.kin.relaxed import RelaxedIK

    return RelaxedIK(_planar(), **kw)


def _sim_rtde(**kw):
    from reconplan_tpu_torch.io.drivers import SimRTDE

    return SimRTDE(_planar(), dynamics=True, **kw)


def _run_teleop(**kw):
    from reconplan_tpu_torch.apps.teleop import run_teleop

    return run_teleop(mode="rtde", script="wq", verbose=False, **kw)


def _reference_benchmark(**kw):
    from reconplan_tpu_torch.grr.teleop_batch import run_reference_benchmark

    return run_reference_benchmark(
        tres.RedundancyResolution(_planar(), device="cpu"), {}, verbose=False,
        **kw)


def _serve_teleop(**kw):
    """The teleop server on a port the system picks, shut at once; its
    session's resolution tells the device."""
    from reconplan_tpu_torch.viz.teleop_server import serve_teleop

    res = tres.RedundancyResolution(_planar(), device="cpu")
    srv = serve_teleop(res, port=0, q0=np.zeros(5), background=True, **kw)
    srv.shutdown()
    srv.server_close()
    return srv


# every entry point that makes tensors from no tensor: (call without a
# device, the same call on the CPU, where its result's device is found)
ENTRY_POINTS = {
    "make_grid": (lambda **kw: ttsdf.make_grid(*_SMALL, **kw),
                  lambda g: g.sdf.device),
    "tsdf_grid_from_numpy": (
        lambda **kw: ttsdf.tsdf_grid_from_numpy(
            np.ones((4, 4, 4)), np.zeros((4, 4, 4)), np.zeros((0, 0, 0, 3)),
            (0, 0, 0), 0.01, 0.05, **kw),
        lambda g: g.sdf.device),
    "make_brick_grid": (lambda **kw: tb.make_brick_grid(*_SMALL, **kw),
                        lambda g: g.sdf.device),
    "brick_grid_from_numpy": (
        lambda **kw: tb.brick_grid_from_numpy(
            _planes(1, np.float32), _planes(0, np.float32), None,
            (16, 16, 32), (0, 0, 0), 0.01, 0.05, **kw),
        lambda g: g.sdf.device),
    "make_sharded_brick_grid": (
        lambda **kw: make_sharded_brick_grid(
            *_SMALL, **({"devices": [kw["device"]] * 2} if kw else {})),
        lambda g: g[0].sdf[0].device),
    "FusionPipeline": (
        lambda **kw: tfusion.FusionPipeline(
            dims=_SMALL[0], origin=_SMALL[1], voxel_size=_SMALL[2], **kw),
        lambda p: p.grid.sdf.device),
    "FusionPipeline-dense": (
        lambda **kw: tfusion.FusionPipeline(
            dims=_SMALL[0], origin=_SMALL[1], voxel_size=_SMALL[2],
            engine="dense", **kw),
        lambda p: p.grid.sdf.device),
    "fuse_frameset": (
        lambda **kw: tfusion.fuse_frameset(
            _small_frames(), dims=_SMALL[0], origin=_SMALL[1],
            voxel_size=_SMALL[2], **kw),
        lambda p: p.grid.sdf.device),
    "SplatCamera": (lambda **kw: trender.SplatCamera(width=8, height=8, **kw),
                    lambda c: c.device),
    "chamfer_distance": (
        lambda **kw: tmetrics.chamfer_distance(
            np.zeros((4, 3), np.float32), np.ones((5, 3), np.float32),
            **kw),
        lambda r: r[0].device),
    "points_to_mesh_distance": (
        lambda **kw: tmetrics.points_to_mesh_distance(
            np.zeros((4, 3), np.float32),
            np.eye(3, dtype=np.float32)[None].repeat(2, 0), k=2, **kw),
        lambda r: r.device),
    "Robot": (
        lambda **kw: trobot.Planar(
            "planar_5", [[-0.5, 0.5], [-0.5, 0.5], [0, 0]], [0, 0, 1], **kw),
        lambda r: r.model.axes.device),
    "make_robot": (
        lambda **kw: trobot.make_robot(load_problem("ur10", "rot_free"),
                                       **kw),
        lambda r: r._spheres["thresholds"].device),
    "model_from_rob": (
        lambda **kw: tchain.model_from_rob(parse_rob(_PLANAR_ROB), **kw),
        lambda m: m.R_parent.device),
    "kinematic_model_from_numpy": (
        lambda **kw: tchain.kinematic_model_from_numpy(
            [-1, 0], [False, True], np.eye(3)[:2], np.tile(np.eye(3), (2, 1, 1)),
            np.zeros((2, 3)), [-1.0, 0.0], [1.0, 0.5], **kw),
        lambda m: m.qmax.device),
    "scan_arc": (
        lambda **kw: tpaths.scan_arc([0.75, 0.75, 0.0], num_points=4, **kw),
        _numpy_out),
    "arc_interpolate": (
        lambda **kw: tpaths.arc_interpolate(*_ARC, 0.5, **kw),
        _numpy_out),
    "linear_interpolate": (
        lambda **kw: tpaths.linear_interpolate(_ARC[0], _ARC[0], 0.5, **kw),
        _numpy_out),
    "get_arc_path": (
        lambda **kw: tpaths.get_arc_path(*_ARC, 1.0, 3, **kw),
        _numpy_out),
    "get_linear_path": (
        lambda **kw: tpaths.get_linear_path(_ARC[0], _ARC[0], 1.0, 3, **kw),
        _numpy_out),
    "RoadmapWorkspace": (
        lambda **kw: tws.RoadmapWorkspace(_planar(), **kw),
        lambda w: w.device),
    "ExpansionSolver": (
        lambda **kw: tsolver.ExpansionSolver(
            tws.RoadmapWorkspace(_planar(), device="cpu"), _planar(), **kw),
        lambda s: s.device),
    "RedundancyResolution": (
        lambda **kw: tres.RedundancyResolution(_planar(), **kw),
        lambda r: r.configs_t.device),
    "DenseTopK": (lambda **kw: tnn.DenseTopK(**kw), lambda d: d.device),
    "build_roadmap": (_build_roadmap, lambda r: r[0].configs_t.device),
    "run_scan": (_run_scan, lambda r: torch.device(r["device"])),
    "make_cloud": (lambda **kw: tpc.make_cloud(np.zeros((4, 3)), **kw),
                   lambda c: c.points.device),
    "backproject_depth": (
        lambda **kw: tpc.backproject_depth(np.ones((4, 4)), 1.0, 1.0, 2.0,
                                           2.0, **kw),
        lambda c: c.points.device),
    "RGBDStitcher": (
        lambda **kw: tstitcher.RGBDStitcher(
            tstitcher.PinholeIntrinsic(8, 8, 10.0, 10.0, 4.0, 4.0), **kw),
        lambda st: st.device),
    "poisson_reconstruct": (
        lambda **kw: tpoisson.poisson_reconstruct(*_ball(), depth=8, **kw),
        lambda tris: tris.device),
    "build_observation_cloud": (
        lambda **kw: tscan.build_observation_cloud(_small_frames(), **kw),
        _numpy_out),
    "poisson_close_mesh": (
        lambda **kw: tscan.poisson_close_mesh(*_ball(), depth=8, **kw),
        _numpy_out),
    "close_gate_signals": (_gate, _dict_out),
    "get_so3_grid": (
        lambda **kw: tgrids.get_so3_grid(4, [0, 0, 1], [0.0, 0.0, 0.0], 2,
                                         **kw),
        _numpy_out),
    "ServoExecutor": (_servo, lambda ex: ex.device),
    "RelaxedIK": (_relaxed, lambda s: s.q.device),
    "SimRTDE": (_sim_rtde, lambda sim: sim.dynamics.device),
    # a tick count and empty results: the CPU call only has to run
    "run_teleop": (_run_teleop,
                   lambda ticks: ticks == 1 and torch.device("cpu")),
    "run_reference_benchmark": (
        _reference_benchmark,
        lambda out: out == ({}, {}) and torch.device("cpu")),
    "serve_teleop": (_serve_teleop,
                     lambda srv: srv.session.resolution.device),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(monkeypatch, name):
    """With no card and no device given, each entry point raises and
    builds nothing on the CPU; with ``device="cpu"`` it runs there."""
    call, device_of = ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    assert device_of(call(device="cpu")).type == "cpu"


def test_tf32_is_off_after_import():
    import reconplan_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_raycast_depth_matches_jax(scene):
    """The twin of ``test_raycast_reproduces_depth``. The ray directions
    of the two packages round one ulp apart on some pixels (XLA's
    (H, W, 3) x (3, 3) product against the port's three-term sums), which
    can flip a nearest-voxel sample where a ray passes a voxel boundary
    within that ulp: hit sets may differ on <= 0.1% of pixels, 99.9% of
    the common hits agree within two ulps of their depth, and none by
    more than one march step."""
    depths, poses, K, _ = scene
    gj, gt = _fuse_both(depths, poses, K)
    H, W = depths[0].shape
    kw = dict(near=0.2, far=0.8, n_steps=256)
    rj = np.asarray(jtsdf.raycast_depth(gj, jnp.asarray(poses[0]), *K, H, W,
                                        **kw))
    rt = ttsdf.raycast_depth(gt, poses[0], *K, H, W, **kw).numpy()
    assert rt.shape == (H, W) and rt.dtype == np.float32
    assert ((rt > 0) != (rj > 0)).mean() <= 0.001
    both = (rt > 0) & (rj > 0)
    assert both.mean() > 0.01
    diff = np.abs(rt - rj)[both]
    ulps = 2 * np.spacing(np.maximum(rt, rj)[both])
    assert (diff <= ulps).mean() >= 0.999
    assert diff.max() <= (0.8 - 0.2) / 256
    # and the JAX test's own claim: the fused sphere's depth within ~3 voxels
    true = depths[0] / 1000.0
    hit = (rt > 0) & (true > 0)
    assert np.median(np.abs(rt[hit] - true[hit])) < 0.01


def test_make_grid_dtype_and_unused_arguments_match_jax(scene):
    """Arguments the JAX functions take and the port had dropped."""
    gt = ttsdf.make_grid((4, 4, 4), (0, 0, 0), 0.01, with_color=True,
                         dtype=torch.float64, device="cpu")
    gj = jtsdf.make_grid((4, 4, 4), (0, 0, 0), 0.01, with_color=True,
                         dtype=jnp.float16)
    assert gt.sdf.dtype == gt.weight.dtype == gt.color.dtype == torch.float64
    assert gj.sdf.dtype == gj.color.dtype == jnp.float16
    assert gt.origin.dtype == gt.voxel_size.dtype == torch.float32
    assert gj.origin.dtype == jnp.float32
    g = ttsdf.make_grid((8, 8, 8), (0, 0, 0), 0.01, device="cpu")
    a = ttsdf.extract_surface_points(g, 1.0, max_points=7)
    b = ttsdf.extract_surface_points(g, 1.0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (512, 3)  # the fixed shape, whatever max_points
    p = tfusion.fuse_frameset(_small_frames(), dims=_SMALL[0],
                              origin=_SMALL[1], voxel_size=_SMALL[2],
                              weight_min=3.0, device="cpu")
    assert p.grid.sdf.shape[0] > 0
