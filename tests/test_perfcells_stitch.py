"""The stitch cell's plain reference (``perfcells/reference/stitch.py``)
against ``reconplan_tpu_torch.recon.stitcher`` on the CPU, the judge's
refusals, and the stitch's spans and counters.

The scene is the cell's: the banana seen along the scan's overhead arc
(12 pictures an arc, base azimuth from the seed), by the cell's D435 cut
to 160x120, of which the first three pictures are stitched at the cell's
settings into 1,024 model slots. Each seed pose but the first carries a
random jitter drawn from the seed (0.5 mm and 1 mrad, each axis), inside
the trust region. The program and the reference are held to the cell's
own limits: the pose gaps, the steps of each ICP stage and the overflow.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfcells import run as harness
from perfcells.reference import stitch as ref
from reconplan_tpu_torch.ops import icp as ticp
from reconplan_tpu_torch.recon import stitcher as tst
from reconplan_tpu_torch.utils import profiling

torch.set_num_threads(2)

SEED = 2**31 + 29
CELL = "stitch.seeded8192"
FRAMES, SLOTS, WIDTH = 3, 1024, 160
JITTER_M, JITTER_RAD = 0.0005, 0.001
COMPARED = ("pose_gap_mm", "pose_gap_mrad", "skipped_solves",
            "overflow_voxels")


def _rotation(rotvec):
    th = np.linalg.norm(rotvec)
    k = rotvec / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


@pytest.fixture(scope="module")
def scene():
    """(cell, config, driver, colors, depths, jittered poses, intrinsics)."""
    bench = harness.Bench()
    cell = bench.cell(CELL)
    config = bench.config(cell["config"])
    s = WIDTH / config["camera"]["width"]
    cam = config["camera"]
    config["camera"] = dict(cam, width=WIDTH, height=int(cam["height"] * s),
                            fx=cam["fx"] * s, fy=cam["fy"] * s,
                            cx=cam["cx"] * s, cy=cam["cy"] * s,
                            samples_per_mesh=300_000)
    config["model_capacity"] = config["frame_capacity"] = SLOTS
    drv = bench.driver(cell["driver"])
    scans, intr = drv.render_scans(dict(cell, scans=1), config, SEED,
                                   torch.device("cpu"))
    colors, depths, poses = scans[0]
    rng = np.random.default_rng(SEED)
    poses = poses[:FRAMES].astype(np.float64)
    for i in range(1, FRAMES):
        J = np.eye(4)
        J[:3, :3] = _rotation(rng.normal(0, JITTER_RAD, 3))
        J[:3, 3] = rng.normal(0, JITTER_M, 3)
        poses[i] = J @ poses[i]
    return (cell, config, drv, colors[:FRAMES], depths[:FRAMES],
            poses.astype(np.float32), intr)


def _program(scene):
    """The program's stitch at the cell's settings, as the judge reads it."""
    _, config, drv, colors, depths, poses, intr = scene
    st = drv.make_stitcher(config, intr, torch.device("cpu"))
    pts, cols, _ = st.stitch_sequence(colors, depths, poses=poses).compact()
    return ref.Stitched(st.last_transforms.astype(np.float64), pts, cols,
                        st.last_overflow, st.last_iterations)


@pytest.fixture(scope="module")
def reference(scene):
    _, config, _, colors, depths, poses, intr = scene
    return ref.stitch(colors, depths, poses, intr, config)


def _readings(scene, program, reference):
    config = scene[1]
    mesh = ref.mesh_points(os.path.join(harness.ROOT, config["object_mesh"]),
                           2000, config["object_point"])
    return ref.readings(program, reference, mesh, config["voxel_size"],
                        "cpu")


def test_stitch_matches_the_reference(scene, reference):
    got = _readings(scene, _program(scene), reference)
    limits = scene[0]["limits"]
    assert set(limits) == set(COMPARED)
    for k in COMPARED:
        assert got[k] <= limits[k], (k, got)


def _start(init):
    """What a left-out stage hands back: its start, after no step."""
    z = torch.zeros(())
    return ticp.ICPResult(ticp._init(init, "cpu"), z, z, z)


def _without_fine_stage(monkeypatch):
    """The fine point-to-plane stage, the second of each registration's
    two point-to-plane solves, left out."""
    real, calls = tst.icp_point_to_plane, []

    def icp_point_to_plane(source, target, dist, init=None, **kw):
        calls.append(dist)
        if len(calls) % 2 == 0:
            return _start(init)
        return real(source, target, dist, init=init, **kw)

    monkeypatch.setattr(tst, "icp_point_to_plane", icp_point_to_plane)


def _without_colored_stage(monkeypatch):
    """The colored-ICP stage of each registration left out."""
    monkeypatch.setattr(tst, "colored_icp",
                        lambda *a, init=None, **kw: _start(init))


@pytest.mark.parametrize("kind", ["fine_stage_left_out",
                                  "colored_stage_left_out", "bfloat16"])
def test_fault_and_control_are_not_correct(scene, reference, monkeypatch,
                                           kind):
    if kind == "bfloat16":
        _, config, _, colors, depths, poses, intr = scene
        program = ref.stitch(colors, depths, poses, intr, config,
                             dtype=torch.bfloat16)
    else:
        {"fine_stage_left_out": _without_fine_stage,
         "colored_stage_left_out": _without_colored_stage}[kind](monkeypatch)
        program = _program(scene)
    got = _readings(scene, program, reference)
    limits = scene[0]["limits"]
    assert any(got[k] > limits[k] for k in COMPARED), got


def test_skipped_solves_counts_the_solves_cut_short():
    def steps(rows):
        return ref.Stitched(None, None, None, 0, np.asarray(rows))

    reference = steps([[25, 9, 7], [10, 35, 1]])
    assert ref._skipped_solves(steps([[3, 2, 30], [2, 35, 1]]),
                               reference) == 0
    assert ref._skipped_solves(steps([[25, 0, 7], [10, 1, 0]]),
                               reference) == 3
    assert ref._skipped_solves(steps([[25, 7], [10, 30]]), reference) == 6


def _steps_and_reads(iterations, max_iteration, every):
    """What ``_solve`` issues for a solve that counted ``iterations`` live
    steps of at most ``max_iteration``, looking every ``every``: (steps,
    reads)."""
    stop = -(-iterations // every) * every  # the first look that stops
    if stop < max_iteration:
        return stop, stop // every
    return max_iteration, (max_iteration - 1) // every


def _recorded_stitch(scene, monkeypatch, every):
    """The program's stitch under ``recording()`` with ``CHECK_EVERY`` =
    ``every``: (recording, transforms, [(iterations, max_iteration)] of
    every solve)."""
    monkeypatch.setattr(ticp, "CHECK_EVERY", every)
    solves = []

    def kept(fn):
        def solve(*a, **kw):
            res = fn(*a, **kw)
            solves.append((int(res.iterations), kw["max_iteration"]))
            return res
        return solve

    monkeypatch.setattr(tst, "icp_point_to_plane",
                        kept(ticp.icp_point_to_plane))
    monkeypatch.setattr(tst, "colored_icp", kept(ticp.colored_icp))
    _, config, drv, colors, depths, poses, intr = scene
    st = drv.make_stitcher(config, intr, torch.device("cpu"))
    with profiling.recording() as rec:
        st.stitch_sequence(colors, depths, poses=poses)
    # each frame's stages, in the order of its solves
    assert st.last_iterations.ravel().tolist() == [n for n, _ in solves]
    return rec, st.last_transforms, solves


def test_spans_and_counters_of_a_stitch(scene, monkeypatch):
    rec, T4, solves = _recorded_stitch(scene, monkeypatch, 4)
    names = [n for n, _, _ in rec.spans]
    F = FRAMES
    assert rec.counters["stitch.frames"] == F - 1
    assert names.count("stitch.sequence") == 1
    assert names.count("stitch.frame") == F - 1
    assert names.count("stitch.register") == F - 1
    assert names.count("stitch.gate") == F - 1
    assert names.count("stitch.append") == F  # the first frame's too
    assert names.count("stitch.prepare") == F
    assert names.count("stitch.outliers") == (F - 1) // 2
    assert names.count("icp.point_to_plane") == 2 * (F - 1)
    assert names.count("icp.colored") == F - 1
    assert names.count("stitch.normals") == 2 * (F - 1)
    assert len(solves) == 3 * (F - 1)
    # each solve's steps and looks at its live flag, as the host issued them
    steps4, reads4 = map(sum, zip(*(_steps_and_reads(n, m, 4)
                                    for n, m in solves)))
    assert rec.counters["icp.steps"] == steps4
    rec1, T1, solves1 = _recorded_stitch(scene, monkeypatch, 1)
    np.testing.assert_array_equal(T1, T4)
    assert solves1 == solves
    steps1, reads1 = map(sum, zip(*(_steps_and_reads(n, m, 1)
                                    for n, m in solves)))
    assert rec1.counters["icp.steps"] == steps1 <= steps4
    # the other reads (outlier gates, neighbour ties, results) are the
    # same; host.reads grows by _solve's looks alone
    assert rec1.counters["host.reads"] - reads1 == \
        rec.counters["host.reads"] - reads4 > 0
    assert reads1 > reads4


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import perfcells.reference.stitch; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout))
    assert "torch" in loaded
    assert not loaded & {"reconplan_tpu_torch", "reconplan_tpu", "jax",
                         "jaxlib"}, loaded


def test_cell_runs_traced_on_the_cpu(monkeypatch):
    """The cell end to end through ``perfcells.run`` at the scene's size
    (no jitter: the cell's own seed poses), traced: the compared numbers
    within their limits, and the metrics that read the program's spans
    and counters in the line."""
    cell, config = harness.Bench.cell, harness.Bench.config

    def small_cell(self, name):
        return dict(cell(self, name), scans=1, chamfer_samples=2000)

    def small_config(self, name):
        c = config(self, name)
        s = WIDTH / c["camera"]["width"]
        cam = c["camera"]
        c["camera"] = dict(cam, width=WIDTH, height=int(cam["height"] * s),
                           fx=cam["fx"] * s, fy=cam["fy"] * s,
                           cx=cam["cx"] * s, cy=cam["cy"] * s,
                           samples_per_mesh=300_000)
        c["model_capacity"] = c["frame_capacity"] = SLOTS
        return c

    drv = harness.Bench().driver("stitch")
    render_scans = drv.render_scans

    def first_pictures(*a):
        scans, intr = render_scans(*a)
        return [tuple(x[:FRAMES] for x in scan) for scan in scans], intr

    monkeypatch.setattr(harness.Bench, "cell", small_cell)
    monkeypatch.setattr(harness.Bench, "config", small_config)
    monkeypatch.setattr(harness.Bench, "driver", lambda self, name: drv)
    monkeypatch.setattr(drv, "render_scans", first_pictures)
    # this lane's conftest loads jax; the run's own check would refuse it
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    profiling.UNDER_PROFILER.clear()
    code, res = harness.run(["--workload", CELL, "--seed", str(SEED),
                             "--seconds", "1", "--trace", "1"],
                            require_card=False)
    profiling.UNDER_PROFILER.clear()
    assert code == 0
    for k in COMPARED:
        assert res["checks"][k]["value"] <= res["checks"][k]["limit"], res
    m = res["metrics"]
    assert {"device_idle.stitch", "icp_idle.stitch",
            "icp_steps_per_frame.stitch",
            "host_reads_per_frame.stitch"} <= set(m)
    # a sequence of F pictures issues at least one step of each of its
    # 3 (F - 1) solves
    assert m["icp_steps_per_frame.stitch"]["value"] >= 3 * (FRAMES - 1) \
        / FRAMES
    assert 0 < m["icp_idle.stitch"]["value"] <= 100
