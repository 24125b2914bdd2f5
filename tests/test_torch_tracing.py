"""``reconplan_tpu_torch.utils.profiling``'s spans and counters on the
CPU: off they build nothing and count nothing; on they name and nest the
stages of the three hot paths (a small fusion, one teleop tick on the
committed ``rot_variable_yaw`` roadmap, a short ``solve_batch``), add no
operation to them, count the IK's early-exit reads, and share a clock
with the profiler's events.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from reconplan_tpu_torch.grr import RedundancyResolution
from reconplan_tpu_torch.io.config import load_problem
from reconplan_tpu_torch.kin.ik import CHECK_EVERY, dls_ik_batch
from reconplan_tpu_torch.kin.robot import make_robot
from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.utils import profiling
from test_tsdf_marching import make_sphere_depths

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROADMAP = os.path.join(REPO, "graph", "ur10", "rot_variable_yaw")


@pytest.fixture(scope="module")
def rvy():
    """The committed ``rot_variable_yaw`` roadmap on the CPU."""
    robot = make_robot(load_problem("ur10", "rot_variable_yaw"),
                       device="cpu")
    res = RedundancyResolution(robot, "cpu")
    res.load_workspace_graph(os.path.join(ROADMAP, "workspace.npz"))
    res.load_resolution_graph(os.path.join(ROADMAP, "resolution.npz"))
    res.load_solver_graph(os.path.join(ROADMAP, "solver.npz"))
    return res


def fuse():
    """16 frames (two chunks) of the analytic sphere into a 64^3 grid."""
    depths, poses, K = make_sphere_depths(n_views=16)
    g = tb.make_brick_grid((64, 64, 64), (-0.15, -0.15, -0.15), 0.3 / 63,
                           device="cpu")
    return tb.integrate_frames_bricked_device(g, depths, poses, *K)[1]


def teleop(res):
    """One tick from a roadmap node toward a target 2 mm off it."""
    res.plan_path, res.path_index = None, 0
    target = res.points[40].astype(np.float64).copy()
    target[:3] += 0.002
    return res.teleop_solve(target, res.configs[40].astype(np.float64),
                            0.04)


def plan(res):
    """Three waypoints near roadmap nodes, solved as a path."""
    pts = res.points[[40, 41, 42]].astype(np.float64).copy()
    pts[:, :3] += 0.001
    return res.solve_batch(pts)


CALLS = {"fuse": lambda res: fuse(), "teleop": teleop, "plan": plan}
# (child, parent) pairs that each call must show
NESTS = {
    "fuse": [("tsdf.chunk", "tsdf.integrate"),
             ("tsdf.active_set", "tsdf.chunk"),
             ("tsdf.occupancy", "tsdf.active_set"),
             ("tsdf.k2", "tsdf.active_set"),
             ("tsdf.refine", "tsdf.active_set"),
             ("tsdf.compact", "tsdf.active_set"),
             ("tsdf.k1", "tsdf.chunk")],
    "teleop": [("teleop.fk", "teleop.solve"), ("grr.solve", "teleop.solve"),
               ("ik.solve", "grr.solve"), ("grr.continuity", "teleop.solve"),
               ("ik.solve", "grr.continuity"),
               ("teleop.towards", "teleop.solve")],
    "plan": [("grr.seeds", "grr.solve_batch"), ("ik.solve", "grr.solve_batch"),
             ("grr.select", "grr.solve_batch")],
}


def parents(spans):
    """(child name, parent name) of every span: the innermost span that
    holds it."""
    out = set()
    for name, s, e in spans:
        holders = [(e2 - s2, n2) for n2, s2, e2 in spans
                   if s2 <= s and e <= e2 and (n2, s2, e2) != (name, s, e)]
        out.add((name, min(holders)[1] if holders else None))
    return out


class OpLog(TorchDispatchMode):
    """The names of the ``aten`` operations run under it, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith("aten."):
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def no_range(monkeypatch):
    """Any profiler range the program opens raises."""
    def refuse(name):
        raise AssertionError(f"a range was opened: {name}")
    monkeypatch.setattr(profiling, "record_function", refuse)


def test_off_builds_no_range_and_counts_nothing(rvy, no_range):
    profiling.UNDER_PROFILER.clear()
    assert profiling.span("x") is profiling.span("y")
    for call in CALLS.values():
        call(rvy)
    profiling.count("x")
    profiling.to_host(torch.ones(1))
    assert profiling.UNDER_PROFILER.counters == {}
    assert profiling.UNDER_PROFILER.spans == []


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_on_names_and_nests_the_stages(rvy, kind):
    with profiling.recording() as rec:
        CALLS[kind](rvy)
    assert parents(rec.spans) >= set(NESTS[kind])
    for name, s, e in rec.spans:
        assert s <= e
    if kind == "fuse":
        assert rec.counters["tsdf.chunks"] == 2
        assert sum(n == "tsdf.chunk" for n, _, _ in rec.spans) == 2
    else:
        assert rec.counters["ik.calls"] == sum(n == "ik.solve"
                                               for n, _, _ in rec.spans)
        assert rec.counters["host.reads"] > 0
    if kind == "teleop":
        assert rec.counters["grr.continuity_checks"] == 1
    # the recording is closed: nothing more goes to it
    profiling.count("tsdf.chunks")
    assert rec.counters.get("tsdf.chunks", 0) == (2 if kind == "fuse" else 0)


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_on_adds_no_operation(rvy, kind):
    """The same ``aten`` operations in the same order, recording or not."""
    with OpLog() as off:
        CALLS[kind](rvy)
    with profiling.recording() as rec, OpLog() as on:
        CALLS[kind](rvy)
    assert rec.spans
    assert len(off.ops) > 10 and on.ops == off.ops


def test_plan_and_fallback_spans_and_counters(rvy, monkeypatch):
    """``plan`` opens ``grr.plan`` and counts ``grr.plans``; a tick with no
    roadmap solve takes the neighbour fallback, counted once."""
    a, b = rvy.points[40], rvy.points[45]
    with profiling.recording() as rec:
        rvy.plan(a, b, interpolation=1)
    assert rec.counters["grr.plans"] == 1
    assert ("grr.solve", "grr.plan") in parents(rec.spans)
    monkeypatch.setattr(rvy, "solve", lambda *args, **kwargs: None)
    with profiling.recording() as rec:
        teleop(rvy)
    assert rec.counters["teleop.fallbacks"] == 1
    assert ("grr.continuity", "teleop.fallback") in parents(rec.spans)


@pytest.mark.parametrize("max_iters,reachable,reads", [
    (8, False, 2), (10, False, 3), (12, False, 3), (8, True, 1)])
def test_host_reads_count_the_ik_early_exit_checks(rvy, max_iters,
                                                   reachable, reads):
    """The eager IK reads the live flag every ``CHECK_EVERY`` iterations:
    out of reach, at each multiple below ``max_iters``; at the target from
    the start, once. Each read that goes on opens a chunk."""
    robot = rvy.robot
    q0 = torch.as_tensor(rvy.configs[40:42])
    if reachable:
        pos, rot, _ = robot._ik_targets(robot.fk_point_batch(q0))
    else:
        pos = torch.full((2, 3), 5.0)
        rot = torch.eye(3).expand(2, 3, 3)
    with profiling.recording() as rec:
        res = dls_ik_batch(robot.model, robot._active_tuple, robot.ee_link,
                           pos, rot, q0, robot._q_rest, max_iters=max_iters)
    iters = int(res.iters.max())
    assert iters == (0 if reachable else max_iters)
    assert reads == -(-max(iters, 1) // CHECK_EVERY)
    assert rec.counters["host.reads"] == reads
    assert rec.counters.get("ik.chunks", 0) == (0 if reachable else reads)
    assert rec.counters["ik.calls"] == 1


def test_spans_under_a_profiler_share_its_clock(rvy):
    """Under a profiler outside ``recording()`` the spans go to
    ``UNDER_PROFILER``, and both their own times and the profiler's
    ranges lie inside a ``time.time_ns()`` window around the call."""
    from torch.profiler import ProfilerActivity, profile

    profiling.UNDER_PROFILER.clear()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan(rvy)
    t1 = time.time_ns()
    rec = profiling.UNDER_PROFILER
    assert rec.spans and rec.counters["ik.calls"] == 3
    for _, s, e in rec.spans:
        assert t0 <= s <= e <= t1
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(profiling.SPAN_PREFIX)]
    assert len(ranges) == len(rec.spans)
    for _, s, e in ranges:
        assert t0 <= s <= e <= t1
    profiling.UNDER_PROFILER.clear()
    profiling.count("ik.calls")
    assert profiling.UNDER_PROFILER.counters == {}


def test_trace_writes_the_program_spans(rvy, tmp_path):
    with profiling.trace(tmp_path):
        plan(rvy)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"reconplan:grr.solve_batch", "reconplan:grr.seeds",
            "reconplan:ik.solve", "reconplan:grr.select"} <= names


def test_stage_timer_opens_its_span():
    timer = profiling.StageTimer("scan.")
    with profiling.recording() as rec:
        with timer.stage("plan"):
            with profiling.span("inner"):
                pass
    assert [n for n, _, _ in rec.spans] == ["inner", "scan.plan"]
    assert timer.as_dict().keys() == {"plan"}


def test_recordings_nest_and_restore():
    with profiling.recording() as outer:
        profiling.count("a")
        with profiling.recording() as inner:
            profiling.count("a", 3)
        profiling.count("a")
    assert outer.counters == {"a": 2} and inner.counters == {"a": 3}
    assert profiling._active() is None


def test_scan_profile_holds_the_program_spans(tmp_path):
    """``apps/scan --profile DIR``: the Chrome trace holds the scan's
    stages and the planner's spans under them."""
    from reconplan_tpu_torch.apps import scan as tscan

    roadmap = os.path.join(REPO, "graph", "ur10", "rot_free")
    tscan.main(["--roadmap", roadmap, "--device", "cpu", "--out",
                str(tmp_path / "out"), "--waypoints", "6", "--images", "2",
                "--grid", "64", "--reconstruct", "fuse", "--close-mode",
                "never", "--profile", str(tmp_path / "tr")])
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"reconplan:scan.plan", "reconplan:scan.grr_plan",
            "reconplan:grr.solve_batch", "reconplan:scan.capture",
            "reconplan:scan.fuse"} <= names
