"""``correct`` on the CPU, at sizes a test run holds: the port's plain
kernels fuse, tick and plan; the control (the lower precision in the
program's place) and a broken timed path each come out not correct.

The whole run goes through ``perfcells.run.run`` with the card's look
skipped; the cells keep their traffic, cut only in size (grid, frames,
trajectories, waypoints) so that the CPU finishes in seconds.
"""

import numpy as np
import pytest
import torch

from perfcells import run as harness
from perfcells.common import no_span

SEED = 2**31 + 19
SMALL = {
    "fuse": ({"arcs": 2, "per_arc": 3}, {"grid_dim": 128}),
    "teleop": ({"trajectories": 2, "warm_ticks": 4}, {}),
    "plan": ({}, {"arc": {"radius": 0.3, "height": 0.15, "waypoints": 24}}),
}
# a teleop circle walks from its roadmap node for 10-25 ticks before the
# plain IK reaches a target in one step: the window holds many of those
# on a loaded CPU
SECONDS = {"fuse": "1", "teleop": "30", "plan": "1"}
JUMP_AT, JUMP_M = 1, 0.1  # where and how far the targets jump
CELLS = {"fuse": "fuse.banana512", "teleop": "teleop.rvy_circle",
         "plan": "plan.arc500"}


@pytest.fixture
def small(monkeypatch):
    """Cut every cell to a CPU size."""
    cell, config = harness.Bench.cell, harness.Bench.config

    def small_cell(self, name):
        c = cell(self, name)
        c.update(SMALL[c["driver"]][0])
        return c

    def small_config(self, name):
        c = config(self, name)
        for cut in SMALL.values():
            c.update({k: v for k, v in cut[1].items() if k in c})
        return c

    monkeypatch.setattr(harness.Bench, "cell", small_cell)
    monkeypatch.setattr(harness.Bench, "config", small_config)


def run(kind):
    code, res = harness.run(
        ["--workload", CELLS[kind], "--seed", str(SEED), "--seconds",
         SECONDS[kind], "--trace", "0"], require_card=False)
    assert code == 0
    return res


@pytest.mark.parametrize("kind", ["fuse", "teleop", "plan"])
def test_sound_run_is_correct(small, kind):
    res = run(kind)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("kind", ["fuse", "teleop", "plan"])
def test_control_is_not_correct(small, kind):
    bench = harness.Bench()
    cell = bench.cell(CELLS[kind])
    drv = bench.driver(cell["driver"])
    s = drv.setup(cell, bench.config(cell["config"]), SEED,
                  torch.device("cpu"))
    out = drv.window(s, float(SECONDS[kind]), no_span)
    drv.release(s)
    checks, _ = drv.judge(s, out, control=True)
    assert any(c["value"] > c["limit"] for c in checks), checks


def _fuse_fault(monkeypatch, fault):
    from reconplan_tpu_torch.ops import tsdf_brick as tb

    real = tb.integrate_frames_bricked_device

    def integrate(grid, depths, poses, *a, **k):
        if fault == "unchanged":
            return grid, torch.zeros((), dtype=torch.int32)
        if fault == "half":
            n = len(depths) // 2
            depths, poses = depths[:n], poses[:n]
        grid, n_active = real(grid, depths, poses, *a, **k)
        if fault == "altered":
            grid.sdf.view(-1)[::7] *= 0.5
        return grid, n_active

    monkeypatch.setattr(tb, "integrate_frames_bricked_device", integrate)


def _teleop_fault(monkeypatch, fault):
    from reconplan_tpu_torch.grr.resolution import RedundancyResolution

    real = RedundancyResolution.teleop_solve
    calls = iter(range(1 << 30))

    def teleop_solve(self, target, q, max_change=0.03):
        if fault == "unchanged":
            return q
        if fault == "unclamped":  # the raw IK answer: no continuity, no clamp
            return self.solve(target, q, none_on_fail=True)
        out = real(self, target, q, max_change)
        if fault == "none" and next(calls) % 2:  # an answer dropped
            return None
        if fault == "altered" and out is not None:
            out = np.asarray(out) + 0.01
        return out

    monkeypatch.setattr(RedundancyResolution, "teleop_solve", teleop_solve)
    if fault == "unclamped":
        _teleop_jump(monkeypatch)


def _teleop_jump(monkeypatch):
    """Targets that jump by ``JUMP_M`` at tick ``JUMP_AT`` of every
    trajectory, so that a tick has to clamp its step."""
    drv = harness.Bench().driver("teleop")
    real = drv.make_trajectories

    def make_trajectories(cell, config, seed):
        trajs, warm = real(cell, config, seed)
        for t, _ in trajs:
            t[JUMP_AT:, :3] += np.float32(JUMP_M) / np.sqrt(3)
        return trajs, warm

    monkeypatch.setattr(harness.Bench, "driver", lambda self, name: drv)
    monkeypatch.setattr(drv, "make_trajectories", make_trajectories)


def _plan_fault(monkeypatch, fault):
    import reconplan_tpu_torch.apps.scan as scan_app

    drv = harness.Bench().driver("plan")
    real = scan_app.grr_plan

    def grr_plan(grr, arc, *a, **k):
        path = real(grr, arc, *a, **k)
        if fault == "unchanged":
            first = next(q for q in path if q is not None)
            return [first for _ in path]
        if fault == "half":  # every other waypoint left to its neighbour
            return [path[i - i % 2] for i in range(len(path))]
        return [None if q is None else np.asarray(q) + 0.01 for q in path]

    # the driver took grr_plan by name when it was loaded
    monkeypatch.setattr(harness.Bench, "driver", lambda self, name: drv)
    monkeypatch.setattr(drv, "grr_plan", grr_plan)


FAULTS = [("fuse", "unchanged"), ("fuse", "half"), ("fuse", "altered"),
          ("teleop", "unchanged"), ("teleop", "altered"),
          ("teleop", "unclamped"), ("teleop", "none"),
          ("plan", "unchanged"), ("plan", "half"), ("plan", "altered")]


@pytest.mark.parametrize("kind,fault", FAULTS)
def test_broken_timed_path_is_not_correct(small, monkeypatch, kind, fault):
    {"fuse": _fuse_fault, "teleop": _teleop_fault,
     "plan": _plan_fault}[kind](monkeypatch, fault)
    res = run(kind)
    assert not res["correct"], res["checks"]
