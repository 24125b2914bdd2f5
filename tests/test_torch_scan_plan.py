"""``reconplan_tpu_torch.apps.scan.grr_plan`` (the scan's plan through
the roadmap, with its IK fallback) and ``apps.redundancy``'s seed
discovery against the JAX package on the CPU, on the committed roadmap
``graph/ur10/rot_free``.

The JAX package's batched IK runs in batches of 64 problems
(``torch_parity.jax_ik_lanes``), which changes no problem's answer.

Tolerances and why: plans by outcome, as ``tests/test_torch_grr.py``
holds ``solve_batch``. The waypoints solved agree but for one or two in
24, solved configurations agree to 1e-4 rad and reach their waypoints by
FK, the tracking diagnostic to 1e-5; on the 500-waypoint arc the counts
of the JAX package's plan are pinned and the port's within 5% of them.
"""

import numpy as np
import pytest
import torch

from reconplan_tpu.apps import scan as jscan
from reconplan_tpu_torch.apps import redundancy as tredundancy
from reconplan_tpu_torch.apps import scan as tscan
from torch_parity import jax_ik_lanes, roadmap_pair, ur10_pair, wrapped

torch.set_num_threads(2)

CFG_TOL = 1e-4
# the JAX package's plan of the 500-waypoint scan arc on the committed
# rot_free roadmap: carried by the roadmap, solved after the IK fallback
# (chip_smoke.py phase 13 holds the card's run to them)
JAX_CARRIED, JAX_SOLVED = 485, 500


@pytest.fixture(scope="module", autouse=True)
def lanes():
    with jax_ik_lanes():
        yield


@pytest.fixture(scope="module")
def roadmaps():
    """The committed rot_free roadmap in a JAX and a port resolution."""
    return roadmap_pair(ur10_pair("rot_free"), "rot_free", solver=False)

def outcome(path):
    """(solved mask, configurations with NaN where unsolved)."""
    ok = np.array([q is not None for q in path])
    q = np.stack([np.full(6, np.nan) if p is None else np.asarray(p)
                  for p in path])
    return ok, q


@pytest.mark.parametrize("batched", [True, False])
def test_grr_plan_matches_jax(roadmaps, batched):
    j, t = roadmaps
    arc = tscan.make_arc_schedule(1, 500, device="cpu")[0][:24]
    jt, tt = [], []
    want = jscan.grr_plan(j, arc, jt, batched=batched)
    stats = {}
    got = tscan.grr_plan(t, arc, tt, batched=batched, stats=stats)
    (jok, jq), (tok, tq) = outcome(want), outcome(got)
    assert len(got) == 24 and (tok == jok).sum() >= 22
    assert stats["waypoints"] == 24
    assert stats["carried"] + stats["rescued"] == tok.sum()
    both = tok & jok
    assert wrapped(tq[both], jq[both]).max() <= CFG_TOL
    ee = t.robot.fk_point_batch(tq[tok].astype(np.float32)).numpy()
    assert np.linalg.norm(ee[:, :3] - arc[tok, :3], axis=-1).max() < 1e-3
    assert len(tt) == len(jt)
    if batched:
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-5)


def test_grr_plan_fallback_rescues_what_the_jax_package_rescues(roadmaps):
    """The twin of ``TestGrrPlanFallback`` on the roadmap cut to its
    first 40 nodes: poses the roadmap does not reach (6 of 8), which the
    seeded IK fallback reaches by position."""
    q = [0.7071068, 0.0, 0.0, 0.7071068]  # a quarter turn about x
    pts = np.asarray([[0.45, 0.45, 0.35] + q, [0.5, 0.4, 0.3] + q,
                      [0.9, 0.2, 0.5] + q, [0.3, 0.9, 0.2] + q] * 2,
                     np.float32)
    plans = []
    for res, grr_plan in zip(roadmaps, (jscan.grr_plan, tscan.grr_plan)):
        keep = (res.edges < 40).all(axis=1)
        cut = type(res).__new__(type(res))
        cut.__dict__.update(res.__dict__)
        cut._set_resolution({"points": res.points[:40],
                             "configs": res.configs[:40],
                             "edges": res.edges[keep],
                             "edge_weights": res.edge_weights[keep]})
        plans.append([outcome(grr_plan(cut, pts, ik_fallback=fb))
                      for fb in (True, False)])
    (j_with, j_without), (t_with, t_without) = plans
    np.testing.assert_array_equal(t_with[0], j_with[0])
    np.testing.assert_array_equal(t_without[0], j_without[0])
    assert t_with[0].sum() > t_without[0].sum()
    robot = roadmaps[1].robot
    ee = robot.fk_point_batch(t_with[1][t_with[0]].astype(np.float32))
    assert np.linalg.norm(ee[:, :3].numpy() - pts[t_with[0], :3],
                          axis=-1).max() < 5e-3


def test_plan_of_the_500_waypoint_arc_against_jax(roadmaps):
    """The counts chip_smoke.py phase 13 is held to: the JAX package's
    plan of the whole arc, and the port's within 5% of it."""
    j, t = roadmaps
    arc = tscan.make_arc_schedule(1, 500, device="cpu")[0]
    plan = j.solve_batch(arc, return_track=True)
    assert int(np.asarray(plan[1]).sum()) == JAX_CARRIED
    j.solve_batch = lambda *args, **kw: plan  # grr_plan's own call, kept
    try:
        want = jscan.grr_plan(j, arc)
    finally:
        del j.solve_batch
    assert sum(q is not None for q in want) == JAX_SOLVED
    stats = {}
    got = tscan.grr_plan(t, arc, stats=stats)
    assert stats["waypoints"] == 500
    assert stats["carried"] >= 0.95 * JAX_CARRIED
    assert stats["carried"] + stats["rescued"] == sum(
        q is not None for q in got) >= JAX_SOLVED - 5


def test_discover_seed_configs_matches_jax(roadmaps):
    """The greedy spaced-seed pick over the workspace's nodes."""
    from reconplan_tpu.apps.redundancy import discover_seed_configs

    j, t = roadmaps
    got = tredundancy.discover_seed_configs(t.robot, t.workspace,
                                            verbose=False)
    want = discover_seed_configs(j.robot, j.workspace, verbose=False)
    assert got.shape == want.shape and 0 < len(got) <= 8
    assert wrapped(got, want).max() <= CFG_TOL
