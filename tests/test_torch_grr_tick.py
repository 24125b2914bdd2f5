"""``reconplan_tpu_torch.grr.teleop_batch``'s batched per-tick primitives
against the JAX package on the CPU: the GRR tick (tracking solve, FK of
the current configurations, inline three-level bisection), the tracking
and Newton solvers, and the plan helper of the discontinuity fallback.

The roadmap is ``tests/test_grr.py``'s ``small_roadmap`` recipe, built
by the port and loaded into both packages
(``torch_parity.small_roadmap_pair``).

Tolerances and why (each test states its measured max):
* flags (``ok``, ``cont``, ``deep``): equal on every row;
* configurations after IK and FK points: 1e-4 (f32 LM iterates from
  roadmap seeds, which agree to a few ulps);
* plans: the same roadmap path, configurations within 1e-6.
"""

import numpy as np
import pytest
import torch

from reconplan_tpu.grr import teleop_batch as jtb
from reconplan_tpu_torch.grr import teleop_batch as ttb
from torch_parity import jax_ik_lanes, small_roadmap_pair, wrapped

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def small_roadmap(tmp_path_factory):
    """(JAX, port) RedundancyResolution of the same small roadmap."""
    return small_roadmap_pair(str(tmp_path_factory.mktemp("small")))


def tick_inputs(res, n=12, seed=0):
    """Rows from a roadmap config toward a point a few mm off another
    node's, from the next node to far across the arc (so some rows need
    the deep check). Off the nodes: the SE3 top-k works on the matmul
    form of the distances, whose f32 cancellation at a distance of zero
    rounds apart between the two libraries (sqrt of 1e-9, 3e-5) and
    reorders equal-looking neighbours."""
    rng = np.random.default_rng(seed)
    M = len(res.points)
    a = rng.integers(0, M, n)
    b = (a + np.arange(1, n + 1) * 2) % M
    qs = res.configs[a] + rng.normal(0, 0.01, (n, 6)).astype(np.float32)
    off = rng.uniform(-0.01, 0.01, (n, 3))
    targets = res.points[b][:, :3].astype(np.float64) + off
    targets[-1] = [2.0, 2.0, 2.0]  # out of reach: IK fails
    return targets, qs


def test_grr_tick_matches_jax(small_roadmap):
    """One batched tick of 12 rows: flags equal on every row, ``q_t`` and
    ``curr_pts`` within 1e-4 (measured max 1.8e-7 and 1.2e-7)."""
    ref, port = small_roadmap
    targets, qs = tick_inputs(port)
    jout = jtb.make_grr_tick(ref, 3)(targets, qs)
    tout = ttb.make_grr_tick(port, 3)(targets, qs)
    (jq, jok, jpts, jcont, jdeep) = (np.asarray(a) for a in jout)
    (tq, tok, tpts, tcont, tdeep) = (a.numpy() for a in tout)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tcont, jcont)
    np.testing.assert_array_equal(tdeep, jdeep)
    assert wrapped(tq, jq)[tok].max() <= 1e-4
    assert np.abs(tpts - jpts).max() <= 1e-4
    # the inputs reach the tick's three outcomes: smooth, deep, failed
    assert (tok & tcont & ~tdeep).any() and (tok & tdeep).any()
    assert not tok[-1]



def test_plan_helper_matches_jax(small_roadmap):
    """``make_plan_helper``'s plan across the arc: the same roadmap path
    of 31 configurations in both packages (measured max 0); and the
    engine's batched planner gives every row of a batch the plan it gets
    alone (a row out of reach gets none)."""
    ref, port = small_roadmap
    rows = [(1, 30), (5, 20), (12, 3)]
    q_goals = [port.configs[b].astype(np.float64) for _, b in rows]
    curr = [port.points[a][:3] for a, _ in rows]
    tgt = [port.points[b][:3] for _, b in rows]
    tgt[2] = np.array([2.0, 2.0, 2.0])
    with jax_ik_lanes():
        plan = jtb.make_plan_helper(ref)
        want = [plan(c, t, q) for c, t, q in zip(curr, tgt, q_goals)]
    tp = ttb.make_plan_helper(port)(curr[0], tgt[0], q_goals[0])
    assert tp is not None and want[0] is not None
    assert tp.shape == want[0].shape == (31, 6)
    np.testing.assert_allclose(tp, want[0], rtol=0, atol=1e-6)
    got = ttb._plan_many(port)(np.stack(curr), np.stack(tgt),
                               np.stack(q_goals))
    assert [g is None for g in got] == [w is None for w in want] == [
        False, False, True]
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["tracking", "newton"])
def test_tracking_and_newton_solvers_match_jax(small_roadmap, which):
    """``make_tracking_solver`` (four roadmap seeds a row) and
    ``make_newton_solver`` (seeded from the current configs) on the tick's
    rows: flags equal, configurations within 1e-4 (measured max 1.8e-7
    and 4.8e-7)."""
    ref, port = small_roadmap
    targets, qs = tick_inputs(port)
    if which == "tracking":
        jq, jok = (np.asarray(a) for a in jtb.make_tracking_solver(ref)(
            targets, qs))
        tq, tok = (a.numpy() for a in ttb.make_tracking_solver(port)(
            targets, qs))
        np.testing.assert_array_equal(tok, jok)
        assert tok[:-1].all() and not tok[-1]
        assert wrapped(tq, jq)[tok].max() <= 1e-4
    else:
        jq = np.asarray(jtb.make_newton_solver(ref.robot)(
            targets.astype(np.float32), qs))
        tq = ttb.make_newton_solver(port.robot)(targets, qs).numpy()
        # the raw iterate, converged or not: held where both converged
        # (the unreachable last row's 100 steps part the packages by
        # 4.4e-4 rad, an f32 drift it carries forward)
        assert wrapped(tq, jq)[:-1].max() <= 1e-4


def test_make_random_resolution_matches_jax(small_roadmap):
    """The Random-GRR ablation over the small roadmap's workspace graph:
    the same numpy draws seed one IK a node, so the same 20 nodes
    configure (configurations within 1e-3 rad: random far seeds, where f32
    LM iterates part by up to 5.3e-4, ROADMAP Queue 3; measured max
    2.0e-6), the same edges test continuous, and the resolution graphs
    match."""
    from reconplan_tpu.grr import experiment as jexp
    from reconplan_tpu_torch.grr import experiment as texp

    ref, port = small_roadmap
    with jax_ik_lanes():
        jr = jexp.make_random_resolution(ref, seed=3)
    tr = texp.make_random_resolution(port, seed=3)
    np.testing.assert_array_equal(tr.solver.has_config, jr.solver.has_config)
    assert 0 < tr.solver.has_config.sum() < 40
    ok = tr.solver.has_config
    assert wrapped(tr.solver.configs[ok], jr.solver.configs[ok]).max() <= 1e-3
    np.testing.assert_array_equal(tr.solver.edge_connected,
                                  jr.solver.edge_connected)
    np.testing.assert_array_equal(tr.edges, jr.edges)
    np.testing.assert_array_equal(tr.points, jr.points)


@pytest.mark.parametrize("dims", [(7, 7), (3, 7), (7, 3), (3, 3)])
def test_interpolate_points_is_workspace_interpolate(small_roadmap, dims):
    """The plan helper's batched interpolation equals
    ``Robot.workspace_interpolate`` row by row, mixed 3D/7D ends included
    (measured max 0)."""
    robot = small_roadmap[1].robot
    rng = np.random.default_rng(dims[0] + dims[1])
    pts = []
    for d in dims:
        p = rng.normal(size=(9, 7))
        p[:, 3:] /= np.linalg.norm(p[:, 3:], axis=-1, keepdims=True)
        pts.append(p[:, :d])
    u = np.arange(9) / 8
    got = ttb._interpolate_points(robot, pts[0], pts[1], u).numpy()
    want = np.stack([robot.workspace_interpolate(a, b, float(w))
                     for a, b, w in zip(pts[0], pts[1], u)])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6
