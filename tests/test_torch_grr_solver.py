"""``reconplan_tpu_torch.grr.solver`` (the expansion of Expansion-GRR)
and ``grr.quality``'s census against the JAX package on the CPU.

Inputs are made from a seed with numpy, or are the committed roadmap
``graph/ur10/rot_free``, and go through the JAX function (jitted, on the
CPU, as ``tests/test_grr.py`` runs it) and its port with
``device="cpu"``. The JAX package's batched IK runs in batches of 64
problems (``torch_parity.jax_ik_lanes``): a problem's answer does not
depend on the batch it rides in, and XLA then compiles the IK loop once.

Tolerances and why:
* continuity flags, k-layer neighbourhoods, connected edges: equal.
* interpolations and weighted averages: 1e-6 of the JAX helpers run op
  by op, 5e-6 of them jitted (angles compared modulo 2 pi).
* configurations after IK: 1e-4 rad (see ``tests/test_torch_grr.py``).
* a whole expansion by outcome: ``has_config`` agrees on 90% of the
  nodes, every configured node reaches its point by FK within 1e-3 m in
  both packages, the connected share within 10 points.
* the census: reachable counts within two (an IK from random seeds,
  up to 100 iterations each).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.grr import quality as jquality
from reconplan_tpu.grr import resolution as jres
from reconplan_tpu.grr import solver as jsolver
from reconplan_tpu_torch.grr import quality as tquality
from reconplan_tpu_torch.grr import resolution as tres
from reconplan_tpu_torch.grr import solver as tsolver
from reconplan_tpu_torch.io.config import load_problem
from torch_parity import (
    jax_eager,
    jax_ik_lanes,
    roadmap_pair,
    se3_points,
    ur10_pair,
    wrapped,
)

torch.set_num_threads(2)

OBJ = [0.75, 0.75, 0.0]
CFG_TOL = 1e-4
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def lanes():
    with jax_ik_lanes():
        yield


@pytest.fixture(scope="module")
def ur10s():
    return ur10_pair("rot_free")


def load_pair(ur10s):
    return roadmap_pair(ur10s, "rot_free")


@pytest.fixture(scope="module")
def rot_free(ur10s):
    return load_pair(ur10s)

# --- grr.solver: building blocks ----------------------------------------


def test_batched_helpers_match_jax(ur10s):
    """The three helpers the JAX package jits, on seeded inputs: within
    1e-6 of the JAX functions run op by op, and within 5e-6 of them
    jitted. Jitted, XLA contracts multiply-adds into FMAs and fuses the
    sums, which moves the weighted average's atan2 by up to 3.6e-6 from
    the same function op by op."""
    jr, tr = ur10s
    rng = np.random.default_rng(11)
    B, K, A = 64, 8, tr.num_joints
    pts = se3_points(B, 12)
    nbr_pts = (pts[:, None] + rng.normal(0, 0.05, (B, K, 7))).astype(
        np.float32)
    nbr_pts[..., 3:] /= np.linalg.norm(nbr_pts[..., 3:], axis=-1,
                                       keepdims=True)
    nbr_cfg = rng.uniform(-np.pi, np.pi, (B, K, A)).astype(np.float32)
    mask = rng.random((B, K)) < 0.6
    mask[:, 0] = True
    qa, qb = (rng.uniform(-np.pi, np.pi, (B, 4, A)).astype(np.float32)
              for _ in range(2))
    p2 = se3_points(B, 13)
    u = ((2 * np.arange(8) + 1) / 16).astype(np.float32)
    cases = [(jsolver._weighted_average_batch,
              tsolver._weighted_average_batch,
              (pts, nbr_pts, nbr_cfg, mask), "cyclic", True)]
    for frac in (0.5, 0.25):
        cases.append((lambda a, b, c, f=frac: jsolver._interp_config_batch(
                          a, b, f, c),
                      lambda a, b, c, f=frac: tsolver._interp_config_batch(
                          a, b, f, c),
                      (qa, qb), "cyclic", True))
    for d in (7, 3):
        cases.append((jsolver._interp_point_batch,
                      tsolver._interp_point_batch,
                      (pts[:, :d], p2[:, :d], u), None, False))
    for jfn, tfn, args, cyc, angles in cases:
        jargs = [jnp.asarray(a) for a in args]
        targs = [torch.as_tensor(a) for a in args]
        if cyc:
            jargs.append(jr._cyclic_mask)
            targs.append(tr._cyclic_mask)
        got = tfn(*targs).numpy()
        with jax_eager():
            eager = np.asarray(jfn(*jargs))
        jitted = np.asarray(jfn(*jargs))
        assert got.shape == eager.shape
        diff = wrapped if angles else (lambda a, b: np.abs(a - b))
        assert diff(got, eager).max() <= TOL
        assert diff(got, jitted).max() <= 5 * TOL


def record_ik(solver, calls):
    """Record every (points, seeds) ``solver._ik_batch`` is given."""
    orig = solver._ik_batch

    def recorded(points, seeds, **kw):
        calls.append((np.asarray(points, np.float32),
                      np.asarray(seeds, np.float32)))
        return orig(points, seeds, **kw)

    solver._ik_batch = recorded


def test_project_neighbors_batch_matches_jax(ur10s):
    """The same seeds (the weighted average, then three neighbours'
    configurations) go to the IK, and the same nodes come out solved:
    configured nodes, and four the committed roadmap left unconfigured."""
    j, t = load_pair(ur10s)
    has = np.flatnonzero(t.solver.has_config)
    nodes = [int(x) for x in np.concatenate([
        has[::12], [i for i in range(t.workspace.num_nodes)
                    if not t.solver.has_config[i]][:4]])]
    calls = ([], [])
    record_ik(j.solver, calls[0])
    record_ik(t.solver, calls[1])
    (jq, jok), (tq, tok) = (r.solver.project_neighbors_batch(nodes)
                            for r in (j, t))
    (jp, js), (tp, ts) = calls[0][0], calls[1][0]
    np.testing.assert_array_equal(tp, jp)
    # a node's seeds: the weighted average (the jitted helper, see
    # test_batched_helpers_match_jax), then configured neighbours' own
    S = len(ts) // len(nodes)
    assert S == 4 and len(js) == len(ts)
    assert wrapped(ts[::S], js[::S]).max() <= 5 * TOL
    restarts = np.arange(len(ts)) % S != 0
    np.testing.assert_array_equal(ts[restarts], js[restarts])
    assert (tok == jok).mean() >= 0.9 and tok.sum() > 0
    for r, q, ok in ((j, np.asarray(jq), jok), (t, tq, tok)):
        ee = np.asarray(r.robot.fk_point_batch(q[ok]))[:, :3]
        assert np.linalg.norm(ee - t.workspace.points[nodes][ok, :3],
                              axis=-1).max() < 1e-3
    both = jok & tok
    assert wrapped(tq[both], jq[both]).max() <= CFG_TOL


def continuity_pairs(res, shifts):
    """(i, j) pairs of configured nodes ``shift`` apart in configured
    order, and their configuration distances over the bisection's eps."""
    has = np.flatnonzero(res.solver.has_config)
    pairs = np.array([(has[i], has[i + s]) for s in shifts
                      for i in range(len(has) - s)])
    q = res.solver.configs
    eps = np.sqrt(q.shape[1]) * 5e-2
    ratio = res.solver._distance(q[pairs[:, 0]], q[pairs[:, 1]]) / eps
    return pairs, ratio


def test_is_continuous_batch_matches_jax(rot_free):
    """256 pairs that need one or two bisection levels, none within 1% of
    a count of segments where the depth would change, against the JAX
    function; and four pairs that need more than six levels, which the
    JAX function fails by construction (``ok &= ~too_deep``) after
    solving all six, and the port fails too."""
    j, t = rot_free
    pairs, ratio = continuity_pairs(t, (1, 2, 3, 4))
    frac = ratio - np.floor(ratio)
    sel = np.flatnonzero((ratio < 3) & (frac > 0.01) & (frac < 0.99))[:256]
    deep = np.flatnonzero(ratio > 70)[:4]
    assert len(sel) == 256 and len(deep) == 4

    def args(idx):
        p = pairs[idx]
        return (t.solver.configs[p[:, 0]], t.solver.configs[p[:, 1]],
                t.workspace.points[p[:, 0]], t.workspace.points[p[:, 1]])

    want = np.asarray(j.solver.is_continuous_batch(*args(sel)))
    got = t.solver.is_continuous_batch(*args(sel))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0
    assert not t.solver.is_continuous_batch(*args(deep)).any()
    q, pt = args(sel[:1])[0][0], args(sel[:1])[2][0]
    assert t.solver.is_continuous(q, q, pt, pt)


def test_check_connections_and_k_layers_match_jax(ur10s):
    j, t = load_pair(ur10s)
    nodes = [int(x) for x in np.flatnonzero(t.solver.has_config)[:40:2]]
    for r in (j, t):
        r.solver.edge_connected[:] = False
        r.solver.check_connections(nodes)
    np.testing.assert_array_equal(t.solver.edge_connected,
                                  j.solver.edge_connected)
    assert t.solver.edge_connected.sum() > 0
    for i in (0, 7, 250, 499):
        for k in (1, 2, 4):
            assert sorted(t.solver._k_layer_neighbors(i, k)) == sorted(
                j.solver._k_layer_neighbors(i, k))


# --- grr.solver: an expansion, by outcome --------------------------------


@pytest.mark.parametrize("n_nodes", [16, 40])  # 40: test_grr's fixture
def test_expansion_by_outcome(ur10s, n_nodes):
    """global_expansion -> fix_boundary(1, 2) -> build_resolution on the
    rot_free arc with ``n_nodes`` workspace nodes and the problem's
    seeds."""
    jr, tr = ur10s
    seeds = np.asarray(load_problem("ur10", "rot_free")["init_configs"],
                       np.float32)
    pair = (jres.RedundancyResolution(jr),
            tres.RedundancyResolution(tr, device="cpu"))
    metrics = []
    for res, quality in zip(pair, (jquality, tquality)):
        res.sample_workspace(OBJ, n_nodes, 1, "random")
        res.global_expansion(seeds, verbose=False)
        res.fix_boundary(1, 2)
        res.build_resolution_graph_and_nn()
        metrics.append(quality.evaluate_roadmap(res, verbose=False))
        ee = np.asarray(res.robot.fk_point_batch(res.configs))[:, :3]
        assert len(res.configs) > 0
        assert np.linalg.norm(ee - res.points[:, :3], axis=-1).max() < 1e-3
    j, t = pair
    assert (t.solver.has_config == j.solver.has_config).mean() >= 0.9
    connected = [100 - m["disconnection_ratio"] for m in metrics]
    assert abs(connected[1] - connected[0]) <= 10
    assert metrics[1]["n_configured"] >= 0.8 * metrics[1]["n_nodes"]


def first_nodes(res, n, solver_cls, **kw):
    """``res``'s workspace and solver state cut to their first n nodes."""
    ws, old = res.workspace, res.solver
    keep = (ws.edges < n).all(axis=1)
    ws.points = ws.points[:n]
    ws._set_edges(ws.edges[keep])
    res.solver = solver_cls(ws, res.robot, **kw)
    res.solver.configs = old.configs[:n].copy()
    res.solver.has_config = old.has_config[:n].copy()
    res.solver.edge_connected = old.edge_connected[keep].copy()
    return res


def test_census_reachability_on_64_nodes(ur10s):
    j, t = load_pair(ur10s)
    first_nodes(j, 64, jsolver.ExpansionSolver)
    first_nodes(t, 64, tsolver.ExpansionSolver, device="cpu")
    want = jquality.census_reachability(j, restarts=3, verbose=False)
    got = tquality.census_reachability(t, restarts=3, verbose=False)
    assert got["n_nodes"] == want["n_nodes"] == 64
    assert got["n_configured"] == want["n_configured"]
    assert abs(got["n_reachable"] - want["n_reachable"]) <= 2
    assert got["n_reachable"] >= got["n_configured"] > 0
    assert got["reachable"][t.solver.has_config].all()
    np.testing.assert_array_equal(got["witness"][t.solver.has_config],
                                  t.solver.configs[t.solver.has_config])
    assert 0 < got["coverage_of_reachable"] <= 100

