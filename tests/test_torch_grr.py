"""``reconplan_tpu_torch.grr`` (the roadmap layer of Expansion-GRR) and
``utils.native`` against the JAX package on the CPU.

Inputs are made from a seed with numpy, or are the committed roadmaps
under ``graph/ur10/``, and go through the JAX function (jitted, on the
CPU, as ``tests/test_grr.py`` runs it) and its port with
``device="cpu"``. The JAX package's batched IK runs in batches of 64
problems (``torch_parity.jax_ik_lanes``): a problem's answer does not
depend on the batch it rides in, and XLA then compiles the IK loop once.

Tolerances and why:
* graph queries, neighbour indices, TrackArray codes and seed choices:
  equal.
* points, distances: 1e-6 (angles compared modulo 2 pi).
* configurations after IK: 1e-4 rad. Both solvers stop at the first
  iterate under the tolerance; from a roadmap seed that takes 2-4
  iterations, and an f32 LM step parts the packages by up to 2.8e-5 rad
  in three (``tests/test_torch_kin.py``).
* roadmap metrics: 1e-6 relative.

The expansion solver's tests are in ``tests/test_torch_grr_solver.py``.
"""

import os

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from reconplan_tpu.core import maths as jmaths
from reconplan_tpu.grr import nearest_neighbors as jnn
from reconplan_tpu.grr import quality as jquality
from reconplan_tpu.grr import resolution as jres
from reconplan_tpu.grr import workspace as jws
from reconplan_tpu.grr.paths import scan_arc as jscan_arc
from reconplan_tpu.io.checkpoint import load_roadmap_npz
from reconplan_tpu.utils import native as jnative
from reconplan_tpu_torch.core import maths
from reconplan_tpu_torch.grr import nearest_neighbors as tnn
from reconplan_tpu_torch.grr import quality as tquality
from reconplan_tpu_torch.grr import resolution as tres
from reconplan_tpu_torch.grr import workspace as tws
from reconplan_tpu_torch.utils import native as tnative
from torch_parity import (
    GRAPH,
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
# evaluate_roadmap of the committed UR10 roadmaps: nodes, edges,
# configured, disconnection %, distance ratio rad/m (chip_smoke.py phase
# 14 holds the card to the same values)
ROADMAP_METRICS = {
    "rot_free": (500, 501, 174, 2.2988505747126435, 201.25680541992188),
    "rot_fixed": (3299, 16642, 2373, 1.912130914265386, 6.28181266784668),
    "rot_fixed_coherent": (3299, 16642, 2683, 4.443774949160201,
                           9.52048397064209),
    "rot_variable_yaw": (5788, 30842, 2481, 21.350949886639043,
                         18.51347541809082),
}
PROBLEM = {"rot_free": "rot_free", "rot_fixed": "rot_fixed",
           "rot_fixed_coherent": "rot_fixed",
           "rot_variable_yaw": "rot_variable_yaw"}


@pytest.fixture(scope="module", autouse=True)
def lanes():
    with jax_ik_lanes():
        yield


@pytest.fixture(scope="module")
def robots():
    """(JAX, port) UR10 of each problem this file uses. The roadmap
    rot_fixed_coherent was built without the floor check, so the
    rot_fixed robots are built the same way; evaluate_roadmap does not
    validate, so rot_fixed's metrics do not depend on it."""
    return {"rot_free": ur10_pair("rot_free"),
            "rot_fixed": ur10_pair("rot_fixed", floor_check=False),
            "rot_variable_yaw": ur10_pair("rot_variable_yaw")}


def load_pair(robots, name, solver=True):
    return roadmap_pair(robots[PROBLEM[name]], name, solver)


@pytest.fixture(scope="module")
def rot_free(robots):
    return load_pair(robots, "rot_free")


# --- utils.native -------------------------------------------------------


@pytest.fixture(scope="module")
def rot_fixed_graph():
    ws = load_roadmap_npz(os.path.join(GRAPH, "rot_fixed", "workspace.npz"))
    n, edges, w = len(ws["points"]), ws["edges"], ws["edge_weights"]
    fallback = tnative.GraphCore(n, edges, w)
    fallback._lib = None
    return n, jnative.GraphCore(n, edges, w), [
        tnative.GraphCore(n, edges, w), fallback]


def path_length(g, path):
    """Sum of the edge weights along ``path`` (each step an edge)."""
    total = 0.0
    for u, v in zip(path[:-1], path[1:]):
        nbrs = g.indices[g.indptr[u]:g.indptr[u + 1]]
        assert v in nbrs
        total += float(g.weights[g.indptr[u] + np.flatnonzero(nbrs == v)[0]])
    return total


def test_graphcore_three_ways_on_the_rot_fixed_workspace(rot_fixed_graph):
    """The port's library, the port's fallback and the JAX package's
    GraphCore on 3,299 nodes and 16,642 edges. On the staggered grid many
    paths tie in weight: the native library and the fallback may take
    different ones of equal length."""
    n, ref, (native, fallback) = rot_fixed_graph
    assert native.native and not fallback.native
    rng = np.random.default_rng(0)
    ref_labels, ref_k = ref.components()
    for g in (native, fallback):
        labels, k = g.components()
        assert k == ref_k and np.array_equal(labels, ref_labels)
        for s, t in rng.choice(n, (4, 2), replace=False):
            assert np.array_equal(g.bfs_distances(s), ref.bfs_distances(s))
            for k in (1, 2, 4):
                assert sorted(g.k_layer_neighbors(s, k)) == sorted(
                    ref.k_layer_neighbors(s, k))
            p, p_ref = g.shortest_path(s, t), ref.shortest_path(s, t)
            assert p[0] == s and p[-1] == t
            assert path_length(g, p) == pytest.approx(path_length(ref, p_ref),
                                                      rel=1e-6)
            if ref.native and g.native:
                assert p == p_ref


@pytest.mark.parametrize("native", [True, False])
def test_graphcore_matches_networkx(native):
    """The twin of ``TestGraphCore``, for the library and the fallback."""
    rng = np.random.default_rng(7)
    edges = rng.integers(0, 60, size=(150, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.uniform(0.1, 1, len(edges)).astype(np.float32)
    g = tnative.GraphCore(60, edges, w)
    if not native:
        g._lib = None
    assert g.native == native
    G = nx.Graph()
    G.add_nodes_from(range(60))
    for (i, j), ww in zip(edges, w):
        if not G.has_edge(int(i), int(j)) or ww < G[int(i)][int(j)]["weight"]:
            G.add_edge(int(i), int(j), weight=float(ww))
    labels, k = g.components()
    assert k == nx.number_connected_components(G)
    d = g.bfs_distances(0)
    ref = nx.single_source_shortest_path_length(G, 0)
    for node, dist in ref.items():
        assert d[node] == dist
    assert set(int(x) for x in g.k_layer_neighbors(0, 2)) == {
        n for n, dd in ref.items() if 0 < dd <= 2}
    far = max(ref, key=ref.get)
    assert path_length(g, g.shortest_path(0, far)) == pytest.approx(
        nx.shortest_path_length(G, 0, far, weight="weight"), rel=1e-6)


def test_graphcore_library_builds_under_the_port():
    """The library is the repository's own source, compiled into the
    port's build folder with its hash beside it."""
    lib = tnative.build()
    assert lib.parent.name == "_build" and lib.is_file()
    assert lib.with_name(lib.name + ".sha256").read_text() == \
        tnative.source_hash()
    assert tnative.SOURCE.parts[-2:] == ("native", "graphcore.cpp")


# --- grr.nearest_neighbors ---------------------------------------------


def test_dense_topk_matches_jax():
    pts, queries = se3_points(2000, 0), se3_points(8, 1)
    j, t = jnn.DenseTopK(), tnn.DenseTopK(device="cpu")
    for nn_ in (j, t):
        nn_.add_list(pts[:1500])
        nn_.add_list(pts[1500:])
        for i in (5, 17, 1999):
            nn_.remove(i)
    assert t.size() == j.size() == 1997
    for q in list(queries) + [pts[5], pts[3]]:
        assert t.nearest(q) == j.nearest(q)
        ti, td = t.nearest_k(q, 10)
        ji, jd = j.nearest_k(q, 10)
        assert ti == ji
        np.testing.assert_allclose(td, jd, rtol=0, atol=TOL)
        ti, td = t.nearest_r(q, 0.6)
        ji, jd = j.nearest_r(q, 0.6)
        assert ti == ji and len(ti) > 0
        np.testing.assert_allclose(td, jd, rtol=0, atol=TOL)


def test_greedy_kcenters_matches_jax():
    pts = se3_points(2000, 2)
    tc, td = tnn.GreedyKCenters(device="cpu").kcenters(pts, 16, seed=3)
    jc, jd = jnn.GreedyKCenters().kcenters(pts, 16, seed=3)
    assert tc == jc and len(set(tc)) == 16
    off = ~np.eye(16, dtype=bool)
    np.testing.assert_allclose(td[off], jd[off], rtol=0, atol=TOL)
    # a centre against itself: the square root of the matmul form's
    # cancellation in both packages
    assert np.abs(np.diag(td)).max() < 1e-3 and np.abs(np.diag(jd)).max() < 1e-3


# --- grr.workspace -----------------------------------------------------


def assert_same_workspace(j, t):
    np.testing.assert_allclose(t.points, j.points, rtol=0, atol=TOL)
    assert t.edges.dtype == np.int64
    assert {tuple(e) for e in t.edges.tolist()} == {
        tuple(e) for e in np.asarray(j.edges).tolist()}
    np.testing.assert_allclose(t.edge_weights, j.edge_weights, rtol=0,
                               atol=TOL)
    assert [sorted(a) for a in t.adjacency] == [sorted(a) for a in j.adjacency]


@pytest.mark.parametrize("method,problem,n_pos,n_rot", [
    ("random", "rot_free", 30, 1),
    ("uniform_random", "rot_free", 40, 1),
    ("grid", "rot_variable_yaw", 27, 4),
])
def test_sample_workspace_matches_jax(robots, method, problem, n_pos, n_rot):
    jr, tr = robots[problem]
    jr._rng, tr._rng = np.random.default_rng(5), np.random.default_rng(5)
    j, t = jws.RoadmapWorkspace(jr), tws.RoadmapWorkspace(tr, device="cpu")
    obj = None if method == "grid" else OBJ
    j.sample_workspace(obj, n_pos, n_rot, method)
    t.sample_workspace(obj, n_pos, n_rot, method)
    assert t.num_nodes == j.num_nodes > 0 and len(t.edges) > 0
    assert t.interpolate_num_neighbors == j.interpolate_num_neighbors
    assert_same_workspace(j, t)
    if method == "random":  # the twin of test_arc_workspace_connectivity
        assert {(i, i + 1) for i in range(n_pos - 1)} <= {
            tuple(e) for e in t.edges.tolist()}
    if method == "grid":
        assert t.points.shape[1] == 7 and t.num_nodes % n_rot == 0


def test_workspace_neighbors_match_jax(rot_free):
    j, t = rot_free[0].workspace, rot_free[1].workspace
    arc = jscan_arc(OBJ, 0.3, 0.15, 32)
    for k in (1, 3, 14):
        np.testing.assert_array_equal(
            t.get_workspace_neighbors(arc, k=k),
            np.asarray(j.get_workspace_neighbors(arc, k=k)))
    # a single point, a node itself first; a position-only query
    assert t.get_workspace_neighbors(t.points[7], k=3)[0] == 7
    np.testing.assert_array_equal(
        t.get_workspace_neighbors(arc[3, :3], k=5),
        np.asarray(j.get_workspace_neighbors(arc[3, :3], k=5)))


def test_workspace_save_load_both_ways(rot_free, robots, tmp_path):
    j, t = rot_free[0].workspace, rot_free[1].workspace
    jr, tr = robots["rot_free"]
    t.save(str(tmp_path / "port.npz"))
    j.save(str(tmp_path / "jax.npz"))
    assert_same_workspace(j, jws.RoadmapWorkspace(jr).load(
        str(tmp_path / "port.npz")))
    assert_same_workspace(j, tws.RoadmapWorkspace(tr, device="cpu").load(
        str(tmp_path / "jax.npz")))


# --- grr.resolution ------------------------------------------------------


def test_resolution_loads_as_the_jax_package(rot_free):
    j, t = rot_free
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.configs, j.configs)
    np.testing.assert_array_equal(t.edges, j.edges)
    assert t.edges.dtype == np.int64 and t.configs.dtype == np.float32
    assert t.adjacency == j.adjacency
    assert t.points_t.device.type == "cpu"
    assert torch.equal(t.configs_t, torch.as_tensor(j.configs))
    for a, b in ((t.solver.configs, j.solver.configs),
                 (t.solver.has_config, j.solver.has_config),
                 (t.solver.edge_connected, j.solver.edge_connected)):
        np.testing.assert_array_equal(a, b)


def both_solve(pair, point, **kw):
    """(JAX q, port q, JAX TrackArray, port TrackArray) of one solve."""
    out, tracks = [], []
    for res in pair:
        ta = []
        q = res.solve(point, TrackArray=ta, **kw)
        out.append(None if q is None else np.asarray(q))
        tracks.append(ta)
    return out[0], out[1], tracks[0], tracks[1]


def test_solve_in_every_mode_matches_jax(rot_free):
    j, t = rot_free
    arc = jscan_arc(OBJ, 0.3, 0.15, 500)
    node = 40
    # regular IK from a roadmap configuration, nearest node only
    jq, tq, jt, tt = both_solve(rot_free, list(arc[3]),
                                curr_config=t.configs[1], regular_ik=True)
    assert jt == tt == [] and wrapped(tq, jq).max() <= CFG_TOL
    jq, tq, jt, tt = both_solve(rot_free, list(t.points[node]),
                                nearest_node_only=True)
    np.testing.assert_array_equal(tq, jq)
    # tracking: the seed is the joint-closest neighbour's configuration
    curr = t.configs[2]
    for p in arc[4:8]:
        jq, tq, jt, tt = both_solve(rot_free, list(p), curr_config=curr,
                                    none_on_fail=True)
        assert len(tt) == len(jt) == 1
        assert tt[0] == pytest.approx(jt[0], abs=1e-5)
        assert wrapped(tq, jq).max() <= CFG_TOL
        curr = tq
    # cold start on a node (code 0) and off the nodes (code 2)
    jq, tq, jt, tt = both_solve(rot_free, list(t.points[node]),
                                none_on_fail=True)
    assert tt == jt == [0] and wrapped(tq, jq).max() <= CFG_TOL
    for p in arc[100:103]:
        jq, tq, jt, tt = both_solve(rot_free, list(p), none_on_fail=True)
        assert tt == jt == [2]
        assert (tq is None) == (jq is None)
        if tq is not None:
            assert wrapped(tq, jq).max() <= CFG_TOL


def jax_seeds(res, points, qs, oks, n_seeds=8):
    """The roadmap seeds the JAX ``solve_batch`` chose at each waypoint,
    recomputed with its own functions from its own results."""
    import jax

    from reconplan_tpu.ops.nn import se3_pairwise

    k = min(res.workspace.interpolate_num_neighbors, len(res.points))
    j = max(1, min(n_seeds, k))
    road_pts, road_cfg = jnp.asarray(res.points), jnp.asarray(res.configs)
    curr = road_cfg[jnp.argmin(se3_pairwise(jnp.asarray(points[:1]),
                                            road_pts)[0])]
    out = []
    for p, q, ok in zip(points, qs, oks):
        _, idx = jax.lax.top_k(-se3_pairwise(jnp.asarray(p)[None],
                                             road_pts)[0], k)
        jd = res.robot.distance_batch(curr[None, :], road_cfg[idx])
        _, sidx = jax.lax.top_k(-jd, j)
        out.append(np.asarray(idx[sidx]))
        if ok:
            curr = jnp.asarray(q)
    return np.stack(out)


def test_solve_batch_matches_jax(rot_free):
    """The first 32 waypoints of the scan arc."""
    j, t = rot_free
    arc = jscan_arc(OBJ, 0.3, 0.15, 500)[:32].astype(np.float32)
    jq, jok, jtr = (np.asarray(a) for a in j.solve_batch(arc,
                                                         return_track=True))
    tq, tok, ttr = t.solve_batch(arc, return_track=True)
    assert tq.shape == (32, 6) and tok.dtype == bool
    want = jax_seeds(j, arc, jq, jok)
    curr = t.configs_t[torch.argmin(tres.se3_pairwise(
        torch.as_tensor(arc[:1]), t.points_t)[0])]
    for w, p, q, ok in zip(want, arc, tq, tok):
        sidx, _ = t._seeds(torch.as_tensor(p[None]), curr, 14, 8)
        np.testing.assert_array_equal(sidx.numpy(), w)
        if ok:
            curr = torch.as_tensor(q)
    assert (tok == jok).sum() >= 30
    both = tok & jok
    assert wrapped(tq[both], jq[both]).max() <= CFG_TOL
    ee = [np.asarray(r.robot.fk_point_batch(q[both]))[:, :3]
          for r, q in ((j, jq), (t, tq))]
    assert np.abs(ee[0] - ee[1]).max() <= 1e-5
    np.testing.assert_allclose(ttr, jtr, rtol=0, atol=1e-5)


def test_teleop_and_plan_match_jax(rot_free):
    j, t = rot_free
    q0 = np.zeros(6, np.float32)
    for target in (np.ones(6, np.float32), q0 + 0.01):
        np.testing.assert_allclose(
            t.teleop_towards(q0, target, 0.03),
            np.asarray(j.teleop_towards(q0, target, 0.03)), rtol=0, atol=TOL)
    for a, b in ((0, 4), (3, 60), (10, 150)):
        assert t._dijkstra(a, b) == j._dijkstra(a, b)
    for r in rot_free:
        r.plan_path, r.path_index = None, 0
    outs = [np.asarray(r.teleop_solve(list(t.points[1]), t.configs[0],
                                      max_change=0.05)) for r in rot_free]
    assert wrapped(outs[1], outs[0]).max() <= CFG_TOL
    assert t.plan_path is None and j.plan_path is None
    (jc, jw), (tc, tw) = (r.plan(t.points[0], t.points[4], interpolation=2)
                          for r in rot_free)
    assert len(tc) == len(jc) >= 2
    np.testing.assert_allclose(tw, np.asarray(jw), rtol=0, atol=TOL)
    assert wrapped(tc, jc).max() <= CFG_TOL


def test_rot_fixed_coherent_without_the_floor_check(robots):
    """The roadmap built with floor_check=False: a path along its own
    nodes solves as the JAX package solves it."""
    j, t = load_pair(robots, "rot_fixed_coherent", solver=False)
    assert not t.robot.FLOOR_CHECK and not j.robot.FLOOR_CHECK
    nodes = t._dijkstra(0, 60)
    assert nodes == j._dijkstra(0, 60) and len(nodes) >= 4
    pts = t.points[nodes]
    jq, jok = (np.asarray(a) for a in j.solve_batch(pts))
    tq, tok = t.solve_batch(pts)
    assert (tok == jok).all() and tok.sum() >= 4
    assert wrapped(tq[tok], jq[tok]).max() <= CFG_TOL
    jq, tq, jt, tt = both_solve((j, t), list(pts[3]), none_on_fail=True)
    assert tt == jt == [0] and wrapped(tq, jq).max() <= CFG_TOL


# --- grr.quality ---------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ROADMAP_METRICS))
def test_evaluate_roadmap_on_the_committed_roadmaps(robots, name):
    j, t = load_pair(robots, name)
    keys = ("n_nodes", "n_edges", "n_configured", "disconnection_ratio",
            "distance_ratio")
    want = jquality.evaluate_roadmap(j, verbose=False)
    got = tquality.evaluate_roadmap(t, verbose=False)
    assert set(got) == set(want)
    for k, value in zip(keys, ROADMAP_METRICS[name]):
        assert got[k] == pytest.approx(want[k], rel=TOL)
        assert got[k] == pytest.approx(value, rel=TOL)


def test_resolution_save_load_into_the_jax_package(rot_free, robots,
                                                   tmp_path):
    """The port's npz files load back equal in the JAX package."""
    _, t = rot_free
    jr, _ = robots["rot_free"]
    t.save_resolution_graph(str(tmp_path / "resolution.npz"))
    t.save_workspace_graph(str(tmp_path / "workspace.npz"))
    t.save_solver_graph(str(tmp_path / "solver.npz"))
    back = jres.RedundancyResolution(jr)
    back.load_resolution_graph(str(tmp_path / "resolution.npz"))
    back.load_workspace_graph(str(tmp_path / "workspace.npz"))
    back.load_solver_graph(str(tmp_path / "solver.npz"))
    np.testing.assert_array_equal(back.configs, t.configs)
    np.testing.assert_array_equal(back.edges, t.edges)
    np.testing.assert_array_equal(back.edge_weights, t.edge_weights)
    np.testing.assert_array_equal(back.workspace.points, t.workspace.points)
    np.testing.assert_array_equal(back.solver.edge_connected,
                                  t.solver.edge_connected)
    assert back.edges.dtype == np.int64 and back.configs.dtype == np.float32
    assert float(jmaths.se3_distance(jnp.asarray(back.points[0]),
                                     jnp.asarray(t.points[0]))) == 0.0
    assert float(maths.se3_distance(t.points[0], t.points[0],
                                    device="cpu")) == 0.0
