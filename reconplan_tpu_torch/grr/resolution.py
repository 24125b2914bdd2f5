"""Global redundancy resolution facade + online queries.

Port of ``reconplan_tpu.grr.resolution``. Holds the three roadmap stages
(workspace graph, solver state, resolution arrays) and serves the
queries the applications call once a waypoint:

    solve(point, curr_config, ...)   (resolution.py:232-433)
    teleop_solve(point, curr, ...)   (resolution.py:145-213)
    plan(start, goal, ...)           (resolution.py:435-517)

The reference's as-modified ``solve`` logic is reproduced with its
quirks (the golden trajectories were made with them):
  * tracking mode: with ``curr_config`` given, the seed is the
    joint-space-CLOSEST neighbor's config and IK runs from it directly
    (resolution.py:313-330); the weighted average only runs on cold start.
  * cold start: exact-node match within 1e-3 first (resolution.py:316),
    else the largest connected component's weighted average, whose
    combined weights are INVERSE-squared again (resolution.py:404-424),
    so closer nodes get *smaller* weights.
  * TrackArray diagnostic codes appended as at
    resolution.py:281,317,322,351,432 (``apps.scan`` writes them to
    trackarr.txt).

``solve_batch`` solves a whole Cartesian path: a Python loop over the
waypoints that carries the current configuration as a device tensor; the
roadmap goes to the device once, at load.

The resolution arrays are numpy attributes, as in the JAX package, with
device copies (``points_t``, ``configs_t``) made when they are set.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from reconplan_tpu_torch.core import maths
from reconplan_tpu_torch.grr.solver import ExpansionSolver
from reconplan_tpu_torch.grr.workspace import RoadmapWorkspace, robot_device
from reconplan_tpu_torch.io.checkpoint import (
    load_roadmap_npz,
    save_roadmap_npz,
)
from reconplan_tpu_torch.kin.ik import dls_ik_batch
from reconplan_tpu_torch.ops.nn import _smallest, se3_pairwise
from reconplan_tpu_torch.utils.native import GraphCore


class RedundancyResolution:
    def __init__(self, robot, device=None):
        self.robot = robot
        self.device = robot_device(robot, device)
        self.workspace = RoadmapWorkspace(robot, self.device)
        self.solver = ExpansionSolver(self.workspace, robot, self.device)

        # resolution arrays (built or loaded)
        self._set_resolution({
            "points": np.zeros((0, 7), dtype=np.float32),
            "configs": np.zeros((0, robot.num_joints), dtype=np.float32),
            "edges": np.zeros((0, 2), dtype=np.int64),
            "edge_weights": np.zeros((0,), dtype=np.float32),
        })

        # teleop state (resolution.py:50-53)
        self.planning_mode = False
        self.plan_path = None
        self.path_index = 0

    # ------------------------------------------------------------------
    # build stages (resolution.py:63-128)
    # ------------------------------------------------------------------
    def sample_workspace(self, obj_pos, n_pos_points, n_rot_points,
                         sampling_method="random"):
        self.workspace.sample_workspace(
            obj_pos, n_pos_points, n_rot_points, sampling_method
        )
        self.solver = ExpansionSolver(self.workspace, self.robot, self.device)

    def global_expansion(self, configs, **kwargs):
        self.solver.global_expansion(configs, **kwargs)

    def fix_boundary(self, n_neighbor_layer=1, n_iter=5):
        self.solver.fix_boundary(n_neighbor_layer, n_iter)

    def build_resolution_graph_and_nn(self, build_new_nn=True):
        res = self.solver.build_resolution()
        self._set_resolution(res)

    def _set_resolution(self, res):
        self.points = np.asarray(res["points"], dtype=np.float32)
        self.configs = np.asarray(res["configs"], dtype=np.float32)
        self.edges = np.asarray(res["edges"], dtype=np.int64).reshape(-1, 2)
        self.edge_weights = np.asarray(res["edge_weights"], dtype=np.float32)
        # the roadmap on the device, once
        self.points_t = torch.as_tensor(self.points, device=self.device)
        self.configs_t = torch.as_tensor(self.configs, device=self.device)
        adj = [[] for _ in range(len(self.points))]
        for (i, j), w in zip(self.edges.tolist(), self.edge_weights.tolist()):
            adj[i].append((j, w))
            adj[j].append((i, w))
        self.adjacency = adj
        # native graph queries (C++ graphcore, python fallback)
        self._gc = (
            GraphCore(len(self.points), self.edges, self.edge_weights)
            if len(self.edges)
            else None
        )

    # ------------------------------------------------------------------
    # persistence (npz instead of pickles; resolution.py:130-143)
    # ------------------------------------------------------------------
    def save_resolution_graph(self, path):
        save_roadmap_npz(
            path,
            points=self.points,
            configs=self.configs,
            edges=self.edges,
            edge_weights=self.edge_weights,
        )

    def load_resolution_graph(self, path):
        data = load_roadmap_npz(path)
        self._set_resolution(data)
        print("\nResolution graph loaded")
        print("Graph has", len(self.points), "nodes")
        print("Graph has", len(self.edges), "edges")

    def save_workspace_graph(self, path):
        self.workspace.save(path)

    def load_workspace_graph(self, path):
        self.workspace.load(path)
        self.solver = ExpansionSolver(self.workspace, self.robot, self.device)

    def save_solver_graph(self, path):
        """Persist expansion-solver state (configs / has_config /
        edge_connected) so an interrupted build can resume and TRUE edge
        connectivity survives a save/load round trip (the reference
        pickles its solver graph and resumes via
        ``load_existed_solver_graph``, redundancy.py:37-52)."""
        save_roadmap_npz(
            path,
            configs=self.solver.configs,
            has_config=self.solver.has_config,
            edge_connected=self.solver.edge_connected,
        )

    def load_solver_graph(self, path):
        """Restore solver state saved by :meth:`save_solver_graph`.
        Requires the matching workspace graph to be loaded first."""
        data = load_roadmap_npz(path)
        s = self.solver
        if tuple(data["configs"].shape) != tuple(s.configs.shape) or len(
            data["edge_connected"]
        ) != len(s.edge_connected):
            raise ValueError(
                "solver graph shape mismatch vs loaded workspace "
                f"(configs {data['configs'].shape} vs {s.configs.shape})"
            )
        s.configs = np.asarray(data["configs"], dtype=np.float32)
        s.has_config = np.asarray(data["has_config"], dtype=bool)
        s.edge_connected = np.asarray(data["edge_connected"], dtype=bool)
        print(
            f"Solver graph loaded: {int(s.has_config.sum())}/"
            f"{len(s.has_config)} configured, "
            f"{int(s.edge_connected.sum())}/{len(s.edge_connected)} "
            "edges connected"
        )

    # ------------------------------------------------------------------
    # the runtime query (resolution.py:232-433)
    # ------------------------------------------------------------------
    def solve(
        self,
        point,
        curr_config=None,
        nearest_node_only=False,
        regular_ik=False,
        none_on_fail=False,
        TrackArray=None,
    ):
        """Solve redundancy for one workspace point. See module docstring
        for the exact mode logic mirrored from resolution.py:232-433."""
        if TrackArray is None:
            TrackArray = []
        point = np.array(point, dtype=np.float64).reshape(-1)

        def solve_with_guess(guess):
            return self.robot.solve_ik(point, guess, none_on_fail=none_on_fail)

        if regular_ik:
            return solve_with_guess(curr_config)

        if len(point) > 3:
            point[3:] = point[3:] / np.linalg.norm(point[3:])

        k = self.workspace.interpolate_num_neighbors
        if len(self.points) == 0:
            TrackArray.append(0)
            return solve_with_guess(curr_config)
        neighbors = self.workspace.get_workspace_neighbors(
            point.astype(np.float32), k=k, points=self.points_t
        ).tolist()

        if len(neighbors) == 0:
            TrackArray.append(0)
            return solve_with_guess(curr_config)

        if nearest_node_only:
            return self.configs[neighbors[0]]

        if curr_config is not None:
            # tracking mode: joint-space closest neighbor as IK seed
            # (resolution.py:299-330)
            dists = self.robot.distance_batch(
                self.robot._tensor(curr_config)[None],
                self.configs_t[neighbors],
            ).cpu().numpy()
            TrackArray.append(float(dists.min()))
            return solve_with_guess(self.configs[neighbors[int(dists.argmin())]])

        # cold start: exact node match (resolution.py:313-318), the
        # distances to all neighbours read back at once
        p32 = point.astype(np.float32)
        d_exact = maths.se3_distance(
            self.robot._tensor(p32), self.points_t[neighbors]).cpu().numpy()
        for n, dn in zip(neighbors, d_exact):
            if dn < 1e-3:
                TrackArray.append(0)
                return solve_with_guess(self.configs[n])

        # largest-connected-component weighted average
        # (resolution.py:369-433)
        component = self._component_containing(neighbors, neighbors[0])
        comp = sorted(component)
        q_nbrs = self.configs[comp]
        d = maths.se3_distance(self.robot._tensor(p32)[None],
                               self.points_t[comp]).cpu().numpy()
        graph_d = self._graph_distances(neighbors[0], comp)
        max_d = d.max()
        workspace_w = (max_d / np.maximum(d, 1e-12)) ** 2
        graph_w = graph_d / max(graph_d.max(), 1e-12)
        joint_w = np.zeros(len(comp))
        alpha, beta = 0.0, 1.0  # resolution.py:416-417
        combined = (1 - alpha) * workspace_w + alpha * graph_w + beta * joint_w
        weights = (1.0 / (combined + 1e-6)) ** 2  # resolution.py:424 (quirk)
        q_avg = self.robot.average(q_nbrs, weights)
        TrackArray.append(2)
        return solve_with_guess(q_avg)

    def _seeds(self, point, curr, k, j):
        """The roadmap seeds of one ``solve_batch`` step: the ``k`` SE3
        nearest roadmap nodes of ``point`` (1, D), then the ``j`` of them
        joint-closest to ``curr`` (A,). Returns (node indices (j,), their
        joint distances to ``curr`` (k,)). Equal distances rank by index,
        as ``lax.top_k`` ranks them."""
        d = se3_pairwise(point, self.points_t)
        idx = _smallest(d, k)[0]
        jd = self.robot.distance_batch(curr[None, :], self.configs_t[idx])
        return idx[_smallest(jd[None], j)[0]], jd

    def solve_batch(self, points, init_config=None, max_iters=100,
                    tolerance=1e-3, return_track=False, n_seeds=8):
        """Solve a whole Cartesian path on the device.

        Tracking-mode semantics of :meth:`solve` (seed = joint-space
        closest roadmap neighbor of the previous solution,
        resolution.py:299-330), as a loop over the waypoints that carries
        the current configuration on the device: the only host reads are
        the IK loop's early-exit checks and the results at the end.

        Documented divergence from the reference's single-seed tracking
        solve (as in the JAX package): the ``n_seeds`` joint-closest
        roadmap configs among the k SE3 neighbors all run as parallel IK
        restarts in one batch, and the converged+valid result closest in
        joint space to the current config wins. Every solution still
        descends from a roadmap config.

        Args:
            points: (T, D) workspace waypoints.
            init_config: optional (A,) starting configuration; when None
                the first waypoint cold-starts from the nearest roadmap
                config.
            n_seeds: roadmap configs tried as IK restarts per waypoint.

        Returns (configs (T, A) np, success (T,) np bool); with
        ``return_track=True`` additionally the per-waypoint min joint
        distance to the roadmap seeds — the same tracking-mode diagnostic
        :meth:`solve` appends to TrackArray (resolution.py:322).
        """
        robot = self.robot
        pts = robot._tensor(points)
        if pts.shape[1] > 3:
            pts = torch.cat([pts[:, :3], pts[:, 3:7] / torch.linalg.norm(
                pts[:, 3:7], dim=-1, keepdim=True)], dim=-1)
        k = min(self.workspace.interpolate_num_neighbors, len(self.points))

        pos_t, rotm_t, use_rot = robot._ik_targets(pts)

        if init_config is None:
            # cold start: nearest roadmap config of waypoint 0
            d0 = se3_pairwise(pts[:1], self.points_t)[0]
            curr = self.configs_t[torch.argmin(d0)]
        else:
            curr = robot._tensor(init_config)

        j = max(1, min(n_seeds, k))
        qs, oks, track = [], [], []
        for t in range(pts.shape[0]):
            sidx, jd = self._seeds(pts[t:t + 1], curr, k, j)
            res = dls_ik_batch(
                robot.model, robot._active_tuple, robot.ee_link,
                pos_t[t].expand(j, 3), rotm_t[t].expand(j, 3, 3),
                self.configs_t[sidx], robot._q_rest,
                max_iters=max_iters, tolerance=tolerance,
                use_rotation=use_rot,
            )
            q = torch.where(robot._cyclic_mask, maths.wrap_to_pi(res.config),
                            res.config)
            okj = res.success & robot._validate_batch(q)
            # among converged+valid restarts, prefer minimal joint motion
            dq = torch.where(okj, robot.distance_batch(curr[None, :], q),
                             torch.inf)
            best = torch.argmin(dq)
            q, ok = q[best], okj[best]
            curr = torch.where(ok, q, curr)
            qs.append(q)
            oks.append(ok)
            track.append(jd.min())
        out = (torch.stack(qs).cpu().numpy(), torch.stack(oks).cpu().numpy())
        if return_track:
            return out + (torch.stack(track).cpu().numpy(),)
        return out

    def _component_containing(self, nodes, target):
        """Connected component of ``target`` within the induced subgraph of
        ``nodes`` (resolution.py:370-376)."""
        nodes_set = set(nodes)
        comp = {target}
        stack = [target]
        while stack:
            i = stack.pop()
            for j, _w in self.adjacency[i]:
                if j in nodes_set and j not in comp:
                    comp.add(j)
                    stack.append(j)
        return comp

    def _graph_distances(self, source, targets):
        """Unweighted shortest-path hop counts on the resolution graph
        (resolution.py:385-388 uses nx.shortest_path_length)."""
        targets = list(targets)
        if self._gc is not None:
            d = self._gc.bfs_distances(source)
            return np.asarray(
                [float(d[t]) if d[t] >= 0 else float(len(self.points)) for t in targets]
            )
        want = set(targets)
        dist = {source: 0}
        frontier = [source]
        found = {source} & want
        while frontier and found != want:
            nxt = []
            for i in frontier:
                for j, _w in self.adjacency[i]:
                    if j not in dist:
                        dist[j] = dist[i] + 1
                        nxt.append(j)
                        if j in want:
                            found.add(j)
            frontier = nxt
        return np.asarray([float(dist.get(t, len(self.points))) for t in targets])

    # ------------------------------------------------------------------
    # teleop (resolution.py:145-228)
    # ------------------------------------------------------------------
    def teleop_solve(self, target_point, curr_config, max_change=0.03):
        pos, rot = self.robot.solve_fk(np.asarray(curr_config), index=-1)
        curr_point = pos
        if self.robot.rotation == "variable":
            curr_point = np.concatenate([pos, rot])

        q = self.solve(target_point, curr_config, none_on_fail=True)
        if curr_config is None:
            return q

        if q is not None:
            if self.solver.is_continuous(curr_config, q, curr_point, target_point):
                self.plan_path = None
                self.path_index = 0
                return self.teleop_towards(curr_config, q, max_change)
            # plan a path towards q (resolution.py:171-195)
            if self.plan_path is None:
                c_path, _w = self.plan(curr_point, target_point, interpolation=1)
                self.plan_path = c_path if len(c_path) else None
                if self.plan_path is None:
                    return curr_config
                self.path_index = 1
                return self.teleop_towards(
                    curr_config, self.plan_path[1], max_change
                )
            self.path_index += 1
            if self.path_index < len(self.plan_path):
                return self.teleop_towards(
                    curr_config, self.plan_path[self.path_index], max_change
                )
            self.plan_path = None
            self.path_index = 0
            return curr_config

        # discontinuity fallback: nearest roadmap nodes (resolution.py:197-213)
        neighbors = self.workspace.get_workspace_neighbors(
            np.asarray(target_point, dtype=np.float32), k=5, points=self.points_t
        )
        for n in neighbors.tolist():
            qn = self.configs[n]
            pn = self.points[n]
            if self.solver.is_continuous(qn, curr_config, pn, curr_point):
                return self.teleop_towards(curr_config, qn, max_change)
        return None

    def teleop_towards(self, curr_config, target_config, max_change):
        """Clamped step toward a target config (resolution.py:215-228)."""
        diff = np.asarray(target_config) - np.asarray(curr_config)
        cyc = self.robot.cyclic_joints
        diff[cyc] = maths.wrap_to_pi(torch.as_tensor(
            diff[cyc], dtype=torch.float32)).numpy()
        diff = np.abs(diff)
        if diff.max() < max_change:
            return self.robot.interpolate(curr_config, target_config, 1)
        u = max_change / diff.max()
        return self.robot.interpolate(curr_config, target_config, u)

    # ------------------------------------------------------------------
    # planning (resolution.py:435-517)
    # ------------------------------------------------------------------
    def _dijkstra(self, source, target):
        """Weighted shortest path on the resolution graph (native
        graphcore when available)."""
        if self._gc is not None:
            return self._gc.shortest_path(source, target)
        dist = {source: 0.0}
        prev = {}
        pq = [(0.0, source)]
        while pq:
            d, i = heapq.heappop(pq)
            if i == target:
                break
            if d > dist.get(i, np.inf):
                continue
            for j, w in self.adjacency[i]:
                nd = d + w
                if nd < dist.get(j, np.inf):
                    dist[j] = nd
                    prev[j] = i
                    heapq.heappush(pq, (nd, j))
        if target not in dist:
            return None
        path = [target]
        while path[-1] != source:
            path.append(prev[path[-1]])
        return path[::-1]

    def plan(self, start_point, goal_point, interpolation=8):
        """Roadmap path + per-segment interpolation re-solve
        (resolution.py:435-517)."""
        start_point = np.asarray(start_point, dtype=np.float32)
        goal_point = np.asarray(goal_point, dtype=np.float32)

        def pick_entry(point):
            """First neighbor whose straight-line approach solves
            throughout (resolution.py:448-474, num_div=8)."""
            neighbors = self.workspace.get_workspace_neighbors(
                point, k=min(4, len(self.points)), points=self.points_t
            )
            for n in neighbors.tolist():
                for kk in range(8):
                    sub = self.robot.workspace_interpolate(
                        point, self.points[n], kk / 8
                    )
                    if self.solve(sub, none_on_fail=True) is None:
                        break
                else:
                    return n
            return None

        n1 = pick_entry(start_point)
        n2 = pick_entry(goal_point)
        if n1 is None or n2 is None:
            print("No valid neighbor found")
            return np.zeros((0, self.robot.num_joints)), np.zeros((0, self.points.shape[1]))

        path = self._dijkstra(n1, n2)
        if path is None:
            print("No path found")
            return np.zeros((0, self.robot.num_joints)), np.zeros((0, self.points.shape[1]))

        path_points = [start_point] + [self.points[p] for p in path] + [goal_point]
        w_path, c_path = [], []
        for pi, pj in zip(path_points[:-1], path_points[1:]):
            for kk in range(interpolation):
                sub = self.robot.workspace_interpolate(pi, pj, kk / interpolation)
                q = self.solve(sub, none_on_fail=True)
                if q is None:
                    continue
                w_path.append(sub)
                c_path.append(q)
        # keep w_path dim-homogeneous when a 3D goal meets a posed roadmap
        w_path.append(
            self.robot.workspace_interpolate(path_points[-2], goal_point, 1.0)
        )
        c_path.append(self.solve(goal_point))
        return np.asarray(c_path), np.asarray(w_path)
