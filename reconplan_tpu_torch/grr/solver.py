"""Expansion solver: global redundancy resolution by BFS expansion.

Port of ``reconplan_tpu.grr.solver``. The algorithm is the reference's
(``Expansion-GRR/grr/solver.py``): a BFS wavefront from seed
configurations, per-node IK projection of the inverse-square-distance
weighted average of <= 4-layer neighbour configurations, bisection
continuity checks on edges, boundary destruct-and-rebuild. As in the JAX
package the frontier goes in level-synchronous waves: one batched IK
(``kin.ik.dls_ik_batch`` on the robot's device) projects a whole wave,
and a continuity check solves all midpoints of one bisection level in
one batch.

The graph work (frontiers, neighbourhoods, colourings) stays on the host
in numpy and ``utils.native.GraphCore``; each batch of IK or distances is
one round trip to the device, where the JAX package reads its results
back with ``np.asarray``. PyTorch does not compile per shape, so the
batches are not padded to powers of two.

Known divergence, as in the JAX package: nodes within one wave do not
see each other's fresh configurations (the reference's FIFO order does);
the outer repeat-until-no-update loop re-sweeps until nothing changes.
The bisection rounds the reference's ``ceil(dist/eps) + 1`` segments up
to a power of two, so every edge of a level shares the interpolation
parameters u = (2j+1)/2^(l+1); a midpoint fails an edge only on a
collision or floor violation, not on IK non-convergence, and the
deviation test is ``d(qa, qm) > 1.8 * d(qa, qb)``.
"""

from __future__ import annotations

import numpy as np
import torch

from reconplan_tpu_torch.core import maths
from reconplan_tpu_torch.grr.workspace import robot_device
from reconplan_tpu_torch.kin.ik import dls_ik_batch
from reconplan_tpu_torch.utils.native import GraphCore

_MAX_BISECT_DEPTH = 6  # up to 64 segments per edge


class ExpansionSolver:
    """Assigns one configuration per workspace node such that neighboring
    nodes have continuously-connected configurations."""

    def __init__(self, workspace, robot, device=None):
        self.workspace = workspace
        self.robot = robot
        self.device = robot_device(robot, device)
        n = workspace.num_nodes
        A = robot.num_joints
        self.configs = np.zeros((n, A), dtype=np.float32)
        self.has_config = np.zeros(n, dtype=bool)
        self.edge_connected = np.zeros(len(workspace.edges), dtype=bool)
        self._edge_index = {
            (i, j): e for e, (i, j) in enumerate(workspace.edges.tolist())
        }
        # native BFS/graph queries (C++ graphcore with python fallback)
        self._gc = (
            GraphCore(n, workspace.edges, workspace.edge_weights)
            if len(workspace.edges)
            else None
        )

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=self.device)

    def _distance(self, q1, q2):
        """``robot.distance_batch`` of numpy configs, read back as numpy."""
        return self.robot.distance_batch(
            self._tensor(q1), self._tensor(q2)).cpu().numpy()

    # ------------------------------------------------------------------
    # batched primitives
    # ------------------------------------------------------------------
    def _ik_batch(self, points, seeds, max_iters=100, tolerance=1e-3):
        """(B, D) points, (B, A) seeds -> numpy (configs, converged,
        valid): one batched IK on the robot's device."""
        robot = self.robot
        pos, rotm, use_rot = robot._ik_targets(points)
        res = dls_ik_batch(
            robot.model,
            robot._active_tuple,
            robot.ee_link,
            pos,
            rotm,
            self._tensor(seeds),
            robot._q_rest,
            max_iters=max_iters,
            tolerance=tolerance,
            use_rotation=use_rot,
        )
        q = torch.where(robot._cyclic_mask, maths.wrap_to_pi(res.config),
                        res.config)
        valid = robot._validate_batch(q)
        return (q.cpu().numpy(), res.success.cpu().numpy(),
                valid.cpu().numpy())

    def project_neighbors_batch(self, nodes, k_layers=4):
        """Batched ``project_neighbors`` (``solver.py:227-259``): for each
        node, IK-project the inverse-square-distance weighted average of
        its configured <=k-layer neighbors. Returns (configs (B, A),
        ok (B,)) with ok False where no configured neighbor exists or IK
        fails validation."""
        ws = self.workspace
        B = len(nodes)
        if B == 0:
            return np.zeros((0, self.robot.num_joints), np.float32), np.zeros(0, bool)

        neighbor_sets = [
            [j for j in self._k_layer_neighbors(i, k_layers) if self.has_config[j]]
            for i in nodes
        ]
        max_k = max((len(s) for s in neighbor_sets), default=0)
        if max_k == 0:
            return np.zeros((B, self.robot.num_joints), np.float32), np.zeros(B, bool)

        nbr_idx = np.zeros((B, max_k), dtype=np.int64)
        nbr_mask = np.zeros((B, max_k), dtype=bool)
        for b, s in enumerate(neighbor_sets):
            nbr_idx[b, : len(s)] = s
            nbr_mask[b, : len(s)] = True

        pts = ws.points[nodes]  # (B, D)
        nbr_pts = ws.points[nbr_idx]  # (B, K, D)
        nbr_cfg = self.configs[nbr_idx]  # (B, K, A)

        seeds = _weighted_average_batch(
            self._tensor(pts),
            self._tensor(nbr_pts),
            self._tensor(nbr_cfg),
            torch.as_tensor(nbr_mask, device=self.device),
            self.robot._cyclic_mask,
        ).cpu().numpy()
        # Multi-seed restarts (documented divergence from the reference's
        # single average-seed projection, solver.py:227-259): near the
        # reach boundary IK from the averaged config alone strands ~1/3 of
        # reachable nodes unconfigured; the configured neighbors' own
        # configs are natural extra basins. Seed order keeps the
        # reference's preference: the weighted average wins whenever it
        # converges, neighbor restarts only rescue otherwise.
        n_restarts = min(3, nbr_mask.shape[1])
        seed_list = [seeds] + [nbr_cfg[:, r] for r in range(n_restarts)]
        S = len(seed_list)
        pts_rep = np.repeat(pts, S, axis=0)
        seeds_all = np.stack(seed_list, axis=1).reshape(B * S, -1)
        q_all, conv_all, valid_all = self._ik_batch(pts_rep, seeds_all)
        ok_all = (conv_all & valid_all).reshape(B, S)
        q_all = q_all.reshape(B, S, -1)
        # restart seeds are only meaningful where that neighbor exists
        ok_all[:, 1:] &= nbr_mask[:, :n_restarts]
        # COHERENCE-FIRST selection among the valid candidates: minimal
        # inverse-square-distance-weighted config distance to the
        # configured neighbors (the reference's single average-seed
        # projection is coherent by construction, solver.py:227-259).
        d_pt = np.linalg.norm(
            pts[:, None, :3] - nbr_pts[..., :3], axis=-1
        )  # (B, K)
        w = np.where(nbr_mask, 1.0 / np.maximum(d_pt, 1e-6) ** 2, 0.0)
        w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)  # (B, K)
        dq = self._distance(q_all[:, :, None, :], nbr_cfg[:, None])  # (B, S, K)
        cost = (dq * w[:, None, :]).sum(axis=2)  # (B, S)
        cost = np.where(ok_all, cost, np.inf)
        best = np.argmin(cost, axis=1)
        q = q_all[np.arange(B), best]
        ok = ok_all.any(axis=1) & nbr_mask.any(axis=1)
        return q, ok

    def _k_layer_neighbors(self, i, k):
        """k-layer BFS neighborhood excluding i (``solver.py:261-282``);
        served by the native graph core when available."""
        if self._gc is not None:
            return self._gc.k_layer_neighbors(i, k)
        visited = {i}
        layer = {i}
        for _ in range(k):
            nxt = set()
            for node in layer:
                nxt.update(self.workspace.adjacency[node])
            nxt -= visited
            visited |= nxt
            layer = nxt
        visited.discard(i)
        return visited

    # ------------------------------------------------------------------
    # continuity (solver.py:304-363)
    # ------------------------------------------------------------------
    def is_continuous_batch(self, q1, q2, p1, p2):
        """Vectorized bisection continuity check for B (config, point)
        pairs. Returns (B,) bool. Each level solves the midpoints of the
        edges that still need it, in one batch."""
        A = self.robot.num_joints
        q1 = np.asarray(q1, dtype=np.float32).reshape(-1, A)
        q2 = np.asarray(q2, dtype=np.float32).reshape(-1, A)
        p1 = np.asarray(p1, dtype=np.float32).reshape(len(q1), -1)
        p2 = np.asarray(p2, dtype=np.float32).reshape(len(q1), -1)
        if p1.shape[1] != p2.shape[1]:
            # mixed 3D/7D endpoints (rot_free teleop targets vs posed
            # roadmap points): continuity interpolates positions only
            d_min = min(p1.shape[1], p2.shape[1])
            p1 = p1[:, :d_min]
            p2 = p2[:, :d_min]
        B = len(q1)

        eps = np.sqrt(A) * 5e-2  # solver.py:318
        deviation = 1.8  # solver.py:317
        dist = self._distance(q1, q2)
        n_divs = np.ceil(dist / eps).astype(np.int64)
        depth = np.ceil(np.log2(np.maximum(n_divs + 1, 1))).astype(np.int64)
        # Pairs needing more than 2^_MAX_BISECT_DEPTH segments (config
        # distance > ~64*eps) would be checked more coarsely than the
        # reference's unbounded ceil(dist/eps)+1 subdivision — fail them
        # conservatively instead of risking a false-continuous edge.
        too_deep = depth > _MAX_BISECT_DEPTH
        depth = np.minimum(depth, _MAX_BISECT_DEPTH)
        S = 1 << _MAX_BISECT_DEPTH

        # segment configs at resolution S; start with endpoints
        Q = np.zeros((B, S + 1, A), dtype=np.float32)
        Q[:, 0] = q1
        Q[:, S] = q2
        ok = np.ones(B, dtype=bool)
        t_p1, t_p2 = self._tensor(p1), self._tensor(p2)

        for level in range(_MAX_BISECT_DEPTH):
            stride = S >> (level + 1)
            n_mid = 1 << level
            mids = (2 * np.arange(n_mid) + 1) * stride  # (n_mid,)
            act = np.flatnonzero(depth > level)  # edges of this level
            if not len(act):
                break
            u = (2 * np.arange(n_mid) + 1) / (2.0 ** (level + 1))  # (n_mid,)

            qa = Q[act][:, mids - stride]  # (b, n_mid, A)
            qb = Q[act][:, mids + stride]
            # midpoint seeds: config interpolation (cyclic-aware)
            seeds = _interp_config_batch(
                self._tensor(qa), self._tensor(qb), 0.5,
                self.robot._cyclic_mask).cpu().numpy()
            # midpoint workspace targets: pos lerp + quat slerp
            idx = torch.as_tensor(act, device=self.device)
            targets = _interp_point_batch(
                t_p1[idx], t_p2[idx], self._tensor(u))  # (b, n_mid, D)

            b = len(act)
            qm, _conv, valid = self._ik_batch(
                targets.reshape(b * n_mid, -1), seeds.reshape(b * n_mid, A))
            qm = qm.reshape(b, n_mid, A)
            valid = valid.reshape(b, n_mid)

            d_seg, d1, d2 = self._distance(np.stack([qa, qa, qm]),
                                           np.stack([qb, qm, qb]))
            level_ok = valid & (d1 <= deviation * d_seg) & (d2 <= deviation * d_seg)
            ok[act] &= level_ok.all(axis=1)
            Q[act[:, None], mids[None, :]] = qm
        ok &= ~too_deep
        return ok

    def is_continuous(self, q1, q2, p1, p2):
        """Single-pair continuity (``solver.py:304-319`` signature)."""
        return bool(self.is_continuous_batch(q1, q2, p1, p2)[0])

    def check_connections(self, nodes):
        """Re-test all edges incident to ``nodes`` whose both endpoints are
        configured (``check_neighbor_connection``, ``solver.py:284-302``)."""
        ws = self.workspace
        todo = set()
        for i in nodes:
            if not self.has_config[i]:
                continue
            for j in ws.adjacency[i]:
                if self.has_config[j]:
                    todo.add((min(i, j), max(i, j)))
        if not todo:
            return
        pairs = np.asarray(sorted(todo), dtype=np.int64)
        cont = self.is_continuous_batch(
            self.configs[pairs[:, 0]],
            self.configs[pairs[:, 1]],
            ws.points[pairs[:, 0]],
            ws.points[pairs[:, 1]],
        )
        for (i, j), c in zip(pairs.tolist(), cont):
            self.edge_connected[self._edge_index[(i, j)]] = c

    # ------------------------------------------------------------------
    # expansion (solver.py:69-225)
    # ------------------------------------------------------------------
    def initialize_from_configs(self, seed_configs, verbose=True):
        """Seed the roadmap (``solver.py:165-225``): FK each seed config,
        snap to the nearest workspace node, IK from the seed, assign."""
        ws = self.workspace
        seeds = np.asarray(seed_configs, dtype=np.float32)
        if seeds.size == 0:
            if verbose:
                print("Valid start configurations: 0/0 (no seeds)")
            return set()
        points = self.robot.fk_point_batch(seeds).cpu().numpy()
        if ws.points.shape[1] == 3:
            points = points[:, :3]
        start_nodes = ws.get_workspace_neighbors(points, k=1)[:, 0]
        targets = ws.points[start_nodes]
        q, conv, valid = self._ik_batch(targets, seeds)
        ok = conv & valid
        start_neighbors = set()
        n_valid = 0
        for b, node in enumerate(start_nodes.tolist()):
            if not ok[b]:
                if verbose:
                    print(f"Cannot start with configuration {b}")
                continue
            self.configs[node] = q[b]
            self.has_config[node] = True
            n_valid += 1
            self.check_connections([node])
            start_neighbors.update(ws.adjacency[node])
        if verbose:
            print(f"Valid start configurations: {n_valid}/{len(seeds)}")
        return start_neighbors

    def _frontier(self, k):
        """Unconfigured nodes with a configured node within k layers."""
        return [
            i
            for i in range(self.workspace.num_nodes)
            if not self.has_config[i]
            and any(self.has_config[j] for j in self._k_layer_neighbors(i, k))
        ]

    def global_expansion(self, seed_configs, k_layers=4, verbose=True,
                         on_sweep=None, coherent=False):
        """BFS expansion (``solver.py:69-163``) in batched waves.

        ``on_sweep(solver)``, when given, is called after every stabilised
        sweep — the build CLI uses it to checkpoint solver state so an
        interrupted expansion can resume (reference redundancy.py:37-52).
        Seeds already present in ``has_config`` (a resumed build) are kept;
        expansion continues from the existing frontier.

        ``coherent=True`` keeps the reference FIFO's field coherence with
        batched waves: (a) the frontier escalates from DIRECT configured
        neighbors (k=1) to ``k_layers`` only when stalled, so no node is
        pinned from a 4-layer-away basin while a nearer projection exists;
        and (b) each wave is partitioned into graph-coloring independent
        sets solved in turn, so adjacent frontier nodes never solve blind
        to each other. Cost: about one more batched IK per colour a wave.
        """
        start_neighbors = self.initialize_from_configs(seed_configs, verbose)
        if self.has_config.sum() > len(seed_configs):
            # resumed state: the frontier is any unconfigured node near a
            # configured one, which the sweep loop discovers on its own
            start_neighbors = start_neighbors or [0]
        if not start_neighbors:
            if verbose:
                print("No valid start configurations")
            return

        ws = self.workspace
        sweep = 0
        while True:
            updated = False
            # Greedy frontier: every unconfigured node with a configured
            # node within k_layers solves in ONE batched IK per pass; the
            # outer repeat-until-stable loop makes the final assignment
            # insensitive to this order, as the reference's own
            # re-expansion loop does.
            k_floor = 1
            while True:
                todo, k_eff = [], k_layers
                if coherent:
                    # tightest frontier first: only escalate the
                    # projection radius when the nearer one is stalled
                    # (k_floor rises past radii whose whole frontier
                    # failed IK, else they would retry forever)
                    for k_try in range(k_floor, k_layers + 1):
                        todo = self._frontier(k_try)
                        if todo:
                            k_eff = k_try
                            break
                else:
                    todo = self._frontier(k_layers)
                if not todo:
                    break
                if coherent:
                    remaining = set(todo)
                    batches = []
                    while remaining:
                        cls, blocked = [], set()
                        for i in sorted(remaining):
                            if i in blocked:
                                continue
                            cls.append(i)
                            blocked.update(ws.adjacency[i])
                        batches.append(cls)
                        remaining -= set(cls)
                else:
                    batches = [todo]
                any_assigned = False
                for cls in batches:
                    q, ok = self.project_neighbors_batch(cls, k_eff)
                    assigned = []
                    for b, i in enumerate(cls):
                        if ok[b]:
                            self.configs[i] = q[b]
                            self.has_config[i] = True
                            assigned.append(i)
                    if assigned:
                        any_assigned = True
                        self.check_connections(assigned)
                if not any_assigned:
                    if coherent and k_eff < k_layers:
                        k_floor = k_eff + 1
                        continue
                    break
                updated = True
                k_floor = 1
            sweep += 1
            if verbose:
                print(
                    f"sweep {sweep}: {int(self.has_config.sum())}/"
                    f"{ws.num_nodes} configured, "
                    f"{int(self.edge_connected.sum())}/{len(ws.edges)} connected"
                )
            if on_sweep is not None:
                on_sweep(self)
            if not updated:
                break

    # ------------------------------------------------------------------
    # boundary repair (solver.py:400-493)
    # ------------------------------------------------------------------
    def _discontinuous(self):
        """(E,) bool: edges that join two configured nodes and are not
        connected."""
        i, j = self.workspace.edges[:, 0], self.workspace.edges[:, 1]
        return ~self.edge_connected & self.has_config[i] & self.has_config[j]

    def fix_boundary(self, n_neighbor_layer=1, n_iter=5, verbose=True):
        """Destruct-and-rebuild repair of discontinuous boundaries."""
        ws = self.workspace
        for _ in range(n_iter):
            boundary = set(
                np.unique(ws.edges[self._discontinuous()]).tolist())
            if not boundary:
                if verbose:
                    print("No discontinuous nodes anymore")
                return
            if verbose:
                print(f"Discontinuous nodes: {len(boundary)}")

            # BFS levels outward from the boundary
            levels = [sorted(boundary)]
            seen = set(boundary)
            for _l in range(n_neighbor_layer - 1):
                nxt = set()
                for i in levels[-1]:
                    for j in ws.adjacency[i]:
                        if j not in seen and self.has_config[j]:
                            nxt.add(j)
                seen |= nxt
                if not nxt:
                    break
                levels.append(sorted(nxt))

            # destruct
            old_config = {}
            for lv in levels:
                for i in lv:
                    for j in ws.adjacency[i]:
                        key = (min(i, j), max(i, j))
                        self.edge_connected[self._edge_index[key]] = False
                    old_config[i] = self.configs[i].copy()
                    self.has_config[i] = False

            # rebuild outer-first
            for lv in levels[::-1]:
                q, ok = self.project_neighbors_batch(lv, 4)
                assigned = []
                for b, i in enumerate(lv):
                    if ok[b]:
                        self.configs[i] = q[b]
                        self.has_config[i] = True
                        assigned.append(i)
                if assigned:
                    self.check_connections(assigned)

            # restore any still-unassigned nodes
            restored = []
            for lv in levels:
                for i in lv:
                    if not self.has_config[i]:
                        self.configs[i] = old_config[i]
                        self.has_config[i] = True
                        restored.append(i)
            if restored:
                self.check_connections(restored)

    # ------------------------------------------------------------------
    def repair_edges(self, max_rounds=3, verbose=True):
        """Targeted cross-seed repair of individual disconnected edges.

        For each disconnected edge (i, j) between configured nodes, try
        re-solving node i's IK seeded from j's config (and vice versa) —
        basin alignment the destruct-and-rebuild pass can't do, because
        ``project_neighbors`` always seeds from the blended average
        (reference ``solver.py:227-259``). A candidate is adopted only if
        it strictly INCREASES the node's count of connected incident
        edges (so an existing connection is never traded 1:1 for the
        repaired one). Goes beyond the reference's fix_boundary
        (``solver.py:400-493``) — documented divergence."""
        ws = self.workspace
        for _round in range(max_rounds):
            bad = np.flatnonzero(self._discontinuous())
            if not len(bad):
                return
            if verbose:
                print(f"edge repair round {_round + 1}: "
                      f"{len(bad)} disconnected edges")

            # two candidates per bad edge: (node, cross-seed neighbor)
            pair = ws.edges[bad]  # (b, 2): candidates i <- j, then j <- i
            cand_node = pair.reshape(-1).tolist()
            seed_node = pair[:, ::-1].reshape(-1)
            q_new, conv, valid = self._ik_batch(
                ws.points[pair.reshape(-1)], self.configs[seed_node])
            ok = conv & valid

            # one batched continuity check over every (candidate, nbr) pair
            pair_owner = [
                (c, m) for c, n in enumerate(cand_node) if ok[c]
                for m in ws.adjacency[n] if self.has_config[m]
            ]  # (candidate idx, neighbor node)
            if not pair_owner:
                return
            c_idx = np.asarray([c for c, _ in pair_owner])
            m_idx = np.asarray([m for _, m in pair_owner])
            cont = self.is_continuous_batch(
                q_new[c_idx], self.configs[m_idx],
                ws.points[np.asarray(cand_node)[c_idx]], ws.points[m_idx],
            )
            new_connected = {}  # candidate idx -> set of connected nbrs
            for (c, m), ct in zip(pair_owner, cont):
                if ct:
                    new_connected.setdefault(c, set()).add(m)

            # greedy adoption: best candidate per node, strict improvement,
            # and never adjacent to a node already changed this round (its
            # continuity was evaluated against the old neighbor config)
            changed = set()
            improved = 0
            order = sorted(
                new_connected.items(), key=lambda kv: -len(kv[1])
            )
            for c, conn in order:
                n = cand_node[c]
                if n in changed or changed & set(ws.adjacency[n]):
                    continue
                cur = sum(
                    1 for m in ws.adjacency[n]
                    if self.has_config[m]
                    and self.edge_connected[
                        self._edge_index[(min(n, m), max(n, m))]]
                )
                if len(conn) <= cur:
                    continue
                self.configs[n] = q_new[c]
                for m in ws.adjacency[n]:
                    key = (min(n, m), max(n, m))
                    self.edge_connected[self._edge_index[key]] = (
                        self.has_config[m] and m in conn
                    )
                changed.add(n)
                improved += 1
            if verbose:
                print(f"  adopted {improved} cross-seeded configs")
            if not improved:
                return

    def smooth_field(self, n_iter=5, verbose=True):
        """Coherence relaxation sweeps over the configured field.

        The reference's strictly-sequential FIFO expansion seeds every
        projection from the inverse-square-weighted average of already-
        assigned neighbors (``solver.py:227-259``), so its config field
        is locally coherent by construction; the batched waves configure
        more nodes but leave a rougher field. This pass is Gauss-Seidel
        relaxation of the redundancy field.

        Per sweep, for each configured node (scheduled over greedy
        graph-coloring independent sets so parallel updates never move
        both endpoints of an edge): IK from the weighted neighbor
        average with NO restarts, adopt iff valid AND it strictly
        decreases the node's weighted config-distance to its configured
        neighbors (descent on a per-edge potential, so sweeps
        terminate), then re-check the node's incident edges.
        """
        ws = self.workspace
        # greedy graph coloring once (host)
        color = -np.ones(ws.num_nodes, dtype=np.int64)
        for i in range(ws.num_nodes):
            used = {color[j] for j in ws.adjacency[i]}
            c = 0
            while c in used:
                c += 1
            color[i] = c
        n_colors = int(color.max()) + 1

        for sweep in range(n_iter):
            adopted = 0
            for c in range(n_colors):
                nodes = [
                    int(i) for i in np.flatnonzero(
                        self.has_config & (color == c)
                    )
                    if any(self.has_config[j] for j in ws.adjacency[i])
                ]
                if not nodes:
                    continue
                # averaged seed only — restarts would hop basins, which
                # is exactly the roughness this pass removes
                nbr_sets = [
                    [j for j in ws.adjacency[i] if self.has_config[j]]
                    for i in nodes
                ]
                K = max(len(s) for s in nbr_sets)
                nbr_idx = np.zeros((len(nodes), K), np.int64)
                nbr_mask = np.zeros((len(nodes), K), bool)
                for b, s in enumerate(nbr_sets):
                    nbr_idx[b, : len(s)] = s
                    nbr_mask[b, : len(s)] = True
                seeds = _weighted_average_batch(
                    self._tensor(ws.points[nodes]),
                    self._tensor(ws.points[nbr_idx]),
                    self._tensor(self.configs[nbr_idx]),
                    torch.as_tensor(nbr_mask, device=self.device),
                    self.robot._cyclic_mask,
                ).cpu().numpy()
                q_new, conv, valid = self._ik_batch(
                    ws.points[nodes], seeds
                )
                ok = conv & valid
                # weighted config-distance of each node's q to its
                # configured neighbors (inverse-square workspace weights)
                d_pt = np.maximum(np.linalg.norm(
                    ws.points[nbr_idx, :3] - ws.points[nodes, None, :3],
                    axis=-1), 1e-6)
                w = np.where(nbr_mask, 1.0 / d_pt**2, 0.0)
                nbr_cfg = self.configs[nbr_idx]
                cur, new = (
                    (w * self._distance(qs[:, None], nbr_cfg)).sum(1)
                    / w.sum(1)
                    for qs in (self.configs[nodes], q_new)
                )
                take = ok & (new < cur - 1e-6)
                changed = [n for n, tk in zip(nodes, take) if tk]
                for b, (n, tk) in enumerate(zip(nodes, take)):
                    if tk:
                        self.configs[n] = q_new[b]
                adopted += len(changed)
                if changed:
                    self.check_connections(changed)
            if verbose:
                print(f"smooth sweep {sweep + 1}: adopted {adopted}")
            if not adopted:
                break

    def scrub_disconnected(self, verbose=True):
        """Remove configs until NO disconnected edge joins two configured
        nodes — the observable end-state of the reference's shipped
        artifacts (its quality metric only counts edges between
        configured nodes, ``experiment/roadmap_quality.py:22-35``, so
        dropping a config converts 'disconnected' into 'unconfigured').
        Victims are chosen greedily: most disconnected incident edges,
        tie-broken by fewest connected ones."""
        ws = self.workspace
        n = ws.num_nodes
        scrubbed = 0
        while True:
            both = (self.has_config[ws.edges[:, 0]]
                    & self.has_config[ws.edges[:, 1]])
            good, bad = (ws.edges[both & sel].reshape(-1)
                         for sel in (self.edge_connected,
                                     ~self.edge_connected))
            bad_count = np.bincount(bad, minlength=n)
            good_count = np.bincount(good, minlength=n)
            if bad_count.max() == 0:
                break
            worst = np.flatnonzero(bad_count == bad_count.max())
            victim = int(worst[np.argmin(good_count[worst])])
            self.has_config[victim] = False
            for m in ws.adjacency[victim]:
                key = (min(victim, m), max(victim, m))
                self.edge_connected[self._edge_index[key]] = False
            scrubbed += 1
        if verbose and scrubbed:
            print(f"scrubbed {scrubbed} configs to reach 0% disconnection")

    # ------------------------------------------------------------------
    def build_resolution(self):
        """Compact configured nodes into resolution arrays
        (``solver.py:373-398``): (points, configs, edges, weights)."""
        ws = self.workspace
        keep = np.flatnonzero(self.has_config)
        remap = -np.ones(ws.num_nodes, dtype=np.int64)
        remap[keep] = np.arange(len(keep))
        sel = self.edge_connected
        return {
            "points": ws.points[keep],
            "configs": self.configs[keep],
            "edges": remap[ws.edges[sel]].astype(np.int64).reshape(-1, 2),
            "edge_weights": ws.edge_weights[sel].astype(np.float32),
        }


# ----------------------------------------------------------------------
# batched helpers (the JAX package jits these)
# ----------------------------------------------------------------------
def _weighted_average_batch(pts, nbr_pts, nbr_cfg, nbr_mask, cyclic_mask):
    """Inverse-square-distance weighted config average per node
    (``solver.py:245-257`` + ``robot.average`` circular-mean semantics)."""
    d = maths.se3_distance(pts[:, None, :], nbr_pts)  # (B, K)
    d = torch.where(nbr_mask, d, torch.inf)
    max_d = torch.where(nbr_mask, d, -torch.inf).amax(dim=1, keepdim=True)
    w = (max_d / torch.clamp(d, min=1e-9)) ** 2  # solver.py:253-254
    w = torch.where(nbr_mask, w, 0.0)
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
    lin = (nbr_cfg * w[..., None]).sum(dim=1)
    x = (w[..., None] * torch.cos(nbr_cfg)).sum(dim=1)
    y = (w[..., None] * torch.sin(nbr_cfg)).sum(dim=1)
    circ = torch.atan2(y, x)
    return torch.where(cyclic_mask, circ, lin)


def _interp_config_batch(qa, qb, u, cyclic_mask):
    lin = qa + u * (qb - qa)
    cyc = maths.wrap_to_pi(qa + u * maths.wrap_to_pi(qb - qa))
    return torch.where(cyclic_mask, cyc, lin)


def _interp_point_batch(p1, p2, u):
    """(B, D) x (B, D) x (n_mid,) -> (B, n_mid, D) interpolated workspace
    points (pos lerp + quat slerp)."""
    uu = u[None, :, None]
    pos = p1[:, None, :3] + uu * (p2[:, None, :3] - p1[:, None, :3])
    if p1.shape[-1] > 3:
        shape = (p1.shape[0], u.shape[0], 4)
        quat = maths.slerp(
            p1[:, None, 3:7].expand(shape),
            p2[:, None, 3:7].expand(shape),
            uu,
        )
        return torch.cat([pos, quat], dim=-1)
    return pos
