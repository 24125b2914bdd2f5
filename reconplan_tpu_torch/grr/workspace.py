"""Workspace roadmap: sampling + connectivity as flat arrays.

Port of ``reconplan_tpu.grr.workspace``. The graph is (points (N, D),
edges (E, 2), weights (E,)) with host-side adjacency lists for BFS;
queries are exact dense top-k on the workspace's device
(``ops.nn.se3_knn``), with no build phase.

Both sampling modes of the reference are kept:
  * "random": the hardcoded scan arc, look-at poses on a tilted circle
    around the object, plus the original uniform-random path;
  * "grid": staggered R^3 grid x SO(3) grid Cartesian product.
"""

from __future__ import annotations

import numpy as np
import torch

from reconplan_tpu_torch.core import grids, maths
from reconplan_tpu_torch.io.checkpoint import (
    load_roadmap_npz,
    save_roadmap_npz,
)
from reconplan_tpu_torch.ops.nn import se3_knn
from reconplan_tpu_torch.utils.device import resolve_device


def robot_device(robot, device):
    """``device`` resolved (None: the card), which must be the robot's:
    the roadmap's queries feed the robot's FK and IK."""
    device = resolve_device(device)
    if (device.type, device.index or 0) != (robot.device.type,
                                            robot.device.index or 0):
        raise ValueError(f"the robot is on {robot.device}, the roadmap was "
                         f"asked for {device}")
    return device


class RoadmapWorkspace:
    """Sampled workspace points + k-NN connectivity.

    Attributes:
        points: (N, D) float32, D = 3 or 7 ([pos, quat]).
        edges: (E, 2) int64, i < j.
        edge_weights: (E,) SE3 edge lengths.
        adjacency: list[list[int]] host-side neighbor lists.
    """

    def __init__(self, robot, device=None):
        self.robot = robot
        self.device = robot_device(robot, device)
        self.pos_dims = len([1 for (a, b) in robot.domain if a != b])
        # reference forces rot_dims = 3 regardless of the problem's
        # rotation_domain (workspace.py:42)
        self.rot_dims = 3
        self.interpolate_num_neighbors = 2**self.pos_dims + self.rot_dims * 2

        self.points = np.zeros((0, 7), dtype=np.float32)
        self.edges = np.zeros((0, 2), dtype=np.int64)
        self.edge_weights = np.zeros((0,), dtype=np.float32)
        self.adjacency: list[list[int]] = []

    # ------------------------------------------------------------------
    @property
    def num_nodes(self):
        return len(self.points)

    def _tensor(self, a):
        """f32 tensor of ``a`` (numpy or tensor) on the workspace's
        device."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=self.device)

    def _points_device(self):
        return self._tensor(self.points)

    # ------------------------------------------------------------------
    # sampling (workspace.py:104-376)
    # ------------------------------------------------------------------
    def sample_workspace(self, obj_pos, n_pos_points, n_rot_points,
                         sampling_method="random"):
        if sampling_method == "random":
            self._sample_arc(obj_pos, n_pos_points, n_rot_points)
        elif sampling_method == "grid":
            self._sample_grid(n_pos_points, n_rot_points)
        elif sampling_method == "uniform_random":
            self._sample_uniform(n_pos_points)
        else:
            raise ValueError(f"Unknown method: {sampling_method}")

    def _sample_arc(self, obj_pos, n_pos_points, n_rot_points):
        """The as-modified reference "random" path (``workspace.py:136-290``):
        a hardcoded tilted arc of look-at poses around the object, with
        n_rot_points forced to 1 and k = n_rot_points*3 - 1 = 2 edges/node.
        """
        n_rot_points = 1  # workspace.py:115
        obj = np.asarray(obj_pos, dtype=np.float64)
        circ_rad = 0.3
        circ_height = 0.3  # workspace.py:155 (final assignment wins)
        t = np.linspace(0, np.pi, n_pos_points)
        x = obj[0] - 0.15 * np.cos(np.pi / 4) + circ_rad * np.cos(t) * np.cos(3 * np.pi / 4)
        y = obj[1] - 0.15 * np.cos(np.pi / 4) + circ_rad * np.cos(t) * np.sin(3 * np.pi / 4)
        z = circ_height + obj[2] + circ_rad * np.sin(t)
        eyes = np.stack([x, y, z], axis=-1).astype(np.float32)
        quats = maths.look_at_quat(self._tensor(eyes),
                                   self._tensor(obj)).cpu().numpy()
        self.points = np.concatenate([eyes, quats], axis=-1).astype(np.float32)

        # connect: k = n_rot_points * 3 - 1 (= 2), via SE3 top-k
        k = n_rot_points * 3 - 1
        self._connect_knn(k)

    def _sample_uniform(self, n_points, seed=0):
        """The reference's original uniform random sampling
        (``robot.workspace_sample`` per node)."""
        pts = [self.robot.workspace_sample() for _ in range(n_points)]
        self.points = np.asarray(pts, dtype=np.float32)
        constant = np.e / 4
        k = int(constant * (1 + 1.0 / self.pos_dims) * np.log(n_points))
        if self.rot_dims > 0:
            k *= self.rot_dims * 2
        self._connect_knn(max(k, 2))

    def _sample_grid(self, n_pos_points, n_rot_points):
        """Staggered grid x SO(3) grid product (``workspace.py:296-368``)."""
        pos_points, pos_edges = grids.get_staggered_grid(
            n_pos_points, self.robot.domain
        )
        if self.robot.rotation != "variable" or n_rot_points <= 0:
            self.points = pos_points.astype(np.float32)
            edges = pos_edges
        else:
            if self.robot.fixed_rotation is not None:
                fixed_euler = maths.quat_to_euler(
                    self._tensor(self.robot.fixed_rotation),
                    seq=maths.PROBLEM_EULER_SEQ,
                ).cpu().numpy()
            else:
                fixed_euler = np.zeros(3)
            rot_points, rot_edges = grids.get_so3_grid(
                n_rot_points,
                self.robot.rot_domain,
                fixed_euler,
                num_neighbors=self.rot_dims * 2,
                device=self.device,
            )
            P, R = len(pos_points), len(rot_points)
            pts = np.concatenate(
                [
                    np.repeat(pos_points, R, axis=0),
                    np.tile(rot_points, (P, 1)),
                ],
                axis=-1,
            )
            self.points = pts.astype(np.float32)
            # product-graph edges: same-rotation position edges +
            # same-position rotation edges (workspace.py:355-365)
            pos_edges = np.asarray(pos_edges, np.int64).reshape(-1, 2)
            rot_edges = np.asarray(rot_edges, np.int64).reshape(-1, 2)
            edges = np.concatenate([
                (pos_edges[:, None] * R + np.arange(R)[:, None]).reshape(-1, 2),
                (np.arange(P)[:, None, None] * R + rot_edges).reshape(-1, 2),
            ])
        self._set_edges(edges)

    # ------------------------------------------------------------------
    def _connect_knn(self, k):
        pts = self._points_device()
        _, idx = se3_knn(pts, pts, k + 1)
        idx = idx.cpu().numpy()
        i = np.repeat(np.arange(len(idx)), idx.shape[1])
        j = idx.reshape(-1)
        keep = i != j
        pairs = np.stack([np.minimum(i, j), np.maximum(i, j)], -1)[keep]
        self._set_edges(np.unique(pairs, axis=0).astype(np.int64))

    def _set_edges(self, edges):
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if len(edges):
            i, j = edges[:, 0], edges[:, 1]
            swap = i > j
            edges = np.stack([np.where(swap, j, i), np.where(swap, i, j)], -1)
            edges = np.unique(edges, axis=0)
        self.edges = edges
        if len(edges):
            w = maths.se3_distance(
                self._tensor(self.points[edges[:, 0]]),
                self._tensor(self.points[edges[:, 1]]),
            )
            self.edge_weights = w.cpu().numpy().astype(np.float32)
        else:
            self.edge_weights = np.zeros((0,), dtype=np.float32)
        adj = [[] for _ in range(self.num_nodes)]
        for i, j in edges.tolist():
            adj[i].append(j)
            adj[j].append(i)
        self.adjacency = adj

    # ------------------------------------------------------------------
    # queries (workspace.py:410-458)
    # ------------------------------------------------------------------
    def get_workspace_neighbors(self, point, k=None, points=None):
        """k nearest roadmap nodes to ``point`` under the SE3 metric.

        Exact (the reference used approximate NNDescent and clamped k to
        >= 200 to compensate, ``workspace.py:454-458`` — unnecessary here).
        Accepts a single point (D,) or batch (Q, D), and ``points`` as
        numpy or as a tensor (kept where it is when already on the
        workspace's device); returns numpy indices.
        """
        target = self._points_device() if points is None else self._tensor(
            points)
        q = self._tensor(point)
        single = q.ndim == 1
        if single:
            q = q[None]
        # position-only queries against a posed roadmap (rot_free
        # problems: rotation is free, so 3D targets match on position)
        if q.shape[1] == 3 and target.shape[1] > 3:
            target = target[:, :3]
        elif q.shape[1] > 3 and target.shape[1] == 3:
            q = q[:, :3]
        k = min(k or 1, target.shape[0])
        _, idx = se3_knn(q, target, k)
        idx = idx.cpu().numpy()
        return idx[0] if single else idx

    # ------------------------------------------------------------------
    def save(self, path):
        save_roadmap_npz(
            path,
            points=self.points,
            edges=self.edges,
            edge_weights=self.edge_weights,
        )

    def load(self, path):
        data = load_roadmap_npz(path)
        self.points = data["points"]
        self._set_edges(data["edges"])
        return self
