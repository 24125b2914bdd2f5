"""Nearest-neighbour structures with the reference's interface.

Port of ``reconplan_tpu.grr.nearest_neighbors``: the GNAT query surface
(``add`` / ``add_list`` / ``nearest`` / ``nearest_k`` / ``nearest_r`` /
``remove`` / ``size``) served by an exact dense top-k under the SE3
metric (``ops.nn.se3_knn``), with no build phase, and ``GreedyKCenters``
for spread-out pivots. Points are kept as numpy on the host and go to
``device`` (default: the card) for each query.
"""

from __future__ import annotations

import numpy as np
import torch

from reconplan_tpu_torch.ops.nn import se3_knn, se3_pairwise
from reconplan_tpu_torch.utils.device import resolve_device


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


class NearestNeighbors:
    """Abstract interface matching ``grr/nearest_neighbors.py:21-68``."""

    def add(self, point):
        raise NotImplementedError

    def add_list(self, points):
        raise NotImplementedError

    def nearest(self, point):
        raise NotImplementedError

    def nearest_k(self, point, k):
        raise NotImplementedError

    def nearest_r(self, point, r):
        raise NotImplementedError

    def remove(self, point_index):
        raise NotImplementedError

    def size(self):
        raise NotImplementedError


class DenseTopK(NearestNeighbors):
    """Exact SE3 nearest neighbours by dense top-k on ``device``.

    Drop-in for the reference's ``GNAT``: same query surface, exact
    results, O(1) removal (a mask). Points are (D,) arrays, D = 3 or 7.
    """

    def __init__(self, capacity=1 << 20, dim=7, device=None):
        self.device = resolve_device(device)
        self._points = np.zeros((0, dim), dtype=np.float32)
        self._alive = np.zeros(0, dtype=bool)
        self.capacity = capacity

    # -- construction ---------------------------------------------------
    def add(self, point):
        self.add_list([point])

    def add_list(self, points):
        pts = np.asarray(points, dtype=np.float32).reshape(len(points), -1)
        self._points = np.concatenate([self._points[: len(self._alive)], pts])
        self._alive = np.concatenate([self._alive, np.ones(len(pts), bool)])

    def remove(self, point_index):
        self._alive[point_index] = False

    def size(self):
        return int(self._alive.sum())

    # -- queries --------------------------------------------------------
    def _query(self, point, k):
        k = min(k, len(self._points))
        d, idx = se3_knn(
            _f32(point, self.device)[None],
            _f32(self._points, self.device),
            k,
            valid=torch.as_tensor(self._alive, device=self.device),
        )
        return d[0].cpu().numpy(), idx[0].cpu().numpy()

    def nearest(self, point):
        _, idx = self._query(point, 1)
        return int(idx[0])

    def nearest_k(self, point, k):
        d, idx = self._query(point, k)
        return idx.tolist(), d.tolist()

    def nearest_r(self, point, r):
        """Radius query: all alive points within SE3 distance r."""
        d = se3_pairwise(_f32(point, self.device)[None],
                         _f32(self._points, self.device))[0].cpu().numpy()
        sel = np.flatnonzero((d <= r) & self._alive)
        order = np.argsort(d[sel])
        return sel[order].tolist(), d[sel][order].tolist()


class GreedyKCenters:
    """Greedy k-centers selection (``grr/nearest_neighbors.py:71-115``):
    pick k points maximizing mutual separation under the SE3 metric, one
    distance row on ``device`` per pick."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def kcenters(self, points, k, seed=0):
        pts = _f32(points, self.device)
        n = len(pts)
        k = min(k, n)
        rng = np.random.default_rng(seed)
        centers = [int(rng.integers(n))]
        min_d = se3_pairwise(pts[centers[-1]][None], pts)[0].cpu().numpy()
        for _ in range(1, k):
            nxt = int(np.argmax(min_d))
            centers.append(nxt)
            d_new = se3_pairwise(pts[nxt][None], pts)[0].cpu().numpy()
            min_d = np.minimum(min_d, d_new)
        # distance matrix of chosen centers (the reference returns it too)
        sel = pts[centers]
        return centers, se3_pairwise(sel, sel).cpu().numpy()


# Alias matching the reference's class name so imports read the same.
GNAT = DenseTopK
