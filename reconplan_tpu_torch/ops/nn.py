"""Brute-force nearest neighbours in matmul form.

Port of ``pairwise_sqdist`` and ``nearest_neighbor`` from
``reconplan_tpu.ops.nn``. Distances take the mean-centred matmul identity
|x|^2 + |y|^2 - 2 x.y in full f32 (TF32 is off, see the package
``__init__``); the winner of each row is then recomputed exactly by
direct subtraction. Queries go in padded row chunks as in the JAX
function, which bounds the distance tile at ``row_chunk x N``.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(x, y):
    """Squared euclidean distances (N, D) x (M, D) -> (N, M).

    The joint mean is subtracted first: the matmul identity's cancellation
    error scales with |x||y|, and centring drops it by orders of magnitude
    for scenes far from the origin.
    """
    mu = 0.5 * (x.mean(dim=0) + y.mean(dim=0))
    x = x - mu
    y = y - mu
    x2 = (x * x).sum(dim=-1, keepdim=True)
    y2 = (y * y).sum(dim=-1, keepdim=True)
    xy = torch.matmul(x, y.T)
    return torch.clamp(x2 + y2.T - 2.0 * xy, min=0.0)


def nearest_neighbor(queries, points, valid=None, row_chunk=2048):
    """Single nearest neighbour: (dists (Q,), idx (Q,))."""
    Q = queries.shape[0]
    pad = (-Q) % row_chunk
    q_padded = torch.nn.functional.pad(queries, (0, 0, 0, pad))
    dists, idxs = [], []
    for q_chunk in q_padded.split(row_chunk):
        d = pairwise_sqdist(q_chunk, points)
        if valid is not None:
            d = torch.where(valid[None, :], d, float("inf"))
        idx = d.argmin(dim=-1)
        # exact recompute of the winner (cancellation, see pairwise_sqdist)
        dists.append(torch.linalg.norm(q_chunk - points[idx], dim=-1))
        idxs.append(idx)
    return torch.cat(dists)[:Q], torch.cat(idxs)[:Q]
