"""Brute-force nearest neighbours in matmul form.

Port of ``pairwise_sqdist``, ``se3_pairwise``, ``knn``,
``nearest_neighbor`` and ``se3_knn`` from ``reconplan_tpu.ops.nn``.
Distances take the mean-centred matmul identity |x|^2 + |y|^2 - 2 x.y in
full f32 (TF32 is off, see the package ``__init__``); the winners of each
row are then recomputed exactly by direct subtraction (for k-NN: a
candidate superset by the matmul metric, re-ranked exactly). Queries go
in padded row chunks as in the JAX functions, which bounds the distance
tile at ``row_chunk x N``.
"""

from __future__ import annotations

import torch

from reconplan_tpu_torch.utils.profiling import to_host


def pairwise_sqdist(x, y, precision=None, center=True):
    """Squared euclidean distances (..., N, D) x (..., M, D) -> (..., N, M);
    leading dimensions are a batch, each pair on its own (the JAX
    function under ``vmap``).

    ``center=True`` subtracts the joint mean first: the matmul identity's
    cancellation error scales with |x||y|, and centring drops it by orders
    of magnitude for scenes far from the origin. ``precision`` is accepted
    and unused: full f32 with TF32 off is the only mode here.
    """
    if center:
        mu = 0.5 * (x.mean(dim=-2, keepdim=True) + y.mean(dim=-2,
                                                          keepdim=True))
        x = x - mu
        y = y - mu
    x2 = (x * x).sum(dim=-1, keepdim=True)
    y2 = (y * y).sum(dim=-1, keepdim=True)
    # (x2 + y2) - 2 xy, in place on the two (N, M) temporaries
    d = x2 + y2.transpose(-1, -2)
    d.sub_(torch.matmul(x, y.transpose(-1, -2)).mul_(2.0))
    return d.clamp_(min=0.0)


# the most entries of one distance tile (256 MB in f32): 2,048 query rows
# against a 200,000-point surface sample would make 1.6 GB tiles, several
# of them alive at once on the CPU
TILE_ENTRIES = 1 << 26


def nearest_neighbor(queries, points, valid=None, row_chunk=2048):
    """Single nearest neighbour: (dists (Q,), idx (Q,)). Queries go in
    chunks of ``row_chunk`` rows, fewer where a chunk's tile against
    ``points`` would pass ``TILE_ENTRIES``."""
    row_chunk = max(1, min(row_chunk, TILE_ENTRIES // max(len(points), 1)))
    Q = queries.shape[0]
    pad = (-Q) % row_chunk
    q_padded = torch.nn.functional.pad(queries, (0, 0, 0, pad))
    dists, idxs = [], []
    for q_chunk in q_padded.split(row_chunk):
        d = pairwise_sqdist(q_chunk, points)
        if valid is not None:
            d.masked_fill_(~valid[None, :], float("inf"))
        idx = d.argmin(dim=-1)
        # exact recompute of the winner (cancellation, see pairwise_sqdist)
        dists.append(torch.linalg.norm(q_chunk - points[idx], dim=-1))
        idxs.append(idx)
    return torch.cat(dists)[:Q], torch.cat(idxs)[:Q]


def se3_pairwise(points1, points2, position_weight=1.0, rotation_weight=0.3):
    """SE3 distance matrix (..., N, 7) x (..., M, 7) -> (..., N, M):
    ``w_p * ||p1 - p2|| + w_r * (1 - |q1.q2|)``, the workspace metric of
    the GRR stack; position-only (D = 3) inputs give the position term.
    Leading dimensions are a batch, as in :func:`pairwise_sqdist`."""
    d_pos = torch.sqrt(pairwise_sqdist(points1[..., :3], points2[..., :3]))
    if points1.shape[-1] <= 3 or points2.shape[-1] <= 3:
        return d_pos
    qdot = torch.matmul(points1[..., 3:7],
                        points2[..., 3:7].transpose(-1, -2))
    return position_weight * d_pos + rotation_weight * (1.0 - qdot.abs())


def _smallest(d, n):
    """Column indices of the ``n`` smallest entries of each row of ``d``,
    ascending by (value, index): ``lax.top_k``'s order, also where equal
    values straddle the ``n``-th place, where ``torch.topk`` may pick any
    of them.

    ``topk`` takes the ``n + 1`` smallest: a row whose ``n + 1``-th value
    equals its ``n``-th has such a tie and is redone by
    :func:`_tie_filled`. The other rows (nearly all of a distance
    matrix's) cost what ``topk`` costs, and one flag read back to the
    host says whether any row is tied."""
    m = min(n + 1, d.shape[1])
    vals, idx = torch.topk(d, m, dim=1, largest=False)
    v = vals[:, n - 1:n]
    idx = idx[:, :n].sort(dim=1).values
    if m > n:
        tied = vals[:, n] == v[:, 0]
        if bool(to_host(tied.any())):
            rows = tied.nonzero()[:, 0]
            idx[rows] = _tie_filled(d[rows], v[rows], n)
    order = torch.sort(torch.gather(d, 1, idx), dim=1, stable=True).indices
    return torch.gather(idx, 1, order)


def _tie_filled(d, v, n):
    """The columns, in index order, of every entry of each row of ``d``
    below its ``v`` and of the lowest-index entries equal to ``v`` up to
    ``n`` in all: the equal ones by a running count of the equal mask, the
    kept ones found by a search of the kept mask's running count."""
    less = d < v
    eq = d == v
    need = n - less.sum(dim=1, keepdim=True, dtype=torch.int32)
    keep = less | (eq & (torch.cumsum(eq, 1, dtype=torch.int32) <= need))
    ranks = torch.arange(1, n + 1, dtype=torch.int32, device=d.device)
    return torch.searchsorted(torch.cumsum(keep, 1, dtype=torch.int32),
                              ranks.expand(d.shape[0], n).contiguous())


def _knn_chunked(queries, points, k, valid, row_chunk, metric, exact):
    """k-NN in padded row chunks: a candidate superset of ``4k + 16`` by
    the matmul ``metric``, re-ranked by the ``exact`` one (direct
    subtraction), so the matmul identity's absolute error cannot reorder
    the winners."""
    Q = queries.shape[0]
    pad = (-Q) % row_chunk
    q_padded = torch.nn.functional.pad(queries, (0, 0, 0, pad))
    n_cand = min(max(4 * k + 16, k), points.shape[0])
    dists, idxs = [], []
    for q_chunk in q_padded.split(row_chunk):
        d = metric(q_chunk, points)
        if valid is not None:
            d.masked_fill_(~valid[None, :], float("inf"))
        cand = _smallest(d, n_cand)
        d_exact = exact(q_chunk[:, None, :], points[cand])
        if valid is not None:
            d_exact = torch.where(valid[cand], d_exact, float("inf"))
        pos = _smallest(d_exact, k)
        dists.append(torch.gather(d_exact, 1, pos))
        idxs.append(torch.gather(cand, 1, pos))
    return torch.cat(dists)[:Q], torch.cat(idxs)[:Q]


def knn(queries, points, k, valid=None, row_chunk=1024):
    """k nearest neighbours by euclidean distance: (dists (Q, k), idx
    (Q, k)) sorted ascending. ``valid`` (N,) bool masks points out."""
    return _knn_chunked(
        queries, points, k, valid, row_chunk, pairwise_sqdist,
        lambda q, sel: torch.linalg.norm(q - sel, dim=-1))


def se3_knn(queries, points, k, valid=None, row_chunk=512):
    """k nearest neighbours under the SE3 workspace metric
    (:func:`se3_pairwise`) of (Q, 7) / (N, 7) [pos, quat] points;
    position-only (D = 3) also works."""

    def exact(q, sel):
        d_pos = torch.linalg.norm(q[..., :3] - sel[..., :3], dim=-1)
        if points.shape[-1] <= 3:
            return d_pos
        qdot = (q[..., 3:7] * sel[..., 3:7]).sum(dim=-1).abs()
        return d_pos + 0.3 * (1.0 - qdot)

    return _knn_chunked(queries, points, k, valid, row_chunk, se3_pairwise,
                        exact)
