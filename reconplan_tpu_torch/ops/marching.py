"""Iso-surface extraction from TSDF grids: marching cubes.

Port of ``reconplan_tpu.ops.marching``, both variants:

* ``variant="table"`` (default): classic 256-case table marching cubes.
  The triangle table is generated at import by the same numpy generator
  (:func:`_build_mc_tables`, copied): per sign case each cube face is
  linked by marching squares with a sign-only ambiguity rule, the
  segments chain into closed polygons and fan-triangulate, which makes
  the table watertight by construction. Crossing points are interpolated
  in a canonical global-corner order, so the two cubes sharing an edge
  produce bitwise identical vertices.
* ``variant="tetra"``: marching tetrahedra (6 tets a cube around the 0-6
  diagonal, 16-case table), the cross-check twin; it emits about twice
  the triangles of the table variant.

Two phases: :func:`active_cubes` marks cubes straddling the zero level,
``torch.nonzero`` compacts them, and :func:`triangulate_cubes_table` or
:func:`triangulate_cubes` emits their triangles.
"""

from __future__ import annotations

import numpy as np
import torch

from reconplan_tpu_torch.ops.tsdf import TSDFGrid

# cube corners in (dx, dy, dz) offsets, index = bit order
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int32,
)

# 6-tet decomposition of the cube around the 0-6 diagonal; all share
# corners 0 and 6 so neighboring cubes tessellate consistently.
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    dtype=np.int32,
)

# tet edges as (corner, corner) local indices
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32
)

# triangle table for the 16 sign cases (bit i set = corner i inside/below
# iso). Each case lists up to 2 triangles of tet-edge ids; -1 pads.
# Winding is normalized at runtime against the SDF gradient.
_TET_TRIS = np.array(
    [
        [[-1, -1, -1], [-1, -1, -1]],  # 0000
        [[0, 2, 1], [-1, -1, -1]],     # 0001: corner 0 in
        [[0, 3, 4], [-1, -1, -1]],     # 0010: corner 1
        [[1, 3, 4], [1, 4, 2]],        # 0011: corners 0,1
        [[1, 5, 3], [-1, -1, -1]],     # 0100: corner 2
        [[0, 5, 3], [0, 2, 5]],        # 0101: corners 0,2
        [[0, 1, 5], [0, 5, 4]],        # 0110: corners 1,2
        [[2, 5, 4], [-1, -1, -1]],     # 0111: corners 0,1,2
        [[2, 4, 5], [-1, -1, -1]],     # 1000: corner 3
        [[0, 4, 5], [0, 5, 1]],        # 1001: corners 0,3
        [[0, 3, 5], [0, 5, 2]],        # 1010: corners 1,3
        [[1, 5, 3], [-1, -1, -1]],     # 1011: complement of 0100
        [[1, 4, 3], [1, 2, 4]],        # 1100: corners 2,3
        [[0, 4, 3], [-1, -1, -1]],     # 1101: complement of 0010
        [[0, 1, 2], [-1, -1, -1]],     # 1110: complement of 0001
        [[-1, -1, -1], [-1, -1, -1]],  # 1111
    ],
    dtype=np.int32,
)

MAX_TRIS_PER_CUBE = 12  # 6 tets x 2 triangles

# cube edges as (corner, corner); standard MC numbering
_CUBE_EDGES = np.array(
    [
        [0, 1], [1, 2], [2, 3], [3, 0],  # bottom ring (z=0)
        [4, 5], [5, 6], [6, 7], [7, 4],  # top ring (z=1)
        [0, 4], [1, 5], [2, 6], [3, 7],  # verticals
    ],
    dtype=np.int32,
)

# faces as cyclic corner quads; consecutive pairs are cube edges
_FACES = np.array(
    [
        [0, 1, 2, 3],  # z = 0
        [4, 5, 6, 7],  # z = 1
        [0, 1, 5, 4],  # y = 0
        [1, 2, 6, 5],  # x = 1
        [2, 3, 7, 6],  # y = 1
        [3, 0, 4, 7],  # x = 0
    ],
    dtype=np.int32,
)


def _edge_id(a, b):
    for e, (x, y) in enumerate(_CUBE_EDGES):
        if (a, b) == (x, y) or (a, b) == (y, x):
            return e
    raise ValueError((a, b))


def _build_mc_tables():
    """Generate (tri_table (256, MAX_TRIS_TABLE, 3), n_tris (256,)).

    Per case: marching-squares linking on each face (sign-only ambiguity
    rule: each maximal cyclic run of INSIDE corners links the crossing
    edge entering the run to the one leaving it), chain the per-face
    segments into closed polygons, fan-triangulate. Winding is normalized
    at runtime against the SDF gradient."""
    face_edges = [
        [_edge_id(int(f[i]), int(f[(i + 1) % 4])) for i in range(4)]
        for f in _FACES
    ]
    all_tris = []
    for case in range(256):
        inside = [(case >> c) & 1 for c in range(8)]
        # per-face segments between crossing cube edges
        links = {}  # edge id -> list of linked edge ids

        def add_link(e1, e2):
            links.setdefault(e1, []).append(e2)
            links.setdefault(e2, []).append(e1)

        for f, fe in zip(_FACES, face_edges):
            s = [inside[c] for c in f]
            if sum(s) in (0, 4):
                continue
            # maximal cyclic runs of inside corners
            for i in range(4):
                if s[i] and not s[i - 1]:  # run starts at i
                    j = i
                    while s[(j + 1) % 4]:
                        j = (j + 1) % 4
                    # entering crossing: edge between corner i-1 and i is
                    # fe[(i-1) % 4]; leaving: between j and j+1 is fe[j]
                    add_link(fe[(i - 1) % 4], fe[j % 4])
        # chain into cycles
        tris = []
        visited = set()
        for start in sorted(links):
            if start in visited:
                continue
            cycle = [start]
            visited.add(start)
            prev, cur = None, start
            while True:
                nxt = [e for e in links[cur] if e != prev]
                # each crossing edge has exactly 2 links; pick the one
                # not just walked
                nxt = nxt[0] if nxt else links[cur][0]
                if nxt == start:
                    break
                cycle.append(nxt)
                visited.add(nxt)
                prev, cur = cur, nxt
            for i in range(1, len(cycle) - 1):
                tris.append((cycle[0], cycle[i], cycle[i + 1]))
        all_tris.append(tris)

    max_t = max(len(t) for t in all_tris)
    table = -np.ones((256, max_t, 3), dtype=np.int32)
    for c, tris in enumerate(all_tris):
        for i, t in enumerate(tris):
            table[c, i] = t
    return table, np.array([len(t) for t in all_tris], dtype=np.int32)


_MC_TRI_TABLE, _MC_NTRIS = _build_mc_tables()
MAX_TRIS_TABLE = _MC_TRI_TABLE.shape[1]


def active_cubes(grid: TSDFGrid, weight_min: float = 1.0):
    """(D-1, H-1, W-1) bool mask of cubes straddling the zero level with
    all 8 corners observed."""
    neg = grid.sdf < 0
    obs = grid.weight >= weight_min

    def all8(x, op):
        x = op(x[:-1], x[1:])
        x = op(x[:, :-1], x[:, 1:])
        return op(x[:, :, :-1], x[:, :, 1:])

    any_neg = all8(neg, torch.logical_or)
    all_neg = all8(neg, torch.logical_and)
    all_obs = all8(obs, torch.logical_and)
    return any_neg & ~all_neg & all_obs


def _cube_corners(grid: TSDFGrid, cube_idx):
    """Corner grid indices (cz, cy, cx) (M, 8), sdf values (M, 8) and world
    positions (M, 8, 3) of the given cubes."""
    D, H, W = grid.sdf.shape
    ch, cw = H - 1, W - 1
    cube_idx = cube_idx.long()
    zi = cube_idx // (ch * cw)
    yi = (cube_idx // cw) % ch
    xi = cube_idx % cw
    corners = torch.as_tensor(_CORNERS, dtype=torch.int64,
                              device=grid.sdf.device)
    cz = zi[:, None] + corners[None, :, 2]
    cy = yi[:, None] + corners[None, :, 1]
    cx = xi[:, None] + corners[None, :, 0]
    vals = grid.sdf[cz, cy, cx]
    pos = (grid.origin
           + torch.stack([cx, cy, cz], dim=-1).float() * grid.voxel_size)
    return (cz, cy, cx), vals, pos


def _interpolate(va, vb, pa, pb):
    """Zero crossing between two corners: t = va / (va - vb), clipped."""
    denom = va - vb
    t = va / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    t = torch.clamp(t, 0.0, 1.0)
    return pa + t[..., None] * (pb - pa)


def _orient(vals, verts):
    """Wind each triangle so its normal points along the local SDF gradient
    (outside = positive sdf). ``verts`` (M, T, 3, 3)."""
    def mean4(idx):
        return vals[:, idx].mean(dim=1)

    gx = mean4([1, 2, 5, 6]) - mean4([0, 3, 4, 7])
    gy = mean4([2, 3, 6, 7]) - mean4([0, 1, 4, 5])
    gz = mean4([4, 5, 6, 7]) - mean4([0, 1, 2, 3])
    grad = torch.stack([gx, gy, gz], dim=-1)[:, None, :]
    n = torch.linalg.cross(
        verts[:, :, 1] - verts[:, :, 0], verts[:, :, 2] - verts[:, :, 0]
    )
    flip = (n * grad).sum(dim=-1) < 0
    v1 = torch.where(flip[..., None], verts[:, :, 2], verts[:, :, 1])
    v2 = torch.where(flip[..., None], verts[:, :, 1], verts[:, :, 2])
    return torch.stack([verts[:, :, 0], v1, v2], dim=2)


def triangulate_cubes(grid: TSDFGrid, cube_idx, cube_valid=None):
    """Marching-tetrahedra triangle emission for the given cubes.

    ``cube_idx`` (M,) linear indices into the (D-1, H-1, W-1) cube grid;
    ``cube_valid`` (M,) bool masks cubes out (padding), None keeps all.
    Returns verts (M, MAX_TRIS_PER_CUBE, 3, 3) world-space triangle
    vertices and tri_valid (M, MAX_TRIS_PER_CUBE).
    """
    dev = grid.sdf.device
    _, vals, pos = _cube_corners(grid, cube_idx)
    tets = torch.as_tensor(_TETS, dtype=torch.int64, device=dev)
    tv = vals[:, tets]  # (M, 6 tets, 4)
    tp = pos[:, tets]  # (M, 6, 4, 3)
    inside = (tv < 0).long()
    case = inside[..., 0] + 2 * inside[..., 1] + 4 * inside[..., 2] \
        + 8 * inside[..., 3]  # (M, 6)
    ea = torch.as_tensor(_TET_EDGES[:, 0], dtype=torch.int64, device=dev)
    eb = torch.as_tensor(_TET_EDGES[:, 1], dtype=torch.int64, device=dev)
    epts = _interpolate(tv[:, :, ea], tv[:, :, eb], tp[:, :, ea, :],
                        tp[:, :, eb, :])  # (M, 6 tets, 6 edges, 3)
    tris_edges = torch.as_tensor(_TET_TRIS, dtype=torch.int64,
                                 device=dev)[case]  # (M, 6, 2, 3)
    tri_ok = tris_edges[..., 0] >= 0  # (M, 6, 2)
    M = vals.shape[0]
    safe = torch.clamp(tris_edges, min=0).reshape(M, 6, 6)
    verts = torch.gather(epts, 2, safe[..., None].expand(-1, -1, -1, 3))
    verts = verts.reshape(M, MAX_TRIS_PER_CUBE, 3, 3)
    if cube_valid is not None:
        tri_ok = tri_ok & cube_valid[:, None, None]
    return _orient(vals, verts), tri_ok.reshape(M, MAX_TRIS_PER_CUBE)


def triangulate_cubes_table(grid: TSDFGrid, cube_idx, cube_valid=None):
    """Classic table-MC triangle emission for the given cubes.

    ``cube_idx`` (M,) linear indices into the (D-1, H-1, W-1) cube grid;
    ``cube_valid`` (M,) bool masks cubes out (padding), None keeps all.
    Returns verts (M, MAX_TRIS_TABLE, 3, 3) world-space triangle vertices
    and tri_valid (M, MAX_TRIS_TABLE).
    """
    D, H, W = grid.sdf.shape
    dev = grid.sdf.device
    (cz, cy, cx), vals, pos = _cube_corners(grid, cube_idx)

    inside = (vals < 0).long()
    case = (inside << torch.arange(8, device=dev)).sum(dim=-1)  # (M,)

    # Interpolate each of the 12 edges in GLOBAL corner order: the two
    # cubes sharing an edge see it with opposite local orientation, and
    # t vs 1-t round differently, so the canonical order makes shared
    # vertices bitwise identical.
    gid = (cz * H + cy) * W + cx  # (M, 8) global corner ids
    ea = torch.as_tensor(_CUBE_EDGES[:, 0], dtype=torch.int64, device=dev)
    eb = torch.as_tensor(_CUBE_EDGES[:, 1], dtype=torch.int64, device=dev)
    swap = gid[:, ea] > gid[:, eb]  # (M, 12)
    va = torch.where(swap, vals[:, eb], vals[:, ea])
    vb = torch.where(swap, vals[:, ea], vals[:, eb])
    pa = torch.where(swap[..., None], pos[:, eb], pos[:, ea])  # (M, 12, 3)
    pb = torch.where(swap[..., None], pos[:, ea], pos[:, eb])
    epts = _interpolate(va, vb, pa, pb)  # (M, 12, 3)

    table = torch.as_tensor(_MC_TRI_TABLE, dtype=torch.int64, device=dev)
    tri_edges = table[case]  # (M, Tmax, 3)
    tri_ok = tri_edges[..., 0] >= 0
    safe = torch.clamp(tri_edges, min=0)
    M = cube_idx.shape[0]
    verts = torch.gather(
        epts, 1, safe.reshape(M, -1)[..., None].expand(-1, -1, 3)
    ).reshape(M, MAX_TRIS_TABLE, 3, 3)
    if cube_valid is not None:
        tri_ok = tri_ok & cube_valid[:, None]
    return _orient(vals, verts), tri_ok


def marching_cubes(grid: TSDFGrid, weight_min: float = 1.0,
                   max_cubes: int | None = None, variant: str = "table"):
    """Extract the zero iso-surface as a (T, 3, 3) f32 tensor of
    world-space triangles on the grid's device. ``variant``: "table"
    (classic 256-case, about half the triangles) or "tetra" (marching
    tetrahedra). ``max_cubes`` keeps the first active cubes in index
    order."""
    fns = {"table": triangulate_cubes_table, "tetra": triangulate_cubes}
    if variant not in fns:
        raise ValueError(f"unknown variant {variant!r}")
    idx = torch.nonzero(active_cubes(grid, weight_min).reshape(-1))[:, 0]
    if max_cubes is not None:
        idx = idx[:max_cubes]
    if idx.numel() == 0:
        return torch.zeros((0, 3, 3), dtype=torch.float32,
                           device=grid.sdf.device)
    verts, tri_valid = fns[variant](grid, idx)
    return verts.reshape(-1, 3, 3)[tri_valid.reshape(-1)]
