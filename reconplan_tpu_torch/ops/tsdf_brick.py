"""Brick-sparse TSDF fusion — the host side of the fast path.

Port of ``reconplan_tpu.ops.tsdf_brick``: the ``BrickGrid`` layout, the
active-brick mask pipeline (depth-occupancy mip -> K2 per-frame bits ->
exact centre-sample refine -> stable-argsort compaction) and the chunk
loop of ``integrate_frames_bricked_device``, which hands the compacted
bricks to K1; and the host-compacted path ``integrate_frames_bricked``
(centre-sample mask -> numpy compaction -> K3). The kernels live in
``ops/kernels``: CUDA C++ for CUDA tensors, their plain PyTorch versions
for CPU tensors.

Memory layout: the volume lives as bricked arrays ``(NB + 1, 8, 128)``
(one row per 8x8x16-voxel brick: sublane = local z, lane = local y*16 +
x; the final row is a scratch brick that absorbs padding). Dense
(D, H, W) views are produced on demand for marching cubes.

Nothing in the device path's chunk loop reads a device value on the host:
the live count of each chunk stays on the device and K1 reads it there.
The host-compacted path reads each chunk's mask on the host by design.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reconplan_tpu_torch.ops.kernels.active_mask import (
    BRICK_X,
    BRICK_Y,
    BRICK_Z,
    active_mask,
    to_int32_bits,
)
from reconplan_tpu_torch.ops.kernels.brick_integrate import brick_integrate
from reconplan_tpu_torch.ops.kernels.brick_integrate_fixed import (
    brick_integrate_fixed,
)
from reconplan_tpu_torch.utils.device import resolve_device, scalar_tensor
from reconplan_tpu_torch.utils.profiling import (
    count,
    span,
    spanned,
    to_host,
)

class BrickGrid(NamedTuple):
    """Bricked TSDF volume. Logical voxel (z, y, x) lives at brick
    (z//8, y//8, x//16), sublane z%8, lane (y%8)*16 + x%16."""

    sdf: torch.Tensor  # (NB + 1, 8, 128) f32
    weight: torch.Tensor  # (NB + 1, 8, 128) f32
    dims: tuple  # (D, H, W) logical voxels
    origin: torch.Tensor  # (3,) f32 on the grid's device
    voxel_size: float
    trunc: float
    rgb: torch.Tensor | None = None  # (NB + 1, 8, 128) i32 packed B<<16|G<<8|R

    @property
    def brick_dims(self):
        D, H, W = self.dims
        return (D // BRICK_Z, H // BRICK_Y, W // BRICK_X)


def make_brick_grid(dims, origin, voxel_size, trunc=None,
                    with_color=False, device=None) -> BrickGrid:
    """An empty brick grid on ``device`` (default: the card; ``"cpu"`` asks
    for the CPU)."""
    device = resolve_device(device)
    D, H, W = dims
    if D % BRICK_Z or H % BRICK_Y or W % BRICK_X:
        raise ValueError(f"dims {dims} must be multiples of (8, 8, 16)")
    nb = (D // BRICK_Z) * (H // BRICK_Y) * (W // BRICK_X)
    if trunc is None:
        trunc = 5.0 * voxel_size
    shape = (nb + 1, BRICK_Z, BRICK_Y * BRICK_X)
    return BrickGrid(
        sdf=torch.ones(shape, dtype=torch.float32, device=device),
        weight=torch.zeros(shape, dtype=torch.float32, device=device),
        dims=tuple(dims),
        origin=torch.as_tensor(np.array(origin, np.float32), device=device),
        voxel_size=float(voxel_size),
        trunc=float(trunc),
        rgb=(torch.zeros(shape, dtype=torch.int32, device=device)
             if with_color else None),
    )


def brick_grid_from_numpy(sdf, weight, rgb, dims, origin, voxel_size, trunc,
                          device=None) -> BrickGrid:
    """A grid from bricked numpy planes (e.g. a JAX ``BrickGrid`` taken
    with ``np.asarray`` field by field), so both packages can start from
    the same volume, on ``device`` (default: the card)."""
    device = resolve_device(device)
    as_t = lambda a, dt: torch.as_tensor(np.array(a), dtype=dt, device=device)  # noqa: E731
    return BrickGrid(
        sdf=as_t(sdf, torch.float32),
        weight=as_t(weight, torch.float32),
        dims=tuple(int(d) for d in dims),
        origin=torch.as_tensor(np.array(origin, np.float32), device=device),
        voxel_size=float(voxel_size),
        trunc=float(trunc),
        rgb=None if rgb is None else as_t(rgb, torch.int32),
    )


def brick_grid_to_numpy(grid: BrickGrid) -> dict:
    """The grid's fields as numpy, keyed as :func:`brick_grid_from_numpy`
    takes them."""
    return {
        "sdf": grid.sdf.cpu().numpy(),
        "weight": grid.weight.cpu().numpy(),
        "rgb": None if grid.rgb is None else grid.rgb.cpu().numpy(),
        "dims": tuple(grid.dims),
        "origin": grid.origin.cpu().numpy(),
        "voxel_size": grid.voxel_size,
        "trunc": grid.trunc,
    }


def _debrick(a, dims):
    D, H, W = dims
    bd, bh, bw = D // BRICK_Z, H // BRICK_Y, W // BRICK_X
    a = a[:-1].reshape(bd, bh, bw, BRICK_Z, BRICK_Y, BRICK_X)
    return a.permute(0, 3, 1, 4, 2, 5).reshape(D, H, W)


def to_dense(grid: BrickGrid):
    """Bricked -> dense (D, H, W) sdf/weight (for extraction)."""
    return _debrick(grid.sdf, grid.dims), _debrick(grid.weight, grid.dims)


def to_dense_color(grid: BrickGrid):
    """Bricked packed RGB -> dense (D, H, W, 3) f32 in [0, 1]."""
    if grid.rgb is None:
        raise ValueError("grid has no color channel (with_color=False)")
    p = _debrick(grid.rgb, grid.dims)
    return torch.stack([p & 255, (p >> 8) & 255, (p >> 16) & 255],
                       dim=-1).float() / 255.0


def from_dense(sdf, weight, origin, voxel_size, trunc) -> BrickGrid:
    D, H, W = sdf.shape
    bd, bh, bw = D // BRICK_Z, H // BRICK_Y, W // BRICK_X

    def brick(a, pad_value):
        a = a.reshape(bd, BRICK_Z, bh, BRICK_Y, bw, BRICK_X)
        a = a.permute(0, 2, 4, 1, 3, 5).reshape(-1, BRICK_Z, BRICK_Y * BRICK_X)
        pad = torch.full((1, BRICK_Z, BRICK_Y * BRICK_X), pad_value,
                         dtype=a.dtype, device=a.device)
        return torch.cat([a, pad], dim=0)

    return BrickGrid(
        brick(sdf, 1.0), brick(weight, 0.0), (D, H, W),
        torch.as_tensor(np.array(origin, np.float32), device=sdf.device),
        float(voxel_size), float(trunc),
    )


# ---------------------------------------------------------------------------
# active brick selection
# ---------------------------------------------------------------------------


def _brick_centers(brick_ids, brick_dims, origin, voxel):
    """World centres (x, y, z) f32 of the given bricks."""
    _, bh, bw = brick_dims
    bz = brick_ids // (bh * bw)
    by = (brick_ids // bw) % bh
    bx = brick_ids % bw
    return (
        origin[0] + (bx.float() * BRICK_X + BRICK_X / 2) * voxel,
        origin[1] + (by.float() * BRICK_Y + BRICK_Y / 2) * voxel,
        origin[2] + (bz.float() * BRICK_Z + BRICK_Z / 2) * voxel,
    )


def _project(T, px, py, pz):
    """Camera coordinates of world points under a (4, 4) w2c pose."""
    x = T[0, 0] * px + T[0, 1] * py + T[0, 2] * pz + T[0, 3]
    y = T[1, 0] * px + T[1, 1] * py + T[1, 2] * pz + T[1, 3]
    z = T[2, 0] * px + T[2, 1] * py + T[2, 2] * pz + T[2, 3]
    return x, y, z


def _dilate(m):
    """One-brick OR dilation along each axis of a (bd, bh, bw) array, with
    the JAX path's wrap-around rolls."""
    for ax in range(3):
        m = m | torch.roll(m, 1, ax) | torch.roll(m, -1, ax)
    return m


def active_brick_mask(brick_dims, origin, voxel_size, trunc, depths, T_w2c,
                      fx, fy, cx, cy, depth_scale=1000.0, depth_max=3.0):
    """(NB,) bool: bricks whose center lies within trunc + brick radius of
    the observed surface in any frame (single depth sample at the center —
    conservative via the expanded band). The branch for frames that no mip
    cell divides."""
    bd, bh, bw = brick_dims
    dev = depths.device
    ids = torch.arange(bd * bh * bw, dtype=torch.int32, device=dev)
    f32 = np.float32
    voxel = f32(voxel_size)
    cx_w, cy_w, cz_w = _brick_centers(ids, brick_dims, origin, float(voxel))
    # f32 arithmetic, as the JAX function traces voxel_size and trunc
    radius = f32(f32(0.5) * voxel) * f32(
        np.sqrt(BRICK_X**2 + BRICK_Y**2 + BRICK_Z**2))
    band = float(f32(trunc) + radius)
    Hd, Wd = depths.shape[1:]
    scale = scalar_tensor(depth_scale, depths.device)
    active = torch.zeros(ids.shape, dtype=torch.bool, device=dev)
    for f in range(depths.shape[0]):
        x, y, z = _project(T_w2c[f], cx_w, cy_w, cz_w)
        zs = torch.clamp(z, min=1e-6)
        uf = x / zs * fx + cx
        vf = y / zs * fy + cy
        ui = torch.round(uf).to(torch.int32).clamp(0, Wd - 1)
        vi = torch.round(vf).to(torch.int32).clamp(0, Hd - 1)
        inside = (z > 1e-4) & (uf >= 0) & (uf < Wd) & (vf >= 0) & (vf < Hd)
        d = depths[f].reshape(-1)[(vi * Wd + ui).long()] / scale
        ok = inside & (d > 0) & (d < depth_max)
        active |= ok & ((d - z).abs() < band)
    return active


def _build_depth_occupancy(depths, depth_scale=1000.0, depth_max=3.0,
                           mip_cell=8, mip_rounds=4):
    """Per-cell depth-occupancy bitmask over 64 adaptive bins spanning the
    chunk's valid-depth range, as two i32 planes (bins 0-31, 32-63) plus
    the (b0, bin_size) parameters, OR-dilated ``mip_rounds`` times with
    wrap-around rolls (see the JAX function for the design)."""
    F, Hd, Wd = depths.shape
    Hm, Wm = Hd // mip_cell, Wd // mip_cell
    d = depths.float() / scalar_tensor(depth_scale, depths.device)
    valid = (d > 0.0) & (d < depth_max)
    inf = float("inf")
    gmin = torch.where(valid, d, inf).amin()
    gmax = torch.where(valid, d, -inf).amax()
    gmin = torch.where(torch.isfinite(gmin), gmin, 0.0)
    gmax = torch.where(torch.isfinite(gmax), gmax, 0.0)
    bs = torch.clamp((gmax - gmin) / scalar_tensor(62.0, d.device), min=0.002)
    b0 = gmin - bs  # bin 1 starts at gmin; 0 and 63 stay as margin
    bins = torch.clamp(((d - b0) / bs).to(torch.int32), 0, 63)

    def cells(a):  # (F, Hd, Wd) -> (F*Hm*Wm, mip_cell**2), one row per cell
        a = a.reshape(F, Hm, mip_cell, Wm, mip_cell).permute(0, 1, 3, 2, 4)
        return a.reshape(F * Hm * Wm, mip_cell * mip_cell)

    # bitwise OR over a cell = presence of each bin among its valid pixels
    present = torch.zeros((F * Hm * Wm, 64), dtype=torch.int32,
                          device=d.device)
    present.scatter_reduce_(1, cells(bins).long(), cells(valid).int(), "amax")
    weights = torch.ones(32, dtype=torch.int64, device=d.device) << torch.arange(
        32, device=d.device)
    planes = []
    for half in (present[:, :32], present[:, 32:]):
        bits = to_int32_bits((half.long() * weights).sum(dim=1))
        planes.append(bits.reshape(F, Hm, Wm))
    occ0, occ1 = planes
    for _ in range(mip_rounds):  # separable 3x3 OR dilation
        for ax in (1, 2):
            occ0 = occ0 | torch.roll(occ0, 1, ax) | torch.roll(occ0, -1, ax)
            occ1 = occ1 | torch.roll(occ1, 1, ax) | torch.roll(occ1, -1, ax)
    return occ0, occ1, torch.stack([b0, bs])


def _exact_frame_bits_dilated(occ_bits, depths, T_w2c, origin, voxel_size,
                              trunc, intr, brick_dims, cap, depth_scale,
                              depth_max):
    """Per-frame exact centre-sample bits on the occupancy candidates,
    dilated one brick in each axis direction (wrap-around). Candidates past
    ``cap`` keep their occupancy bits (see the JAX function)."""
    bd, bh, bw = brick_dims
    NB = bd * bh * bw
    dev = occ_bits.device
    cap = min(cap, NB)
    F, Hd, Wd = depths.shape
    fx, fy, cx, cy = intr
    occupied = occ_bits != 0
    # stable-argsort compaction: actives first in index order, padding ->
    # the NB sentinel
    n_cand = occupied.sum()
    cand = torch.argsort(torch.where(occupied, 0, 1).to(torch.int32),
                         stable=True)[:cap]
    cand = torch.where(torch.arange(cap, device=dev) < n_cand, cand, NB)
    ccx, ccy, ccz = _brick_centers(
        torch.clamp(cand, max=NB - 1), brick_dims, origin,
        float(np.float32(voxel_size)))
    # Python-double band, as the JAX function computes it from static floats
    r_b = 0.5 * voxel_size * np.sqrt(BRICK_X**2 + BRICK_Y**2 + BRICK_Z**2)
    band = trunc + r_b
    scale = scalar_tensor(depth_scale, depths.device)
    ebits = torch.zeros(cand.shape, dtype=torch.int32, device=dev)
    for f in range(F):
        x, y, z = _project(T_w2c[f], ccx, ccy, ccz)
        zs = torch.clamp(z, min=1e-6)
        uf = x / zs * fx + cx
        vf = y / zs * fy + cy
        ui = torch.round(uf).to(torch.int32).clamp(0, Wd - 1)
        vi = torch.round(vf).to(torch.int32).clamp(0, Hd - 1)
        inside = (z > 1e-4) & (uf >= 0) & (uf < Wd) & (vf >= 0) & (vf < Hd)
        d = depths[f].reshape(-1)[(vi * Wd + ui).long()] / scale
        hit = inside & (d > 0) & (d < depth_max) & ((d - z).abs() < band)
        ebits = ebits | torch.where(hit, 1 << f, 0).to(torch.int32)
    # rank = position among actives in index order, matching the stable
    # argsort compaction above, so rank < cap <=> examined
    rank = torch.cumsum(occupied, 0) - 1
    base = torch.where(occupied & (rank >= cap), occ_bits, 0)
    dense = torch.cat([base, torch.zeros(1, dtype=torch.int32, device=dev)])
    dense = dense.scatter_reduce(0, cand, ebits, "amax")
    return _dilate(dense[:NB].reshape(bd, bh, bw)).reshape(-1)


# ---------------------------------------------------------------------------
# the chunk loop
# ---------------------------------------------------------------------------


def _occupancy_cell(Hd, Wd):
    """The finest mip cell (tightness vs dilation reach) that divides the
    frames with at most 128 cells across; None when none does."""
    return next(
        (c for c in (8, 16, 32)
         if Hd % c == 0 and Wd % c == 0 and Wd // c <= 128),
        None,
    )


def compact_ids(mask, size, fill):
    """The indices of ``mask``'s set entries in order, cut or padded to
    ``size`` with ``fill`` (``jnp.nonzero(mask, size=, fill_value=)``), as
    (size,) i32 on the device: a stable argsort, with no host read."""
    ids = torch.argsort(torch.where(mask, 0, 1).to(torch.int32),
                        stable=True)[:size].to(torch.int32)
    if ids.shape[0] < size:
        ids = torch.cat([ids, ids.new_full((size - ids.shape[0],), fill)])
    slot = torch.arange(size, device=mask.device)
    return torch.where(slot < mask.sum(), ids, fill).to(torch.int32)


@spanned("tsdf.active_set")
def chunk_active_set(d_chunk, T_chunk, intr, origin, brick_dims, voxel_size,
                     trunc, max_active, nb_scratch, depth_scale=1000.0,
                     depth_max=3.0, dilate_active=False):
    """The bricks one chunk of frames updates, on the device.

    Occupancy mip -> K2 per-frame bits -> exact refine (or the centre
    mask when no mip cell divides the frames) -> stable-argsort
    compaction. With ``dilate_active`` (always when no mip cell divides
    the frames) the active mask is dilated one brick along each axis, with
    wrap-around, and the dilated-in bricks integrate every frame. Returns (ids (M,) i32 with padding at ``nb_scratch``,
    fbits (M,) i32, n_chunk (1,) i32 live count, n_mask () i32 unclamped
    count), M = min(max_active, NB). Nothing is read on the host.
    """
    bd, bh, bw = brick_dims
    F_chunk, Hd, Wd = d_chunk.shape
    all_frames = (1 << F_chunk) - 1
    occ_cell = _occupancy_cell(Hd, Wd)
    if occ_cell is not None:
        with span("tsdf.occupancy"):
            occ0, occ1, binp = _build_depth_occupancy(
                d_chunk, depth_scale, depth_max, occ_cell)
        with span("tsdf.k2"):
            # K2: conservative per-frame occupancy superset
            bits = active_mask(
                brick_dims, origin, voxel_size, trunc, occ0, occ1, binp,
                T_chunk, *intr, mip_cell=occ_cell)
        with span("tsdf.refine"):
            bits = refine_frame_bits(
                bits, d_chunk, T_chunk, intr, origin, brick_dims, voxel_size,
                trunc, max_active, depth_scale, depth_max)
        if dilate_active:
            # dilated-in bricks integrate all frames (conservative)
            mask = _dilate((bits != 0).reshape(bd, bh, bw)).reshape(-1)
            bits = torch.where(mask, bits | all_frames, 0).to(torch.int32)
    else:
        # the centre sample can clip the band at silhouettes: dilate it
        # one brick, and integrate every frame (no per-frame skip)
        mask = _dilate(active_brick_mask(
            brick_dims, origin, voxel_size, trunc, d_chunk, T_chunk,
            *intr, depth_scale, depth_max).reshape(bd, bh, bw)).reshape(-1)
        bits = torch.where(mask, all_frames, 0).to(torch.int32)
    with span("tsdf.compact"):
        return compact_active(bits, max_active, nb_scratch)


def refine_frame_bits(bits, d_chunk, T_chunk, intr, origin, brick_dims,
                      voxel_size, trunc, max_active, depth_scale=1000.0,
                      depth_max=3.0):
    """The refine stage of :func:`chunk_active_set`: the exact per-frame
    centre test on K2's candidate ``bits`` (at most min(max_active, 4096)
    of them) + one brick of dilation, intersected with ``bits``."""
    return bits & _exact_frame_bits_dilated(
        bits, d_chunk, T_chunk, origin, voxel_size, trunc, intr,
        brick_dims, min(max_active, 4096), depth_scale, depth_max)


def compact_active(bits, max_active, nb_scratch):
    """The last stage of :func:`chunk_active_set`: the per-brick frame
    ``bits`` (NB,) i32 -> (ids, fbits, n_chunk, n_mask), as returned
    there."""
    NB = bits.shape[0]
    max_active = min(max_active, NB)
    mask = bits != 0
    # the unclamped count keeps a cap overshoot visible in n_active;
    # n_chunk (clamped) is K1's live count and never leaves the device
    n_mask = mask.sum().to(torch.int32)
    n_chunk = torch.clamp(n_mask, max=max_active).reshape(1)
    ids = compact_ids(mask, max_active, nb_scratch)
    fbits = torch.cat([bits, bits.new_zeros(1)])[
        torch.clamp(ids, max=NB).long()]
    return ids, fbits, n_chunk, n_mask


def _integrate_device_all(
    sdf_b, weight_b, rgb_b, poses, intr, depths, colors, origin,
    brick_dims, max_active, voxel_size, trunc,
    depth_scale, depth_max, max_weight, frames_per_dispatch,
    dilate_active=False,
):
    """Per chunk of <= frames_per_dispatch frames: the active set
    (:func:`chunk_active_set`) -> K1, all on the device with no host sync.
    The planes are updated in place. Returns the unclamped active count."""
    T_w2c_all = torch.linalg.inv(poses)
    n_active = torch.zeros((), dtype=torch.int32, device=depths.device)
    for f0 in range(0, depths.shape[0], frames_per_dispatch):
        count("tsdf.chunks")
        with span("tsdf.chunk"):
            chunk = slice(f0, f0 + frames_per_dispatch)
            d_chunk = depths[chunk]
            T_chunk = T_w2c_all[chunk].contiguous()
            ids, fbits, n_chunk, n_mask = chunk_active_set(
                d_chunk, T_chunk, intr, origin, brick_dims, voxel_size,
                trunc, max_active, sdf_b.shape[0] - 1, depth_scale,
                depth_max, dilate_active)
            n_active = n_active + n_mask
            with span("tsdf.k1"):
                brick_integrate(
                    sdf_b, weight_b, rgb_b, ids, fbits, n_chunk, T_chunk,
                    intr, d_chunk, None if colors is None else colors[chunk],
                    origin, brick_dims, voxel_size, trunc, depth_scale,
                    depth_max, max_weight,
                )
    return n_active


@spanned("tsdf.integrate")
def integrate_frames_bricked_device(
    grid: BrickGrid,
    depths,
    poses_cam_to_world,
    fx, fy, cx, cy,
    colors=None,  # (F, H, W, 3) uint8/float, only if grid has a color plane
    depth_scale=1000.0,
    depth_max=3.0,
    max_weight=64.0,
    max_active=8192,
    frames_per_dispatch=8,
    dilate_active=False,
):
    """Zero-host-sync brick integration (the production/bench path).

    ``dilate_active`` defaults False: K2's occupancy mask is already a
    conservative superset of every brick K1 can update in-band (dilation
    is forced on for frame sizes where no mip can be built). When set, the
    mask grows one brick along each axis and the dilated-in bricks
    integrate every frame of the chunk.

    The grid's planes are updated IN PLACE (the JAX path donates them); the
    returned grid holds the same tensors. ``colors`` enables the packed-RGB
    channel (the grid must be built with ``with_color=True``); colors are
    u8 per channel, averaged with the same weights as the TSDF. With
    colors, chunks hold at most 4 frames, as in the JAX path.

    ``max_active`` caps the bricks updated per chunk; overflow drops the
    highest-index bricks. The returned ``n_active`` (a 0-d i32 device
    tensor) accumulates the unclamped per-chunk count, so a count above
    ``n_chunks * max_active`` flags a drop.
    Returns (grid, n_active).
    """
    dev = grid.sdf.device
    depths = torch.as_tensor(depths, dtype=torch.float32, device=dev)
    poses = torch.as_tensor(poses_cam_to_world, dtype=torch.float32,
                            device=dev)
    intr = tuple(float(np.float32(v)) for v in (fx, fy, cx, cy))
    packed = None
    if colors is not None:
        # kept for parity with the JAX path's VMEM-bound chunking
        frames_per_dispatch = min(frames_per_dispatch, 4)
        if grid.rgb is None:
            raise ValueError(
                "colors given but grid has no color plane — build with "
                "make_brick_grid(..., with_color=True)"
            )
        c = torch.as_tensor(colors, device=dev)
        if c.dtype != torch.uint8:
            c = c.float()
            c = torch.clamp(torch.where(c.max() > 1.5, c, c * 255.0),
                            0, 255).to(torch.uint8)
        c = c.to(torch.int32)
        packed = (c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)).contiguous()
    n_active = _integrate_device_all(
        grid.sdf, grid.weight, grid.rgb if packed is not None else None,
        poses, intr, depths.contiguous(), packed, grid.origin,
        grid.brick_dims, max_active, grid.voxel_size, grid.trunc,
        depth_scale, depth_max, max_weight, frames_per_dispatch,
        dilate_active,
    )
    return grid, n_active


def _dilate_no_wrap(m):
    """One-brick OR dilation along each axis of a (bd, bh, bw) numpy bool
    array, without wrap-around (the host path's slices)."""
    dm = m.copy()
    dm[1:] |= m[:-1]
    dm[:-1] |= m[1:]
    dm[:, 1:] |= m[:, :-1]
    dm[:, :-1] |= m[:, 1:]
    dm[:, :, 1:] |= m[:, :, :-1]
    dm[:, :, :-1] |= m[:, :, 1:]
    return dm


def host_active_ids(mask, brick_dims, nb_scratch, dilate_active=True,
                    pad_multiple=512):
    """The host compaction of :func:`integrate_frames_bricked`: the (NB,)
    bool mask read on the host, optionally dilated one brick along each
    axis (no wrap-around), ``np.flatnonzero``, padded to a multiple of
    ``pad_multiple`` with ``nb_scratch``. Returns (ids i32 numpy, n)."""
    m = to_host(mask).numpy().reshape(brick_dims)
    if dilate_active:
        m = _dilate_no_wrap(m)
    ids = np.flatnonzero(m.reshape(-1)).astype(np.int32)
    n = len(ids)
    pad = (-n) % pad_multiple
    return np.concatenate([ids, np.full(pad, nb_scratch, np.int32)]), n


def integrate_frames_bricked(
    grid: BrickGrid,
    depths,  # (F, H, W) raw depth
    poses_cam_to_world,  # (F, 4, 4)
    fx, fy, cx, cy,
    depth_scale=1000.0,
    depth_max=3.0,
    max_weight=64.0,
    pad_multiple=512,
    frames_per_dispatch=8,
    dilate_active=True,
):
    """Integrate F frames into the brick grid (host-orchestrated).

    Per chunk of <= ``frames_per_dispatch`` frames:
      1. the centre-sample active-brick mask (:func:`active_brick_mask`),
         optionally dilated one brick along each axis (no wrap-around):
         the centre sample is conservative but can clip the band at
         silhouettes;
      2. host compaction of the active ids (:func:`host_active_ids`),
         padded to a multiple of ``pad_multiple`` with the scratch row;
      3. one K3 launch over the padded ids, every frame of the chunk.

    The grid's planes are updated IN PLACE (the JAX path donates them).
    The JAX function refuses frames smaller than its kernel's VMEM window;
    K3 has no window, so any frame size is taken.
    Returns (grid, n_active_total) with the count a Python int.
    """
    dev = grid.sdf.device
    depths = torch.as_tensor(depths, dtype=torch.float32,
                             device=dev).contiguous()
    poses = torch.as_tensor(poses_cam_to_world, dtype=torch.float32,
                            device=dev)
    T_w2c_all = torch.linalg.inv(poses)
    intr = tuple(float(np.float32(v)) for v in (fx, fy, cx, cy))
    bd, bh, bw = grid.brick_dims
    n_active_total = 0
    for f0 in range(0, depths.shape[0], frames_per_dispatch):
        chunk = slice(f0, f0 + frames_per_dispatch)
        d_chunk = depths[chunk]
        T_chunk = T_w2c_all[chunk].contiguous()
        mask = active_brick_mask(
            grid.brick_dims, grid.origin, grid.voxel_size, grid.trunc,
            d_chunk, T_chunk, *intr, depth_scale, depth_max)
        ids, n_active = host_active_ids(
            mask, grid.brick_dims, grid.sdf.shape[0] - 1, dilate_active,
            pad_multiple)
        n_active_total += n_active
        if n_active == 0:
            continue
        brick_integrate_fixed(
            grid.sdf, grid.weight, torch.as_tensor(ids, device=dev), 0,
            bd * bh * bw, T_chunk, intr, d_chunk, grid.origin,
            grid.brick_dims, grid.voxel_size, grid.trunc, depth_scale,
            depth_max, max_weight)
    return grid, n_active_total
