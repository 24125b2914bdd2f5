"""Drive the PyTorch/CUDA port's fusion path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and the exit code is not 0):
  1. device   require a CUDA card; print nvidia-smi's name and power limit
  2. build    compile the CUDA kernels from reconplan_tpu_torch/csrc
  3. kernels  K2, K1 and K3 against their plain PyTorch versions on the
              card, at the bench shapes (512^3, one 8-frame chunk of the
              bench scene with the real ids / fbits / live count of the mask
              pipeline; K1 again with color on a 4-frame chunk; K3 with the
              host-compacted ids of the chunk padded to 512), with CUDA-event
              times
  4. check    the brick path against the dense engine on a small input
  5. bench    integrate_frames_bricked_device, 32 frames of 640x480 at 512^3
  6. banana   SplatCamera orbit of the YCB banana -> FusionPipeline(brick,
              512^3, color) -> extract_mesh -> chamfer_to_mesh (<= 1 mm)
  7. bricked  integrate_frames_bricked (host-compacted, K3) on the bench
              scene, held against phase 5's grid and the dense engine on
              the voxels both brick paths weight as the dense engine does
  8. sharded  sharded_integrate_frames_bricked, 4 shards on the card at
              512^3, gathered: bit-identical to a one-chunk bricked run
  9. banana   points_to_mesh_distance of the banana mesh's vertices to the
              GT triangles (mean <= 1 mm), and raycast_depth of the fused
              banana grid against the splat depth of an orbit view
Launch counters are zeroed just before phase 5 and read after phase 6 (K1
and K2), and zeroed before and read after each of phases 7 and 8 (K3): each
kernel must have been launched by its paths. The line before the last is a
JSON summary of the kernels; the last line is the run's JSON status.
"""

import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BANANA = os.path.join(REPO, "data/objects/011_banana/tsdf/nontextured.ply")


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def events_ms(fn, reps=10):
    """Mean ms per call from CUDA events, after one warm-up call."""
    from reconplan_tpu_torch.bench import time_ms

    return time_ms(fn, reps=reps, warmup=1)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from reconplan_tpu_torch.bench import (
        MAX_ACTIVE, N, ORIGIN, VOXEL, make_frames)
    from reconplan_tpu_torch.io.meshio import load_mesh
    from reconplan_tpu_torch.io.render import SplatCamera
    from reconplan_tpu_torch.io.frames import FrameSet
    from reconplan_tpu_torch.ops import tsdf as tsdf_ops
    from reconplan_tpu_torch.ops import tsdf_brick as tb
    from reconplan_tpu_torch.ops.kernels import (
        active_mask, active_mask_reference, brick_integrate,
        brick_integrate_fixed, brick_integrate_fixed_reference,
        brick_integrate_reference, build)
    from reconplan_tpu_torch.parallel import (
        gather_brick_grid, make_sharded_brick_grid,
        sharded_integrate_frames_bricked)
    from reconplan_tpu_torch.recon.fusion import FusionPipeline
    from reconplan_tpu_torch.recon.metrics import (
        chamfer_to_mesh, points_to_mesh_distance)
    from reconplan_tpu_torch.utils.device import card_summary

    dev = torch.device("cuda")
    card = card_summary()
    phase("device", f"{card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} card(s)")

    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.load_library()
    phase("build", f"{lib_path.name} in {time.perf_counter() - t0:.2f} s")

    # --- 3. kernels against their plain versions at the bench shapes -------
    depths, poses, K = make_frames(32)
    d_all = torch.as_tensor(depths, device=dev)
    p_all = torch.as_tensor(poses, device=dev)
    intr = tuple(float(np.float32(v)) for v in K)
    T_all = torch.linalg.inv(p_all)
    grid = tb.make_brick_grid((N,) * 3, ORIGIN, VOXEL, device=dev)
    bd = grid.brick_dims
    NB = bd[0] * bd[1] * bd[2]
    trunc = grid.trunc
    # prior state: frames 8-15 fused into the grid
    tb.integrate_frames_bricked_device(grid, d_all[8:16], p_all[8:16], *K)
    d8, T8 = d_all[:8], T_all[:8].contiguous()
    occ0, occ1, binp = tb._build_depth_occupancy(d8, 1000.0, 3.0, 8)
    k2_args = (bd, grid.origin, VOXEL, trunc, occ0, occ1, binp, T8, *intr)
    bits = active_mask(*k2_args, mip_cell=8)
    bits_ref = active_mask_reference(*k2_args, mip_cell=8)
    torch.cuda.synchronize()
    k2_err = (bits.long() - bits_ref.long()).abs().max().item()
    if not torch.equal(bits, bits_ref):
        raise AssertionError(
            f"K2 bits differ on {(bits != bits_ref).sum().item()} bricks")
    k2_ms = events_ms(lambda: active_mask(*k2_args, mip_cell=8))
    k2_plain_ms = events_ms(lambda: active_mask_reference(*k2_args,
                                                          mip_cell=8))
    phase("kernels", f"K2 active_mask: bits identical on {NB} bricks "
          f"({(bits != 0).sum().item()} active) | kernel {k2_ms:.4f} ms, "
          f"plain {k2_plain_ms:.4f} ms")

    def k1_compare(n_frames, colors, rgb):
        d, T = d_all[:n_frames], T_all[:n_frames].contiguous()
        ids, fbits, n, _ = tb.chunk_active_set(
            d, T, intr, grid.origin, bd, VOXEL, trunc, MAX_ACTIVE, NB)
        planes = (grid.sdf.clone(), grid.weight.clone(),
                  None if rgb is None else rgb.clone())
        ref = tuple(None if a is None else a.clone() for a in planes)
        rest = (ids, fbits, n, T, intr, d, colors, grid.origin, bd, VOXEL,
                trunc, 1000.0, 3.0, 64.0)
        brick_integrate(*planes, *rest)
        brick_integrate_reference(*ref, *rest)
        torch.cuda.synchronize()
        err = (planes[0] - ref[0]).abs().max().item()
        if err > 1e-6 or not torch.equal(planes[1], ref[1]):
            raise AssertionError(f"K1 sdf err {err} or weight differs")
        if rgb is not None and not torch.equal(planes[2], ref[2]):
            raise AssertionError("K1 packed rgb differs")
        scratch = tuple(None if a is None else a.clone() for a in planes)
        ms = events_ms(lambda: brick_integrate(*scratch, *rest))
        plain_ms = events_ms(lambda: brick_integrate_reference(*scratch,
                                                               *rest), reps=3)
        return err, ms, plain_ms, n.item()

    k1_err, k1_ms, k1_plain_ms, n_live = k1_compare(8, None, None)
    phase("kernels", f"K1 brick_integrate depth: sdf max err {k1_err:.3g}, "
          f"weight identical, {n_live} live bricks | kernel {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.4f} ms")
    gen = torch.Generator(device=dev).manual_seed(0)
    colors = torch.randint(0, 1 << 24, (4,) + d_all.shape[1:], generator=gen,
                           dtype=torch.int32, device=dev)
    rgb = torch.randint(0, 1 << 24, grid.sdf.shape, generator=gen,
                        dtype=torch.int32, device=dev)
    k1c_err, k1c_ms, k1c_plain_ms, n_live_c = k1_compare(4, colors, rgb)
    phase("kernels", f"K1 brick_integrate color (4 frames): sdf max err "
          f"{k1c_err:.3g}, weight and rgb identical, {n_live_c} live bricks "
          f"| kernel {k1c_ms:.4f} ms, plain {k1c_plain_ms:.4f} ms")
    # K3 on the same chunk: the host path's compacted ids, padded to 512
    mask = tb.active_brick_mask(bd, grid.origin, VOXEL, trunc, d8, T8, *intr)
    ids_np, n_k3 = tb.host_active_ids(mask, bd, NB)
    ids = torch.as_tensor(ids_np, device=dev)
    planes = (grid.sdf.clone(), grid.weight.clone())
    ref = tuple(a.clone() for a in planes)
    rest = (ids, 0, NB, T8, intr, d8, grid.origin, bd, VOXEL, trunc,
            1000.0, 3.0, 64.0)
    brick_integrate_fixed(*planes, *rest)
    brick_integrate_fixed_reference(*ref, *rest)
    torch.cuda.synchronize()
    k3_err = (planes[0] - ref[0]).abs().max().item()
    if k3_err > 1e-6 or not torch.equal(planes[1], ref[1]):
        raise AssertionError(f"K3 sdf err {k3_err} or weight differs")
    k3_ms = events_ms(lambda: brick_integrate_fixed(*planes, *rest))
    k3_plain_ms = events_ms(
        lambda: brick_integrate_fixed_reference(*ref, *rest), reps=3)
    phase("kernels", f"K3 brick_integrate_fixed (8 frames): sdf max err "
          f"{k3_err:.3g}, weight identical, {n_k3} bricks padded to "
          f"{len(ids_np)} | kernel {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms")
    del grid, planes, ref

    # --- 4. the whole brick path against the dense engine, small input -----
    sd, sp, sK = make_frames(8, H=120, W=160, fx=150.0, fy=150.0)
    small = ((64,) * 3, (-0.16,) * 3, 0.32 / 63)
    g = tb.make_brick_grid(*small, device=dev)
    g, _ = tb.integrate_frames_bricked_device(g, sd, sp, *sK)
    dense = tsdf_ops.integrate_frames(
        tsdf_ops.make_grid(*small, device=dev), sd, sp, *sK)
    sdf_b, w_b = tb.to_dense(g)
    same = (w_b > 0) & (w_b == dense.weight)
    small_err = (sdf_b - dense.sdf)[same].abs().max().item()
    if same.sum().item() < 1000 or small_err > 1e-6:
        raise AssertionError(f"brick vs dense: {same.sum().item()} voxels, "
                             f"max err {small_err}")
    phase("check", f"brick path vs dense engine at 64^3: max sdf err "
          f"{small_err:.3g} on {same.sum().item()} voxels")

    # --- 5. the main path: bench scene --------------------------------------
    active_mask.launches = 0
    brick_integrate.launches = 0
    grid = tb.make_brick_grid((N,) * 3, ORIGIN, VOXEL, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid, n_active = tb.integrate_frames_bricked_device(
        grid, d_all, p_all, *K, max_active=MAX_ACTIVE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    w = grid.weight
    if not torch.isfinite(grid.sdf).all() or w.max().item() <= 0:
        raise AssertionError("bench grid is empty or not finite")
    phase("bench", f"32 frames 640x480 -> {N}^3: n_active {int(n_active)}, "
          f"{32 / dt:.1f} frames/s cold-grid wall clock "
          f"(host clock, one batch) | {card}")
    device_grid = grid  # phase 7 holds the host-compacted path against it
    del w

    # --- 6. the main path: banana orbit, color, mesh, Chamfer ---------------
    times = {}
    t0 = time.perf_counter()
    cam = SplatCamera(device=dev).add_mesh_file(BANANA)
    fd, fc, fp = [], [], []
    for k in range(32):
        ang = 2 * np.pi * k / 32
        eye = [0.35 * np.cos(ang), 0.35 * np.sin(ang), 0.25]
        d, c, T = cam.take_picture(eye, [0.0, 0.0, 0.0])
        fd.append(d)
        fc.append(c)
        fp.append(T)
    frames = FrameSet(depth=torch.stack(fd), color=torch.stack(fc),
                      poses=np.stack(fp), intrinsics=cam.intrinsics)
    torch.cuda.synchronize()
    times["render_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = FusionPipeline(dims=(N,) * 3, origin=(-0.2, -0.2, -0.15),
                          voxel_size=0.4 / (N - 1), with_color=True,
                          engine="brick", device=dev)
    pipe.integrate(frames)
    torch.cuda.synchronize()
    times["fuse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tris, cols = pipe.extract_mesh(with_colors=True)
    torch.cuda.synchronize()
    times["extract_s"] = time.perf_counter() - t0
    launches = {"active_mask": active_mask.launches,
                "brick_integrate": brick_integrate.launches}
    if len(tris) == 0:
        raise AssertionError("banana mesh has no triangles")
    if not (torch.isfinite(tris).all() and torch.isfinite(cols).all()
            and cols.min() >= 0 and cols.max() <= 1):
        raise AssertionError("banana mesh or colors not finite / in range")
    t0 = time.perf_counter()
    gt_v, gt_f = load_mesh(BANANA)
    ch, ab, ba = chamfer_to_mesh(tris.reshape(-1, 3), gt_v, gt_f)
    times["chamfer_s"] = time.perf_counter() - t0
    phase("banana", f"{len(tris)} triangles, Chamfer {ch * 1e3:.4f} mm "
          f"(recon->gt {ab * 1e3:.4f}, gt->recon {ba * 1e3:.4f}) | "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    if ch > 1e-3:
        raise AssertionError(f"banana Chamfer {ch * 1e3:.4f} mm > 1.0 mm")
    # --- 7. the host-compacted path: bench scene through K3 ---------------
    brick_integrate_fixed.launches = 0
    grid = tb.make_brick_grid((N,) * 3, ORIGIN, VOXEL, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid, n_bricked = tb.integrate_frames_bricked(grid, d_all, p_all, *K)
    torch.cuda.synchronize()
    dt_cold = time.perf_counter() - t0
    k3_bricked = brick_integrate_fixed.launches
    # Each brick path folds a subset of the frames into a voxel, and not
    # the same subset, so equal weights alone do not mean equal frames. A
    # weight equal to the dense engine's, which folds every frame, does:
    # compare where all three weights agree. (At 512^3 the dense engine
    # works in z-chunks whose origins round apart from the bricks' voxel
    # coordinates, so its sdf is no bit-level reference here; phase 4
    # holds the sdf against it where it is one.)
    dense = tsdf_ops.integrate_frames(
        tsdf_ops.make_grid((N,) * 3, ORIGIN, VOXEL, device=dev), d_all,
        p_all, *K)
    sdf_b, w_b = tb.to_dense(grid)
    sdf_v, w_v = tb.to_dense(device_grid)
    same = (w_b == dense.weight) & (w_v == dense.weight) & (w_b > 0)
    bricked_err = (sdf_b - sdf_v)[same].abs().max().item()
    n_same = same.sum().item()
    if n_same < 100_000 or bricked_err > 1e-6:
        raise AssertionError(f"bricked vs device path: {n_same} voxels, "
                             f"max sdf err {bricked_err}")
    del dense, sdf_b, w_b, sdf_v, w_v, same
    t0 = time.perf_counter()
    tb.integrate_frames_bricked(grid, d_all, p_all, *K)
    torch.cuda.synchronize()
    dt_warm = time.perf_counter() - t0
    phase("bricked", f"integrate_frames_bricked 32 frames -> {N}^3: "
          f"n_active {n_bricked}, {k3_bricked} K3 launches, "
          f"{32 / dt_cold:.1f} frames/s cold grid, {32 / dt_warm:.1f} warm "
          f"(host clock, one batch each) | vs the device path on {n_same} "
          f"voxels both weight as the dense engine: max sdf err "
          f"{bricked_err:.3g} | {card}")
    del grid, device_grid

    # --- 8. the brick-sharded path: 4 shards on the one card --------------
    shards, per_shard = 4, 8192
    one = tb.make_brick_grid((N,) * 3, ORIGIN, VOXEL, device=dev)
    one, n_one = tb.integrate_frames_bricked(
        one, d_all, p_all, *K, frames_per_dispatch=32, dilate_active=False)
    mask = tb.active_brick_mask(bd, one.origin, VOXEL, trunc, d_all,
                                T_all.contiguous(), *intr)
    counts = mask.reshape(shards, -1).sum(dim=1).tolist()
    if max(counts) > per_shard:
        raise AssertionError(f"a shard would drop bricks: {counts} active, "
                             f"cap {per_shard}")
    brick_integrate_fixed.launches = 0
    g_nbl = make_sharded_brick_grid((N,) * 3, ORIGIN, VOXEL,
                                    devices=[dev] * shards)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_nbl, n_sharded = sharded_integrate_frames_bricked(
        g_nbl, d_all, p_all, *K, max_active_per_device=per_shard)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k3_sharded = brick_integrate_fixed.launches
    gathered = gather_brick_grid(g_nbl)
    if not (int(n_sharded) == n_one and torch.equal(gathered.sdf, one.sdf)
            and torch.equal(gathered.weight, one.weight)):
        raise AssertionError("sharded grid differs from the bricked run")
    phase("sharded", f"{shards} shards x {g_nbl[1]} bricks, active "
          f"{counts} (cap {per_shard}, none dropped), {k3_sharded} K3 "
          f"launches, {32 / dt:.1f} frames/s (host clock, one batch) | "
          f"gathered planes bit-identical to the one-chunk bricked run")
    del one, g_nbl, gathered, mask
    launches["brick_integrate_fixed"] = k3_bricked + k3_sharded

    # --- 9. the banana, continued: exact mesh distance and a raycast ------
    t0 = time.perf_counter()
    verts = torch.unique(tris.reshape(-1, 3), dim=0)
    gt_tris = torch.as_tensor(gt_v[gt_f], dtype=torch.float32, device=dev)
    p2m = points_to_mesh_distance(verts, gt_tris)
    p2m_mm = p2m.mean().item() * 1e3
    times_p2m = time.perf_counter() - t0
    if not (torch.isfinite(p2m).all() and p2m_mm <= 1.0):
        raise AssertionError(f"banana points_to_mesh_distance {p2m_mm} mm")
    sdf_d, w_d = tb.to_dense(pipe.grid)
    f32 = dict(dtype=torch.float32, device=dev)
    dense = tsdf_ops.TSDFGrid(
        sdf_d, w_d, torch.zeros((0, 0, 0, 3), **f32), pipe.grid.origin,
        torch.tensor(pipe.grid.voxel_size, **f32),
        torch.tensor(pipe.grid.trunc, **f32))
    # steps of one voxel over the banana's depth range
    ray = tsdf_ops.raycast_depth(dense, fp[0], *cam.intrinsics, cam.height,
                                 cam.width, near=0.25, far=0.65,
                                 n_steps=512)
    splat = fd[0] / 1000.0
    both = (ray > 0) & (splat > 0)
    hit_share = (ray > 0).float().mean().item()
    ray_med = (ray - splat)[both].abs().median().item()
    if not (torch.isfinite(ray).all() and both.sum().item() > 1000
            and ray_med < 0.01):
        raise AssertionError(f"raycast: {both.sum().item()} common hits, "
                             f"median |d| {ray_med}")
    phase("banana", f"points_to_mesh_distance of {len(verts)} mesh vertices "
          f"to {len(gt_tris)} GT triangles: mean {p2m_mm:.4f} mm, max "
          f"{p2m.max().item() * 1e3:.4f} mm ({times_p2m:.3f} s) | "
          f"raycast_depth {cam.width}x{cam.height}: hit share "
          f"{hit_share:.4f}, median |ray - splat| {ray_med * 1e3:.4f} mm on "
          f"{both.sum().item()} pixels")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"main path never launched {name}")
    phase("launches", json.dumps(launches))

    print(json.dumps({"kernels": [
        {"name": "active_mask", "route": "cuda",
         "source": "reconplan_tpu_torch/csrc/active_mask.cu",
         "replaces": "reconplan_tpu/ops/tsdf_brick.py:278",
         "launches": launches["active_mask"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "brick_integrate", "route": "cuda",
         "source": "reconplan_tpu_torch/csrc/brick_integrate.cu",
         "replaces": "reconplan_tpu/ops/tsdf_brick.py:682",
         "launches": launches["brick_integrate"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "brick_integrate_fixed", "route": "cuda",
         "source": "reconplan_tpu_torch/csrc/brick_integrate_fixed.cu",
         "replaces": "reconplan_tpu/ops/tsdf_brick.py:503",
         "launches": launches["brick_integrate_fixed"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
