"""Drive the PyTorch/CUDA port once on one CUDA card: the fusion paths
and the planning and capture half of the scan loop.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and the exit code is not 0):
  1. device   require a CUDA card; print nvidia-smi's name and power limit
  2. build    compile the CUDA kernels from reconplan_tpu_torch/csrc; print
              ptxas's registers, shared memory and spills of the K1, K2, K3
              and K6 kernels, their SASS instruction counts (K6: the loads
              and adds of its step loop) and the occupancy query's blocks
              per SM of K1 (depth and color), K3 and K6
  3. kernels  K2, K1 and K3 against their plain PyTorch versions on the
              card, at the bench shapes (512^3, one 8-frame chunk of the
              bench scene with the real ids / fbits / live count of the mask
              pipeline; K1 again with color on a 4-frame chunk; K3 with the
              host-compacted ids of the chunk padded to 512, and again
              padded to 4096 and to 8192 as the sharded path pads, the
              padding's share of the time). Each gets its device time per
              launch, K1 beside its first design (the ablation arm
              `pr1_full`) and its own code as the ablation library builds
              it (the arm `full`), in turns: pr1_full, K1, full, full, K1,
              pr1_full
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
 10. ablate   the nine ablation arms of K1 (K4/K5) against their plain
              versions at phase 3's bench chunk; `full`, `smem_window`,
              `no_skips`, `static_stride` and `pr1_full` also against K1
              bit for bit; with device times
 11. profile  reconplan_tpu_torch.benchmarks.profile_brick end to end: the
              bench scene's stage split and the ablation arms; its JSON
              line is printed on a line of its own
 12. probe    reconplan_tpu_torch.benchmarks.probe_sublane_ops: the four
              microprobe arms (K6) at s0 in {0, 5}, bit-identical to their
              plain versions, with times; each arm's device time at 2,048
              and 4,096 steps beside the library call's, at other grids
              (blocks an SM), and the time of one step
 13. scan     the planning and capture half of the scan loop on the card:
              load_problem("ur10", "rot_free") -> make_robot; FK of the 500
              golden configurations against data/golden/wtraj.txt (position
              < 5e-5 m, |quat . conj| > 1 - 1e-5); scan_arc of 64 waypoints
              -> one seeded IK batch of 1,024 problems (16 restarts a
              waypoint, max_iters=100); camera-link positions by FK of the
              solved configurations; 12 pictures of the banana at 640x480
              -> FusionPipeline(brick, 256^3, color) -> marching cubes ->
              mean distance of the mesh's vertices to the ground-truth
              triangles (finite and under two voxels). Prints the solved
              waypoints of 64, the IK batch's ms (CUDA events; a profiler
              run of a second batch gives its kernels' count and
              device-busy ms), the FK's ms and the stage times
Launch counters are zeroed just before phase 5 and read after phase 5 (one
bench batch) and after phase 6 (K1 and K2), zeroed before and read after
each of phases 7 and 8 (K3), 11 (every ablation arm), 12 (every probe
arm) and 13 (K1 and K2 again): each kernel must have been launched by its
paths.

The line before the last is a JSON summary of the kernels. For each:
  ms, device_ms   the kernel's device time per launch: 20 launches
                  captured in one CUDA graph, CUDA events around a replay,
                  over 20, the median of 5 replays. events_ms is the mean
                  of 10 launches timed with CUDA events as the host issues
                  them: for a short kernel (K2) it is the host's issue
                  rate, not the kernel.
  plain_ms        the plain PyTorch version, CUDA events.
  bound_ms        the least time the card could take for the call's work,
  bound_by        the larger of its bytes (each input read once, each
                  output written once: the live bricks' rows, the distinct
                  depth / color pixels they sample, the mip planes) over
                  3.35 TB/s, and its f32 operations (counted per
                  voxel-frame or per test from the code, times the set
                  brick-frames of this run's data) over 67 TFLOP/s.
  bound_share     bound_ms / device_ms.
  l2              "warm": the graph replays the same call, so rows and
                  inputs that fit the 50 MB L2 stay there, and a kernel
                  that only moves bytes can read above bound_share 1.
  launches        launches by the paths of this run; launches_per_batch
                  those of one 32-frame batch of the path that launches it
                  (the device path for K1 and K2, launches_per_orbit for
                  the banana orbit; the host-compacted path for K3; 0 for
                  the tools' kernels K4-K6).
  library_ms      one PyTorch call computing the same function, or null
                  where none does (K1-K5); for K6, x[s0:s0+L, :128].sum(0),
                  which sums in another order and once, not 2,048 times: a
                  yardstick of time only.
K1's entry also has vs_old_design (the first design's device time over
K1's, same call), arm_full_device_ms (the ablation arm `full` in the same
turns) and launches_per_scan (phase 13, as K2's entry), K2's graph_floor_ms (a tiny torch op in a CUDA graph);
the ablation and probe entries give each arm's numbers under "arms", and
at the top
those of K5's `full`, K4's `smem_window` and the probe's `baseline`. The
last line is the run's JSON status.
"""

import json
import math
import os
import re
import statistics
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BANANA = os.path.join(REPO, "data/objects/011_banana/tsdf/nontextured.ply")
# the scan loop's scene (phase 13): where the object stands, its
# ground-truth mesh, and the D435's intrinsics
OBJECT_POINT = [0.75, 0.75, 0.0]
BANANA_MESH = os.path.join(
    REPO, "data/objects/011_banana/poisson/nontextured.ply")
D435 = dict(fx=615.6707153320312, fy=615.962158203125,
            cx=326.0557861328125, cy=240.55592346191406)
GOLDEN = os.path.join(REPO, "data/golden")


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def load_golden():
    """The 500 golden UR10 configurations and their end-effector poses
    (position, quaternion), each line ``t,[numbers]``."""
    def rows(name):
        with open(os.path.join(GOLDEN, name)) as f:
            return np.array([[float(x) for x in re.findall(
                r"-?\d+\.?\d*(?:[eE][+-]?\d+)?", line.split(",", 1)[1])]
                for line in f])

    return rows("ctraj.txt").astype(np.float32), rows("wtraj.txt")


def events_ms(fn, reps=10):
    """Mean ms per call from CUDA events, after one warm-up call."""
    from reconplan_tpu_torch.bench import time_ms

    return time_ms(fn, reps=reps, warmup=1)


def graph_ms(fn, n=20, replays=5):
    """Device ms per call: ``n`` calls captured in one CUDA graph, CUDA
    events around each replay, the median of ``replays`` replays over
    ``n``. The host issues one replay, so its pace is not in the time."""
    fn()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations of one voxel-frame of K1 (K3 and the ablation arms do the
# same), counted in csrc/brick_integrate.cu: projection 18, z clamp 1, the
# two pixel coordinates 6; depth / depth_scale, d - z, three tests, the
# tsdf divide and clip 3, weight add, clamp and reciprocal 3, the average
# 4, the empty test and the weight clamp 2 (42); color adds 4 a channel.
K1_OPS, K1_COLOR_OPS = 42, 12
# f32 operations of one K2 (brick, frame) test, in csrc/active_mask.cu:
# projection 18, z clamp 1, the two cell coordinates 6, the bin range 8,
# the z test 1
K2_OPS = 34


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    f32 operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(ids, fbits, n, T, intr, depths, origin, brick_dims, voxel):
    """(set brick-frames, distinct in-image pixels sampled, summed over
    the frames) of the first ``n`` bricks of ``ids`` under ``fbits``, from
    the plain version's projection."""
    from reconplan_tpu_torch.ops.kernels.brick_integrate import (
        _project_voxels, _voxel_world)

    F, Hd, Wd = depths.shape
    brick_frames = pixels = 0
    for f in range(F):
        sel = ((fbits[:n] >> f) & 1) > 0
        if not sel.any():
            continue
        brick_frames += int(sel.sum())
        wx, wy, wz = _voxel_world(ids[:n][sel], brick_dims, origin, voxel)
        _, _, _, in_img, pix = _project_voxels(T[f].reshape(16), wx, wy, wz,
                                               intr, Hd, Wd)
        pixels += int(torch.unique(pix[in_img]).numel())
    return brick_frames, pixels


def k1_bound(n, brick_frames, pixels, planes, color_ops, F):
    """K1-shaped work: ``n`` brick rows of ``planes`` planes read and
    written, ids and frame bits, ``pixels`` 4-byte samples per sampled
    plane (depth, and color when ``color_ops``), the poses; 1024
    voxel-frames a brick-frame."""
    sampled = 2 if color_ops else 1
    nbytes = (n * planes * 4096 * 2 + n * 8 + pixels * 4 * sampled
              + F * 64)
    return bound(nbytes, brick_frames * 1024 * (K1_OPS + color_ops))


def bound_fields(bound_pair, device_ms):
    b_ms, by = bound_pair
    return {"bound_ms": b_ms, "bound_by": by,
            "bound_share": b_ms / device_ms, "l2": "warm"}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from reconplan_tpu_torch.bench import (
        MAX_ACTIVE, N, ORIGIN, VOXEL, make_frames)
    from reconplan_tpu_torch.benchmarks import (
        probe_sublane_ops, profile_brick)
    from reconplan_tpu_torch.io.meshio import load_mesh
    from reconplan_tpu_torch.io.render import SplatCamera
    from reconplan_tpu_torch.io.frames import FrameSet
    from reconplan_tpu_torch.ops import tsdf as tsdf_ops
    from reconplan_tpu_torch.ops import tsdf_brick as tb
    from reconplan_tpu_torch.ops.kernels import (
        active_mask, active_mask_reference, brick_ablate,
        brick_ablate_reference, brick_integrate, brick_integrate_fixed,
        brick_integrate_fixed_reference, brick_integrate_reference, build,
        gather_probe)
    from reconplan_tpu_torch.ops.kernels.brick_ablate import (
        ARMS, occupancy as ablate_occupancy_query)
    from reconplan_tpu_torch.ops.kernels.brick_integrate import occupancy
    from reconplan_tpu_torch.ops.kernels.brick_integrate_fixed import (
        occupancy as k3_occupancy_query)
    from reconplan_tpu_torch.ops.kernels.gather_probe import (
        ARMS as PROBE_ARMS, GRID as PROBE_GRID, H as PROBE_H, LOOP,
        W as PROBE_W, _launch as probe_launch, blocks_per_sm as probe_blocks,
        grid_size as probe_grid_size)
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
    for name, u in build.resource_usage().items():
        if name.startswith(("brick_integrate_kernel", "active_mask_kernel",
                            "brick_integrate_fixed_kernel",
                            "gather_probe_kernel", "brick_ablate_")):
            phase("build", f"ptxas {name}: {u.get('registers')} registers, "
                  f"{u.get('smem_bytes')} B smem, spill stores "
                  f"{u.get('spill_stores')} B, loads {u.get('spill_loads')} B")
    sass = build.sass_counts(("brick_integrate_kernel", "active_mask_kernel",
                              "brick_integrate_fixed_kernel",
                              "brick_ablate_kernel<0>"))
    phase("build", "SASS instructions (MUFU, FCHK, BSSY) of each kernel: "
          + ("no cuobjdump" if sass is None else ", ".join(
              f"{k} {v['instructions']} ({v['MUFU']}, {v['FCHK']}, "
              f"{v['BSSY']})" for k, v in sass.items())))
    # K6's step loop is its only loop: its loads and adds are the kernel's
    probe_sass = build.sass_counts(("gather_probe_kernel",),
                                   ("LDG", "LDS", "LDGSTS", "FADD"))
    phase("build", "K6 SASS instructions (LDG, LDS, LDGSTS, FADD) of each "
          "arm <arm,H,W,LOOP>: "
          + ("no cuobjdump" if probe_sass is None else ", ".join(
              f"{k} {v['instructions']} ({v['LDG']}, {v['LDS']}, "
              f"{v['LDGSTS']}, {v['FADD']})" for k, v in probe_sass.items())))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k1_occupancy = {}
    for name, color in (("depth", False), ("color", True)):
        blocks, threads = occupancy(color, dev.index or 0)
        k1_occupancy[name] = {"blocks_per_sm": blocks, "threads": threads}
    phase("build", f"K1 occupancy query on {sms} SMs, blocks per SM x "
          "threads: " + ", ".join(f"{k} {v['blocks_per_sm']} x {v['threads']}"
                                  for k, v in k1_occupancy.items()))
    ablate_occupancy = {arm: ablate_occupancy_query(arm, dev.index or 0)[0]
                        for arm in ARMS}
    phase("build", "K4/K5 occupancy query, blocks per SM of each arm "
          "<arm index>: " + ", ".join(f"{a} <{ARMS.index(a)}> {b}"
                                      for a, b in ablate_occupancy.items()))
    k3_blocks, k3_threads = k3_occupancy_query(dev.index or 0)
    k3_occupancy = {"blocks_per_sm": k3_blocks, "threads": k3_threads}
    probe_occupancy = {arm: dict(zip(("most_blocks_per_sm", "blocks_per_sm"),
                                     probe_blocks(arm, dev.index or 0)))
                       for arm in PROBE_ARMS}
    phase("build", f"K3 occupancy query: {k3_blocks} x {k3_threads} | K6 "
          "blocks of 128 threads an SM, most by the occupancy query -> "
          "taken: " + ", ".join(
              f"{a} {v['most_blocks_per_sm']} -> {v['blocks_per_sm']}"
              for a, v in probe_occupancy.items()))

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
    if not torch.equal(bits, bits_ref):
        raise AssertionError(
            f"K2 bits differ on {(bits != bits_ref).sum().item()} bricks")
    k2_run = lambda: active_mask(*k2_args, mip_cell=8)  # noqa: E731
    k2 = {"max_abs_err": (bits.long() - bits_ref.long()).abs().max().item(),
          "events_ms": events_ms(k2_run), "device_ms": graph_ms(k2_run),
          "plain_ms": events_ms(lambda: active_mask_reference(
              *k2_args, mip_cell=8))}
    # the floor of a device time from a CUDA graph: a tiny torch op
    tiny = torch.zeros(1, device=dev)
    k2["graph_floor_ms"] = graph_ms(lambda: tiny.add_(1))
    # the mip planes whole, the bits, the poses; one test a (brick, frame)
    k2.update(bound_fields(bound(
        2 * occ0.numel() * 4 + NB * 4 + 8 * 64 + 8, NB * 8 * K2_OPS),
        k2["device_ms"]))
    phase("kernels", f"K2 active_mask: bits identical on {NB} bricks "
          f"({(bits != 0).sum().item()} active) | device "
          f"{k2['device_ms']:.5f} ms a launch (bound {k2['bound_ms']:.5f}, "
          f"{k2['bound_by']}), events {k2['events_ms']:.4f}, plain "
          f"{k2['plain_ms']:.4f} ms | a tiny torch op in a CUDA graph "
          f"{k2['graph_floor_ms']:.5f}")

    def k1_compare(n_frames, colors, rgb):
        """K1 against its plain version on a chunk of the bench scene;
        returns its numbers, the kernel's output planes and the rest of
        the call's arguments."""
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
        run = lambda: brick_integrate(*scratch, *rest)  # noqa: E731
        out = {"max_abs_err": err, "events_ms": events_ms(run),
               "device_ms": graph_ms(run),
               "plain_ms": events_ms(lambda: brick_integrate_reference(
                   *scratch, *rest), reps=3),
               "live_bricks": n.item()}
        out["brick_frames"], out["pixels"] = k1_work(
            ids, fbits, out["live_bricks"], T, intr, d, grid.origin, bd,
            VOXEL)
        out.update(bound_fields(k1_bound(
            out["live_bricks"], out["brick_frames"], out["pixels"],
            2 if rgb is None else 3, 0 if rgb is None else K1_COLOR_OPS,
            n_frames), out["device_ms"]))
        return out, planes, rest

    k1, _, rest = k1_compare(8, None, None)
    # the depth-only call as brick_ablate takes it
    k1_depth_rest = rest[:6] + rest[7:]
    # the first design (ablation arm `pr1_full`), K1, and K1's own code as
    # the ablation library instantiates it (arm `full`), in turns
    scratch = (grid.sdf.clone(), grid.weight.clone())
    old_run = lambda: brick_ablate("pr1_full", *scratch, *k1_depth_rest)  # noqa: E731
    new_run = lambda: brick_integrate(*scratch, None, *rest)  # noqa: E731
    arm_run = lambda: brick_ablate("full", *scratch, *k1_depth_rest)  # noqa: E731
    turns = [graph_ms(old_run), graph_ms(new_run), graph_ms(arm_run),
             graph_ms(arm_run), graph_ms(new_run), graph_ms(old_run)]
    k1["old_design_device_ms"] = (turns[0] + turns[5]) / 2
    k1["vs_old_design"] = k1["old_design_device_ms"] / (
        (turns[1] + turns[4]) / 2)
    k1["arm_full_device_ms"] = (turns[2] + turns[3]) / 2
    k1["turns_ms"] = turns
    phase("kernels", f"K1 brick_integrate depth: sdf max err "
          f"{k1['max_abs_err']:.3g}, weight identical, {k1['live_bricks']} "
          f"live bricks, {k1['brick_frames']} brick-frames | device "
          f"{k1['device_ms']:.5f} ms a launch (bound {k1['bound_ms']:.5f}, "
          f"{k1['bound_by']}), events {k1['events_ms']:.4f}, plain "
          f"{k1['plain_ms']:.4f} ms")
    phase("kernels", "K1 against its first design (`pr1_full`) and the "
          "ablation arm `full`, in turns pr1_full, K1, full, full, K1, "
          "pr1_full: " + ", ".join(f"{t:.5f}" for t in turns)
          + f" ms -> K1 {k1['vs_old_design']:.3f}x its first design")
    gen = torch.Generator(device=dev).manual_seed(0)
    colors = torch.randint(0, 1 << 24, (4,) + d_all.shape[1:], generator=gen,
                           dtype=torch.int32, device=dev)
    rgb = torch.randint(0, 1 << 24, grid.sdf.shape, generator=gen,
                        dtype=torch.int32, device=dev)
    k1c, _, _ = k1_compare(4, colors, rgb)
    phase("kernels", f"K1 brick_integrate color (4 frames): sdf max err "
          f"{k1c['max_abs_err']:.3g}, weight and rgb identical, "
          f"{k1c['live_bricks']} live bricks, {k1c['brick_frames']} "
          f"brick-frames | device {k1c['device_ms']:.5f} ms a launch (bound "
          f"{k1c['bound_ms']:.5f}, {k1c['bound_by']}), events "
          f"{k1c['events_ms']:.4f}, plain {k1c['plain_ms']:.4f} ms")
    del rgb, colors
    # K3 on the same chunk: the host path's compacted ids, padded to 512
    mask = tb.active_brick_mask(bd, grid.origin, VOXEL, trunc, d8, T8, *intr)
    ids_np, n_k3 = tb.host_active_ids(mask, bd, NB)
    ids = torch.as_tensor(ids_np, device=dev)
    planes = (grid.sdf.clone(), grid.weight.clone())
    ref = tuple(a.clone() for a in planes)
    k3_rest = (ids, 0, NB, T8, intr, d8, grid.origin, bd, VOXEL, trunc,
               1000.0, 3.0, 64.0)
    brick_integrate_fixed(*planes, *k3_rest)
    brick_integrate_fixed_reference(*ref, *k3_rest)
    torch.cuda.synchronize()
    k3_err = (planes[0] - ref[0]).abs().max().item()
    if k3_err > 1e-6 or not torch.equal(planes[1], ref[1]):
        raise AssertionError(f"K3 sdf err {k3_err} or weight differs")
    k3_expect = tuple(a.clone() for a in ref)
    k3_run = lambda: brick_integrate_fixed(*planes, *k3_rest)  # noqa: E731
    k3 = {"max_abs_err": k3_err, "events_ms": events_ms(k3_run),
          "device_ms": graph_ms(k3_run),
          "plain_ms": events_ms(lambda: brick_integrate_fixed_reference(
              *ref, *k3_rest), reps=3),
          "real_bricks": n_k3, "padding": len(ids_np) - n_k3,
          "grid": len(ids_np), "occupancy": k3_occupancy}
    # the padding's share: the same real ids with no padding, and padded
    # as the sharded path pads a shard (4,096, and phase 8's 8,192); the
    # results must not change
    k3["device_ms_by_padded_len"] = {}
    for m_pad in (n_k3, 4096, 8192):
        ids_m = torch.cat([ids[:n_k3], ids.new_full((m_pad - n_k3,), NB)])
        out_m = (grid.sdf.clone(), grid.weight.clone())
        rest_m = (ids_m,) + k3_rest[1:]
        brick_integrate_fixed(*out_m, *rest_m)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out_m, k3_expect)):
            raise AssertionError(f"K3 padded to {m_pad} differs")
        k3["device_ms_by_padded_len"][m_pad] = graph_ms(
            lambda o=out_m, r=rest_m: brick_integrate_fixed(*o, *r))
    k3["registers"] = build.resource_usage()[
        "brick_integrate_fixed_kernel"]["registers"]
    phase("kernels", f"K3 {k3['registers']} registers (ptxas), grid "
          f"{k3['grid']} blocks, one an id ({k3_blocks} "
          f"an SM x {sms} SMs at once), {k3['real_bricks']} real ids + "
          f"{k3['padding']} padding | device ms by padded length: "
          + ", ".join(f"{m} {t:.5f}" for m, t in
                      k3["device_ms_by_padded_len"].items()))
    # every frame of every real brick; the padding's blocks return at once
    k3_bf, k3_pix = k1_work(ids, torch.full_like(ids, 255), n_k3, T8, intr,
                            d8, grid.origin, bd, VOXEL)
    k3.update(bound_fields(bound(
        n_k3 * 2 * 4096 * 2 + len(ids_np) * 4 + k3_pix * 4 + 8 * 64,
        k3_bf * 1024 * K1_OPS), k3["device_ms"]))
    phase("kernels", f"K3 brick_integrate_fixed (8 frames): sdf max err "
          f"{k3_err:.3g}, weight identical, {n_k3} bricks padded to "
          f"{len(ids_np)} | device {k3['device_ms']:.5f} ms a launch (bound "
          f"{k3['bound_ms']:.5f}, {k3['bound_by']}), events "
          f"{k3['events_ms']:.4f}, plain {k3['plain_ms']:.4f} ms")
    del grid, planes, ref, scratch, k3_expect, out_m

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
    per_batch = {"active_mask": active_mask.launches,
                 "brick_integrate": brick_integrate.launches}
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
    per_orbit = {k: v - per_batch[k] for k, v in launches.items()}
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
    per_batch["brick_integrate_fixed"] = k3_bricked
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

    # --- 10. the ablation arms (K4/K5) at phase 3's bench chunk ----------
    grid = tb.make_brick_grid((N,) * 3, ORIGIN, VOXEL, device=dev)
    tb.integrate_frames_bricked_device(grid, d_all[8:16], p_all[8:16], *K)
    ids, fbits, n, _ = tb.chunk_active_set(
        d8, T8, intr, grid.origin, bd, VOXEL, trunc, MAX_ACTIVE, NB)
    rest = (ids, fbits, n, T8, intr, d8, grid.origin, bd, VOXEL, trunc,
            1000.0, 3.0, 64.0)
    k1_planes = (grid.sdf.clone(), grid.weight.clone())
    brick_integrate(*k1_planes, None, *rest[:6], None, *rest[6:])
    # each arm's work on this chunk: `full`, `smem_window`, `no_skips`,
    # `static_stride` and `pr1_full` do K1's (the function, whatever the
    # arm spends on it), `one_row` and `no_gather` K1's operations on
    # (almost) no depth,
    # `no_fbits` every frame of each live brick, `rw_only` the rows alone
    n_live = n.item()
    rows = n_live * 2 * 4096 * 2 + n_live * 8 + 8 * 64
    nf_bf, nf_pix = k1_work(ids, torch.full_like(fbits, 255), n_live, T8,
                            intr, d8, grid.origin, bd, VOXEL)
    as_k1_arms = ("full", "smem_window", "no_skips", "static_stride",
                  "pr1_full")
    arm_bound = {
        **{arm: (k1["bound_ms"], k1["bound_by"]) for arm in as_k1_arms},
        "one_row": bound(rows, k1["brick_frames"] * 1024 * K1_OPS),
        "no_gather": bound(rows, k1["brick_frames"] * 1024 * K1_OPS),
        "no_fbits": k1_bound(n_live, nf_bf, nf_pix, 2, 0, 8),
        "rw_only": bound(rows, 0),
    }
    ablate = {}
    for arm in ARMS:
        planes = (grid.sdf.clone(), grid.weight.clone())
        ref = tuple(a.clone() for a in planes)
        brick_ablate(arm, *planes, *rest)
        brick_ablate_reference(arm, *ref, *rest)
        torch.cuda.synchronize()
        err = (planes[0] - ref[0]).abs().max().item()
        if err > 1e-6 or not torch.equal(planes[1], ref[1]):
            raise AssertionError(f"ablation arm {arm}: sdf err {err} or "
                                 "weight differs from its plain version")
        as_k1 = torch.equal(planes[0], k1_planes[0]) and torch.equal(
            planes[1], k1_planes[1])
        if arm in as_k1_arms and not as_k1:
            raise AssertionError(f"ablation arm {arm} differs from K1")
        run = lambda a=arm, p=planes: brick_ablate(a, *p, *rest)  # noqa: E731
        ablate[arm] = {
            "max_abs_err": err, "events_ms": events_ms(run),
            "device_ms": graph_ms(run),
            "plain_ms": events_ms(
                lambda a=arm, p=ref: brick_ablate_reference(a, *p, *rest),
                reps=3)}
        ablate[arm]["ms"] = ablate[arm]["device_ms"]
        ablate[arm].update(bound_fields(arm_bound[arm],
                                        ablate[arm]["device_ms"]))
        phase("ablate", f"{arm}: sdf max err {err:.3g}, weight identical"
              + (", bit-identical to K1" if as_k1 else "")
              + f" | device {ablate[arm]['device_ms']:.5f} ms a launch "
              f"(bound {ablate[arm]['bound_ms']:.5f}), events "
              f"{ablate[arm]['events_ms']:.4f}, plain "
              f"{ablate[arm]['plain_ms']:.4f} ms")
        del planes, ref
    phase("ablate", f"{n_live} live bricks of the 8-frame bench chunk | "
          f"{card}")
    del grid, k1_planes

    # --- 11. the stage split and ablation tool, end to end ----------------
    for arm in ARMS:
        brick_ablate.launches[arm] = 0
    t0 = time.perf_counter()
    prof = profile_brick.run(reps=2, inner=2, log=sys.stdout)
    dt = time.perf_counter() - t0
    print(json.dumps(prof), flush=True)
    ablate_launches = dict(brick_ablate.launches)
    bad = [k for k, v in prof.items() if k.endswith("_ms") and v is not None
           and not (math.isfinite(v) and v > 0)]
    if bad:
        raise AssertionError(f"profile_brick stage times not positive: {bad}")
    phase("profile", f"{dt:.1f} s | full pipeline "
          f"{prof['full_pipeline_ms']:.3f} ms/batch (device "
          f"{prof['full_pipeline_device_ms']:.3f}; after the profiler "
          f"{prof['full_pipeline_after_profiler_ms']:.3f}), mask pipeline "
          f"{prof['mask_pipeline_ms']:.3f} (device "
          f"{prof['mask_pipeline_device_ms']:.3f}), K1 alone "
          f"{prof['kernel_production_ms']:.4f} | ablation launches "
          f"{json.dumps(ablate_launches)}")

    # --- 12. the microprobe (K6) -------------------------------------------
    for arm in gather_probe.launches:
        gather_probe.launches[arm] = 0
    probe = probe_sublane_ops.run()
    probe_launches = dict(gather_probe.launches)
    # device times and the library yardstick on the probe's own input
    x = torch.as_tensor(np.random.default_rng(probe_sublane_ops.SEED).random(
        (PROBE_H, PROBE_W), dtype=np.float32), device=dev)
    probe_arms = {}
    s0_sweep = probe_sublane_ops.S0S[-1]
    for arm in PROBE_ARMS:
        L = PROBE_H if arm == "baseline" else LOOP
        dev_ms, twice_ms, lib_ms = [], [], []
        for s0 in probe_sublane_ops.S0S:
            a = 0 if arm == "baseline" else min(s0, PROBE_H - LOOP)
            dev_ms.append(graph_ms(lambda s=s0, r=arm: gather_probe(r, x, s)))
            twice_ms.append(graph_ms(lambda s=s0, r=arm: gather_probe(
                r, x, s, steps=2 * PROBE_GRID)))
            lib_ms.append(graph_ms(lambda a=a, L=L: x[a:a + L, :128].sum(0)))
            if not torch.equal(gather_probe(arm, x, s0, steps=2 * PROBE_GRID),
                               gather_probe(arm, x, s0)):
                raise AssertionError(f"probe arm {arm}: {2 * PROBE_GRID} "
                                     "steps give another output")
        # the same steps on other grids: blocks an SM -> device ms
        by_blocks = {
            b: graph_ms(lambda r=arm, b=b: probe_launch(
                r, x, s0_sweep, PROBE_GRID, min(PROBE_GRID, b * sms)))
            for b in (1, 2, 4, 8, 16)}
        # a step's latency: 16 blocks, each alone on its SM, at 2,048 and
        # 4,096 steps; the difference over the 128 steps a block
        alone = [graph_ms(lambda r=arm, n=n: probe_launch(
            r, x, s0_sweep, n, 16)) for n in (PROBE_GRID, 2 * PROBE_GRID)]
        step_ns = (alone[1] - alone[0]) * 1e6 / (PROBE_GRID / 16)
        grid_blocks = probe_grid_size(arm, dev, PROBE_GRID)
        phase("probe", f"{arm}: grid {grid_blocks} blocks, "
              f"{PROBE_GRID / grid_blocks:.2f} steps a block | device ms at "
              f"{PROBE_GRID} steps {np.mean(dev_ms):.5f}, at "
              f"{2 * PROBE_GRID} steps {np.mean(twice_ms):.5f} | library "
              f"x[s0:s0+L, :128].sum(0) {np.mean(lib_ms):.5f} | device ms by "
              f"blocks an SM at s0={s0_sweep}: "
              + ", ".join(f"{b} {t:.5f}" for b, t in by_blocks.items())
              + f" | one step of a block alone on its SM {step_ns:.1f} ns")
        if not np.mean(twice_ms) > np.mean(dev_ms):
            raise AssertionError(f"probe arm {arm}: the device time does not "
                                 "grow with the step count")
        probe_arms[arm] = {
            "launches": probe_launches[arm], "ms": float(np.mean(dev_ms)),
            "device_ms": float(np.mean(dev_ms)),
            "device_ms_twice_the_steps": float(np.mean(twice_ms)),
            "grid": grid_blocks, "occupancy": probe_occupancy[arm],
            "device_ms_by_blocks_per_sm": by_blocks, "step_ns": step_ns,
            "events_ms": probe["ms"][arm], "plain_ms": probe["plain_ms"][arm],
            "max_abs_err": probe["max_abs_err"][arm],
            "library_ms": float(np.mean(lib_ms)),
            **bound_fields(bound(x.numel() * 4 + 8 * 128 * 4,
                                 PROBE_GRID * 128 * L),
                           float(np.mean(dev_ms)))}
    phase("probe", "bit-identical to the plain versions at s0 in "
          f"{probe['s0']} | device ms "
          + ", ".join(f"{a} {v['device_ms']:.5f}"
                      for a, v in probe_arms.items())
          + " | events ms "
          + ", ".join(f"{a} {v:.4f}" for a, v in probe["ms"].items())
          + " | plain ms "
          + ", ".join(f"{a} {v:.4f}" for a, v in probe["plain_ms"].items())
          + " | library x[s0:s0+L, :128].sum(0) ms "
          + ", ".join(f"{a} {v['library_ms']:.5f}"
                      for a, v in probe_arms.items()))

    # --- 13. the planning and capture half of the scan loop --------------
    from reconplan_tpu_torch.grr import scan_arc
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin import fk_all, make_robot
    from reconplan_tpu_torch.utils.profiling import StageTimer

    active_mask.launches = 0
    brick_integrate.launches = 0
    timer = StageTimer()
    with timer.stage("robot", fence=dev):
        robot = make_robot(load_problem("ur10", "rot_free"))
    n_geom = len(robot._spheres["self"][0]) + len(robot._spheres["ee"][0])
    if not (robot.device.type == "cuda" and robot.rob.num_links == 18
            and robot.num_joints == 6 and n_geom == 12
            and robot._spheres["self"][1].shape[1:] == (32, 3)):
        raise AssertionError("the UR10 is not the one the scan loop plans for")
    ctraj, wtraj = load_golden()
    pos, rot = robot.solve_fk_batch(ctraj)
    pos, quat = pos[:, -1].cpu().numpy(), rot[:, -1].cpu().numpy()
    fk_pos_err = np.linalg.norm(pos - wtraj[:, :3], axis=-1).max()
    # the golden file stores the quaternion of R^T (the conjugate)
    fk_dot = np.abs(np.sum(quat * [-1.0, -1.0, -1.0, 1.0] * wtraj[:, 3:7],
                           axis=-1)).min()
    if not (fk_pos_err < 5e-5 and fk_dot > 1 - 1e-5):
        raise AssertionError(f"golden FK: position err {fk_pos_err} m, "
                             f"min |quat . conj| {fk_dot}")
    fk_ms = events_ms(lambda: robot.solve_fk_batch(ctraj))
    arc = scan_arc(OBJECT_POINT, radius=0.3, height=0.15, num_points=64)
    n_way, restarts = len(arc), 16
    targets = np.repeat(arc[:, :3], restarts, axis=0)
    seeds = robot.sample(n_way * restarts, rng=np.random.default_rng(0))
    # the solver's first call pays for the library handles of its 6x6
    # solves: a batch of two problems takes that out of the timed batch
    robot.solve_ik_batch(targets[:2], seeds[:2], max_iters=2)
    ik_events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with timer.stage("plan", fence=dev):
        ik_events[0].record()
        qf, okf = robot.solve_ik_batch(targets, seeds)
        ik_events[1].record()
    ik_ms = ik_events[0].elapsed_time(ik_events[1])
    # the same batch again under the profiler: its kernels and their time
    # on the card (the profiler slows the host, not the kernels)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as ik_prof:
        robot.solve_ik_batch(targets, seeds)
        torch.cuda.synchronize()
    ik_kernels = [e for e in ik_prof.events()
                  if e.device_type == DeviceType.CUDA]
    ik_busy_ms = sum(e.device_time_total for e in ik_kernels) / 1e3
    del ik_prof
    okf = okf.reshape(n_way, restarts)
    solved = okf.any(dim=1)
    first = okf.to(torch.int8).argmax(dim=1)
    qs = qf.reshape(n_way, restarts, -1)[torch.arange(n_way, device=dev),
                                         first][solved]
    n_solved = int(solved.sum())
    if n_solved < 56:  # every run so far solved 64 of 64
        raise AssertionError(f"IK solved {n_solved} of {n_way} waypoints")
    # every configuration called solved reaches its target by FK
    reach = (robot.fk_point_batch(qs)[:, :3] - torch.as_tensor(
        arc[:, :3], device=dev)[solved]).norm(dim=-1).max().item()
    if not reach < 1e-3:
        raise AssertionError(f"a solved configuration misses its waypoint "
                             f"by {reach} m")
    _, t_links = fk_all(robot.model, robot._full_config(qs))
    cam_positions = t_links[:, robot.camera_link].cpu().numpy()
    pick = np.linspace(0, len(qs) - 1, 12).astype(int)
    with timer.stage("capture", fence=dev):
        cam = SplatCamera(**D435, device=dev).add_mesh_file(
            BANANA_MESH, translate=OBJECT_POINT)
        shots = [cam.take_picture(cam_positions[i], OBJECT_POINT)
                 for i in pick]
    frames = FrameSet(depth=torch.stack([s[0] for s in shots]),
                      color=torch.stack([s[1] for s in shots]),
                      poses=np.stack([s[2] for s in shots]).astype(np.float32),
                      depth_scale=1000.0, intrinsics=cam.intrinsics)
    coverage = (frames.depth > 0).float().mean().item()
    scan_dim = 256
    scan_voxel = 0.3 / (scan_dim - 1)
    with timer.stage("fuse", fence=dev):
        scan_pipe = FusionPipeline(
            dims=(scan_dim,) * 3,
            origin=(OBJECT_POINT[0] - 0.15, OBJECT_POINT[1] - 0.15, -0.05),
            voxel_size=scan_voxel, with_color=True, engine="brick",
            device=dev)
        scan_pipe.integrate(frames)
    with timer.stage("extract", fence=dev):
        scan_tris, scan_cols = scan_pipe.extract_mesh(with_colors=True)
    per_scan = {"active_mask": active_mask.launches,
                "brick_integrate": brick_integrate.launches}
    if len(scan_tris) == 0:
        raise AssertionError("the scan's mesh has no triangles")
    with timer.stage("distance", fence=dev):
        scan_gt_v, scan_gt_f = load_mesh(BANANA_MESH)
        scan_gt = torch.as_tensor(
            (scan_gt_v + np.asarray(OBJECT_POINT))[scan_gt_f],
            dtype=torch.float32, device=dev)
        mesh_to_gt = points_to_mesh_distance(
            torch.unique(scan_tris.reshape(-1, 3), dim=0), scan_gt)
        mesh_to_gt_mm = mesh_to_gt.mean().item() * 1e3
    if not (torch.isfinite(scan_tris).all() and torch.isfinite(scan_cols).all()
            and math.isfinite(mesh_to_gt_mm)
            and mesh_to_gt_mm < 2 * scan_voxel * 1e3):
        raise AssertionError(f"scan mesh -> ground truth {mesh_to_gt_mm} mm "
                             f"(limit {2 * scan_voxel * 1e3} mm)")
    for name, count in per_scan.items():
        if count == 0:
            raise AssertionError(f"the scan's fusion never launched {name}")
        launches[name] += count
    phase("scan", f"UR10 on {robot.device}: {robot.rob.num_links} links, "
          f"{robot.num_joints} active joints, {n_geom} geometry links of 32 "
          f"spheres | golden FK of {len(ctraj)} configs: position err "
          f"{fk_pos_err:.3g} m, min |quat . conj| {fk_dot:.8f}, "
          f"{fk_ms:.3f} ms a batch (events)")
    phase("scan", f"IK: solved {n_solved} of {n_way} waypoints "
          f"({int(okf.sum())} of {okf.numel()} restarts), worst FK miss "
          f"{reach:.3g} m | batch of {okf.numel()}, max_iters=100: "
          f"{ik_ms:.1f} ms (CUDA events) | under the profiler "
          f"{len(ik_kernels)} kernels and copies, {ik_busy_ms:.1f} ms on "
          f"the card: busy share {ik_busy_ms / ik_ms:.3f}")
    phase("scan", f"12 pictures {cam.width}x{cam.height}, coverage "
          f"{coverage:.3%} | {len(scan_tris)} triangles at {scan_dim}^3, "
          f"voxel {scan_voxel * 1e3:.4f} mm | mesh -> ground truth mean "
          f"{mesh_to_gt_mm:.4f} mm, max {mesh_to_gt.max().item() * 1e3:.4f} "
          f"mm | K2 / K1 launches {per_scan['active_mask']} / "
          f"{per_scan['brick_integrate']} | stages s (synchronised): "
          + ", ".join(f"{k} {v:.3f}" for k, v in timer.stages)
          + f" | {card}")
    del scan_pipe, frames, shots, cam

    for arm, count in {**ablate_launches, **probe_launches}.items():
        if count == 0:
            raise AssertionError(f"its tool never launched arm {arm}")
    launches["brick_ablate"] = sum(ablate_launches.values())
    launches["gather_probe"] = sum(probe_launches.values())
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"main path never launched {name}")
    phase("launches", json.dumps(launches) + " | one bench batch "
          + json.dumps(per_batch) + " | one banana orbit "
          + json.dumps(per_orbit) + " | one planned scan "
          + json.dumps(per_scan))

    def entry(name, source, replaces, nums, **extra):
        """One kernel's line: its device time as ``ms``."""
        keys = ("max_abs_err", "device_ms", "events_ms", "plain_ms",
                "bound_ms", "bound_by", "bound_share", "l2")
        return {"name": name, "route": "cuda",
                "source": "reconplan_tpu_torch/csrc/" + source,
                "replaces": replaces, "ms": nums["device_ms"],
                **{k: nums[k] for k in keys}, "library_ms": None, **extra}

    # K4 and K5 share one templated kernel; each arm goes under one entry
    # only (K4's `full2` is K5's `full`), and the first arm gives the
    # entry's own numbers
    def ablate_entry(name, replaces, arms):
        return entry(
            name, "brick_ablate.cu", replaces, ablate[arms[0]],
            launches=sum(ablate_launches[a] for a in arms),
            launches_per_batch=0,
            arms={a: {"launches": ablate_launches[a], **ablate[a],
                      "blocks_per_sm": ablate_occupancy[a],
                      "library_ms": None} for a in arms})

    print(json.dumps({"kernels": [
        entry("active_mask", "active_mask.cu",
              "reconplan_tpu/ops/tsdf_brick.py:278", k2,
              launches=launches["active_mask"],
              launches_per_batch=per_batch["active_mask"],
              launches_per_orbit=per_orbit["active_mask"],
              launches_per_scan=per_scan["active_mask"],
              graph_floor_ms=k2["graph_floor_ms"]),
        entry("brick_integrate", "brick_integrate.cu",
              "reconplan_tpu/ops/tsdf_brick.py:682", k1,
              launches=launches["brick_integrate"],
              launches_per_batch=per_batch["brick_integrate"],
              launches_per_orbit=per_orbit["brick_integrate"],
              launches_per_scan=per_scan["brick_integrate"],
              live_bricks=k1["live_bricks"],
              brick_frames=k1["brick_frames"],
              vs_old_design=k1["vs_old_design"],
              old_design_device_ms=k1["old_design_device_ms"],
              arm_full_device_ms=k1["arm_full_device_ms"],
              occupancy=k1_occupancy,
              color={k: k1c[k] for k in (
                  "device_ms", "events_ms", "plain_ms", "max_abs_err",
                  "bound_ms", "bound_by", "bound_share", "live_bricks",
                  "brick_frames")}),
        entry("brick_integrate_fixed", "brick_integrate_fixed.cu",
              "reconplan_tpu/ops/tsdf_brick.py:503", k3,
              launches=launches["brick_integrate_fixed"],
              launches_per_batch=per_batch["brick_integrate_fixed"],
              **{k: k3[k] for k in ("real_bricks", "padding", "grid",
                                    "registers", "occupancy",
                                    "device_ms_by_padded_len")}),
        ablate_entry("brick_ablate_k5", "benchmarks/profile_brick.py:75",
                     ("full", "no_fbits", "no_gather", "one_row", "rw_only",
                      "no_skips", "static_stride", "pr1_full")),
        ablate_entry("brick_ablate_k4", "benchmarks/profile_brick.py:320",
                     ("smem_window",)),
        {**entry("gather_probe", "gather_probe.cu",
                 "benchmarks/probe_sublane_ops.py:35",
                 probe_arms["baseline"],
                 launches=launches["gather_probe"], launches_per_batch=0,
                 arms=probe_arms),
         "library_ms": probe_arms["baseline"]["library_ms"]},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
