"""Drive the PyTorch/CUDA port once on one CUDA card: the fusion paths,
the flagship scan through its entry point with every route, the roadmap
layer, the stitch and the teleop half.

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
 13. scan     the scan loop through its entry point on the card:
              make_robot for ur10 / rot_free; FK of the 500 golden
              configurations against data/golden/wtraj.txt (position
              < 5e-5 m, |quat . conj| > 1 - 1e-5); the IK fallback's
              routine alone, one seeded batch of 1,024 problems (scan_arc
              of 64 waypoints x 16 random restarts, max_iters=100), timed
              and under the profiler; then apps.scan.run_scan on the
              committed roadmap graph/ur10/rot_free with 500 waypoints, 12
              pictures, fusion at 256^3 (brick engine), and the CLI's
              other defaults: the Poisson closure at 192^3 with the auto
              gate and the pose-seeded ICP stitch, into a temporary
              directory. Prints the waypoints
              solved, carried by the roadmap (solve_batch) and rescued by
              the IK fallback beside the JAX package's counts, the worst
              FK miss of a solved configuration (read back from
              ctraj.txt), the plan's seconds and ms a waypoint, a second
              solve_batch of 32 waypoints timed and under the profiler
              (kernels and copies, busy share), the stage times, the mean
              distance of the fused mesh's vertices to the ground-truth
              triangles and run_scan's Chamfer; the stitch, close and gate
              stages, the stitched, closed and best Chamfers (with their
              two directions) beside the JAX package's, the gate's
              signals, one stitched frame timed and profiled (kernels and
              copies, busy share) and the batched 3x3 eigh at the
              stitch's and the close stage's sizes. Fails under 490
              solved, at a miss of 1e-3 m or more, when the roadmap
              carries 5% fewer than the JAX package, when the mesh is not
              within two voxels of the ground truth, when the stitched
              cloud is more than 1 mm from it, when the closed or
              stitched Chamfer is more than 10% from the JAX package's,
              or when the gate decides otherwise than the JAX package
              while its two proxies are more than 5% apart
 14. roadmap  GraphCore built from native/graphcore.cpp and run natively
              on the rot_fixed workspace graph, equal to its Python
              fallback; the four committed UR10 roadmaps loaded onto the
              card (rot_fixed_coherent with floor_check=False) and
              evaluate_roadmap against the CPU test's values (counts
              equal, the two ratios within 1e-5 relative); one
              build_roadmap of ur10 / rot_free at 40 workspace nodes (a
              reduced depth) into a temporary directory, every configured
              node within 1e-3 m of its point by FK. Nothing is written
              under graph/
 15. stitch   the pose-free stitch of tests/test_recon_io.py's viewpoint
              jump (six 160x120 frames, 4 mm voxel, 8,192 slots): frames
              rescued and dropped, failing at a centre error of 3 cm or a
              spread of 0.2 m; poisson_reconstruct on the card against the
              CPU on a seeded sphere (chi within 1e-4 of its peak,
              triangle counts within 1%); estimate_normals and the three
              ICPs on the card against the CPU (the same iterations, T
              within 1e-5)
 16. teleop   the teleop half on the card: (a) the four-arm teleop
              benchmark (grr/teleop_batch.run_reference_benchmark) on
              graph/ur10/rot_variable_yaw with its rgrr/ Random-GRR roadmap,
              the first 50 of the 100 circle_random trajectories of the
              reference protocol (4 s at 50 Hz, seed 7; a reduced depth,
              see teleop_phase), converge_steps=100, rows batched: each
              arm's success rate, n_valid, mean
              DTW and mean ratio beside the circle_random row of
              benchmarks/results/teleop_ur10_rvy_n100.json (the JAX
              package's CPU run), the GRR fallback statistics, each arm's
              seconds, one GRR tick at 50 rows and a block of 16 ticks
              (kernels and copies, busy share); fails when an arm's success
              rate is more than 0.10 from the table's. (b) teleop_solve
              along one of those trajectories, synchronised each tick:
              median, p90 and max ms against the UR10's 8 ms servo period.
              (c) ServoExecutor.execute of data/golden/ctraj.txt on the
              card against the CPU (traces within 1e-5, joint err mean
              < 0.05 rad, EE err mean < 25 mm), timed. (d) run_teleop in
              grr and rtde modes, SimRTDE(dynamics=True) with play_ctraj,
              apps.eval_roadmap on rot_variable_yaw (phase 14's values),
              one /tick through serve_teleop. It prints which of
              matplotlib, PIL and pygame the machine has; it needs none.
Launch counters are zeroed just before phase 5 and read after phase 5 (one
bench batch) and after phase 6 (K1 and K2), zeroed before and read after
each of phases 7 and 8 (K3), 11 (every ablation arm) and 12 (every probe
arm), and zeroed just before run_scan in phase 13 and read just after it
(K1 and K2 again): each kernel must have been launched by its paths.

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
NUM = r"-?\d+\.?\d*(?:[eE][+-]?\d+)?"
# the JAX package's counts on the 500-waypoint scan arc over
# graph/ur10/rot_free, from one CPU run (tests/test_torch_scan.py holds
# the port to them): carried by the roadmap, and solved after the IK
# fallback
JAX_CARRIED, JAX_SOLVED = 485, 500
# the JAX package's reconstruct half of that scan with the CLI's defaults
# (reconstruct="both", close_mesh="auto", close_depth=192; 12 pictures,
# 256^3), from one CPU run: the closed mesh's and the stitched cloud's
# Chamfer distances to the banana (mm), the gate's decision and its two
# proxies (mm)
JAX_CLOSED_MM, JAX_STITCH_MM = 0.7892397698014975, 2.2463095374405384
JAX_GATE = ("closed", 1.7212564831832424, 0.29079012988756103)
# the committed UR10 roadmaps: problem, floor_check, and the
# evaluate_roadmap metrics (nodes, edges, configured, disconnection %,
# distance ratio rad/m) that tests/test_torch_grr.py asserts on the CPU
ROADMAPS = {
    "rot_free": ("rot_free", None,
                 (500, 501, 174, 2.2988505747126435, 201.25680541992188)),
    "rot_fixed": ("rot_fixed", None,
                  (3299, 16642, 2373, 1.912130914265386, 6.28181266784668)),
    # built without the floor check (ADVICE.md): 772 of its 2,683
    # configurations fail the default validator
    "rot_fixed_coherent": ("rot_fixed", False,
                           (3299, 16642, 2683, 4.443774949160201,
                            9.52048397064209)),
    "rot_variable_yaw": ("rot_variable_yaw", None,
                         (5788, 30842, 2481, 21.350949886639043,
                          18.51347541809082)),
}


# the JAX package's four-arm teleop benchmark on graph/ur10/rot_variable_yaw
# (100 trajectories a kind, seed 7, its CPU run): phase 16 reads its
# circle_random row
TELEOP_TABLE = os.path.join(REPO, "benchmarks", "results",
                            "teleop_ur10_rvy_n100.json")
TELEOP_ARMS = ("grr", "random_grr", "newton", "relaxed")
# the UR10's servo period at its 125 Hz servo rate (BASELINE.md:17)
SERVO_PERIOD_MS = 8.0


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def load_golden():
    """The 500 golden UR10 configurations and their end-effector poses
    (position, quaternion), each line ``t,[numbers]``."""
    def rows(name):
        with open(os.path.join(GOLDEN, name)) as f:
            return np.array([[float(x) for x in re.findall(
                NUM, line.split(",", 1)[1])]
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


def once_ms(fn):
    """(fn's result, its ms by CUDA events around one call)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1])


def profiled(fn):
    """(fn's result, the kernels and copies of one call under
    torch.profiler, their ms on the card). The profiler slows the host,
    not the kernels. The profiler's raw events are read, not
    ``prof.events()``, whose Python objects cost about 70 us an event
    (a 16-tick GRR block has 1.7 million)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    return out, len(ns), sum(ns) / 1e6


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


def _fmt(x, spec=".4f"):
    return "none" if x is None else format(x, spec)


def teleop_phase(card, n_traj=50):
    """Phase 16: the four-arm teleop benchmark at the reference's width,
    the teleop tick's latency, the servo model on the card against the
    CPU, and the teleop apps on the card.

    The benchmark tracks the first ``n_traj`` of the reference's 100
    trajectories: all 100 took 732 s on an H100 at 700 W (before the GRR
    engine planned a tick's rows in one batch), past what the smoke's
    time limit leaves, and the GRR arms' host fallbacks grow with the
    rows (the first 50: 366-445 s)."""
    import importlib.util
    import urllib.request

    from reconplan_tpu_torch.apps import eval_roadmap
    from reconplan_tpu_torch.apps.teleop import run_teleop
    from reconplan_tpu_torch.benchmarks.bench_teleop import (
        load_random_resolution)
    from reconplan_tpu_torch.grr import RedundancyResolution
    from reconplan_tpu_torch.grr import teleop_batch as tb
    from reconplan_tpu_torch.grr.experiment import generate_trajectories
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.io.drivers import SimRTDE, play_ctraj
    from reconplan_tpu_torch.kin import make_robot
    from reconplan_tpu_torch.kin.dynamics import ServoExecutor
    from reconplan_tpu_torch.viz.teleop_server import serve_teleop

    dev = torch.device("cuda")
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("matplotlib", "PIL", "pygame")}
    phase("teleop", "host packages on this machine: "
          + ", ".join(f"{m} {'yes' if h else 'no'}" for m, h in have.items())
          + " (phase 16 imports none of them)")

    # (a) the four-arm benchmark on the benchmark's roadmap
    folder = os.path.join(REPO, "graph", "ur10", "rot_variable_yaw")
    robot = make_robot(load_problem("ur10", "rot_variable_yaw"))
    res = RedundancyResolution(robot)
    res.load_workspace_graph(os.path.join(folder, "workspace.npz"))
    res.load_resolution_graph(os.path.join(folder, "resolution.npz"))
    res.load_solver_graph(os.path.join(folder, "solver.npz"))
    rand = load_random_resolution(res, os.path.join(folder, "rgrr"))
    if not (res.configs_t.is_cuda and rand.configs_t.is_cuda):
        raise AssertionError("the teleop roadmaps are not on the card")
    t0 = time.perf_counter()
    trajs = generate_trajectories(robot, kind="circle_random",
                                  n_trajectories=100, seed=7)[:n_traj]
    gen_s = time.perf_counter() - t0
    with open(TELEOP_TABLE) as f:
        table = json.load(f)["per_kind"]["circle_random"]
    t0 = time.perf_counter()
    results, stats = tb.run_reference_benchmark(
        res, {"circle_random": trajs}, random_resolution=rand,
        converge_steps=100, verbose=True)
    bench_s = time.perf_counter() - t0
    row, st = results["circle_random"], stats["circle_random"]
    gaps = {}
    for arm in TELEOP_ARMS:
        got, want = row[arm], table[arm]
        gaps[arm] = got["success_rate"] - want["success_rate"]
        phase("teleop", f"{arm}: success {got['success_rate']:.2f} (JAX "
              f"table {want['success_rate']:.2f}, gap {gaps[arm]:+.2f}), "
              f"n_valid {got['n_valid']} ({want['n_valid']}), mean DTW "
              f"{_fmt(got['mean_dtw'])} ({want['mean_dtw']:.4f}), mean "
              f"ratio {_fmt(got['mean_ratio'], '.2f')} "
              f"({want['mean_ratio']:.2f}) | {st['seconds'][arm]:.1f} s")
    for arm in ("grr", "random_grr"):
        phase("teleop", f"{arm} fallbacks: " + json.dumps(st[arm]))
    phase("teleop", f"the first {len(trajs)} of 100 circle_random "
          f"trajectories of {len(trajs[0])} points (seed 7; the JAX table "
          f"tracked all 100) generated in {gen_s:.1f} s | "
          f"cold starts {st['seconds']['cold_starts']:.1f} s | "
          f"run_reference_benchmark {bench_s:.1f} s | {card}")

    # one GRR tick at the benchmark's width, and a block of 16 ticks
    T = np.stack(trajs)
    q0s, alive = tb.cold_starts(res, T)
    tick = tb.make_grr_tick(res, T.shape[2])
    steps = torch.as_tensor(np.swapaxes(T, 0, 1), dtype=torch.float32,
                            device=dev)
    qs = torch.as_tensor(q0s, dtype=torch.float32, device=dev)

    def block():
        q = qs
        for t in range(16):
            q_t, ok, _, cont, deep = tick(steps[t], q)
            q = torch.where((ok & cont & ~deep)[:, None],
                            tb._step_toward_j(robot, q, q_t, 0.04), q)
        return q

    tick(steps[0], qs)
    _, tick_ms = once_ms(lambda: tick(steps[0], qs))
    _, tick_kernels, tick_busy = profiled(lambda: tick(steps[0], qs))
    _, block_ms = once_ms(block)
    _, block_kernels, block_busy = profiled(block)
    phase("teleop", f"one GRR tick at {len(qs)} rows: {tick_ms:.1f} ms "
          f"(CUDA events), {tick_kernels} kernels and copies, "
          f"{tick_busy:.2f} ms on the card | a block of 16 ticks: "
          f"{block_ms:.1f} ms, {block_kernels} kernels and copies, "
          f"{block_busy:.2f} ms on the card: busy share "
          f"{block_busy / block_ms:.3f}")

    # (b) the teleop tick's latency along one trajectory
    row_i = int(np.flatnonzero(alive)[0])
    q = q0s[row_i]
    res.teleop_solve(T[row_i, 0], q, 0.04)  # the solver's handles
    res.plan_path, res.path_index = None, 0
    lat = []
    for target in T[row_i]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_new = res.teleop_solve(target, q, 0.04)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if q_new is not None:
            q = np.asarray(q_new, dtype=np.float64)
    lat = np.asarray(lat)
    phase("teleop", f"teleop_solve along circle_random trajectory "
          f"{row_i} ({len(lat)} targets, synchronised each tick): median "
          f"{np.median(lat):.2f} ms, p90 {np.percentile(lat, 90):.2f} ms, "
          f"max {lat.max():.2f} ms against the UR10's "
          f"{SERVO_PERIOD_MS:.0f} ms servo period; "
          f"{int((lat > SERVO_PERIOD_MS).sum())} of {len(lat)} ticks over it")

    # (c) the servo model of the golden trajectory, the card against the CPU
    times, golden = [], []
    with open(os.path.join(GOLDEN, "ctraj.txt")) as f:
        for line in f:
            t, rest = line.split(",", 1)
            times.append(float(t))
            golden.append([float(x) for x in re.findall(NUM, rest)])
    times = np.asarray(times, np.float32)
    golden = np.asarray(golden, np.float32)
    on_cpu_robot = make_robot(load_problem("ur10", "rot_variable_yaw"),
                              device="cpu")
    servo = ServoExecutor(robot)
    servo.execute(times[:2], golden[:2])
    t0 = time.perf_counter()
    on_card = servo.execute(times, golden)
    card_ms = (time.perf_counter() - t0) * 1e3
    _, servo_kernels, servo_busy = profiled(
        lambda: servo.execute(times, golden))
    t0 = time.perf_counter()
    on_cpu = ServoExecutor(on_cpu_robot, device="cpu").execute(times, golden)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    servo_err = max(np.abs(on_card[k] - on_cpu[k]).max()
                    for k in ("q_ticks", "qd_ticks"))
    if not (servo.device.type == "cuda" and servo_err <= 1e-5
            and on_card["joint_err_mean"] < 0.05
            and on_card["ee_err_mean_mm"] < 25.0):
        raise AssertionError(f"servo on the card: trace err {servo_err}, "
                             f"joint err mean {on_card['joint_err_mean']}, "
                             f"ee err mean {on_card['ee_err_mean_mm']} mm")
    phase("teleop", f"ServoExecutor.execute of the golden ctraj.txt "
          f"({len(on_card['q_ticks'])} ticks at 240 Hz): {card_ms:.1f} ms on "
          f"the card (host clock, read back), {servo_kernels} kernels and "
          f"copies, {servo_busy:.2f} ms on the card | the CPU {cpu_ms:.1f} "
          f"ms | trace against the CPU's {servo_err:.3g} (limit 1e-5) | "
          f"joint err mean {on_card['joint_err_mean']:.5f} rad (limit "
          f"0.05), max {on_card['joint_err_max']:.5f}; EE err mean "
          f"{on_card['ee_err_mean_mm']:.3f} mm (limit 25), max "
          f"{on_card['ee_err_max_mm']:.3f}")

    # (d) the apps on the card
    t0 = time.perf_counter()
    n_grr = run_teleop(mode="grr", script="wwwaaiijjddq", verbose=False)
    grr_s = time.perf_counter() - t0
    n_rtde = run_teleop(mode="rtde", script="wwssaaddiijjq", verbose=False)
    sim = SimRTDE(robot, dynamics=True)
    sim.move_joint(golden[0])
    move_err = np.abs(np.asarray(sim.get_joint_values()) - golden[0]).max()
    n_play = play_ctraj(sim, os.path.join(GOLDEN, "ctraj.txt"))
    if not (n_grr == 11 and n_rtde == 12 and n_play == 500
            and move_err < 5e-3 and sim.dynamics.device.type == "cuda"):
        raise AssertionError(f"teleop apps: grr {n_grr} ticks, rtde "
                             f"{n_rtde}, play_ctraj {n_play}, moveJ err "
                             f"{move_err}")
    m = eval_roadmap.main(["ur10", "rot_variable_yaw", "--dir", folder])
    want = ROADMAPS["rot_variable_yaw"][2]
    got = tuple(m[k] for k in ("n_nodes", "n_edges", "n_configured",
                               "disconnection_ratio", "distance_ratio"))
    if not (got[:3] == want[:3] and all(
            abs(g - w) <= 1e-5 * abs(w) for g, w in zip(got[3:], want[3:]))):
        raise AssertionError(f"eval_roadmap on the card: {got}, the CPU "
                             f"test's {want}")
    srv = serve_teleop(res, port=0, background=True)
    try:
        ee = np.asarray(srv.session.state()["ee"], dtype=float)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/tick",
            data=json.dumps({"target": (ee + [0, 0, 0.05]).tolist()}).encode(),
            method="POST")
        reply = json.loads(urllib.request.urlopen(req, timeout=120).read())
    finally:
        srv.shutdown()
        srv.server_close()
    if not (len(reply["links"]) >= 3 and not reply["status"].startswith(
            "error")):
        raise AssertionError(f"/tick answered {reply}")
    phase("teleop", f"run_teleop grr {n_grr} ticks ({grr_s:.2f} s with "
          f"the roadmap load), rtde {n_rtde} ticks | SimRTDE(dynamics=True) "
          f"on the card: moveJ err {move_err:.2e} rad, play_ctraj "
          f"{n_play} waypoints, servo joint err mean "
          f"{sim.last_execution['joint_err_mean']:.5f} rad | "
          f"apps.eval_roadmap ur10 rot_variable_yaw: {got[0]} nodes, "
          f"{got[1]} edges, {got[2]} configured, disconnection "
          f"{got[3]:.6f} %, distance ratio {got[4]:.6f} rad/m | one /tick "
          f"of serve_teleop: {reply['status']}")
    bad = {a: g for a, g in gaps.items() if abs(g) > 0.10}
    if bad:
        raise AssertionError(f"teleop arms part from the JAX table's "
                             f"success rate by more than 0.10: {bad}")


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

    # --- 13. the scan loop through its entry point ------------------------
    import tempfile

    from reconplan_tpu_torch.apps.scan import make_arc_schedule, run_scan
    from reconplan_tpu_torch.grr import RedundancyResolution, scan_arc
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin import make_robot

    t0 = time.perf_counter()
    robot = make_robot(load_problem("ur10", "rot_free"))
    torch.cuda.synchronize()
    robot_s = time.perf_counter() - t0
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
    # the routine of grr_plan's IK fallback: FALLBACK_RESTARTS random
    # seeds a waypoint in one batch, here 64 waypoints x 16 = 1,024
    arc64 = scan_arc(OBJECT_POINT, radius=0.3, height=0.15, num_points=64)
    n_way, restarts = len(arc64), 16
    targets = np.repeat(arc64[:, :3], restarts, axis=0)
    seeds = robot.sample(n_way * restarts, rng=np.random.default_rng(0))
    # the solver's first call pays for the library handles of its 6x6
    # solves: a batch of two problems takes that out of the timed batch
    robot.solve_ik_batch(targets[:2], seeds[:2], max_iters=2)
    (qf, okf), ik_ms = once_ms(lambda: robot.solve_ik_batch(targets, seeds))
    _, ik_kernels, ik_busy_ms = profiled(
        lambda: robot.solve_ik_batch(targets, seeds))
    okf = okf.reshape(n_way, restarts)
    solved = okf.any(dim=1)
    first = okf.to(torch.int8).argmax(dim=1)
    qs = qf.reshape(n_way, restarts, -1)[torch.arange(n_way, device=dev),
                                         first][solved]
    n_ik_solved = int(solved.sum())
    if n_ik_solved < 56:  # every run so far solved 64 of 64
        raise AssertionError(f"IK solved {n_ik_solved} of {n_way} waypoints")
    ik_reach = (robot.fk_point_batch(qs)[:, :3] - torch.as_tensor(
        arc64[:, :3], device=dev)[solved]).norm(dim=-1).max().item()
    if not ik_reach < 1e-3:
        raise AssertionError(f"a solved configuration misses its waypoint "
                             f"by {ik_reach} m")
    phase("scan", f"UR10 on {robot.device}: {robot.rob.num_links} links, "
          f"{robot.num_joints} active joints, {n_geom} geometry links of 32 "
          f"spheres, make_robot {robot_s:.3f} s | golden FK of {len(ctraj)} "
          f"configs: position err {fk_pos_err:.3g} m, min |quat . conj| "
          f"{fk_dot:.8f}, {fk_ms:.3f} ms a batch (events)")
    phase("scan", f"fallback IK batch: solved {n_ik_solved} of {n_way} "
          f"waypoints ({int(okf.sum())} of {okf.numel()} restarts), worst "
          f"FK miss {ik_reach:.3g} m | batch of {okf.numel()}, "
          f"max_iters=100: {ik_ms:.1f} ms (CUDA events) | under the "
          f"profiler {ik_kernels} kernels and copies, {ik_busy_ms:.1f} ms on "
          f"the card: busy share {ik_busy_ms / ik_ms:.3f}")

    # the flagship scan with the CLI's defaults: 500 waypoints planned
    # through the committed roadmap, 12 pictures, fusion at 256^3, the
    # Poisson closure at 192^3 with the auto gate, and the pose-seeded
    # ICP stitch. run_scan builds a roadmap into roadmap_dir when it
    # finds none, which must never happen under graph/
    roadmap = os.path.join(REPO, "graph", "ur10", "rot_free")
    if not os.path.isfile(os.path.join(roadmap, "resolution.npz")):
        raise AssertionError(f"no committed roadmap in {roadmap}")
    n_scan = 500
    active_mask.launches = 0
    brick_integrate.launches = 0
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        scan = run_scan(roadmap_dir=roadmap, n_waypoints=n_scan, n_images=12,
                        grid_dim=256, reconstruct="both", close_mesh="auto",
                        close_depth=192, out_dir=out)
        scan_s = time.perf_counter() - t0
        per_scan = {"active_mask": active_mask.launches,
                    "brick_integrate": brick_integrate.launches}
        files = sorted(os.listdir(out))
        with open(os.path.join(out, "ctraj.txt")) as f:
            entries = re.findall(r"^[^,\n]+,(None|\[[^\]]*\])", f.read(),
                                 re.M)
        with open(os.path.join(out, "wtraj_input.txt")) as f:
            waypoints = np.array([[float(x) for x in re.findall(
                NUM, re.sub(r"np\.float32\(([^)]*)\)", r"\1", line))]
                for line in f])
        scan_v, scan_f = load_mesh(os.path.join(out, "fused_mesh.ply"))
        stitch_v, _ = load_mesh(os.path.join(out, "stitched_cloud.ply"))
    if files != ["best_mesh.ply", "closed_mesh.ply", "ctraj.txt",
                 "fused_mesh.ply", "stitched_cloud.ply", "trackarr.txt",
                 "wtraj.txt", "wtraj_input.txt"]:
        raise AssertionError(f"run_scan wrote {files}")
    plan = scan["plan"]
    solved = np.array([e != "None" for e in entries])
    n_solved = int(solved.sum())
    if not (len(entries) == len(waypoints) == plan["waypoints"] == n_scan
            and n_solved == plan["carried"] + plan["rescued"]):
        raise AssertionError(f"ctraj.txt has {len(entries)} entries, "
                             f"{n_solved} solved, for {len(waypoints)} "
                             f"waypoints; run_scan counted {plan}")
    if n_solved < 490 or plan["carried"] < 0.95 * JAX_CARRIED:
        raise AssertionError(f"solved {n_solved} of {n_scan} waypoints, "
                             f"{plan['carried']} by the roadmap (the JAX "
                             f"package: {JAX_SOLVED}, {JAX_CARRIED})")
    # every solved configuration reaches its waypoint by FK on the card
    q_solved = np.array([[float(x) for x in e.strip("[]").split()]
                         for e in entries if e != "None"], np.float32)
    reach = np.linalg.norm(robot.fk_point_batch(q_solved)[:, :3].cpu().numpy()
                           - waypoints[solved, :3], axis=-1).max()
    if not reach < 1e-3:
        raise AssertionError(f"a solved configuration misses its waypoint "
                             f"by {reach} m")
    scan_voxel = 0.3 / (256 - 1)
    scan_gt_v, scan_gt_f = load_mesh(BANANA_MESH)
    scan_gt = torch.as_tensor((scan_gt_v + np.asarray(OBJECT_POINT))[
        scan_gt_f], dtype=torch.float32, device=dev)
    mesh_to_gt = points_to_mesh_distance(torch.unique(torch.as_tensor(
        scan_v, dtype=torch.float32, device=dev), dim=0), scan_gt)
    mesh_to_gt_mm = mesh_to_gt.mean().item() * 1e3
    if not (len(scan_f) and math.isfinite(mesh_to_gt_mm)
            and mesh_to_gt_mm < 2 * scan_voxel * 1e3):
        raise AssertionError(f"scan mesh -> ground truth {mesh_to_gt_mm} mm "
                             f"(limit {2 * scan_voxel * 1e3} mm)")
    for name, count in per_scan.items():
        if count == 0:
            raise AssertionError(f"the scan's fusion never launched {name}")
        launches[name] += count
    stages = scan["stage_timings"]
    # the reconstruct half: the stitched cloud on the object, the closed
    # and stitched Chamfers beside the JAX package's, and the gate
    stitch_to_gt = points_to_mesh_distance(torch.as_tensor(
        stitch_v, dtype=torch.float32, device=dev), scan_gt)
    stitch_to_gt_mm = stitch_to_gt.mean().item() * 1e3
    if not (len(stitch_v) and stitch_to_gt_mm <= 1.0):
        raise AssertionError(f"stitched cloud -> ground truth "
                             f"{stitch_to_gt_mm} mm (limit 1 mm)")
    st_ch, st_ab, st_ba = chamfer_to_mesh(
        torch.as_tensor(stitch_v, dtype=torch.float32, device=dev),
        scan_gt_v + np.asarray(OBJECT_POINT), scan_gt_f)
    for key, want in (("closed_chamfer_mm", JAX_CLOSED_MM),
                      ("stitch_chamfer_mm", JAX_STITCH_MM)):
        if not abs(scan[key] - want) <= 0.1 * want:
            raise AssertionError(f"{key} {scan[key]} mm, the JAX package's "
                                 f"{want} mm: more than 10% apart")
    gate = scan["close_gate"]
    proxies = (gate["proxy_open_mm"], gate["proxy_closed_mm"])
    near_tie = abs(proxies[0] - proxies[1]) <= 0.05 * max(proxies)
    if gate["best"] != JAX_GATE[0] and not near_tie:
        raise AssertionError(f"the gate kept {gate['best']} (proxies "
                             f"{proxies}), the JAX package {JAX_GATE}")
    best_pre = {"open": "fuse", "closed": "closed"}[scan["best_mesh"]]
    # a second solve_batch of the first 32 waypoints, timed alone and
    # under the profiler
    grr = RedundancyResolution(robot)
    grr.load_resolution_graph(os.path.join(roadmap, "resolution.npz"))
    grr.load_workspace_graph(os.path.join(roadmap, "workspace.npz"))
    arc = make_arc_schedule(1, n_scan)[0]
    _, sb_ms = once_ms(lambda: grr.solve_batch(arc[:32]))
    _, sb_kernels, sb_busy_ms = profiled(lambda: grr.solve_batch(arc[:32]))
    phase("scan", f"run_scan on graph/ur10/rot_free, {n_scan} waypoints: "
          f"solved {n_solved} ({plan['carried']} carried by the roadmap, "
          f"{plan['rescued']} rescued by the IK fallback; the JAX package "
          f"on the CPU: {JAX_CARRIED} and {JAX_SOLVED}), worst FK miss "
          f"{reach:.3g} m | plan {stages['plan']:.3f} s, "
          f"{stages['plan'] * 1e3 / n_scan:.2f} ms a waypoint | "
          f"run_scan {scan_s:.3f} s")
    phase("scan", f"solve_batch of 32 waypoints: {sb_ms:.1f} ms (CUDA "
          f"events), {sb_ms / 32:.2f} ms a waypoint | under the profiler "
          f"{sb_kernels} kernels and copies ({sb_kernels / 32:.0f} a "
          f"waypoint), {sb_busy_ms:.2f} ms on the card: busy share "
          f"{sb_busy_ms / sb_ms:.3f}")
    # one stitched frame alone: two of the scan's views (camera on the
    # arc, looking at the object) through the scan's stitcher settings,
    # the first append and one registered frame, timed and profiled
    from reconplan_tpu_torch.recon.stitcher import (
        PinholeIntrinsic, RGBDStitcher)

    view = SplatCamera(**D435)
    view.add_mesh_file(BANANA_MESH, translate=OBJECT_POINT)
    shots = [view.take_picture(arc[i, :3], OBJECT_POINT) for i in (0, 45)]
    pair_poses = np.stack([sh[2] for sh in shots])

    def stitch_pair():
        st = RGBDStitcher(PinholeIntrinsic(640, 480, **D435))
        st.voxel_size, st.distance_threshold, st.model_capacity = (
            0.004, 0.02, 8192)
        return st.stitch_sequence([sh[1] for sh in shots],
                                  [sh[0] for sh in shots], poses=pair_poses)

    stitch_pair()
    _, pair_ms = once_ms(stitch_pair)
    _, pair_kernels, pair_busy_ms = profiled(stitch_pair)
    # the batched 3x3 eigh of the normals: the model's 8,192 slots (the
    # stitch) and the 80,000 observation points (the close stage)
    # (batched_eigh, in batches of EIGH_BATCH), and the batch sizes that
    # one torch.linalg.eigh call takes on this card
    from reconplan_tpu_torch.ops.pointcloud import EIGH_BATCH, batched_eigh

    eig_ms, eig_raw = {}, {}
    for n in (8192, 80_000):
        a = torch.randn(n, 16, 3, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        cov = (a[..., :, None] * a[..., None, :]).mean(dim=1)
        batched_eigh(cov)
        eig_ms[n] = statistics.median(
            once_ms(lambda: batched_eigh(cov))[1] for _ in range(5))
    for n in (16384, 32768, 65536, 80_000):
        try:
            torch.linalg.eigh(cov[:n])
            torch.cuda.synchronize()
            eig_raw[n] = "ok"
        except RuntimeError as e:  # the probe's answer, printed below
            eig_raw[n] = type(e).__name__
    phase("scan", f"stitch {stages['stitch']:.3f} s for 11 registered frames | poisson_close {stages['poisson_close']:.3f} s"
          f" | close_gate {stages['close_gate']:.3f} s | one stitched frame "
          f"(a two-picture stitch_sequence, 8,192 slots): {pair_ms:.1f} ms "
          f"(CUDA events), under the profiler {pair_kernels} kernels and "
          f"copies, {pair_busy_ms:.2f} ms on the card: busy share "
          f"{pair_busy_ms / pair_ms:.3f} | eigh of 8,192 3x3 "
          f"{eig_ms[8192]:.3f} ms, of 80,000 {eig_ms[80_000]:.3f} ms (in "
          f"batches of {EIGH_BATCH}) | one eigh call by batch size: "
          + json.dumps(eig_raw))
    phase("scan", f"stitched cloud {len(stitch_v)} points -> ground truth "
          f"mean {stitch_to_gt_mm:.4f} mm | stitch Chamfer "
          f"{scan['stitch_chamfer_mm']:.4f} mm (JAX on the CPU "
          f"{JAX_STITCH_MM:.4f}; cloud -> gt {st_ab * 1e3:.4f}, gt -> cloud "
          f"{st_ba * 1e3:.4f}) | closed Chamfer "
          f"{scan['closed_chamfer_mm']:.4f} mm (JAX {JAX_CLOSED_MM:.4f}; "
          f"mesh -> gt {scan['closed_chamfer_ab_mm']:.4f}, gt -> mesh "
          f"{scan['closed_chamfer_ba_mm']:.4f}) | best {scan['best_mesh']} "
          f"{scan['best_chamfer_mm']:.4f} mm (mesh -> gt "
          f"{scan[best_pre + '_chamfer_ab_mm']:.4f}, gt -> mesh "
          f"{scan[best_pre + '_chamfer_ba_mm']:.4f}) | gate "
          + json.dumps(gate) + f" (JAX: {JAX_GATE})")
    phase("scan", f"12 pictures -> {len(scan_f)} triangles at 256^3, voxel "
          f"{scan_voxel * 1e3:.4f} mm | mesh -> ground truth mean "
          f"{mesh_to_gt_mm:.4f} mm, max {mesh_to_gt.max().item() * 1e3:.4f} "
          f"mm | fuse Chamfer {scan['fuse_chamfer_mm']:.4f} mm (mesh -> gt "
          f"{scan['fuse_chamfer_ab_mm']:.4f}, gt -> mesh "
          f"{scan['fuse_chamfer_ba_mm']:.4f}) | K2 / K1 launches "
          f"{per_scan['active_mask']} / {per_scan['brick_integrate']} | "
          "stages s (synchronised): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f" | {card}")
    del grr, scan_gt, shots, view

    # --- 14. the roadmap layer ------------------------------------------
    from reconplan_tpu_torch.apps.redundancy import build_roadmap
    from reconplan_tpu_torch.grr import evaluate_roadmap
    from reconplan_tpu_torch.io.checkpoint import load_roadmap_npz
    from reconplan_tpu_torch.utils.native import GraphCore

    ws = load_roadmap_npz(os.path.join(REPO, "graph/ur10/rot_fixed",
                                       "workspace.npz"))
    n_ws = len(ws["points"])
    gc = GraphCore(n_ws, ws["edges"], ws["edge_weights"])
    if not gc.native:
        raise AssertionError("GraphCore took its Python fallback: the "
                             "native library did not build or load")
    t0 = time.perf_counter()
    labels, n_comp = gc.components()
    hops = gc.bfs_distances(0)
    far = int(np.argmax(hops))
    path = gc.shortest_path(0, far)
    ring = gc.k_layer_neighbors(0, 4)
    gc_ms = (time.perf_counter() - t0) * 1e3
    py = GraphCore(n_ws, ws["edges"], ws["edge_weights"])
    py._lib = None
    if not (np.array_equal(py.components()[0], labels)
            and np.array_equal(py.bfs_distances(0), hops)
            and py.shortest_path(0, far) == path
            and sorted(py.k_layer_neighbors(0, 4)) == sorted(ring)):
        raise AssertionError("GraphCore's native answers differ from its "
                             "Python fallback's")
    phase("roadmap", f"GraphCore native on graph/ur10/rot_fixed ({n_ws} "
          f"nodes, {len(ws['edges'])} edges): {n_comp} components, "
          f"shortest path 0 -> {far} of {len(path)} nodes, {len(ring)} "
          f"nodes within 4 hops, {gc_ms:.3f} ms for the four queries; equal "
          "to the Python fallback")
    for name, (problem, floor_check, want) in ROADMAPS.items():
        res = RedundancyResolution(make_robot(load_problem("ur10", problem),
                                              floor_check=floor_check))
        folder = os.path.join(REPO, "graph", "ur10", name)
        res.load_resolution_graph(os.path.join(folder, "resolution.npz"))
        res.load_workspace_graph(os.path.join(folder, "workspace.npz"))
        res.load_solver_graph(os.path.join(folder, "solver.npz"))
        if not (res.configs_t.is_cuda and res.points_t.is_cuda):
            raise AssertionError(f"{name}: the roadmap is not on the card")
        m = evaluate_roadmap(res, verbose=False)
        got = tuple(m[k] for k in ("n_nodes", "n_edges", "n_configured",
                                   "disconnection_ratio", "distance_ratio"))
        # counts exact; the two ratios within 1e-5 relative: the card
        # contracts multiply-adds into FMAs, and the quaternion term
        # 1 - |q1 . q2| of a millimetre edge keeps few digits in f32
        # (rot_free's distance ratio reads 1.6e-6 apart)
        if not (got[:3] == want[:3] and all(
                abs(g - w) <= 1e-5 * abs(w) for g, w in zip(got[3:],
                                                            want[3:]))):
            raise AssertionError(f"{name}: evaluate_roadmap gives {got}, "
                                 f"the CPU test {want}")
        phase("roadmap", f"{name} on the card (floor_check={floor_check}): "
              f"{got[0]} nodes, {got[1]} edges, {got[2]} configured, "
              f"disconnection {got[3]:.6f} %, distance ratio {got[4]:.6f} "
              f"rad/m ({got[4] / want[4] - 1:+.2e} from the CPU test's)")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        res, m = build_roadmap("ur10", "rot_free", n_pos_points=40,
                               out_dir=out, verbose=False)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        files = sorted(os.listdir(out))
    if files != ["resolution.npz", "solver.npz", "workspace.npz"]:
        raise AssertionError(f"build_roadmap wrote {files}")
    miss = np.linalg.norm(res.robot.fk_point_batch(res.configs)[:, :3]
                          .cpu().numpy() - res.points[:, :3], axis=-1).max()
    if not (m["n_configured"] > 0 and miss < 1e-3):
        raise AssertionError(f"build_roadmap configured {m['n_configured']} "
                             f"nodes, worst FK miss {miss} m")
    phase("roadmap", f"build_roadmap ur10 rot_free, 40 nodes (a reduced "
          f"depth: the committed roadmap has 500, and 40 keep the smoke "
          f"inside its time limit): {build_s:.2f} s, {m['n_configured']} "
          f"of {m['n_nodes']} configured, disconnection "
          f"{m['disconnection_ratio']:.3f} %, distance ratio "
          f"{m['distance_ratio']:.3f} rad/m, worst FK miss {miss:.3g} m | "
          "written to a temporary directory")

    # --- 15. the stitch's pose-free route and the card against the CPU ---
    from reconplan_tpu_torch.ops import icp as icp_ops
    from reconplan_tpu_torch.ops import pointcloud as pc_ops
    from reconplan_tpu_torch.recon.poisson import poisson_reconstruct

    # the scene of tests/test_recon_io.py's pose-free viewpoint jump: six
    # 160x120 frames (fx = 100), two clusters split by an azimuth jump
    obj = np.asarray(OBJECT_POINT)
    small = SplatCamera(width=160, height=120, fx=100, fy=100, cx=80, cy=60,
                        samples_per_mesh=300_000)
    small.add_mesh_file(BANANA_MESH, translate=tuple(obj))
    shots = [small.take_picture(obj + [0.35 * math.cos(a),
                                       0.35 * math.sin(a), 0.25], obj)
             for a in (2.0, 2.1, 2.2, 3.2, 3.3, 3.4)]
    pose0 = shots[0][2]
    st = RGBDStitcher(PinholeIntrinsic(160, 120, 100, 100, 80, 60))
    st.voxel_size, st.distance_threshold, st.model_capacity = (0.004, 0.02,
                                                               8192)
    t0 = time.perf_counter()
    cloud = st.stitch_sequence([sh[1] for sh in shots],
                               [sh[0] for sh in shots], poses=None)
    free_pts = cloud.compact()[0]
    free_s = time.perf_counter() - t0
    world = free_pts @ pose0[:3, :3].T + pose0[:3, 3]
    center_err = float(np.linalg.norm(world.mean(axis=0)[:2] - obj[:2]))
    spread = float(np.linalg.norm(world - world.mean(axis=0), axis=1).max())
    chained, accepted = st.last_scores.T
    rescued = int(((chained < st.global_rescue_score)
                   & (accepted > chained)).sum())
    dropped = int((accepted < st.integrate_score_floor).sum())
    if not (center_err < 0.03 and spread < 0.2):
        raise AssertionError(f"pose-free stitch: centre off by {center_err} "
                             f"m, spread {spread} m")
    phase("stitch", f"pose-free, 6 frames of 160x120 across an azimuth "
          f"jump, 8,192 slots: {free_s:.2f} s, {len(free_pts)} points, "
          f"{rescued} frames rescued by FPFH + RANSAC, {dropped} dropped | "
          f"centre error {center_err * 1e3:.2f} mm (limit 30), spread "
          f"{spread:.4f} m (limit 0.2) | tight scores chained "
          f"{np.round(chained, 3).tolist()}, accepted "
          f"{np.round(accepted, 3).tolist()}")
    # the Poisson solve on a seeded sphere: the splat adds atomically on
    # the card, in no fixed order, so chi agrees within a tolerance
    rng = np.random.default_rng(0)
    sph = rng.normal(size=(20000, 3))
    sph /= np.linalg.norm(sph, axis=-1, keepdims=True)
    sph_pts, sph_nrm = (0.1 * sph).astype(np.float32), sph.astype(np.float32)
    poisson_reconstruct(sph_pts, sph_nrm, depth=128)
    (tris_c, grid_c), poi_ms = once_ms(lambda: poisson_reconstruct(
        sph_pts, sph_nrm, depth=128, return_grid=True))
    tris_h, grid_h = poisson_reconstruct(sph_pts, sph_nrm, depth=128,
                                         return_grid=True, device="cpu")
    chi_err = ((grid_c.sdf.cpu() - grid_h.sdf).abs().max()
               / grid_h.sdf.abs().max()).item()
    if not (chi_err <= 1e-4 and abs(len(tris_c) - len(tris_h))
            <= 0.01 * len(tris_h)):
        raise AssertionError(f"poisson on the card: chi err {chi_err} of the "
                             f"peak, {len(tris_c)} triangles against the "
                             f"CPU's {len(tris_h)}")
    # estimate_normals and the three ICPs, the card against the CPU
    bumps = sph * (0.5 + 0.05 * np.sin(5 * sph[:, :1])
                   + 0.04 * np.cos(7 * sph[:, 1:2]))
    src_np = bumps[:1500].astype(np.float32)
    dst_np = src_np + np.float32([0.02, -0.01, 0.015])
    cols = np.repeat(0.5 + 0.5 * np.sin(7 * src_np[:, :1]), 3, 1).astype(
        np.float32)
    icp_out, nrm_out = [], []
    for where in ("cuda", "cpu"):
        src = pc_ops.make_cloud(src_np, colors=cols, device=where)
        tgt = pc_ops.estimate_normals(pc_ops.make_cloud(
            dst_np, colors=cols, device=where), k=12)
        nrm_out.append(tgt.normals.cpu())
        icp_out.append([
            icp_ops.icp_point_to_point(src, tgt, 0.1),
            icp_ops.icp_point_to_plane(src, tgt, 0.1),
            icp_ops.colored_icp(src, tgt, icp_ops.color_gradients(tgt), 0.1)])
    nrm_dot = (nrm_out[0] * nrm_out[1]).sum(-1).min().item()
    icp_lines = []
    for name, a, b in zip(("point_to_point", "point_to_plane", "colored"),
                          *icp_out):
        t_err = (a.transformation.cpu() - b.transformation).abs().max().item()
        if not (int(a.iterations) == int(b.iterations) and t_err <= 1e-5):
            raise AssertionError(f"{name} ICP on the card: {int(a.iterations)}"
                                 f" iterations against {int(b.iterations)}, "
                                 f"T err {t_err}")
        icp_lines.append(f"{name} {int(a.iterations)} iterations, T err "
                         f"{t_err:.3g}")
    if not nrm_dot > 1 - 1e-5:
        raise AssertionError(f"estimate_normals on the card: min n . n' "
                             f"{nrm_dot}")
    phase("stitch", f"poisson_reconstruct at 128^3 of 20,000 sphere points "
          f"{poi_ms:.1f} ms (CUDA events): chi err {chi_err:.3g} of the peak "
          f"(limit 1e-4), {len(tris_c)} triangles (CPU {len(tris_h)}) | "
          f"estimate_normals min n . n' {nrm_dot:.8f} | "
          + "; ".join(icp_lines) + " (the card against the CPU)")
    del small, shots, grid_c, grid_h

    # --- 16. the teleop half -----------------------------------------
    teleop_phase(card)

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
