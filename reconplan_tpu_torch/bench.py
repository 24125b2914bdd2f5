"""Measure brick TSDF integration throughput at 512^3 on one CUDA card.

The counterpart of the JAX package's root ``bench.py``, on the same scene:
32 synthetic 640x480 depth frames of a sphere on an orbit
(:func:`make_frames`), a 512^3 brick grid, ``max_active=8192``. It
integrates the 32 frames into a live grid after a warm-up, timed with
CUDA events, and one batch into a fresh grid (``cold_grid_fps``), and
prints one JSON line:

    {"metric": ..., "value": fps, "unit": "frames/sec",
     "cold_grid_fps": ..., "device": ..., "power_limit_w": ...}

Run: ``python -m reconplan_tpu_torch.bench``. It needs a CUDA card and
exits nonzero without one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

N = 512
N_FRAMES = 32
ORIGIN = (-0.4, -0.4, -0.3)
VOXEL = 0.8 / (N - 1)
MAX_ACTIVE = 8192


def make_frames(n_frames, H=480, W=640, fx=615.67, fy=615.96):
    """Analytic depth (mm) of a 0.12 m sphere from an orbit of radius 0.5 m.
    Returns (depths (F, H, W) f32, poses cam->world (F, 4, 4) f32, K)."""
    cx, cy = W / 2.0, H / 2.0
    depths, poses = [], []
    for k in range(n_frames):
        ang = 2 * np.pi * k / n_frames
        eye = np.array([0.5 * np.cos(ang), 0.5 * np.sin(ang), 0.1])
        z = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(up, z); x /= np.linalg.norm(x)
        y = np.cross(z, x)
        T = np.eye(4); T[:3, :3] = np.stack([x, y, z], 1); T[:3, 3] = eye
        poses.append(T)
        u = (np.arange(W) - cx) / fx
        v = (np.arange(H) - cy) / fy
        uu, vv = np.meshgrid(u, v)
        dirs = np.stack([uu, vv, np.ones_like(uu)], -1) @ T[:3, :3].T
        a = np.sum(dirs * dirs, -1)
        b = 2 * np.sum(dirs * eye, -1)
        c = np.dot(eye, eye) - 0.12**2
        disc = b * b - 4 * a * c
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
        depths.append(np.where(t > 0, t, 0.0).astype(np.float32) * 1000.0)
    return np.stack(depths), np.stack(poses).astype(np.float32), (fx, fy, cx, cy)


def time_ms(fn, reps, warmup=1):
    """Mean milliseconds per call of ``fn`` on the current stream, from
    CUDA events around ``reps`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    from reconplan_tpu_torch.ops import tsdf_brick as tb
    from reconplan_tpu_torch.utils.device import card_summary, resolve_device

    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        sys.exit(1)
    dev = resolve_device("cuda")
    depths, poses, K = make_frames(N_FRAMES)
    depths_d = torch.as_tensor(depths, device=dev)  # staged once
    poses_d = torch.as_tensor(poses, device=dev)

    def integrate(grid):
        return tb.integrate_frames_bricked_device(
            grid, depths_d, poses_d, *K, max_active=MAX_ACTIVE)

    grid = tb.make_brick_grid((N,) * 3, ORIGIN, VOXEL, device=dev)
    # warm-up: builds the kernels, then steady-state batches into the
    # live grid, the best of 3 runs of 5 batches
    ms = min(time_ms(lambda: integrate(grid), reps=5) for _ in range(3))
    cold_grid = tb.make_brick_grid((N,) * 3, ORIGIN, VOXEL, device=dev)
    cold_ms = time_ms(lambda: integrate(cold_grid), reps=1, warmup=0)
    name, limit = (s.strip() for s in card_summary().splitlines()[0].split(","))
    print(json.dumps({
        "metric": f"TSDF integration throughput @ {N}^3 voxels, 640x480 depth",
        "value": N_FRAMES / (ms / 1e3),
        "unit": "frames/sec",
        "cold_grid_fps": N_FRAMES / (cold_ms / 1e3),
        "device": name,
        "power_limit_w": _watts(limit),
    }))


def _watts(limit):
    """'700.00 W' -> 700.0; None where nvidia-smi reports no number."""
    try:
        return float(limit.split()[0])
    except (IndexError, ValueError):
        return None


if __name__ == "__main__":
    main()
