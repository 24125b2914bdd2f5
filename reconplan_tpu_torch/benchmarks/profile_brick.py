"""The brick bench's time split by stage, and the ablation arms of K1, on
one CUDA card.

The counterpart of the TPU tool ``benchmarks/profile_brick.py``, on the
bench scene (``reconplan_tpu_torch.bench``: 32 frames of 640x480, 512^3,
``MAX_ACTIVE=8192``, 4 chunks of 8). Every ``*_ms`` is per 32-frame batch:

(a) ``full_pipeline_ms``: ``integrate_frames_bricked_device``.
(b) ``mask_pipeline_ms``: ``chunk_active_set`` for the 4 chunks, and its
    stages, the functions it calls in order, each timed alone on the
    previous stage's outputs: ``mask_occ_ms`` (``_build_depth_occupancy``),
    ``mask_bits_ms`` (K2 ``active_mask``), ``mask_refine_ms``
    (``refine_frame_bits``) and ``mask_argsort_ms`` (``compact_active``:
    the stable-argsort ``compact_ids`` and the frame-bit gather). The TPU
    tool timed jitted prefixes of the pipeline; eager PyTorch times each
    stage on its own, so the stages sum to about the whole.
(b3) ``compact_argsort_ms`` against ``compact_topk_ms``: 4 compactions of
    chunk 0's mask by the production ``compact_ids`` and by the same with
    ``torch.topk`` on keys that put the actives first in index order in
    place of its stable argsort; the two must return the same ids.
(c) the ids / frame bits / live count of each chunk precomputed, then
    ``kernel_production_ms`` (K1) and ``kernel_<arm>_ms`` for each arm of
    ``ops/kernels/brick_ablate.py``. The TPU arms with no CUDA counterpart
    print as ``null``, with the reason, under ``null_arms``.

Before any ablation time, the parity gate holds ``full`` against K1 on
chunk 0: the planes must be bit-identical, or it raises.

Timing follows the TPU tool's ``timed()``: the live state is threaded
through the steps; one warm-up step, then the best of ``reps`` means over
``inner`` batches, from CUDA events. The pipeline is bound by the host's
launches, so event time alone cannot show what the card does: each stage
also gets ``<key>_device_ms``, the time per batch of the kernels (and
copies) that ``torch.profiler`` recorded on the card over ``inner``
batches (the median of 3 sessions), in a second pass after every event
time, so that no profiler session runs before a timed launch.
``full_pipeline_after_profiler_ms``, the event time of (a) taken again
after that pass, shows what the sessions do to the host's later
launches. The profiler lists each kernel under its torch op and again by
its own name; only the latter, the device events, are summed, once
each.

The live counts and (brick, frame) hits of the chunks go to stderr; stdout
gets one JSON line with the keys above, ``device`` and ``power_limit_w``.

Run: ``python -m reconplan_tpu_torch.benchmarks.profile_brick``. It needs
a CUDA card and exits nonzero without one.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from reconplan_tpu_torch.bench import (
    MAX_ACTIVE,
    N,
    ORIGIN,
    VOXEL,
    _watts,
    make_frames,
    time_ms,
)
from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.ops.kernels import (
    active_mask,
    brick_ablate,
    brick_integrate,
)
from reconplan_tpu_torch.ops.kernels.brick_ablate import ARMS
from reconplan_tpu_torch.utils.device import card_summary

F_ALL = 32
CHUNK = 8
DEPTH_SCALE, DEPTH_MAX, MAX_WEIGHT = 1000.0, 3.0, 64.0
# CUDA arm -> the TPU arms (of _ablate_kernel / _ablate_kernel2) it answers
TPU_ARMS = {
    "full": ["full", "full2"],
    "no_fbits": ["no_fbits"],
    "no_gather": ["no_window"],
    "one_row": ["no_rowloop"],
    "rw_only": ["dma_only"],
    "smem_window": ["dmahbm2"],
    # what the CUDA K1 alone is made of: no TPU arm asks these
    "no_skips": [],
    "static_stride": [],
    "pr1_full": [],
}
_NO_ROLLS = "the CUDA K1 reads depth by address and has no window rolls"
NULL_ARMS = {
    "no_rolls": _NO_ROLLS,
    "no_roll_u": _NO_ROLLS,
    "no_roll_v": _NO_ROLLS,
    "noroll2": _NO_ROLLS,
    "no_prologue": "the CUDA K1 has no footprint prologue to replace; "
                   "one_row and smem_window carry it",
    "noladder2": "the CUDA K1 has no SAMPLE_BRANCHES cond ladder",
    "nostraddle2": "the CUDA K1 has no 128-lane window to straddle",
    "flat2": "ladder, straddle and rolls together: none is in the CUDA K1",
}


def device_ms(fn, inner):
    """Kernel (and copy) time per call of ``fn`` on the card, from
    ``torch.profiler`` over ``inner`` calls: the device events, each once,
    as the median of 3 sessions. A session of about a millisecond once
    recorded none of its kernels, so each also idles the host 20 ms
    before and after the calls, away from the session's edges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    us = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(inner):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        us.append(sum(e.device_time_total for e in prof.events()
                      if e.device_type == DeviceType.CUDA))
    return statistics.median(us) / 1e3 / inner


def threaded(state, step):
    """A call that threads the live ``state`` through ``step``, as the TPU
    tool's ``timed()`` does."""
    live = [state]

    def batch():
        live[0] = step(live[0])

    return batch


def event_ms(batch, reps, inner):
    """One warm-up call, then the best of ``reps`` CUDA-event means over
    ``inner`` calls."""
    batch()
    return min(time_ms(batch, reps=inner, warmup=0) for _ in range(reps))


def compact_topk(mask, size, fill):
    """``tb.compact_ids`` with a partial sort in place of its stable
    argsort (``size`` <= the mask's length): keys 2n - i for actives and
    n - i for the rest put the actives first, each group in index order."""
    n = mask.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    key = torch.where(mask, 2 * n - idx, n - idx)
    ids = torch.topk(key, size).indices
    slot = torch.arange(size, device=mask.device)
    return torch.where(slot < mask.sum(), ids, fill).to(torch.int32)


def run(reps=5, inner=3, log=sys.stderr):
    """Measure the stage split and the ablation arms; returns the dict
    that :func:`main` prints. Raises without a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_brick needs a CUDA card")
    dev = torch.device("cuda")
    depths, poses, K = make_frames(F_ALL)
    d_all = torch.as_tensor(depths, device=dev)
    p_all = torch.as_tensor(poses, device=dev)
    intr = tuple(float(np.float32(v)) for v in K)

    def fresh():
        return tb.make_brick_grid((N,) * 3, ORIGIN, VOXEL, device=dev)

    out = {}
    grid = fresh()
    bd, origin, trunc = grid.brick_dims, grid.origin, grid.trunc
    nb = bd[0] * bd[1] * bd[2]
    del grid
    T_all = torch.linalg.inv(p_all)
    chunks = [(d_all[f0:f0 + CHUNK], T_all[f0:f0 + CHUNK].contiguous())
              for f0 in range(0, F_ALL, CHUNK)]
    cell = tb._occupancy_cell(*d_all.shape[1:])

    def active_sets(_=None):
        return [tb.chunk_active_set(d, T, intr, origin, bd, VOXEL, trunc,
                                    MAX_ACTIVE, nb) for d, T in chunks]

    def occ_stage(_=None):
        return [tb._build_depth_occupancy(d, DEPTH_SCALE, DEPTH_MAX, cell)
                for d, _ in chunks]

    occ = occ_stage()

    def bits_stage(_=None):
        return [active_mask(bd, origin, VOXEL, trunc, *o, T, *intr,
                            mip_cell=cell) for o, (_, T) in zip(occ, chunks)]

    bits = bits_stage()

    def refine_stage(_=None):
        return [tb.refine_frame_bits(b, d, T, intr, origin, bd, VOXEL, trunc,
                                     MAX_ACTIVE, DEPTH_SCALE, DEPTH_MAX)
                for b, (d, T) in zip(bits, chunks)]

    refined = refine_stage()

    def argsort_stage(_=None):
        return [tb.compact_active(r, MAX_ACTIVE, nb) for r in refined]

    # (b3) compaction A/B on chunk 0's mask: the same ids first
    mask0 = refined[0] != 0
    if not torch.equal(tb.compact_ids(mask0, MAX_ACTIVE, nb),
                       compact_topk(mask0, MAX_ACTIVE, nb)):
        raise AssertionError("top-k compaction differs from the argsort's")

    # (c) the active sets precomputed for the kernels alone
    pre = [(ids, fbits, n, T, intr, d, origin, bd, VOXEL, trunc,
            DEPTH_SCALE, DEPTH_MAX, MAX_WEIGHT)
           for (ids, fbits, n, _), (d, T) in zip(active_sets(), chunks)]
    live = [int(p[2].item()) for p in pre]
    hits = [sum(bin(b).count("1") for b in p[1][:k].tolist())
            for p, k in zip(pre, live)]
    print(f"[chunks] live bricks = {live}", file=log)
    print(f"[chunks] (brick, frame) hits = {hits} (total {sum(hits)})",
          file=log)

    def k1(g, a):
        ids, fbits, n, T, intr_, d, *rest = a
        brick_integrate(g.sdf, g.weight, None, ids, fbits, n, T, intr_, d,
                        None, *rest)

    # parity gate: the ablation kernel's `full` must equal K1 bit for bit
    g1, g2 = fresh(), fresh()
    k1(g1, pre[0])
    brick_ablate("full", g2.sdf, g2.weight, *pre[0])
    if not (torch.equal(g1.sdf, g2.sdf) and torch.equal(g1.weight,
                                                        g2.weight)):
        raise AssertionError("ablation arm `full` differs from K1")
    print("[parity] full vs K1 on chunk 0: bit-identical", file=log)
    del g1, g2

    def kernel_step(arm):
        def step(g):
            for a in pre:
                if arm == "production":
                    k1(g, a)
                else:
                    brick_ablate(arm, g.sdf, g.weight, *a)
            return g

        return step

    def no_state():
        return None

    # (key, initial state, step)
    stages = [
        ("full_pipeline", fresh,
         lambda g: tb.integrate_frames_bricked_device(
             g, d_all, p_all, *K, max_active=MAX_ACTIVE)[0]),
        ("mask_pipeline", no_state, active_sets),
        ("mask_occ", no_state, occ_stage),
        ("mask_bits", no_state, bits_stage),
        ("mask_refine", no_state, refine_stage),
        ("mask_argsort", no_state, argsort_stage),
    ] + [
        (f"compact_{name}", no_state,
         lambda _, fn=fn: [fn(mask0, MAX_ACTIVE, nb) for _ in range(4)])
        for name, fn in (("argsort", tb.compact_ids), ("topk", compact_topk))
    ] + [
        (f"kernel_{arm}", fresh, kernel_step(arm))
        for arm in ("production",) + ARMS
    ]
    # Every event time comes before the first profiler session; the full
    # pipeline's event time, taken again last, shows what the sessions do
    # to later launches. A grid lives for one stage only, so one 1 GiB
    # pair of 512^3 planes is held at a time.
    for key, init, step in stages:
        batch = threaded(init(), step)
        out[key + "_ms"] = event_ms(batch, reps, inner)
        del batch
    for key, init, step in stages:
        batch = threaded(init(), step)
        batch()
        out[key + "_device_ms"] = device_ms(batch, inner)
        del batch
    key, init, step = stages[0]
    batch = threaded(init(), step)
    out[key + "_after_profiler_ms"] = event_ms(batch, reps, inner)
    del batch
    for arm in NULL_ARMS:
        out[f"kernel_{arm}_ms"] = None
    out["null_arms"] = NULL_ARMS
    out["tpu_arms"] = TPU_ARMS
    out["live_bricks"] = live
    out["hits"] = hits
    out["note"] = (f"ms per {F_ALL}-frame batch ({F_ALL // CHUNK} chunks of "
                   f"{CHUNK}); best of {reps} CUDA-event means over {inner} "
                   "batches; *_device_ms: device events per batch from "
                   "torch.profiler; *_after_profiler_ms: the event time "
                   "again after the profiler sessions")
    name, limit = (s.strip() for s in card_summary().splitlines()[0]
                   .split(","))
    out["device"] = name
    out["power_limit_w"] = _watts(limit)
    return out


def main():
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        sys.exit(1)
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
