"""The depth-sampling microprobe on one CUDA card: should a kernel stage
its depth window in shared memory, or read each row from global memory
(L1/L2)?

The counterpart of the TPU probe ``benchmarks/probe_sublane_ops.py``,
which asked which dynamic sublane alignment Mosaic prefers for K1's VMEM
window (a roll, a dynamic slice or per-row loads). The CUDA K1 has no
window and reads depth by address; its ablation arm ``smem_window``
stages one. This probe asks the same question at the TPU probe's shapes,
``H=32, W=256, LOOP=24`` and ``s0`` in {0, 5}, with the four arms of
``ops/kernels/gather_probe.py`` on a grid of 2048 blocks. Each arm is
first held against its plain version (bit-identical, or it raises), then
timed with CUDA events over 20 calls, as is the plain version.

Prints one JSON line: ms per arm (mean over ``s0``), per ``s0``, the plain
versions' ms, the error, the card's name and power limit.

Run: ``python -m reconplan_tpu_torch.benchmarks.probe_sublane_ops``. It
needs a CUDA card and exits nonzero without one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from reconplan_tpu_torch.bench import _watts, time_ms
from reconplan_tpu_torch.ops.kernels import (
    gather_probe,
    gather_probe_reference,
)
from reconplan_tpu_torch.ops.kernels.gather_probe import ARMS, H, LOOP, W
from reconplan_tpu_torch.utils.device import card_summary

S0S = (0, 5)
REPS = 20
SEED = 0


def run():
    """Check and time every arm at both shifts; returns the dict that
    :func:`main` prints. Raises without a CUDA card or on a mismatch."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_sublane_ops needs a CUDA card")
    dev = torch.device("cuda")
    x = torch.as_tensor(
        np.random.default_rng(SEED).random((H, W), dtype=np.float32),
        device=dev)
    by_s0, plain_by_s0, err = {}, {}, {}
    for arm in ARMS:
        for s0 in S0S:
            got = gather_probe(arm, x, s0)
            ref = gather_probe_reference(arm, x, s0)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"probe arm {arm} at s0={s0} differs "
                                     "from its plain version")
            err[arm] = max(err.get(arm, 0.0),
                           (got - ref).abs().max().item())
            by_s0.setdefault(arm, []).append(
                time_ms(lambda: gather_probe(arm, x, s0), reps=REPS))
            plain_by_s0.setdefault(arm, []).append(
                time_ms(lambda: gather_probe_reference(arm, x, s0),
                        reps=REPS))
    name, limit = (s.strip() for s in card_summary().splitlines()[0]
                   .split(","))
    return {
        "shape": [H, W], "loop": LOOP, "s0": list(S0S),
        "ms": {a: float(np.mean(v)) for a, v in by_s0.items()},
        "ms_by_s0": by_s0,
        "plain_ms": {a: float(np.mean(v)) for a, v in plain_by_s0.items()},
        "max_abs_err": err,
        "note": f"CUDA-event mean over {REPS} calls after one warm-up",
        "device": name,
        "power_limit_w": _watts(limit),
    }


def main():
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        sys.exit(1)
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
