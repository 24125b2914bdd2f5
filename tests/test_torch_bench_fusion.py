"""``reconplan_tpu_torch.benchmarks.bench_fusion`` against the repo's
``benchmarks/bench_fusion.py`` (loaded by path) on the CPU, the JAX
script's Pallas kernels (K2, K1) under the TPU interpreter.

One frame of the banana orbit at 256^3: there every brick's footprint
fits the JAX K1's sampling window (57 rows x 128 lanes; the CUDA K1
samples every voxel in the image). At 64^3 and below a brick is 0.1 m
and more across at the orbit's 0.43 m and the JAX kernel drops its outer
voxels (32^3 / 64^3, 4 frames: 4 / 679 triangles against the port's
43 / 1,042), so a smaller grid would compare the window, not the port.
The warm batch and the REPS = 5 timed batches run as in the scripts
(about 4 minutes for the two on an 8-core CPU).
"""

import json

import torch

from reconplan_tpu_torch.benchmarks import bench_fusion
from test_torch_bench_scripts import json_rows, load_jax_script
from torch_parity import pallas_tpu_interpret

torch.set_num_threads(2)


def test_bench_fusion_matches_jax(capsys):
    """The same keys (plus ``"device"``), active bricks and triangle count
    equal, the Chamfer equal to the printed 1e-3 mm (measured: 10,986
    triangles, 2.686 mm in both)."""
    with pallas_tpu_interpret():
        load_jax_script("bench_fusion").main(n_frames=1, dims=(256,))
    (want,) = json_rows(capsys.readouterr().out)
    (got,) = bench_fusion.main(n_frames=1, dims=(256,), device="cpu")
    assert json_rows(capsys.readouterr().out) == [json.loads(
        json.dumps(got))]
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    for key in ("config", "grid", "frames", "active_bricks", "triangles"):
        assert got[key] == want[key], key
    assert abs(got["chamfer_mm"] - want["chamfer_mm"]) <= 1e-3
    assert got["fps"] > 0
