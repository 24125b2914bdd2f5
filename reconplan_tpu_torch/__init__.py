"""reconplan_tpu_torch — the PyTorch/CUDA port of ``reconplan_tpu``.

The package mirrors the JAX package's module paths and public names, so
each counterpart is easy to find, and keeps its layouts at public
functions (``(NB + 1, 8, 128)`` brick planes with the scratch row,
``(D, H, W)`` dense grids, cam->world poses, depth in raw millimetres with
``depth_scale``). It imports ``torch`` and never ``jax`` or
``reconplan_tpu``; the few numpy helpers it needs are copied in.

The six TPU kernels of the repository are hand-written CUDA C++ for
``sm_90a`` (``csrc/``), built with ``nvcc`` into ``_build/`` at first use
(``ops/kernels/build.py``). Each wrapper runs its kernel on CUDA tensors
and its plain PyTorch version on CPU tensors. Everything else is torch
ops. Every entry point that makes tensors takes ``device=None``, which
means the card (``utils/device.resolve_device``) and raises without one;
``device="cpu"`` asks for the CPU.

Subpackages
-----------
utils       device resolution, stage timer and profiler trace
io          mesh IO, frame sets and feeds, problem configs, roadmap
            checkpoints, splat renderer
core        SE3 / quaternion maths, workspace sampling grids
kin         .rob parser, kinematic chain (FK, Jacobian), batched DLS IK,
            collision, the Robot protocol
grr         Cartesian path generators (the scan arc), roadmaps
ops         point clouds, ICP, FPFH + RANSAC, dense TSDF and raycast, brick
            TSDF, marching cubes, nearest neighbours, kernels
parallel    device meshes (one process or a torch.distributed group),
            z-sharded dense and brick-sharded fusion, sharded IK
recon       fusion pipeline, RGBD stitcher, Poisson reconstruction, Chamfer
            and point-to-mesh metrics
viz         the HTML point-cloud viewer
apps        the roadmap build, the scan loop and the stitch CLIs
benchmarks  the brick profiler and the sampling microprobe
"""

import torch as _torch

__version__ = "0.1.0"

# The JAX package runs its geometry products at precision=HIGHEST. TF32 is
# the GPU form of the TPU's bf16 matmul trap, so keep full f32 products.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
