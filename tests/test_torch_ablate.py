"""The ablation arms' plain versions against the TPU ablation kernels K5
(``_ablate_kernel``) and K4 (``_ablate_kernel2``) of
``benchmarks/profile_brick.py``, run on the CPU under the Pallas TPU
interpreter (``torch_parity.pallas_tpu_interpret``). ``benchmarks/`` is no
package, so the file is loaded by its path.

Scene: the sphere and voxel of ``test_torch_brick_k1.py``, 4 views of
128x256, on a 64 (z) x 64 (y) x 32 (x) grid: at 32^3 the sphere fills all
32 bricks and every frame bit is set, so ``no_fbits`` would equal
``full``; here 48 bricks are live and 24 of them skip a frame. The
starting state is JAX's: the odd views fused by the JAX device path,
carried over with ``brick_grid_from_numpy``. The ids, frame bits and live
count come from the port's ``chunk_active_set`` on the even views, and
both sides fold the even views into that state.

Tolerances and why:
* XLA:CPU contracts multiply-adds into FMAs inside the interpreted kernel,
  which moves a voxel's camera coordinates by about one f32 ulp (ROADMAP
  Queue 3).
* Off the rounding ties, weights identical and sdf within two ulps of
  camera z over trunc (``SDF_TOL``). A tie is a voxel whose pixel
  coordinate lies within ``TIE_PX`` of k + 0.5 in a frame, where that ulp
  can round to the neighbouring pixel. The scene's symmetric views put
  0.78% of the voxels on exact ties (v = 41.499997, say), and the two
  packages round a few of them apart: at most ``TIE_SHARE`` of the
  voxels differ there. Every footprint of the scene fits the TPU windows,
  so the TPU arms sample every voxel the port does.
* ``one_row`` is timing-only on both sides (one image row stands for the
  whole footprint); it is held to ``SDF_TOL`` where both weights agree,
  and the share of voxels whose weights differ is printed, not bounded.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.ops import tsdf_brick as jb
from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.ops.kernels import brick_ablate_reference
from reconplan_tpu_torch.ops.kernels.brick_integrate import (
    BRICK_VOXELS,
    _voxel_world,
)
from test_torch_brick_k1 import SDF_TOL, TRUNC, VOX
from test_tsdf_marching import make_sphere_depths
from torch_parity import pallas_tpu_interpret, same_inverse

torch.set_num_threads(2)

DIMS = (64, 64, 32)
DIMS_BRICKS = (8, 8, 2)
ORIGIN = (-0.15, -0.3, -0.3)
TIE_PX = 1e-4  # about 25 f32 ulps of a pixel coordinate below 64
TIE_SHARE = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# CUDA arm -> (TPU runner, TPU arm) it is held against
JAX_ARM = {
    "full": ("_run_ablate", "full"),
    "no_fbits": ("_run_ablate", "no_fbits"),
    "no_gather": ("_run_ablate", "no_window"),
    "rw_only": ("_run_ablate", "dma_only"),
    "one_row": ("_run_ablate", "no_rowloop"),
    "full2": ("_run_ablate2", "full2"),
    "smem_window": ("_run_ablate2", "dmahbm2"),
}


def _load_profile_brick():
    spec = importlib.util.spec_from_file_location(
        "tpu_profile_brick", os.path.join(REPO, "benchmarks",
                                          "profile_brick.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene():
    """The starting state, the even views' active set, and every TPU arm's
    planes from it (one interpreter session)."""
    depths, poses, K = make_sphere_depths(n_views=8, H=128, W=256,
                                          fx=120.0, fy=120.0)
    even, odd = slice(0, None, 2), slice(1, None, 2)
    g = jb.make_brick_grid(DIMS, ORIGIN, VOX)
    pb = _load_profile_brick()
    with pallas_tpu_interpret():
        with same_inverse():
            g, _ = jb.integrate_frames_bricked_device(
                g, depths[odd], poses[odd], *K)
        start = {k: np.asarray(getattr(g, k)) for k in ("sdf", "weight")}
        d = torch.as_tensor(depths[even])
        T = torch.linalg.inv(torch.as_tensor(poses[even])).contiguous()
        intr = tuple(float(np.float32(v)) for v in K)
        origin = torch.tensor(ORIGIN, dtype=torch.float32)
        bd = g.brick_dims
        ids, fbits, n, _ = tb.chunk_active_set(
            d, T, intr, origin, bd, VOX, TRUNC, 8192, start["sdf"].shape[0] - 1)
        meta = np.asarray(list(ORIGIN) + [VOX, TRUNC, 64.0, 0.0, int(n)],
                          np.float32)
        jax_out = {}
        for arm, (runner, mode) in JAX_ARM.items():
            s, w = getattr(pb, runner)(
                jnp.asarray(start["sdf"]), jnp.asarray(start["weight"]),
                jnp.asarray(ids.numpy()), jnp.asarray(meta),
                jnp.asarray(T.reshape(-1, 16).numpy()), jnp.asarray(intr),
                jnp.asarray(fbits.numpy()), jnp.asarray(d.numpy()), bd, mode)
            jax_out[arm] = (np.asarray(s), np.asarray(w))
    args = (ids, fbits, n, T, intr, d, origin, bd, VOX, TRUNC, 1000.0, 3.0,
            64.0)
    return dict(start=start, args=args, jax=jax_out,
                ties=_rounding_ties(start["weight"].shape, *args[:7]))


def _rounding_ties(shape, ids, fbits, n, T, intr, d, origin):
    """(planes shape) bool: live voxels whose u or v lies within ``TIE_PX``
    of k + 0.5 in any frame (f64 projection)."""
    fx, fy, cx, cy = intr
    live = ids[:int(n)]
    wx, wy, wz = (a.double() for a in _voxel_world(live, DIMS_BRICKS,
                                                    origin, VOX))
    tie = torch.zeros(wx.shape, dtype=torch.bool)
    for P in T.double():
        x, y, z = (P[i, 0] * wx + P[i, 1] * wy + P[i, 2] * wz + P[i, 3]
                   for i in range(3))
        for c in (x / z * fx + cx, y / z * fy + cy):
            tie |= ((c - torch.floor(c)) - 0.5).abs() < TIE_PX
    out = np.zeros(shape, bool)
    out.reshape(-1, BRICK_VOXELS)[live.numpy()] = tie.numpy()
    return out


def _compare(port, ref, ties, label):
    """Off the ties: weights identical, sdf within ``SDF_TOL``. On them:
    at most ``TIE_SHARE`` of the voxels differ."""
    (sdf, w), (sdf_j, w_j) = port, ref
    np.testing.assert_array_equal(w[~ties], w_j[~ties])
    seen = (w > 0) & ~ties
    diff = np.abs(sdf - sdf_j)[seen]
    apart = (w != w_j) | (np.abs(sdf - sdf_j) > SDF_TOL)
    print(f"{label}: sdf max {diff.max():.3g} on {seen.sum()} voxels off "
          f"the ties; {apart.sum()} tie voxels apart")
    assert diff.max() <= SDF_TOL, (diff.max(), SDF_TOL)
    assert apart.mean() <= TIE_SHARE, apart.sum()


def _port(scene, arm):
    g = tb.brick_grid_from_numpy(scene["start"]["sdf"],
                                 scene["start"]["weight"], None, DIMS,
                                 ORIGIN, VOX, TRUNC, device="cpu")
    brick_ablate_reference(arm, g.sdf, g.weight, *scene["args"])
    return g.sdf.numpy(), g.weight.numpy()


@pytest.mark.parametrize("arm", ["full", "no_fbits", "no_gather", "rw_only",
                                 "smem_window"])
def test_arm_matches_tpu_arm(scene, arm):
    sdf, w = _port(scene, arm)
    _compare((sdf, w), scene["jax"][arm], scene["ties"],
             f"{arm} vs TPU {JAX_ARM[arm][1]}")
    if arm == "rw_only":
        np.testing.assert_array_equal(sdf, scene["start"]["sdf"])
        np.testing.assert_array_equal(w, scene["start"]["weight"])
    else:
        assert (w != scene["start"]["weight"]).any()


def test_full_matches_the_tpu_production_copy_full2(scene):
    """``full`` answers both K5 ``full`` and K4 ``full2``."""
    _compare(_port(scene, "full"), scene["jax"]["full2"], scene["ties"],
             "full vs TPU full2")


def test_no_fbits_differs_from_full(scene):
    """The real frame bits skip frames. The skipped frames observe none of
    a brick's voxels here, but folding a void observation, (sdf * w) *
    (1 / w), is not the identity in f32, so the sdf bits differ."""
    ids, fbits, n = scene["args"][:3]
    assert (fbits[:int(n)] != 15).sum() > 10
    assert not np.array_equal(_port(scene, "no_fbits")[0],
                              _port(scene, "full")[0])


@pytest.mark.parametrize("arm", ["no_skips", "static_stride", "pr1_full"])
def test_arm_plain_equals_full_bitwise(scene, arm):
    """The arms that compute what K1 computes another way share ``full``'s
    plain body."""
    for a, b in zip(_port(scene, arm), _port(scene, "full")):
        np.testing.assert_array_equal(a, b)


def test_smem_window_plain_equals_full_bitwise(scene):
    for a, b in zip(_port(scene, "smem_window"), _port(scene, "full")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arm", ["no_skips", "static_stride", "pr1_full"])
def test_new_arm_matches_tpu_full(scene, arm):
    """No TPU arm asks what these ask; each computes ``full``, so it is
    held to the TPU kernel's ``full``."""
    _compare(_port(scene, arm), scene["jax"]["full"], scene["ties"],
             f"{arm} vs TPU full")


@pytest.mark.parametrize("arm", ["full", "pr1_full"])
def test_empty_id_list_changes_nothing_and_counts_no_launch(scene, arm):
    """With no ids there is nothing to launch: the wrapper returns before
    it counts, and the planes stay as they were."""
    from reconplan_tpu_torch.ops.kernels import brick_ablate

    g = tb.brick_grid_from_numpy(scene["start"]["sdf"],
                                 scene["start"]["weight"], None, DIMS,
                                 ORIGIN, VOX, TRUNC, device="cpu")
    ids, fbits, n, T, intr, d = scene["args"][:6]
    before = dict(brick_ablate.launches)
    brick_ablate(arm, g.sdf, g.weight, ids[:0], fbits[:0],
                 torch.zeros_like(n), T, intr, d.contiguous(),
                 *scene["args"][6:])
    assert brick_ablate.launches == before
    np.testing.assert_array_equal(g.sdf.numpy(), scene["start"]["sdf"])
    np.testing.assert_array_equal(g.weight.numpy(), scene["start"]["weight"])


def test_arms_follow_the_cuda_enum():
    """``ARMS`` is the order of ``enum Arm`` in ``csrc/brick_ablate.cu``,
    and the tool's table of TPU arms names every arm."""
    import re

    from reconplan_tpu_torch.benchmarks import profile_brick
    from reconplan_tpu_torch.ops.kernels import brick_ablate
    from reconplan_tpu_torch.ops.kernels.brick_ablate import ARMS

    with open(os.path.join(REPO, "reconplan_tpu_torch", "csrc",
                           "brick_ablate.cu")) as f:
        body = re.search(r"enum Arm : int \{(.*?)\};", f.read(), re.S).group(1)
    enum = re.findall(r"k(\w+) = (\d+)", body)
    assert [int(v) for _, v in enum] == list(range(len(ARMS)))
    assert [n.lower() for n, _ in enum] == [a.replace("_", "") for a in ARMS]
    assert len(ARMS) == 9 and set(profile_brick.TPU_ARMS) == set(ARMS)
    assert all(profile_brick.TPU_ARMS[a] == []
               for a in ("no_skips", "static_stride", "pr1_full"))
    assert set(brick_ablate.launches) == set(ARMS)
    with pytest.raises(ValueError, match="unknown ablation arm"):
        brick_ablate_reference("full2", *[None] * 15)


def test_one_row_against_tpu_no_rowloop(scene):
    sdf, w = _port(scene, "one_row")
    sdf_j, w_j = scene["jax"]["one_row"]
    both = (w == w_j) & (w > 0)
    print(f"one_row vs TPU no_rowloop: weights differ on "
          f"{(w != w_j).mean():.4%} of voxels; sdf max "
          f"{np.abs(sdf - sdf_j)[both].max():.3g} on {both.sum()} voxels")
    assert both.sum() > 5000
    assert np.abs(sdf - sdf_j)[both].max() <= SDF_TOL
