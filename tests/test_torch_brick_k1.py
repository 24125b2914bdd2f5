"""K1's plain version against the JAX kernel ``_integrate_kernel_dyn``.

The JAX device path runs on the CPU under the Pallas TPU interpreter
(``torch_parity.pallas_tpu_interpret``); its frames and the port's are the
same and the JAX side gets the same w2c poses. Scene: the 128x256 sphere
on a 32^3 grid, 4 views (the even views of an 8-view orbit); the odd views
are the "4 more frames" of the state-carry test.

Tolerances and why:
* weight>0 sets may differ on <= 0.1% of voxels: the TPU kernel's VMEM
  windows drop the outer voxels of footprints taller than 57 rows or wider
  than 256 lanes, and the port samples every in-image voxel.
* sdf: XLA:CPU contracts multiply-adds into FMAs inside the interpreted
  kernel, which moves the camera-space z of a voxel by one f32 ulp; the
  tsdf then moves by ulp(z) / trunc (~1.2e-6 here). Every voxel both
  observed stays within two such ulps.
* packed color within 1 level at q99.
"""

import numpy as np
import pytest
import torch

from reconplan_tpu.ops import tsdf_brick as jb
from reconplan_tpu_torch.ops import tsdf_brick as tb
from test_tsdf_marching import make_sphere_depths
from torch_parity import pallas_tpu_interpret, same_inverse, unpack_rgb

torch.set_num_threads(2)

DIMS = (32, 32, 32)
ORIGIN = (-0.15, -0.15, -0.15)
VOX = 0.3 / 31
TRUNC = 5.0 * VOX
# the scene's camera-space z stays below 1 m: one f32 ulp of z in [0.5, 1)
SDF_TOL = 2 * np.spacing(np.float32(0.5)) / TRUNC


@pytest.fixture(scope="module")
def orbit():
    depths, poses, K = make_sphere_depths(n_views=8, H=128, W=256,
                                          fx=120.0, fy=120.0)
    F, H, W = depths.shape
    colors = np.zeros((F, H, W, 3), np.uint8)
    colors[..., 0] = np.arange(W)[None, None, :] * 255 // W
    colors[..., 1] = np.arange(H)[None, :, None] * 255 // H
    colors[..., 2] = 128
    even, odd = slice(0, None, 2), slice(1, None, 2)
    return dict(K=K, d0=depths[even], p0=poses[even], c0=colors[even],
                d1=depths[odd], p1=poses[odd])


def _jax_device(grid, depths, poses, K, colors=None):
    """The JAX device path (call under ``pallas_tpu_interpret``); returns
    the grid and its planes as numpy."""
    with same_inverse():
        grid, _ = jb.integrate_frames_bricked_device(
            grid, depths, poses, *K, colors=colors)
    return grid, {k: None if v is None else np.asarray(v)
                  for k, v in grid._asdict().items()
                  if k in ("sdf", "weight", "rgb")}


@pytest.fixture(scope="module")
def jax_depth_states(orbit):
    """JAX after the even views, and after the odd views on top."""
    g = jb.make_brick_grid(DIMS, ORIGIN, VOX)
    with pallas_tpu_interpret():
        g, after_even = _jax_device(g, orbit["d0"], orbit["p0"], orbit["K"])
        _, after_odd = _jax_device(g, orbit["d1"], orbit["p1"], orbit["K"])
    return after_even, after_odd


def _compare(port, ref):
    wp, wr = port.weight.numpy(), ref["weight"]
    assert ((wp > 0) != (wr > 0)).mean() <= 0.001
    both = (wp > 0) & (wr > 0)
    assert both.sum() > 5000
    diff = np.abs(port.sdf.numpy() - ref["sdf"])[both]
    print(f"sdf vs JAX K1: max {diff.max():.3g} q99 "
          f"{np.quantile(diff, 0.99):.3g} on {both.sum()} voxels")
    assert diff.max() <= SDF_TOL, (diff.max(), SDF_TOL)
    return both


def test_k1_depth_matches_pallas_kernel(orbit, jax_depth_states):
    g = tb.make_brick_grid(DIMS, ORIGIN, VOX, device="cpu")
    g, _ = tb.integrate_frames_bricked_device(g, orbit["d0"], orbit["p0"],
                                              *orbit["K"])
    _compare(g, jax_depth_states[0])


def test_state_carries_from_jax_brick_grid(orbit, jax_depth_states):
    """4 frames in JAX, convert the grid, 4 more frames in the port."""
    after_even, after_odd = jax_depth_states
    g = tb.brick_grid_from_numpy(
        after_even["sdf"], after_even["weight"], None, DIMS, ORIGIN, VOX,
        TRUNC, device="cpu")
    g, _ = tb.integrate_frames_bricked_device(g, orbit["d1"], orbit["p1"],
                                              *orbit["K"])
    _compare(g, after_odd)
    assert g.weight.max() > 1


def test_k1_color_matches_pallas_kernel(orbit):
    gj = jb.make_brick_grid(DIMS, ORIGIN, VOX, with_color=True)
    with pallas_tpu_interpret():
        _, ref = _jax_device(gj, orbit["d0"], orbit["p0"], orbit["K"],
                             orbit["c0"])
    g = tb.make_brick_grid(DIMS, ORIGIN, VOX, with_color=True, device="cpu")
    g, _ = tb.integrate_frames_bricked_device(
        g, orbit["d0"], orbit["p0"], *orbit["K"], colors=orbit["c0"])
    both = _compare(g, ref)
    levels = np.abs(unpack_rgb(g.rgb.numpy()).astype(np.int64)
                    - unpack_rgb(ref["rgb"]))[both]
    print(f"color vs JAX K1: max {levels.max()} levels")
    assert np.quantile(levels, 0.99) <= 1, np.quantile(levels, 0.99)
