"""K3's plain version and the host-compacted brick path against
``reconplan_tpu.ops.tsdf_brick`` (``_integrate_bricks`` /
``integrate_frames_bricked``, the Pallas kernel ``_integrate_kernel`` run
with ``interpret=True``).

Scene: the 128x256 sphere on a 32^3 grid (32 bricks), as in
``test_brick_matches_dense_integration``; the JAX side gets the same w2c
poses. Tolerances and why (those of ``test_torch_brick_k1.py``):
* weight>0 sets may differ on <= 0.1% of voxels: the TPU kernel's VMEM
  windows drop the outer voxels of very large footprints, and the port
  samples every in-image voxel.
* sdf: XLA:CPU contracts multiply-adds into FMAs inside the interpreted
  kernel, which moves the camera-space z of a voxel by one f32 ulp; the
  tsdf then moves by ulp(z) / trunc (~1.2e-6 here). Every voxel of equal
  weight stays within two such ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.ops import tsdf as jtsdf
from reconplan_tpu.ops import tsdf_brick as jb
from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.ops.kernels import (
    brick_integrate_fixed,
    brick_integrate_fixed_reference,
)
from reconplan_tpu_torch.ops.kernels.brick_integrate_fixed import (
    _launch as k3_launch,
)
from reconplan_tpu_torch.utils import profiling
from test_tsdf_marching import make_sphere_depths
from torch_parity import f32, jax_eager, same_inverse, t

torch.set_num_threads(2)

DIMS = (32, 32, 32)
BD = (4, 4, 2)
NB = 32
ORIGIN = (-0.15, -0.15, -0.15)
VOX = 0.3 / 31
TRUNC = 5.0 * VOX
# the scene's camera-space z stays below 1 m: one f32 ulp of z in [0.5, 1)
SDF_TOL = 2 * np.spacing(np.float32(0.5)) / TRUNC


@pytest.fixture(scope="module")
def scene():
    depths, poses, K = make_sphere_depths(n_views=4, H=128, W=256,
                                          fx=120.0, fy=120.0)
    w2c = torch.linalg.inv(torch.from_numpy(poses)).numpy()
    return dict(depths=depths, poses=poses, K=K, w2c=w2c)


def _compare(sdf_p, w_p, sdf_r, w_r, min_voxels):
    """Weights equal except the window tail; sdf within two z-ulps on the
    voxels of equal weight."""
    sdf_p, w_p = np.asarray(sdf_p), np.asarray(w_p)
    sdf_r, w_r = np.asarray(sdf_r), np.asarray(w_r)
    assert (w_p != w_r).mean() <= 0.001
    same = (w_p == w_r) & (w_r > 0)
    assert same.sum() > min_voxels
    diff = np.abs(sdf_p - sdf_r)[same]
    print(f"sdf vs JAX K3: max {diff.max():.3g} on {same.sum()} voxels")
    assert diff.max() <= SDF_TOL, (diff.max(), SDF_TOL)


def _prior_planes(n_rows, seed):
    """A non-empty prior state: sdf in [-1, 1), integer weights 0..4."""
    rng = np.random.default_rng(seed)
    sdf = rng.uniform(-1, 1, (n_rows, 8, 128)).astype(np.float32)
    w = rng.integers(0, 5, (n_rows, 8, 128)).astype(np.float32)
    return sdf, w


# (id_base, n_real_local, padded length): the whole grid, and the second
# of two 16-brick shards with fewer real bricks than ids
CASES = {"whole": (0, NB, 512), "shard": (16, 16, 64)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k3_plain_matches_pallas_kernel(scene, case):
    id_base, n_real, M = CASES[case]
    mask = tb.active_brick_mask(
        BD, t(ORIGIN, torch.float32), VOX, TRUNC, t(scene["depths"]),
        t(scene["w2c"]), *map(f32, scene["K"])).numpy()
    local = np.flatnonzero(mask[id_base:id_base + n_real]).astype(np.int32)
    assert 0 < len(local) < n_real
    ids = np.concatenate([local, np.full(M - len(local), n_real, np.int32)])
    sdf0, w0 = _prior_planes(n_real + 1, seed=len(case))
    meta = jnp.asarray([*ORIGIN, VOX, TRUNC, 64.0, id_base, n_real],
                       jnp.float32)
    sdf_j, w_j = jb._integrate_bricks(
        jnp.asarray(sdf0), jnp.asarray(w0), jnp.asarray(ids), meta,
        jnp.asarray(scene["w2c"].reshape(-1, 16)),
        jnp.asarray(scene["K"], jnp.float32), jnp.asarray(scene["depths"]),
        BD, 1000.0, 3.0, 64.0, interpret=True)
    sdf_t, w_t = t(sdf0), t(w0)
    brick_integrate_fixed_reference(
        sdf_t, w_t, t(ids), id_base, n_real, t(scene["w2c"]),
        tuple(map(f32, scene["K"])), t(scene["depths"]),
        t(ORIGIN, torch.float32), BD, VOX, TRUNC, 1000.0, 3.0, 64.0)
    _compare(sdf_t, w_t, sdf_j, w_j, 5000)
    # the scratch row and the bricks not listed are untouched
    untouched = np.setdiff1d(np.arange(n_real + 1), local)
    np.testing.assert_array_equal(sdf_t.numpy()[untouched], sdf0[untouched])
    np.testing.assert_array_equal(w_t.numpy()[untouched], w0[untouched])


@pytest.mark.parametrize("case", sorted(CASES))
def test_k3_plain_padding_interleaved_ids_permuted(scene, case):
    """Padding may stand anywhere in the list and the real ids in any
    order: the plain version against the Pallas kernel on such a list, and
    bit for bit against itself on the compacted, ascending list."""
    id_base, n_real, _ = CASES[case]
    mask = tb.active_brick_mask(
        BD, t(ORIGIN, torch.float32), VOX, TRUNC, t(scene["depths"]),
        t(scene["w2c"]), *map(f32, scene["K"])).numpy()
    local = np.flatnonzero(mask[id_base:id_base + n_real]).astype(np.int32)
    rng = np.random.default_rng(7)
    ids = [n_real] * 3  # padding first
    for bid in rng.permutation(local):
        ids += [int(bid)] + [n_real] * int(rng.integers(0, 4))
    ids = np.asarray(ids + [n_real] * (-len(ids) % 8), np.int32)
    assert (ids[:-1] > ids[1:]).any() and ids[0] == n_real
    sdf0, w0 = _prior_planes(n_real + 1, seed=3 + len(case))
    meta = jnp.asarray([*ORIGIN, VOX, TRUNC, 64.0, id_base, n_real],
                       jnp.float32)
    sdf_j, w_j = jb._integrate_bricks(
        jnp.asarray(sdf0), jnp.asarray(w0), jnp.asarray(ids), meta,
        jnp.asarray(scene["w2c"].reshape(-1, 16)),
        jnp.asarray(scene["K"], jnp.float32), jnp.asarray(scene["depths"]),
        BD, 1000.0, 3.0, 64.0, interpret=True)
    rest = (id_base, n_real, t(scene["w2c"]), tuple(map(f32, scene["K"])),
            t(scene["depths"]), t(ORIGIN, torch.float32), BD, VOX, TRUNC,
            1000.0, 3.0, 64.0)
    sdf_t, w_t = t(sdf0), t(w0)
    brick_integrate_fixed(sdf_t, w_t, t(ids), *rest)
    _compare(sdf_t, w_t, sdf_j, w_j, 5000)
    sdf_c, w_c = t(sdf0), t(w0)
    brick_integrate_fixed(sdf_c, w_c, t(local), *rest)
    assert torch.equal(sdf_t, sdf_c) and torch.equal(w_t, w_c)
    untouched = np.setdiff1d(np.arange(n_real + 1), local)
    np.testing.assert_array_equal(sdf_t.numpy()[untouched], sdf0[untouched])
    np.testing.assert_array_equal(w_t.numpy()[untouched], w0[untouched])


@pytest.mark.parametrize("dilate", [False, True])
def test_integrate_frames_bricked_matches_jax(scene, dilate):
    d, p, K = scene["depths"], scene["poses"], scene["K"]
    gj = jb.make_brick_grid(DIMS, ORIGIN, VOX)
    with same_inverse():
        gj, n_j = jb.integrate_frames_bricked(
            gj, d, p, *K, dilate_active=dilate, interpret=True)
    g = tb.make_brick_grid(DIMS, ORIGIN, VOX, device="cpu")
    with profiling.recording() as rec:
        g, n_t = tb.integrate_frames_bricked(g, d, p, *K,
                                             dilate_active=dilate)
    # CPU: the plain version, no launch counted
    assert not any(k.startswith("kernel.") for k in rec.counters)
    assert isinstance(n_t, int) and n_t == n_j > 0
    _compare(g.sdf, g.weight, gj.sdf, gj.weight, 5000)


def test_bricked_matches_dense_integration(scene):
    """The twin of ``test_brick_matches_dense_integration``: the
    host-compacted path against the dense engine run op by op. K3 folds
    every frame into every active brick and samples every in-image voxel,
    so each voxel it observed equals the dense engine's."""
    d, p, K = scene["depths"][:2], scene["poses"][:2], scene["K"]
    g = tb.make_brick_grid(DIMS, ORIGIN, VOX, device="cpu")
    g, n_active = tb.integrate_frames_bricked(g, d, p, *K,
                                              dilate_active=False)
    assert n_active > 0
    with jax_eager():
        dense = jtsdf.integrate_frames(
            jtsdf.make_grid(DIMS, ORIGIN, VOX), jnp.asarray(d),
            jnp.asarray(p), *K)
    sdf_b, w_b = (a.numpy() for a in tb.to_dense(g))
    w_d = np.asarray(dense.weight)
    seen = w_b > 0
    assert seen.sum() > 1000
    np.testing.assert_array_equal(w_b[seen], w_d[seen])
    diff = np.abs(sdf_b - np.asarray(dense.sdf))[seen]
    assert diff.max() <= 1e-6, diff.max()


def test_any_frame_size_and_chunking(scene):
    """No kernel window: frames below the JAX kernel's (64, 256) window are
    taken, and chunks of 2 frames give the dense result on what they
    observed too."""
    d, p, _ = make_sphere_depths(n_views=4, H=48, W=64, fx=40.0, fy=40.0)
    K = (40.0, 40.0, 32.0, 24.0)
    g = tb.make_brick_grid(DIMS, ORIGIN, VOX, device="cpu")
    g, n_active = tb.integrate_frames_bricked(g, d, p, *K,
                                              frames_per_dispatch=2,
                                              pad_multiple=8)
    assert n_active > 0 and g.weight.max() > 1
    assert torch.isfinite(g.sdf).all()


def test_k3_wrapper_checks_its_inputs():
    plane = torch.zeros((5, 8, 128))
    ids = torch.full((8,), 4, dtype=torch.int32)
    T = torch.eye(4)[None]
    depths = torch.zeros((1, 4, 4))
    args = ((1.0, 1.0, 0.0, 0.0), depths, torch.zeros(3), (1, 2, 2), 0.01,
            0.05, 1000.0, 3.0, 64.0)
    with pytest.raises(ValueError, match="ids"):
        brick_integrate_fixed(plane, plane.clone(), ids.long(), 0, 4, T,
                              *args)
    with pytest.raises(ValueError, match="n_real_local"):
        brick_integrate_fixed(plane, plane.clone(), ids, 0, 5, T, *args)
    with pytest.raises(ValueError, match="T_w2c"):
        brick_integrate_fixed(plane, plane.clone(), ids, 0, 4,
                              T.repeat(2, 1, 1), *args)
    # all padding: nothing changes
    sdf, w = plane.clone(), plane.clone()
    brick_integrate_fixed(sdf, w, ids, 0, 4, T, *args)
    assert torch.equal(sdf, plane) and torch.equal(w, plane)


@pytest.mark.parametrize("trunc,depth_scale", [
    (0.0, 1000.0), (-0.05, 1000.0), (0.05, 0.0), (0.05, -1000.0),
    (float("nan"), 1000.0)])
def test_k3_launch_refuses_nonpositive_scale_and_trunc(trunc, depth_scale):
    """The kernel skips divides that are exact only for depth_scale > 0 and
    trunc > 0, so its launch refuses anything else, before it looks at the
    device. The plain version, which skips nothing, takes them."""
    plane = torch.zeros((5, 8, 128))
    ids = torch.arange(4, dtype=torch.int32)
    args = [plane.clone(), plane.clone(), ids, 0, 4, torch.eye(4)[None],
            (1.0, 1.0, 0.0, 0.0), torch.ones((1, 4, 4)), torch.zeros(3),
            (1, 2, 2), 0.01, trunc, depth_scale, 3.0, 64.0]
    with pytest.raises(ValueError, match="must be > 0"):
        k3_launch(*args)
    args[11], args[12] = 0.05, 1000.0
    with pytest.raises(ValueError, match="unsupported device cpu"):
        k3_launch(*args)
    args[11], args[12] = trunc, depth_scale
    with profiling.recording() as rec:
        brick_integrate_fixed(*args)  # CPU tensors: the plain version
    assert rec.counters == {}
