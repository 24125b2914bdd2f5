"""The port's dense TSDF engine against ``reconplan_tpu.ops.tsdf``.

Same inputs (the analytic sphere of ``test_tsdf_marching``) through both
packages; the JAX side runs op by op with the same w2c poses
(``torch_parity.jax_eager``), so the two agree to the last bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.ops import tsdf as jtsdf
from reconplan_tpu_torch.ops import tsdf as ttsdf
from reconplan_tpu_torch.utils import device as tdevice
from test_tsdf_marching import make_sphere_depths
from torch_parity import jax_eager

torch.set_num_threads(2)

DIMS = (96, 96, 96)
ORIGIN = (-0.15, -0.15, -0.15)
VOX = 0.3 / 95


@pytest.fixture(scope="module")
def scene():
    depths, poses, K = make_sphere_depths()
    rng = np.random.default_rng(0)
    colors = rng.uniform(size=depths.shape + (3,)).astype(np.float32)
    return depths, poses, K, colors


def _fuse_both(depths, poses, K, colors=None, dims=DIMS):
    with_color = colors is not None
    with jax_eager():
        gj = jtsdf.make_grid(dims, ORIGIN, VOX, with_color=with_color)
        gj = jtsdf.integrate_frames(
            gj, jnp.asarray(depths), jnp.asarray(poses), *K,
            colors=None if colors is None else jnp.asarray(colors),
        )
    gt = ttsdf.make_grid(dims, ORIGIN, VOX, with_color=with_color)
    gt = ttsdf.integrate_frames(gt, depths, poses, *K, colors=colors)
    return gj, gt


def test_dense_integration_matches_jax(scene):
    depths, poses, K, _ = scene
    gj, gt = _fuse_both(depths, poses, K)
    wj, wt = np.asarray(gj.weight), gt.weight.numpy()
    np.testing.assert_array_equal(wt, wj)
    both = (wj > 0) & (wt > 0)
    assert both.sum() > 100_000
    diff = np.abs(np.asarray(gj.sdf) - gt.sdf.numpy())
    assert diff.max() <= 1e-6, diff.max()


def test_dense_color_matches_jax(scene):
    depths, poses, K, colors = scene
    gj, gt = _fuse_both(depths[:4], poses[:4], K, colors[:4], dims=(48,) * 3)
    np.testing.assert_array_equal(gt.weight.numpy(), np.asarray(gj.weight))
    assert np.abs(np.asarray(gj.sdf) - gt.sdf.numpy()).max() <= 1e-6
    cdiff = np.abs(np.asarray(gj.color) - gt.color.numpy())
    assert cdiff.max() <= 1e-6, cdiff.max()
    assert gt.has_color and gt.color.shape == (48, 48, 48, 3)


def test_extract_surface_points_masks_identical(scene):
    depths, poses, K, _ = scene
    gj, gt = _fuse_both(depths, poses, K)
    with jax_eager():
        pj, mj = jtsdf.extract_surface_points(gj)
    pt, mt = ttsdf.extract_surface_points(gt)
    mj = np.asarray(mj)
    np.testing.assert_array_equal(mt.numpy(), mj)
    assert mj.sum() > 500
    np.testing.assert_array_equal(pt.numpy()[mj], np.asarray(pj)[mj])


def test_state_carries_from_jax_grid(scene):
    """4 frames in JAX, convert the grid, 4 more frames in both."""
    depths, poses, K, _ = scene
    with jax_eager():
        gj = jtsdf.make_grid(DIMS, ORIGIN, VOX)
        gj = jtsdf.integrate_frames(
            gj, jnp.asarray(depths[:4]), jnp.asarray(poses[:4]), *K)
    gt = ttsdf.tsdf_grid_from_numpy(
        np.asarray(gj.sdf), np.asarray(gj.weight), np.asarray(gj.color),
        np.asarray(gj.origin), float(gj.voxel_size), float(gj.trunc))
    back = ttsdf.tsdf_grid_to_numpy(gt)
    np.testing.assert_array_equal(back["sdf"], np.asarray(gj.sdf))
    assert back["trunc"] == float(gj.trunc)
    with jax_eager():
        gj = jtsdf.integrate_frames(
            gj, jnp.asarray(depths[4:]), jnp.asarray(poses[4:]), *K)
    gt = ttsdf.integrate_frames(gt, depths[4:], poses[4:], *K)
    np.testing.assert_array_equal(gt.weight.numpy(), np.asarray(gj.weight))
    assert np.abs(np.asarray(gj.sdf) - gt.sdf.numpy()).max() <= 1e-6


def test_resolve_device_never_substitutes_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device(None).type == "cpu"
    assert tdevice.resolve_device("cpu").type == "cpu"


def test_tf32_is_off_after_import():
    import reconplan_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
