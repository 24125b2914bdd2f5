"""The port's splat renderer against ``reconplan_tpu.io.render``.

50k banana splats at 120x160. The two packages' (N, 3) x (3, 3)
projections round one f32 ulp apart on a share of the splats that depends
on the host CPU's matmul code; measured, depth was identical on 0.99833 to
0.99896 of the pixels of these views. So the hit sets must be equal and
every pixel's depth within one ulp of it; color within 1e-5 on the pixels
whose depth is identical (scatter-add order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.io import render as jrender
from reconplan_tpu_torch.io import render as trender

torch.set_num_threads(2)

BANANA = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                      "data/objects/011_banana/tsdf/nontextured.ply")
H, W, F = 120, 160, 150.0
EYES = [(0.35, 0.0, 0.25), (-0.2, 0.28, 0.25), (0.05, -0.33, 0.15)]


@pytest.fixture(scope="module")
def cameras():
    kw = dict(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
              samples_per_mesh=50_000, seed=0)
    cj = jrender.SplatCamera(**kw).add_mesh_file(BANANA)
    ct = trender.SplatCamera(device="cpu", **kw).add_mesh_file(BANANA)
    return cj, ct


def test_camera_look_at_identical():
    for eye in EYES:
        np.testing.assert_array_equal(trender.camera_look_at(eye, (0, 0, 0)),
                                      jrender.camera_look_at(eye, (0, 0, 0)))


@pytest.mark.parametrize("eye", EYES)
def test_splat_depth_and_color_match_jax(cameras, eye):
    cj, ct = cameras
    dj, colj, Tj = cj.take_picture(eye, (0.0, 0.0, 0.0))
    dt, colt, Tt = ct.take_picture(eye, (0.0, 0.0, 0.0))
    np.testing.assert_array_equal(Tt, Tj)
    dt, colt = dt.numpy(), colt.numpy()
    hit = dj > 0
    assert hit.mean() > 0.02
    same = dt == dj
    print(f"depth identical on {same.mean():.5f} of pixels, max diff "
          f"{np.abs(dt - dj).max():.3g} mm")
    np.testing.assert_array_equal(dt > 0, hit)
    assert (np.abs(dt - dj) <= np.spacing(np.maximum(dt, dj))).all()
    # color through the renderer's float output (the u8 frames truncate)
    T_w2c = np.linalg.inv(Tj).astype(np.float32)
    cpu = jax.local_devices(backend="cpu")[0]
    _, cfj = jrender.splat_depth_color(
        jax.device_put(cj._points, cpu), jax.device_put(cj._colors, cpu),
        jax.device_put(T_w2c, cpu), F, F, W / 2, H / 2, H, W)
    _, cft = trender.splat_depth_color(ct._points, ct._colors, T_w2c,
                                       F, F, W / 2, H / 2, H, W)
    cdiff = np.abs(cft.numpy() - np.asarray(cfj))[same]
    assert cdiff.max() <= 1e-5, cdiff.max()
    assert (colt[same] == colj[same]).mean() >= 0.999


def test_splat_points_and_colors_identical(cameras):
    cj, ct = cameras
    np.testing.assert_array_equal(ct._points.numpy(), cj._points)
    np.testing.assert_array_equal(ct._colors.numpy(), cj._colors)
    assert ct._points.device == torch.device("cpu")
    jnp.asarray(0)  # JAX stays importable beside the port


def test_checker_floor_and_mesh_options_match_jax():
    """``add_checker_floor`` and ``add_mesh``'s ``translate`` / ``color``
    build the same splats as the JAX camera."""
    kw = dict(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
              samples_per_mesh=2000, seed=1)
    cj = jrender.SplatCamera(**kw).add_mesh_file(
        BANANA, translate=(0.0, 0.0, 0.02), color=(0.2, 0.4, 0.6))
    ct = trender.SplatCamera(device="cpu", **kw).add_mesh_file(
        BANANA, translate=(0.0, 0.0, 0.02), color=(0.2, 0.4, 0.6))
    cj.add_checker_floor(size=0.4, tiles=4, samples_per_tile=500)
    ct.add_checker_floor(size=0.4, tiles=4, samples_per_tile=500)
    np.testing.assert_array_equal(ct._points.numpy(), cj._points)
    np.testing.assert_array_equal(ct._colors.numpy(), cj._colors)
    assert len(cj._points) == 2000 + 16 * 500
    dj, colj, _ = cj.take_picture((0.3, 0.1, 0.35), (0.0, 0.0, 0.0))
    dt, colt, _ = ct.take_picture((0.3, 0.1, 0.35), (0.0, 0.0, 0.0))
    np.testing.assert_array_equal(dt.numpy() > 0, dj > 0)
    assert (dj > 0).mean() > 0.1  # the sparse floor splats cover pixels
