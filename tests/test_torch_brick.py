"""The port's brick TSDF host side and K2 against ``reconplan_tpu.ops.tsdf_brick``.

Layouts and the mask pipeline (occupancy mip -> K2 bits -> exact refine)
must agree bit for bit; the JAX side gets the same w2c poses. XLA's CPU
code generation may contract a multiply-add and flip a brick whose band
edge lies within an ulp of a bin edge, so each bit-exact check allows at
most 0.1% differing bricks (none has been seen). K1 against the JAX
kernel is in ``test_torch_brick_k1.py``; the CUDA kernels against their
plain versions in ``test_torch_cuda.py`` (on the card).
"""

import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.ops import tsdf as jtsdf
from reconplan_tpu.ops import tsdf_brick as jb
from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.ops.kernels import (
    active_mask,
    active_mask_reference,
    brick_integrate,
    icp_step,
    occupancy_bits,
    occupancy_bits_reference,
    refine_bits,
    refine_bits_reference,
)
from reconplan_tpu_torch.ops.kernels.icp_step import POINT_TO_PLANE, icp_solve
from reconplan_tpu_torch.ops.kernels.occupancy_bits import (
    MAX_ROUNDS,
    MAX_WIDTH,
    PARTIALS,
)
from reconplan_tpu_torch.ops.kernels.refine_bits import _brick_centers
from reconplan_tpu_torch.utils import profiling
from test_tsdf_marching import make_sphere_depths
from torch_parity import f32, jax_eager, t

torch.set_num_threads(2)

ORIGIN = (-0.15, -0.15, -0.15)
# (n_views, H, W, fx, dims): the 120x160 sphere on 64^3 (256 bricks, most
# of them inactive) and the 128x256 kernel scene on 32^3
SCENES = {
    "64cube": (8, 120, 160, 100.0, (64, 64, 64)),
    "32cube": (4, 128, 256, 120.0, (32, 32, 32)),
}


def assert_bits_match(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    n_diff = int((port != ref).sum())
    assert n_diff <= 0.001 * port.size, (n_diff, port.size)


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    n_views, H, W, fx, dims = SCENES[request.param]
    depths, poses, K = make_sphere_depths(n_views=n_views, H=H, W=W,
                                          fx=fx, fy=fx)
    vox = 0.3 / (dims[0] - 1)
    w2c = torch.linalg.inv(torch.from_numpy(poses)).numpy()
    return dict(depths=depths, poses=poses, K=K, dims=dims, vox=vox,
                trunc=5.0 * vox, w2c=w2c)


def _brick_dims(dims):
    return (dims[0] // 8, dims[1] // 8, dims[2] // 16)


def test_layout_roundtrip_and_from_dense_match_jax():
    rng = np.random.default_rng(0)
    sdf = rng.normal(size=(16, 16, 32)).astype(np.float32)
    w = rng.uniform(size=(16, 16, 32)).astype(np.float32)
    gj = jb.from_dense(jnp.asarray(sdf), jnp.asarray(w), (0, 0, 0), 0.01, 0.05)
    gt = tb.from_dense(t(sdf), t(w), (0, 0, 0), 0.01, 0.05)
    np.testing.assert_array_equal(gt.sdf.numpy(), np.asarray(gj.sdf))
    np.testing.assert_array_equal(gt.weight.numpy(), np.asarray(gj.weight))
    sdf2, w2 = tb.to_dense(gt)
    np.testing.assert_array_equal(sdf2.numpy(), sdf)
    np.testing.assert_array_equal(w2.numpy(), w)


def test_color_plane_and_numpy_roundtrip_match_jax():
    gj = jb.make_brick_grid((16, 16, 32), (0, 0, 0), 0.01, with_color=True)
    rgb = np.random.default_rng(1).integers(0, 1 << 24, size=gj.rgb.shape,
                                            dtype=np.int32)
    gj = gj._replace(rgb=jnp.asarray(rgb))
    gt = tb.brick_grid_from_numpy(
        np.asarray(gj.sdf), np.asarray(gj.weight), np.asarray(gj.rgb),
        gj.dims, np.asarray(gj.origin), gj.voxel_size, gj.trunc,
        device="cpu")
    np.testing.assert_array_equal(tb.to_dense_color(gt).numpy(),
                                  np.asarray(jb.to_dense_color(gj)))
    back = tb.brick_grid_to_numpy(gt)
    np.testing.assert_array_equal(back["rgb"], rgb)
    assert back["dims"] == (16, 16, 32) and gt.brick_dims == (2, 2, 2)
    assert back["trunc"] == gj.trunc


def test_build_depth_occupancy_bitexact(scene):
    occ_j = jb._build_depth_occupancy(jnp.asarray(scene["depths"]),
                                      1000.0, 3.0, 8)
    occ_t = occupancy_bits_reference(t(scene["depths"]), 1000.0, 3.0, 8)
    assert_bits_match(occ_t[0], occ_j[0])
    assert_bits_match(occ_t[1], occ_j[1])
    np.testing.assert_array_equal(occ_t[2].numpy(), np.asarray(occ_j[2]))
    assert (np.asarray(occ_j[0]) != 0).any()


def test_depth_occupancy_takes_the_plain_version_on_cpu(scene):
    """On CPU tensors the occupancy wrapper is the plain chain, alone and
    inside ``chunk_active_set``: bit for bit, and no ``kernel.*`` counter;
    a tensor on another device is refused."""
    d = t(scene["depths"])
    bd = _brick_dims(scene["dims"])
    with profiling.recording() as rec:
        got = occupancy_bits(d, 1000.0, 3.0, 8)
        tb.chunk_active_set(d, t(scene["w2c"]), tuple(map(f32, scene["K"])),
                            t(ORIGIN, torch.float32), bd, scene["vox"],
                            scene["trunc"], 8192, bd[0] * bd[1] * bd[2])
    want = occupancy_bits_reference(d, 1000.0, 3.0, 8)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert (got[0] != 0).any()
    with pytest.raises(ValueError, match="unsupported device meta"):
        occupancy_bits(d.to("meta"), 1000.0, 3.0, 8)
    assert rec.counters == {}


def test_occupancy_wrapper_sizes_what_the_kernel_expects():
    """The wrapper's scratch and limits are the kernel's own constants:
    ``PARTIALS`` partial minima and maxima, and the dilation's rows in
    static shared memory (``MAX_WIDTH`` cells across, ``MAX_ROUNDS``)."""
    src = (Path(tb.__file__).parents[1] / "csrc" /
           "occupancy_bits.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kPartials"]) == PARTIALS
    assert int(consts["kMaxWidth"]) == MAX_WIDTH
    assert int(consts["kMaxRounds"]) == MAX_ROUNDS


def _meta_calls():
    """One small call of each kernel wrapper, its tensors on ``meta``."""
    from reconplan_tpu_torch.ops.kernels import (
        brick_ablate, brick_integrate_fixed, gather_probe)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    planes = (z(9, 8, 128), z(9, 8, 128))
    ids, frames = z(4, dtype=i32), (z(2, 4, 4), (1.0, 1.0, 8.0, 8.0),
                                   z(2, 16, 16))
    brick = (z(3), (2, 2, 2), 0.01, 0.05, 1000.0, 3.0, 64.0)
    cloud = SimpleNamespace(points=z(8, 3), valid=z(8, dtype=torch.bool),
                            normals=z(8, 3))
    return {
        "icp_step": lambda: icp_step(icp_solve(
            POINT_TO_PLANE, cloud, cloud, z(4, 4), 0.02, 1e-6, None, None)),
        "active_mask": lambda: active_mask(
            (2, 2, 2), z(3), 0.01, 0.05, z(2, 2, 2, dtype=i32),
            z(2, 2, 2, dtype=i32), z(2), z(2, 4, 4), 1.0, 1.0, 8.0, 8.0),
        "brick_integrate": lambda: brick_integrate(
            *planes, None, ids, ids, z(1, dtype=i32), *frames[:3], None,
            *brick),
        "brick_integrate_fixed": lambda: brick_integrate_fixed(
            *planes, ids, 0, 8, *frames, *brick),
        "brick_ablate": lambda: brick_ablate(
            "full", *planes, ids, ids, z(1, dtype=i32), *frames, *brick),
        "gather_probe": lambda: gather_probe("baseline", z(32, 256), 0),
        "occupancy_bits": lambda: occupancy_bits(z(2, 16, 16)),
        "refine_bits": lambda: refine_bits(
            z(8, dtype=i32), z(2, 16, 16), z(2, 4, 4), z(3), 0.01, 0.05,
            (1.0, 1.0, 8.0, 8.0), (2, 2, 2), 4096),
    }


@pytest.mark.parametrize("name", sorted(_meta_calls()))
def test_each_kernel_wrapper_refuses_another_device(name):
    """A wrapper takes the CPU (its plain version) and CUDA (its kernel):
    past its argument checks, a tensor on any other device raises."""
    with pytest.raises(ValueError, match=f"{name}: unsupported device meta"):
        _meta_calls()[name]()


def test_kernels_import_nothing_above_them():
    """``ops/kernels`` imports only itself and ``utils``: ``ops/tsdf_brick``
    and the layers above call down into it, never the other way."""
    import ast

    for path in (Path(tb.__file__).parent / "kernels").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                names = [node.module]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            for name in names:
                if name.startswith("reconplan_tpu_torch"):
                    assert name.startswith((
                        "reconplan_tpu_torch.ops.kernels",
                        "reconplan_tpu_torch.utils")), (path.name, name)


@pytest.mark.parametrize("hw,cell", [
    ((480, 640), 8), ((120, 160), 8), ((128, 256), 8), ((64, 2048), 16),
    ((96, 4096), 32), ((64, 8192), None), ((100, 160), None)])
def test_occupancy_cell_is_the_finest_the_kernels_take(hw, cell):
    """The mask pipeline's mip cell: the finest of K2's cells that divides
    the frames with at most the occupancy kernel's ``MAX_WIDTH`` cells
    across, or none (then the centre-sample mask)."""
    assert tb._occupancy_cell(*hw) == cell


def _mask_inputs(scene):
    occ0, occ1, binp = jb._build_depth_occupancy(
        jnp.asarray(scene["depths"]), 1000.0, 3.0, 8)
    return occ0, occ1, binp


def test_k2_plain_matches_pallas_interpret(scene):
    occ0, occ1, binp = _mask_inputs(scene)
    bd = _brick_dims(scene["dims"])
    fx, fy, cx, cy = scene["K"]
    bits_j = jb.active_brick_bits_pallas(
        bd, jnp.asarray(ORIGIN, jnp.float32), scene["vox"], scene["trunc"],
        occ0, occ1, binp, jnp.asarray(scene["w2c"]), fx, fy, cx, cy,
        3.0, 8, interpret=True)
    args = (bd, t(ORIGIN, torch.float32), scene["vox"], scene["trunc"],
            t(occ0), t(occ1), t(binp), t(scene["w2c"]),
            *map(f32, scene["K"]))
    bits_t = active_mask_reference(*args, mip_cell=8)
    assert_bits_match(bits_t, bits_j)
    # the wrapper takes the plain version on CPU tensors, without counting
    with profiling.recording() as rec:
        np.testing.assert_array_equal(active_mask(*args, mip_cell=8).numpy(),
                                      bits_t.numpy())
    assert rec.counters == {}
    assert (np.asarray(bits_j) != 0).any()


@pytest.mark.parametrize("n_frames", [1, 3, 8])
@pytest.mark.parametrize("mip_cell", [8, 16, 32])
def test_k2_plain_matches_pallas_interpret_at_cell(mip_cell, n_frames):
    """K2's plain version against the interpreted TPU kernel at each mip
    cell and frame count, on 128x256 frames (every cell divides them) seen
    at fx 300, so that brick centres project left of or above the image:
    negative pixel coordinates, which the CUDA kernel floors by an
    arithmetic shift."""
    depths, poses, K = make_sphere_depths(n_views=n_frames, H=128, W=256,
                                          fx=300.0, fy=300.0)
    w2c = torch.linalg.inv(torch.from_numpy(poses)).numpy()
    dims, vox = (32, 32, 32), 0.3 / 31
    bd = _brick_dims(dims)
    occ0, occ1, binp = jb._build_depth_occupancy(jnp.asarray(depths), 1000.0,
                                                 3.0, mip_cell)
    assert occ0.shape == (n_frames, 128 // mip_cell, 256 // mip_cell)
    fx, fy, cx, cy = K
    # the brick centres' truncated pixel coordinates: some are <= -1
    ids = torch.arange(bd[0] * bd[1] * bd[2])
    c = torch.stack(_brick_centers(ids, bd, t(ORIGIN, torch.float32),
                                   float(np.float32(vox))), 1).double()
    cam = c @ torch.from_numpy(w2c[:, :3, :3]).double().transpose(1, 2) \
        + torch.from_numpy(w2c[:, None, :3, 3]).double()
    u = cam[..., 0] / cam[..., 2] * fx + cx
    v = cam[..., 1] / cam[..., 2] * fy + cy
    assert ((u <= -1) | (v <= -1)).any()
    bits_j = jb.active_brick_bits_pallas(
        bd, jnp.asarray(ORIGIN, jnp.float32), vox, 5.0 * vox, occ0, occ1,
        binp, jnp.asarray(w2c), fx, fy, cx, cy, 3.0, mip_cell,
        interpret=True)
    bits_t = active_mask_reference(
        bd, t(ORIGIN, torch.float32), vox, 5.0 * vox, t(occ0), t(occ1),
        t(binp), t(w2c), *map(f32, K), mip_cell=mip_cell)
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j))
    assert (np.asarray(bits_j) != 0).any()


def test_exact_frame_bits_dilated_bitexact(scene):
    occ0, occ1, binp = _mask_inputs(scene)
    bd = _brick_dims(scene["dims"])
    fx, fy, cx, cy = scene["K"]
    origin = jnp.asarray(ORIGIN, jnp.float32)
    bits = jb.active_brick_bits_pallas(
        bd, origin, scene["vox"], scene["trunc"], occ0, occ1, binp,
        jnp.asarray(scene["w2c"]), fx, fy, cx, cy, 3.0, 8, interpret=True)
    for cap in (4096, 7):  # 7: most candidates overflow the refine cap
        ej = jb._exact_frame_bits_dilated(
            bits, jnp.asarray(scene["depths"]), jnp.asarray(scene["w2c"]),
            origin, scene["vox"], scene["trunc"],
            jnp.asarray(scene["K"], jnp.float32), bd, cap, 1000.0, 3.0)
        et = refine_bits_reference(
            t(bits), t(scene["depths"]), t(scene["w2c"]),
            t(ORIGIN, torch.float32), scene["vox"], scene["trunc"],
            tuple(map(f32, scene["K"])), bd, cap, 1000.0, 3.0)
        # the plain version keeps only K2's bits, as the wrapper does
        assert_bits_match(et, np.asarray(bits) & np.asarray(ej))


def test_refine_frame_bits_takes_the_plain_version_on_cpu(scene):
    """On CPU tensors the refine wrapper is the plain chain, bit for bit,
    with no ``kernel.*`` counter; a tensor on another device is refused."""
    bd = _brick_dims(scene["dims"])
    d, w2c = t(scene["depths"]), t(scene["w2c"])
    origin, intr = t(ORIGIN, torch.float32), tuple(map(f32, scene["K"]))
    occ = occupancy_bits_reference(d, 1000.0, 3.0, 8)
    bits = active_mask(bd, origin, scene["vox"], scene["trunc"], *occ, w2c,
                       *intr, mip_cell=8)
    args = (d, w2c, origin, scene["vox"], scene["trunc"], intr, bd,
            tb.REFINE_CAP)
    with profiling.recording() as rec:
        got = refine_bits(bits, *args)
    want = refine_bits_reference(bits, *args, 1000.0, 3.0)
    assert torch.equal(got, want) and (got != 0).any()
    assert rec.counters == {}
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in (bits, *args)]
    with pytest.raises(ValueError, match="unsupported device meta"):
        refine_bits(*meta)


def test_refine_refuses_more_frames_than_its_bit_words_hold():
    """31 frames at most: bit 31 is the i32 word's sign, which the plain
    version's max-scatter drops and the JAX function cannot form. The
    wrapper refuses 32 on any device, as K2's wrapper refuses 33, before
    any work."""
    bd, origin = (2, 2, 2), t(ORIGIN, torch.float32)
    bits = torch.ones(8, dtype=torch.int32)
    d = torch.zeros((32, 16, 32), dtype=torch.float32)
    T = torch.eye(4).expand(32, 4, 4).contiguous()
    intr = (20.0, 20.0, 16.0, 8.0)
    with profiling.recording() as rec:
        with pytest.raises(ValueError, match="32 frames"):
            refine_bits(bits, d, T, origin, 0.01, 0.05, intr, bd, 4096)
        with pytest.raises(ValueError, match="32 frames"):
            refine_bits(bits.to("meta"), d.to("meta"), T.to("meta"),
                        origin.to("meta"), 0.01, 0.05, intr, bd, 4096)
        # 31 frames take the plain chain
        out = refine_bits(bits, d[:31], T[:31].contiguous(), origin, 0.01,
                          0.05, intr, bd, 4096)
    assert out.shape == (8,) and out.dtype == torch.int32
    assert rec.counters == {}


def test_active_brick_mask_bitexact(scene):
    bd = _brick_dims(scene["dims"])
    mj = jb.active_brick_mask(
        bd, jnp.asarray(ORIGIN, jnp.float32), scene["vox"], scene["trunc"],
        jnp.asarray(scene["depths"]), jnp.asarray(scene["w2c"]),
        *scene["K"])
    mt = tb.active_brick_mask(
        bd, t(ORIGIN, torch.float32), scene["vox"], scene["trunc"],
        t(scene["depths"]), t(scene["w2c"]), *map(f32, scene["K"]))
    assert_bits_match(mt, mj)
    assert np.asarray(mj).any()


def _dense_reference(depths, poses, K, dims, vox, colors=None):
    with jax_eager():
        g = jtsdf.make_grid(dims, ORIGIN, vox, with_color=colors is not None)
        g = jtsdf.integrate_frames(
            g, jnp.asarray(depths), jnp.asarray(poses), *K,
            colors=None if colors is None
            else jnp.asarray(colors, jnp.float32) / 255.0)
    return g


def test_device_path_matches_jax_dense(scene):
    """The port's whole brick path (plain kernels) equals the dense engine
    on the voxels both observed equally often. On the 4-view scene that is
    every voxel both observed; with 8 views the per-frame bits skip some
    free-space (+1) observations beyond a frame's band by design."""
    d, p, K, dims, vox = (scene[k] for k in ("depths", "poses", "K", "dims",
                                              "vox"))
    g = tb.make_brick_grid(dims, ORIGIN, vox, device="cpu")
    g, n_active = tb.integrate_frames_bricked_device(g, d, p, *K)
    assert int(n_active) > 0
    dense = _dense_reference(d, p, K, dims, vox)
    sdf_b, w_b = (a.numpy() for a in tb.to_dense(g))
    w_d = np.asarray(dense.weight)
    both = (w_b > 0) & (w_d > 0)
    same = both & (w_b == w_d)
    assert both.sum() > 1000 and same.sum() >= 0.9 * both.sum()
    if len(d) <= 4:
        assert same.sum() == both.sum()
    diff = np.abs(sdf_b - np.asarray(dense.sdf))[same]
    assert diff.max() <= 1e-6, diff.max()


def test_device_path_color_matches_jax_dense():
    depths, poses, K = make_sphere_depths(n_views=4, H=128, W=256,
                                          fx=120.0, fy=120.0)
    F, H, W = depths.shape
    colors = np.zeros((F, H, W, 3), np.uint8)
    colors[..., 0] = np.arange(W)[None, None, :] * 255 // W
    colors[..., 1] = np.arange(H)[None, :, None] * 255 // H
    colors[..., 2] = 128
    dims, vox = (64, 64, 64), 0.3 / 63
    g = tb.make_brick_grid(dims, ORIGIN, vox, with_color=True, device="cpu")
    g, _ = tb.integrate_frames_bricked_device(g, depths, poses, *K,
                                              colors=colors)
    dense = _dense_reference(depths, poses, K, dims, vox, colors)
    wb = tb.to_dense(g)[1].numpy()
    both = (wb > 0) & (np.asarray(dense.weight) > 0)
    assert both.sum() > 1000
    diff = np.abs(tb.to_dense_color(g).numpy() - np.asarray(dense.color))[both]
    # one u8 rounding per 4-frame chunk bounds the drift
    assert np.quantile(diff, 0.99) < 8 / 255.0, np.quantile(diff, 0.99)


def test_fallback_mask_branch_matches_jax_dense():
    """Frames no mip cell divides take the centre-sample mask + dilation."""
    depths, poses, K = make_sphere_depths(n_views=3, H=100, W=250,
                                          fx=120.0, fy=120.0)
    dims, vox = (32, 32, 32), 0.3 / 31
    g = tb.make_brick_grid(dims, ORIGIN, vox, device="cpu")
    g, n_active = tb.integrate_frames_bricked_device(g, depths, poses, *K)
    assert int(n_active) > 0
    dense = _dense_reference(depths, poses, K, dims, vox)
    sdf_b, w_b = (a.numpy() for a in tb.to_dense(g))
    both = (w_b > 0) & (np.asarray(dense.weight) > 0)
    assert both.sum() > 1000
    assert np.abs(sdf_b - np.asarray(dense.sdf))[both].max() <= 1e-6


def test_n_active_is_unclamped_and_cap_drops_bricks(scene):
    d, p, K, dims, vox = (scene[k] for k in ("depths", "poses", "K", "dims",
                                              "vox"))
    full = tb.make_brick_grid(dims, ORIGIN, vox, device="cpu")
    full, n_full = tb.integrate_frames_bricked_device(full, d, p, *K)
    capped = tb.make_brick_grid(dims, ORIGIN, vox, device="cpu")
    capped, n_capped = tb.integrate_frames_bricked_device(
        capped, d, p, *K, max_active=4)
    # n_active counts the mask before the cap (the refine cap also shrinks
    # to max_active, so the mask itself may grow)
    assert int(n_capped) >= int(n_full) > 4
    touched = lambda g: int((g.weight.reshape(g.weight.shape[0], -1)  # noqa: E731
                             > 0).any(1).sum())
    assert touched(capped) <= 4 < touched(full)


def test_kernel_wrappers_check_their_inputs():
    occ = torch.zeros((2, 4, 4), dtype=torch.int32)
    binp = torch.tensor([0.0, 0.01])
    T = torch.eye(4).repeat(2, 1, 1)
    origin = torch.zeros(3)
    with pytest.raises(ValueError, match="occ1"):
        active_mask((1, 1, 1), origin, 0.01, 0.05, occ, occ.float(), binp,
                    T, 1.0, 1.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="mip_cell"):
        active_mask((1, 1, 1), origin, 0.01, 0.05, occ, occ, binp, T, 1.0,
                    1.0, 0.0, 0.0, mip_cell=4)
    plane = torch.zeros((2, 8, 128))
    ids = torch.zeros(1, dtype=torch.int32)
    n = torch.ones(1, dtype=torch.int32)
    depths = torch.zeros((2, 4, 4))
    with pytest.raises(ValueError, match="ids"):
        brick_integrate(plane, plane.clone(), None, ids.long(), ids, n, T,
                        (1.0, 1.0, 0.0, 0.0), depths, None, origin,
                        (1, 1, 1), 0.01, 0.05, 1000.0, 3.0, 64.0)
    with pytest.raises(ValueError, match="together"):
        brick_integrate(plane, plane.clone(), None, ids, ids, n, T,
                        (1.0, 1.0, 0.0, 0.0), depths,
                        depths.int(), origin, (1, 1, 1), 0.01, 0.05,
                        1000.0, 3.0, 64.0)


def _chunk_bits(scene, **kw):
    """The port's active set of the scene's frames as per-brick frame bits
    (NB,), with the live count and the ids."""
    bd = _brick_dims(scene["dims"])
    NB = bd[0] * bd[1] * bd[2]
    ids, fbits, n, n_mask = tb.chunk_active_set(
        t(scene["depths"]), t(scene["w2c"]), tuple(map(f32, scene["K"])),
        t(ORIGIN, torch.float32), bd, scene["vox"], scene["trunc"], 8192, NB,
        **kw)
    n = int(n)
    assert int(n_mask) == n and (ids[n:] == NB).all() and (fbits[n:] == 0).all()
    assert (ids[:n].diff() > 0).all()  # index order
    bits = np.zeros(NB, np.int32)
    bits[ids[:n].numpy()] = fbits[:n].numpy()
    return bits, n


def test_chunk_active_set_dilate_active(scene):
    """``dilate_active=True`` grows the active mask one brick along each
    axis with wrap-around rolls and turns every frame bit on for the
    masked bricks, as the JAX path does after its refine
    (``reconplan_tpu/ops/tsdf_brick.py:1252-1258``); the default path's
    bits stay as they were."""
    bd = _brick_dims(scene["dims"])
    all_on = (1 << len(scene["depths"])) - 1
    bits, n = _chunk_bits(scene)
    again, _ = _chunk_bits(scene, dilate_active=False)
    np.testing.assert_array_equal(bits, again)
    m = jnp.asarray(bits != 0).reshape(bd)
    for ax in range(3):
        m = m | jnp.roll(m, 1, ax) | jnp.roll(m, -1, ax)
    expect = np.where(np.asarray(m).reshape(-1), bits | all_on, 0)
    dilated, n_dil = _chunk_bits(scene, dilate_active=True)
    np.testing.assert_array_equal(dilated, expect)
    assert n_dil == int(np.asarray(m).sum()) >= n
    if scene["dims"][0] == 64:
        # bricks join and frame bits turn on: the option has teeth here
        assert n_dil > n and (bits[bits != 0] != all_on).any()
