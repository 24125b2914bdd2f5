"""The CUDA kernels against their plain PyTorch versions, and the
kinematics on the card against the same calls on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels are CUDA C++ and have no CPU mode. This file imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import importlib
import os
import re

import numpy as np
import pytest
import torch

from reconplan_tpu_torch import bench
from reconplan_tpu_torch.bench import make_frames
from reconplan_tpu_torch.ops import tsdf as ttsdf
from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.ops.kernels import (
    active_mask,
    active_mask_reference,
    brick_ablate,
    brick_ablate_reference,
    brick_integrate,
    brick_integrate_fixed,
    brick_integrate_fixed_reference,
    brick_integrate_reference,
    gather_probe,
    gather_probe_reference,
    occupancy_bits,
    occupancy_bits_reference,
    refine_bits,
    refine_bits_reference,
)
from reconplan_tpu_torch.ops.kernels.active_mask import MIP_CELLS
from reconplan_tpu_torch.ops.kernels.brick_ablate import ARMS, footprint
from reconplan_tpu_torch.ops.kernels.brick_ablate import (
    grid_size as ablate_grid_size,
)
from reconplan_tpu_torch.ops.kernels.brick_integrate import (
    _project_voxels,
    _voxel_world,
    grid_size,
)
from reconplan_tpu_torch.ops.kernels.brick_integrate_fixed import (
    MAX_FRAMES,
    occupancy as k3_occupancy,
)
from reconplan_tpu_torch.ops.kernels.gather_probe import ARMS as PROBE_ARMS
from reconplan_tpu_torch.ops.kernels.gather_probe import GRID as PROBE_GRID
from reconplan_tpu_torch.ops.kernels.refine_bits import (
    _brick_centers,
    _project,
)
from reconplan_tpu_torch.parallel import (
    gather_brick_grid,
    make_mesh,
    make_sharded_brick_grid,
    sharded_integrate_frames_bricked,
)
from reconplan_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

DIMS = (64, 64, 64)
ORIGIN = (-0.16, -0.16, -0.16)
VOX = 0.32 / 63


def launches(rec, name):
    """The launches the wrapper ``name`` counted in a recording
    (``kernel.<name>``)."""
    return rec.counters.get("kernel." + name, 0)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def chunk(card):
    depths, poses, K = make_frames(8, H=120, W=160, fx=150.0, fy=150.0)
    d = torch.as_tensor(depths, device=card)
    T = torch.linalg.inv(torch.as_tensor(poses, device=card)).contiguous()
    intr = tuple(float(np.float32(v)) for v in K)
    origin = torch.tensor(ORIGIN, dtype=torch.float32, device=card)
    return dict(d=d, T=T, intr=intr, origin=origin, poses=poses, K=K,
                depths=depths)


def test_k2_bits_identical_to_plain(chunk):
    occ0, occ1, binp = occupancy_bits_reference(chunk["d"], 1000.0, 3.0, 8)
    args = ((8, 8, 4), chunk["origin"], VOX, 5 * VOX, occ0, occ1, binp,
            chunk["T"], *chunk["intr"])
    with profiling.recording() as rec:
        bits = active_mask(*args, mip_cell=8)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.active_mask": 1}
    ref = active_mask_reference(*args, mip_cell=8)
    assert torch.equal(bits, ref)
    assert (bits != 0).any()


@pytest.mark.parametrize("with_color", [False, True])
def test_k1_matches_plain(chunk, with_color):
    """sdf within 1e-6, weight and packed rgb identical."""
    bd = (8, 8, 4)
    NB = 256
    n_frames = 4 if with_color else 8
    d, T = chunk["d"][:n_frames], chunk["T"][:n_frames]
    ids, fbits, n, _ = tb.chunk_active_set(
        d, T, chunk["intr"], chunk["origin"], bd, VOX, 5 * VOX, 8192, NB)
    gen = torch.Generator(device=d.device).manual_seed(0)
    planes = [
        torch.rand((NB + 1, 8, 128), generator=gen, device=d.device) * 2 - 1,
        torch.randint(0, 5, (NB + 1, 8, 128), generator=gen,
                      device=d.device).float(),
        torch.randint(0, 1 << 24, (NB + 1, 8, 128), generator=gen,
                      dtype=torch.int32, device=d.device)
        if with_color else None,
    ]
    colors = (torch.randint(0, 1 << 24, d.shape, generator=gen,
                            dtype=torch.int32, device=d.device)
              if with_color else None)
    ref = [None if a is None else a.clone() for a in planes]
    rest = (ids, fbits, n, T, chunk["intr"], d, colors, chunk["origin"], bd,
            VOX, 5 * VOX, 1000.0, 3.0, 64.0)
    with profiling.recording() as rec:
        brick_integrate(*planes, *rest)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.brick_integrate": 1}
    brick_integrate_reference(*ref, *rest)
    assert (planes[0] - ref[0]).abs().max().item() <= 1e-6
    assert torch.equal(planes[1], ref[1])
    if with_color:
        assert torch.equal(planes[2], ref[2])
    assert not torch.equal(planes[1], ref[1].new_zeros(ref[1].shape))


def test_device_path_matches_dense_engine_on_card(chunk, card):
    """The brick path through both kernels against the dense engine on the
    voxels both observed equally often."""
    K = chunk["K"]
    g = tb.make_brick_grid(DIMS, ORIGIN, VOX, device=card)
    with profiling.recording() as rec:
        g, n_active = tb.integrate_frames_bricked_device(
            g, chunk["depths"], chunk["poses"], *K)
    assert launches(rec, "brick_integrate") > 0
    assert launches(rec, "active_mask") > 0
    dense = ttsdf.integrate_frames(
        ttsdf.make_grid(DIMS, ORIGIN, VOX, device=card), chunk["depths"],
        chunk["poses"], *K)
    sdf_b, w_b = tb.to_dense(g)
    same = (w_b > 0) & (w_b == dense.weight)
    assert same.sum().item() > 1000 and int(n_active) > 0
    assert (sdf_b - dense.sdf)[same].abs().max().item() <= 1e-6


def test_fusion_counts_each_kernel_once_a_chunk(card):
    """The card's twin of ``test_torch_tracing``'s fuse case: 16 frames
    (two chunks) through the device path, and each of the chunk's four
    kernels counted once a chunk."""
    depths, poses, K = make_frames(16, H=120, W=160, fx=150.0, fy=150.0)
    g = tb.make_brick_grid(DIMS, ORIGIN, VOX, device=card)
    with profiling.recording() as rec:
        tb.integrate_frames_bricked_device(g, depths, poses, *K)
    kernels = {k: n for k, n in rec.counters.items()
               if k.startswith("kernel.")}
    assert rec.counters["tsdf.chunks"] == 2
    assert kernels == dict.fromkeys(
        ("kernel.occupancy_bits", "kernel.active_mask", "kernel.refine_bits",
         "kernel.brick_integrate"), 2)


@pytest.mark.parametrize("id_base,n_real", [(0, 256), (128, 128)])
def test_k3_matches_plain(chunk, card, id_base, n_real):
    """K3 on a random prior state, the whole grid and its second half as a
    shard: sdf within 1e-6, weight identical, padding untouched."""
    bd = (8, 8, 4)
    mask = tb.active_brick_mask(bd, chunk["origin"], VOX, 5 * VOX,
                                chunk["d"], chunk["T"], *chunk["intr"])
    local = torch.nonzero(mask[id_base:id_base + n_real])[:, 0].int()
    assert 0 < len(local) < n_real
    ids = torch.cat([local, local.new_full((512 - len(local),), n_real)])
    gen = torch.Generator(device=card).manual_seed(1)
    planes = [
        torch.rand((n_real + 1, 8, 128), generator=gen, device=card) * 2 - 1,
        torch.randint(0, 5, (n_real + 1, 8, 128), generator=gen,
                      device=card).float(),
    ]
    ref = [a.clone() for a in planes]
    rest = (ids, id_base, n_real, chunk["T"], chunk["intr"], chunk["d"],
            chunk["origin"], bd, VOX, 5 * VOX, 1000.0, 3.0, 64.0)
    with profiling.recording() as rec:
        brick_integrate_fixed(*planes, *rest)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.brick_integrate_fixed": 1}
    brick_integrate_fixed_reference(*ref, *rest)
    assert (planes[0] - ref[0]).abs().max().item() <= 1e-6
    assert torch.equal(planes[1], ref[1])
    assert not torch.equal(planes[1], ref[1].new_zeros(ref[1].shape))
    assert torch.equal(planes[0][-1], ref[0][-1])  # the scratch row


def test_bricked_and_sharded_paths_launch_k3(chunk, card):
    """The host-compacted path against the dense engine, and four shards on
    the one card bit-identical to it (one chunk, no dilation)."""
    K = chunk["K"]
    g = tb.make_brick_grid(DIMS, ORIGIN, VOX, device=card)
    with profiling.recording() as rec:
        g, n_active = tb.integrate_frames_bricked(
            g, chunk["depths"], chunk["poses"], *K, dilate_active=False)
    assert launches(rec, "brick_integrate_fixed") == 1 and n_active > 0
    dense = ttsdf.integrate_frames(
        ttsdf.make_grid(DIMS, ORIGIN, VOX, device=card), chunk["depths"],
        chunk["poses"], *K)
    sdf_b, w_b = tb.to_dense(g)
    seen = w_b > 0
    assert torch.equal(w_b[seen], dense.weight[seen])
    assert (sdf_b - dense.sdf)[seen].abs().max().item() <= 1e-6
    g_nbl = make_sharded_brick_grid(DIMS, ORIGIN, VOX,
                                    mesh=make_mesh(devices=[card] * 4))
    with profiling.recording() as rec:
        g_nbl, n_sh = sharded_integrate_frames_bricked(
            g_nbl, chunk["depths"], chunk["poses"], *K,
            max_active_per_device=64)
    assert launches(rec, "brick_integrate_fixed") == 4
    assert int(n_sh) == n_active
    gathered = gather_brick_grid(g_nbl)
    assert torch.equal(gathered.sdf, g.sdf)
    assert torch.equal(gathered.weight, g.weight)


def _ablate_case(card, d, T, intr, origin, bd):
    """A random prior state on the bricks of (NB + 1, 8, 128) planes, and
    the chunk's real active set."""
    NB = bd[0] * bd[1] * bd[2]
    ids, fbits, n, _ = tb.chunk_active_set(d, T, intr, origin, bd, VOX,
                                           5 * VOX, 8192, NB)
    gen = torch.Generator(device=card).manual_seed(2)
    planes = (
        torch.rand((NB + 1, 8, 128), generator=gen, device=card) * 2 - 1,
        torch.randint(0, 5, (NB + 1, 8, 128), generator=gen,
                      device=card).float(),
    )
    rest = (ids, fbits, n, T, intr, d, origin, bd, VOX, 5 * VOX, 1000.0,
            3.0, 64.0)
    return planes, rest


# the arms that compute what K1 computes, another way
AS_K1_ARMS = ("full", "smem_window", "no_skips", "static_stride", "pr1_full")


def _check_arm(arm, planes, rest):
    """The arm's kernel against its plain version (sdf within 1e-6, weight
    identical) and, for the arms of ``AS_K1_ARMS``, against K1 bit for
    bit."""
    out = [a.clone() for a in planes]
    ref = [a.clone() for a in planes]
    with profiling.recording() as rec:
        brick_ablate(arm, *out, *rest)
    torch.cuda.synchronize()
    assert rec.counters == {f"kernel.brick_ablate.{arm}": 1}
    brick_ablate_reference(arm, *ref, *rest)
    assert (out[0] - ref[0]).abs().max().item() <= 1e-6
    assert torch.equal(out[1], ref[1])
    if arm == "rw_only":
        assert all(torch.equal(a, b) for a, b in zip(out, planes))
    else:
        assert not torch.equal(out[1], planes[1])
    if arm in AS_K1_ARMS:
        k1 = [a.clone() for a in planes]
        brick_integrate(*k1, None, *rest[:6], None, *rest[6:])
        assert _same_bits(out[0], k1[0]) and _same_bits(out[1], k1[1])


@pytest.mark.parametrize("arm", ARMS)
def test_ablate_arm_matches_plain(chunk, card, arm):
    planes, rest = _ablate_case(card, chunk["d"], chunk["T"], chunk["intr"],
                                chunk["origin"], (8, 8, 4))
    _check_arm(arm, planes, rest)


@pytest.mark.parametrize("arm", ["full", "smem_window", "one_row",
                                 "no_skips"])
def test_ablate_tall_footprints(card, arm):
    """640x480 frames at fx 615.67 on the 64^3 grid of 5 mm voxels: brick
    footprints taller than the 64-row tile, so smem_window reads their
    rest from global memory."""
    depths, poses, K = make_frames(4)
    d = torch.as_tensor(depths, device=card)
    T = torch.linalg.inv(torch.as_tensor(poses, device=card)).contiguous()
    intr = tuple(float(np.float32(v)) for v in K)
    origin = torch.tensor(ORIGIN, dtype=torch.float32, device=card)
    bd = (8, 8, 4)
    planes, rest = _ablate_case(card, d, T, intr, origin, bd)
    ids, n = rest[0], int(rest[2].item())
    wx, wy, wz = _voxel_world(ids[:n], bd, origin, VOX)
    _, _, vmin, vmax = footprint(T[0].reshape(16), wx, wy, wz, intr,
                                 *d.shape[1:])
    assert (vmax - vmin + 1 > 64).any()
    _check_arm(arm, planes, rest)


PROBE_CASES = [(arm, s0) for arm in PROBE_ARMS for s0 in (0, 5, 8)] + [
    ("smem_roll", 31), ("smem_slice", 31)]


@pytest.mark.parametrize("arm,s0", PROBE_CASES)
def test_probe_arm_matches_plain(card, arm, s0):
    """Bit for bit, and the same output at twice the steps and at one
    step (a grid of one block)."""
    x = torch.rand((32, 256), generator=torch.Generator(device=card)
                   .manual_seed(3), device=card)
    with profiling.recording() as rec:
        out = gather_probe(arm, x, s0)
    torch.cuda.synchronize()
    assert rec.counters == {f"kernel.gather_probe.{arm}": 1}
    ref = gather_probe_reference(arm, x, s0)
    assert torch.equal(out, ref)
    assert torch.equal(gather_probe(arm, x, s0, steps=2 * PROBE_GRID), ref)
    assert torch.equal(gather_probe(arm, x, s0, steps=1), ref)


def test_probe_wrapper_refuses_a_misaligned_window(card):
    x = torch.rand(32 * 256 + 1, device=card)[1:].view(32, 256)
    assert x.is_contiguous() and x.data_ptr() % 16
    with profiling.recording() as rec:
        with pytest.raises(ValueError, match="aligned"):
            gather_probe("smem_roll", x, 0)
        with pytest.raises(ValueError, match="steps"):
            gather_probe("baseline", x.clone(), 0, steps=0)
    assert rec.counters == {}


# --- the persistent K1 and the per-(brick, frame) K2 at their edges -------

WIDE_ORIGIN = (-0.4, -0.4, -0.4)
WIDE_VOX = 0.8 / 127  # 128^3: 2048 bricks, many outside a 120x160 view


def _k1_case(card, n_frames, bd, origin, vox, fb, with_color, seed=5):
    """Bricks in a random order with the frame bits ``fb`` ((NB,) i32), a
    random prior state, and frames of the 120x160 sphere orbit."""
    depths, poses, K = make_frames(n_frames, H=120, W=160, fx=150.0,
                                   fy=150.0)
    d = torch.as_tensor(depths, device=card)
    T = torch.linalg.inv(torch.as_tensor(poses, device=card)).contiguous()
    intr = tuple(float(np.float32(v)) for v in K)
    NB = bd[0] * bd[1] * bd[2]
    gen = torch.Generator(device=card).manual_seed(seed)
    ids = torch.randperm(NB, generator=gen, device=card).int()
    planes = [
        torch.rand((NB + 1, 8, 128), generator=gen, device=card) * 2 - 1,
        torch.randint(0, 5, (NB + 1, 8, 128), generator=gen,
                      device=card).float(),
        torch.randint(0, 1 << 24, (NB + 1, 8, 128), generator=gen,
                      dtype=torch.int32, device=card) if with_color else None,
    ]
    colors = (torch.randint(0, 1 << 24, d.shape, generator=gen,
                            dtype=torch.int32, device=card)
              if with_color else None)
    org = torch.tensor(origin, dtype=torch.float32, device=card)
    rest = [ids, fb.to(card), None, T, intr, d, colors, org, bd, vox,
            5 * vox, 1000.0, 3.0, 64.0]
    return planes, rest


def _k1_matches_plain(planes, rest, n):
    """K1 with live count ``n`` against its plain version: sdf within
    1e-6, weight and rgb identical (bricks past n untouched by both)."""
    rest = list(rest)
    rest[2] = torch.tensor([n], dtype=torch.int32, device=planes[0].device)
    out = [None if a is None else a.clone() for a in planes]
    ref = [None if a is None else a.clone() for a in planes]
    with profiling.recording() as rec:
        brick_integrate(*out, *rest)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.brick_integrate": 1}
    brick_integrate_reference(*ref, *rest)
    assert (out[0] - ref[0]).abs().max().item() <= 1e-6
    assert torch.equal(out[1], ref[1])
    if out[2] is not None:
        assert torch.equal(out[2], ref[2])
    return out


def test_k1_live_counts_around_the_persistent_grid(card):
    """n_live = 0, 1, the persistent grid, one past it, max_active and 5
    past max_active (the kernel reads no id past len(ids)): every live
    brick folded once, the rest untouched, twice in a row (the work
    counter is back at zero after each launch)."""
    bd = (16, 16, 8)
    NB = bd[0] * bd[1] * bd[2]
    gen = torch.Generator().manual_seed(6)
    fb = torch.randint(0, 256, (NB,), generator=gen, dtype=torch.int32)
    fb[::7] = 0  # bricks with no frame between live ones
    planes, rest = _k1_case(card, 8, bd, WIDE_ORIGIN, WIDE_VOX, fb, False)
    G = grid_size(False, card, NB)
    assert 1 < G < NB
    for n in (0, 1, G, G + 1, NB, NB + 5):
        out = _k1_matches_plain(planes, rest, n)
        if n == 0:
            assert all(torch.equal(a, b) for a, b in zip(out[:2], planes))
        _k1_matches_plain(planes, rest, n)
    assert not torch.equal(out[1], planes[1])


def test_k1_all_32_frame_bits(card):
    bd = (8, 8, 4)
    NB = bd[0] * bd[1] * bd[2]
    fb = torch.full((NB,), -1, dtype=torch.int32)  # all 32 bits
    planes, rest = _k1_case(card, 32, bd, ORIGIN, VOX, fb, False)
    out = _k1_matches_plain(planes, rest, NB)
    # each voxel a frame observes gains up to 32 frames of weight
    assert (out[1] - planes[1]).max().item() > 8


@pytest.mark.parametrize("with_color", [False, True])
def test_k1_footprints_partly_outside_the_image(card, with_color):
    bd = (16, 16, 8)
    NB = bd[0] * bd[1] * bd[2]
    n_frames = 4 if with_color else 8
    fb = torch.full((NB,), (1 << n_frames) - 1, dtype=torch.int32)
    planes, rest = _k1_case(card, n_frames, bd, WIDE_ORIGIN, WIDE_VOX, fb,
                            with_color)
    ids, T, intr, d, org = rest[0], rest[3], rest[4], rest[5], rest[7]
    wx, wy, wz = _voxel_world(ids, bd, org, WIDE_VOX)
    _, _, _, in_img, _ = _project_voxels(T[0].reshape(16), wx, wy, wz, intr,
                                         *d.shape[1:])
    share = in_img.float().mean(dim=1)
    assert ((share > 0) & (share < 1)).sum().item() > 10
    _k1_matches_plain(planes, rest, NB)


def test_k1_on_two_streams_at_once(card):
    """Two launches on two streams, neither waiting for the other, each
    equal to its plain version: each stream takes bricks from its own
    work counter."""
    bd = (16, 16, 8)
    NB = bd[0] * bd[1] * bd[2]
    fb = torch.randint(0, 256, (NB,), generator=torch.Generator()
                       .manual_seed(7), dtype=torch.int32)
    cases = [_k1_case(card, 8, bd, WIDE_ORIGIN, WIDE_VOX, fb, False,
                      seed=s) for s in (8, 9)]
    outs, refs = [], []
    for planes, rest in cases:
        rest[2] = torch.tensor([NB - 3], dtype=torch.int32, device=card)
        outs.append([a.clone() for a in planes[:2]])
        refs.append([a.clone() for a in planes[:2]])
        brick_integrate_reference(*refs[-1], None, *rest)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card) for _ in cases]
    for _ in range(3):
        for stream, out, (_, rest) in zip(streams, outs, cases):
            with torch.cuda.stream(stream):
                brick_integrate(*out, None, *rest)
        torch.cuda.synchronize()
        for out, ref, (_, rest) in zip(outs, refs, cases):
            assert (out[0] - ref[0]).abs().max().item() <= 1e-6
            assert torch.equal(out[1], ref[1])
            brick_integrate_reference(*ref, None, *rest)


@pytest.mark.parametrize("mip_cell", MIP_CELLS)
@pytest.mark.parametrize("n_frames", [1, 3, 8, 32])
def test_k2_frame_counts_and_cells(card, n_frames, mip_cell):
    """K2 at F frames (a brick's frame groups padded to a power of two on
    a warp's lanes) and each mip cell, with brick centres left of and
    above the image."""
    depths, poses, K = make_frames(n_frames, H=128, W=256, fx=300.0,
                                   fy=300.0)
    d = torch.as_tensor(depths, device=card)
    T = torch.linalg.inv(torch.as_tensor(poses, device=card)).contiguous()
    intr = tuple(float(np.float32(v)) for v in K)
    bd = (16, 16, 8)
    origin = torch.tensor(WIDE_ORIGIN, dtype=torch.float32, device=card)
    ids = torch.arange(bd[0] * bd[1] * bd[2], device=card)
    x, y, z = _project(T[0], *_brick_centers(ids, bd, origin, WIDE_VOX))
    u, v = x / z * intr[0] + intr[2], y / z * intr[1] + intr[3]
    assert (((u <= -1) | (v <= -1)) & (z > 0)).any()
    occ0, occ1, binp = occupancy_bits_reference(d, 1000.0, 3.0, mip_cell)
    args = (bd, origin, WIDE_VOX, 5 * WIDE_VOX, occ0, occ1, binp, T, *intr)
    with profiling.recording() as rec:
        bits = active_mask(*args, mip_cell=mip_cell)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.active_mask": 1}
    assert torch.equal(bits, active_mask_reference(*args, mip_cell=mip_cell))
    assert (bits != 0).any()


def test_k2_wrapper_refuses_other_cells(chunk):
    occ0, occ1, binp = occupancy_bits_reference(chunk["d"], 1000.0, 3.0, 8)
    with profiling.recording() as rec:
        with pytest.raises(ValueError, match="mip_cell"):
            active_mask((8, 8, 4), chunk["origin"], VOX, 5 * VOX, occ0, occ1,
                        binp, chunk["T"], *chunk["intr"], mip_cell=4)
    assert rec.counters == {}


# --- the refine (refine_bits): tests, ranks past the cap, wrap-around -----

# 2,176 bricks: two whole tiles of 1,024 and part of a third
REFINE_BD = (17, 16, 8)
FACES = [(0,), (-1,), (slice(None), 0), (slice(None), -1), (Ellipsis, 0),
         (Ellipsis, -1)]


def _refine_inputs(card, n_frames, mip_cell, bd=REFINE_BD, seed=31):
    """A chunk of the 128x256 sphere frames at fx 300 on the wide grid cut
    to ``bd`` bricks, K2's bits, and more candidates with random frame
    bits on every face of the grid, whose dilation wraps around."""
    depths, poses, K = make_frames(n_frames, H=128, W=256, fx=300.0,
                                   fy=300.0)
    d = torch.as_tensor(depths, device=card)
    T = torch.linalg.inv(torch.as_tensor(poses, device=card)).contiguous()
    intr = tuple(float(np.float32(v)) for v in K)
    origin = torch.tensor(WIDE_ORIGIN, dtype=torch.float32, device=card)
    occ = occupancy_bits_reference(d, 1000.0, 3.0, mip_cell)
    bits = active_mask(bd, origin, WIDE_VOX, 5 * WIDE_VOX, *occ, T, *intr,
                       mip_cell=mip_cell)
    g = torch.Generator().manual_seed(seed)
    b3 = bits.cpu().reshape(bd)
    for face in FACES:
        shape = b3[face].shape
        word = torch.randint(1, 1 << n_frames, shape, generator=g,
                             dtype=torch.int32)
        b3[face] |= torch.where(torch.rand(shape, generator=g) < 0.3,
                                word, 0).to(torch.int32)
    return b3.reshape(-1).to(card), d, T, intr, origin


def _refine_plain(bits, d, T, intr, origin, bd, cap, vox=WIDE_VOX):
    return refine_bits_reference(bits, d, T, origin, vox, 5 * vox, intr,
                                 bd, cap, 1000.0, 3.0)


def _refine(bits, d, T, intr, origin, bd, cap, vox=WIDE_VOX):
    with profiling.recording() as rec:
        out = refine_bits(bits, d, T, origin, vox, 5 * vox, intr, bd, cap)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.refine_bits": 1}
    return out


@pytest.mark.parametrize("cap", [7, 4096, 1 << 20])
@pytest.mark.parametrize("mip_cell", MIP_CELLS)
@pytest.mark.parametrize("n_frames", [1, 4, 8])
def test_refine_equals_plain(card, n_frames, mip_cell, cap):
    """The refine kernel against its plain version: most candidates past
    the cap (7), the production cap, and a cap no grid reaches; candidates
    on every face; NB not a multiple of the kernel's tile."""
    args = _refine_inputs(card, n_frames, mip_cell)
    bits = args[0]
    n_cand = int((bits != 0).sum())
    assert n_cand > 7 and np.prod(REFINE_BD) % 1024
    got = _refine(*args, REFINE_BD, cap)
    assert torch.equal(got, _refine_plain(*args, REFINE_BD, cap))
    assert (got != 0).any()
    if cap > n_cand:  # every candidate tested: the test prunes some
        assert (got != bits).any()


def test_refine_dilation_wraps_around(card):
    """Brick 0 is tested and fails (far from the sphere); the last brick,
    past a cap of 1, keeps its bits, and reaches brick 0 only across the
    grid's three wrap-around faces."""
    bits, d, T, intr, origin = _refine_inputs(card, 4, 8)
    bits = torch.zeros_like(bits)
    bits[0] = bits[-1] = 0b101
    got = _refine(bits, d, T, intr, origin, REFINE_BD, 1)
    assert torch.equal(got, _refine_plain(bits, d, T, intr, origin,
                                          REFINE_BD, 1))
    assert int(got[0]) == int(got[-1]) == 0b101
    tested = _refine(bits, d, T, intr, origin, REFINE_BD, 2)
    assert torch.equal(tested, _refine_plain(bits, d, T, intr, origin,
                                             REFINE_BD, 2))
    assert int(tested[0]) == int(tested[-1]) == 0


def test_refine_without_a_candidate(card):
    bits, d, T, intr, origin = _refine_inputs(card, 8, 8)
    bits = torch.zeros_like(bits)
    got = _refine(bits, d, T, intr, origin, REFINE_BD, 4096)
    assert torch.equal(got, bits)


@pytest.mark.parametrize("max_active", [32768, 2048])
def test_refine_at_the_fuse_cells_shape(card, max_active):
    """512^3, one 8-frame chunk of 640x480 bench frames (3,571
    candidates), the cap at 4,096 and at 2,048 as ``chunk_active_set``
    sets it: the kernel, counted once in ``kernel.refine_bits``, equals the
    plain version on the card and the wrapper on the CPU."""
    depths, poses, K = make_frames(8)
    d = torch.as_tensor(depths, device=card)
    T = torch.linalg.inv(torch.as_tensor(poses, device=card)).contiguous()
    intr = tuple(float(np.float32(v)) for v in K)
    grid = tb.make_brick_grid((bench.N,) * 3, bench.ORIGIN, bench.VOXEL,
                              device=card)
    bd = grid.brick_dims
    occ = occupancy_bits_reference(d, 1000.0, 3.0, 8)
    bits = active_mask(bd, grid.origin, bench.VOXEL, grid.trunc, *occ, T,
                       *intr, mip_cell=8)
    cap = min(max_active, tb.REFINE_CAP)
    assert int((bits != 0).sum()) > 2048
    with profiling.recording() as rec:
        got = refine_bits(bits, d, T, grid.origin, bench.VOXEL, grid.trunc,
                          intr, bd, cap)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.refine_bits": 1}
    plain = refine_bits_reference(bits, d, T, grid.origin, bench.VOXEL,
                                  grid.trunc, intr, bd, cap, 1000.0, 3.0)
    assert torch.equal(got, plain)
    cpu = refine_bits(bits.cpu(), d.cpu(), T.cpu(), grid.origin.cpu(),
                      bench.VOXEL, grid.trunc, intr, bd, cap)
    assert torch.equal(got.cpu(), cpu)
    assert (got != bits).any() and (got != 0).any()


@pytest.mark.parametrize("max_active", [16, 4096])
def test_chunk_active_set_on_the_card_is_its_stages_in_order(chunk,
                                                             max_active):
    """``chunk_active_set`` on the card (the refine kernel) against its
    stages run in order with the plain refine."""
    d, T, intr, origin = chunk["d"], chunk["T"], chunk["intr"], chunk["origin"]
    bd, nb, trunc = (8, 8, 4), 256, 5 * VOX
    with profiling.recording() as rec:
        got = tb.chunk_active_set(d, T, intr, origin, bd, VOX, trunc,
                                  max_active, nb)
    assert rec.counters == {"kernel.occupancy_bits": 1,
                            "kernel.active_mask": 1, "kernel.refine_bits": 1}
    occ = occupancy_bits_reference(d, 1000.0, 3.0, 8)
    bits = active_mask(bd, origin, VOX, trunc, *occ, T, *intr, mip_cell=8)
    bits = refine_bits_reference(
        bits, d, T, origin, VOX, trunc, intr, bd,
        min(max_active, tb.REFINE_CAP), 1000.0, 3.0)
    want = tb.compact_active(bits, max_active, nb)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].item()) > 0


def test_refine_wrapper_refuses_what_it_cannot_take(card):
    bits, d, T, intr, origin = _refine_inputs(card, 4, 8)
    d32 = d[:1].expand(32, -1, -1).contiguous()
    T32 = T[:1].expand(32, -1, -1).contiguous()
    with profiling.recording() as rec:
        with pytest.raises(ValueError, match="32 frames"):
            refine_bits(bits, d32, T32, origin, WIDE_VOX, 5 * WIDE_VOX, intr,
                        REFINE_BD, 4096)
        with pytest.raises(ValueError, match="T_w2c"):
            refine_bits(bits, d, T.transpose(1, 2), origin, WIDE_VOX,
                        5 * WIDE_VOX, intr, REFINE_BD, 4096)
    assert rec.counters == {}


# --- the occupancy mip (occupancy_bits): frames, cells, edge depths, wrap --


def _occupancy_equals_plain(d, mip_cell, mip_rounds=4):
    """The kernel's (occ0, occ1, binp) against the plain version's, bit
    for bit (binp by its f32 words); the kernel counted once. Returns the
    plain planes."""
    with profiling.recording() as rec:
        got = occupancy_bits(d, 1000.0, 3.0, mip_cell, mip_rounds)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.occupancy_bits": 1}
    want = occupancy_bits_reference(d, 1000.0, 3.0, mip_cell, mip_rounds)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    return want


@pytest.mark.parametrize("mip_cell", MIP_CELLS)
@pytest.mark.parametrize("n_frames", [1, 4, 8, 31])
def test_occupancy_equals_plain(card, n_frames, mip_cell):
    """The sphere frames at 128x256 (planes of 16x32, 8x16 and 4x8 cells,
    the last two smaller than the 9x9 box in one axis or both)."""
    depths, _, _ = make_frames(n_frames, H=128, W=256, fx=300.0, fy=300.0)
    occ0, occ1, _ = _occupancy_equals_plain(
        torch.as_tensor(depths, device=card), mip_cell)
    assert (occ0 != 0).any() and (occ1 != 0).any()


def _sparse_frames(card, n_frames, H, W, values, seed=3):
    """Zero frames with ``values`` (mm) at random pixels."""
    g = torch.Generator().manual_seed(seed)
    d = torch.zeros(n_frames * H * W)
    d[torch.randperm(d.numel(), generator=g)[:len(values)]] = torch.tensor(
        values, dtype=torch.float32)
    return d.reshape(n_frames, H, W).to(card)


@pytest.mark.parametrize("mip_cell", MIP_CELLS)
def test_occupancy_without_a_valid_pixel(card, mip_cell):
    """Every depth out of range (0, negative, at and past depth_max, inf,
    NaN): the range's min and max are not finite and fall back to 0."""
    d = _sparse_frames(card, 3, 64, 96, [-5.0, 3000.0, 4500.0,
                                         float("inf"), float("nan")])
    occ0, occ1, binp = _occupancy_equals_plain(d, mip_cell)
    assert not (occ0.any() or occ1.any())
    assert binp.tolist() == [np.float32(-0.002), np.float32(0.002)]


def test_occupancy_of_a_single_valid_pixel(card):
    d = _sparse_frames(card, 4, 96, 128, [700.0, 3000.0])
    occ0, occ1, binp = _occupancy_equals_plain(d, 8)
    assert binp[1].item() == np.float32(0.002)
    assert (occ0 != 0).sum() == 81 and not occ1.any()


def test_occupancy_at_depth_max_and_the_last_bin(card):
    """gmin falls in bin 0, gmax (one depth under depth_max) in bin 63,
    bit 31 of the second plane: the i32 sign; depths at depth_max are out."""
    d = _sparse_frames(card, 2, 96, 128, [500.0, 2999.0] + [3000.0] * 8
                       + [1700.0] * 4)
    occ0, occ1, _ = _occupancy_equals_plain(d, 8)
    assert (occ0 & 1).any() and (occ1 < 0).any()


@pytest.mark.parametrize("rounds", [0, 1, 4])
@pytest.mark.parametrize("hw", [(8, 8), (16, 24), (40, 56), (136, 16)])
def test_occupancy_box_wraps_around(card, hw, rounds):
    """Planes of 1x1, 2x3, 5x7 and 17x2 cells (the 17 rows across three of
    the dilation's row tiles), smaller than the box on some axis, with a
    few valid pixels: the modulo box equals the iterated rolls."""
    d = _sparse_frames(card, 3, *hw, [600.0, 900.0, 1200.0, 2500.0])
    occ0, _, _ = _occupancy_equals_plain(d, 8, rounds)
    assert occ0.any()


def test_occupancy_wrapper_refuses_what_it_cannot_take(card):
    d = torch.zeros((2, 64, 64), device=card)
    with profiling.recording() as rec:
        with pytest.raises(ValueError, match="mip_cell"):
            occupancy_bits(d, mip_cell=4)
        with pytest.raises(ValueError, match="mip_cell"):
            occupancy_bits(torch.zeros((2, 60, 64), device=card), mip_cell=8)
        with pytest.raises(ValueError, match="cells across"):
            occupancy_bits(torch.zeros((1, 8, 8 * 129), device=card))
        with pytest.raises(ValueError, match="rounds"):
            occupancy_bits(d, mip_rounds=17)
        with pytest.raises(ValueError, match="depths"):
            occupancy_bits(d.double())
        with pytest.raises(ValueError, match="contiguous"):
            occupancy_bits(d.transpose(1, 2))
    assert rec.counters == {}


def test_chunk_active_set_at_the_fuse_cells_shape(card):
    """512^3, one 8-frame chunk of 640x480 bench frames at the fuse cell's
    max_active: ``chunk_active_set`` (the occupancy and refine kernels,
    each counted once) returns the plain chain's ids, fbits and counts."""
    depths, poses, K = make_frames(8)
    d = torch.as_tensor(depths, device=card)
    T = torch.linalg.inv(torch.as_tensor(poses, device=card)).contiguous()
    intr = tuple(float(np.float32(v)) for v in K)
    grid = tb.make_brick_grid((bench.N,) * 3, bench.ORIGIN, bench.VOXEL,
                              device=card)
    bd, nb, max_active = grid.brick_dims, grid.sdf.shape[0] - 1, 32768
    args = (grid.origin, bd, bench.VOXEL, grid.trunc)
    with profiling.recording() as rec:
        got = tb.chunk_active_set(d, T, intr, *args, max_active, nb)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.occupancy_bits": 1,
                            "kernel.active_mask": 1, "kernel.refine_bits": 1}
    occ = _occupancy_equals_plain(d, 8)
    bits = active_mask(bd, grid.origin, bench.VOXEL, grid.trunc, *occ, T,
                       *intr, mip_cell=8)
    bits = refine_bits_reference(bits, d, T, grid.origin, bench.VOXEL,
                                 grid.trunc, intr, bd, tb.REFINE_CAP, 1000.0,
                                 3.0)
    want = tb.compact_active(bits, max_active, nb)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].item()) > 0


# --- K3: padding anywhere, list lengths around one wave, streams ------------


def _k3_case(card, M, real, n_frames=8, seed=11, weights=(0, 5)):
    """``real`` (a list of local ids) placed in a list of ``M`` ids, the
    rest padding, on the 128^3 grid's 2048 bricks; a random prior state;
    frames of the 120x160 sphere orbit (many bricks partly or wholly
    outside the image). Returns (planes, rest) with rest[0] the ids."""
    depths, poses, K = make_frames(n_frames, H=120, W=160, fx=150.0,
                                   fy=150.0)
    d = torch.as_tensor(depths, device=card)
    T = torch.linalg.inv(torch.as_tensor(poses, device=card)).contiguous()
    intr = tuple(float(np.float32(v)) for v in K)
    bd = (16, 16, 8)
    NB = bd[0] * bd[1] * bd[2]
    gen = torch.Generator(device=card).manual_seed(seed)
    planes = [
        torch.rand((NB + 1, 8, 128), generator=gen, device=card) * 2 - 1,
        torch.randint(*weights, (NB + 1, 8, 128), generator=gen,
                      device=card).float(),
    ]
    ids = torch.full((M,), NB, dtype=torch.int32)
    ids[:len(real)] = torch.as_tensor(real, dtype=torch.int32)
    org = torch.tensor(WIDE_ORIGIN, dtype=torch.float32, device=card)
    rest = [ids.to(card), 0, NB, T, intr, d, org, bd, WIDE_VOX,
            5 * WIDE_VOX, 1000.0, 3.0, 64.0]
    return planes, rest


def _same_bits(a, b):
    """Equal bit for bit: the sign of a zero counts."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _k3_reference_planes(planes, rest):
    ref = [a.clone() for a in planes]
    brick_integrate_fixed_reference(*ref, *rest)
    return ref


def _k3_matches_plain(planes, rest, n_launches=1):
    """K3 against its plain version, bit for bit; returns the output."""
    out = [a.clone() for a in planes]
    with profiling.recording() as rec:
        brick_integrate_fixed(*out, *rest)
    torch.cuda.synchronize()
    assert rec.counters == {"kernel.brick_integrate_fixed": n_launches}
    ref = _k3_reference_planes(planes, rest)
    assert _same_bits(out[0], ref[0]) and _same_bits(out[1], ref[1])
    return out


def _spread(n, NB=2048, seed=12):
    """``n`` distinct brick ids in a random order."""
    return torch.randperm(NB, generator=torch.Generator().manual_seed(seed)
                          )[:n].tolist()


def test_k3_list_lengths_around_one_wave_of_blocks(card):
    """M of 1, the blocks the card holds at once, one more, and 4096 with 5
    real ids: every real brick folded once, nothing else touched, twice in
    a row on the same planes (a launch leaves no state behind)."""
    blocks, _ = k3_occupancy(card.index or 0)
    G = blocks * torch.cuda.get_device_properties(card).multi_processor_count
    assert 1 < G < 2048
    for M, n_real_ids in ((1, 1), (G, G), (G + 1, G + 1), (4096, 5)):
        real = _spread(n_real_ids)
        planes, rest = _k3_case(card, M, real)
        out = _k3_matches_plain(planes, rest)
        untouched = torch.ones(2049, dtype=torch.bool, device=card)
        untouched[real] = False
        assert torch.equal(out[0][untouched], planes[0][untouched])
        assert torch.equal(out[1][untouched], planes[1][untouched])
        if n_real_ids >= G:  # enough bricks that some see the sphere
            assert not torch.equal(out[1], planes[1])
        _k3_matches_plain(out, rest)


def test_k3_no_real_brick(card):
    """n_real_local = 0 (an empty shard) and an all-padding list: nothing
    is written, and the next launch is right."""
    planes, rest = _k3_case(card, 512, [])
    out = _k3_matches_plain(planes, rest)
    assert all(torch.equal(a, b) for a, b in zip(out, planes))
    planes, rest = _k3_case(card, 512, _spread(40))
    rest[2] = 0  # every id is padding now
    out = _k3_matches_plain(planes, rest)
    assert all(torch.equal(a, b) for a, b in zip(out, planes))
    rest[2] = 2048
    _k3_matches_plain(planes, rest)


def test_k3_padding_interleaved_and_ids_descending(card):
    """Padding between the real ids (alone, in runs shorter and longer
    than a warp, at the front and at the end) and real ids in descending
    order."""
    real = sorted(_spread(300), reverse=True)
    NB = 2048
    ids, gen = [], np.random.default_rng(13)
    ids += [NB] * 70  # a run longer than two warps at the front
    for i, r in enumerate(real):
        ids.append(r)
        ids += [NB] * int(gen.choice([0, 0, 1, 3, 31, 32, 33, 100]))
    ids += [NB] * 5
    planes, rest = _k3_case(card, len(ids), [])
    rest[0] = torch.as_tensor(ids, dtype=torch.int32, device=card)
    out = _k3_matches_plain(planes, rest)
    # the same bricks with no padding, ascending: the same planes
    planes2, rest2 = _k3_case(card, len(real), sorted(real))
    out2 = _k3_matches_plain(planes2, rest2)
    assert torch.equal(out[0], out2[0]) and torch.equal(out[1], out2[1])
    assert torch.equal(out[0][-1], planes[0][-1])  # the scratch row


def test_k3_footprints_partly_outside_the_image(card):
    real = list(range(2048))
    planes, rest = _k3_case(card, 2048, real)
    ids, T, intr, d, org, bd = (rest[0], rest[3], rest[4], rest[5], rest[6],
                                rest[7])
    wx, wy, wz = _voxel_world(ids, bd, org, WIDE_VOX)
    _, _, _, in_img, _ = _project_voxels(T[0].reshape(16), wx, wy, wz, intr,
                                         *d.shape[1:])
    share = in_img.float().mean(dim=1)
    assert ((share > 0) & (share < 1)).sum().item() > 10
    assert (share == 0).sum().item() > 10  # bricks no voxel of which is seen
    _k3_matches_plain(planes, rest)


def test_k3_prior_weights_zero_one_and_max(card):
    """A prior state with weights of 0, 1 and max_weight (the average's
    divide runs only past a weight of 1, and the clamp holds the weight),
    and sdf of both signs and both zeros."""
    planes, rest = _k3_case(card, 2048, list(range(2048)))
    gen = torch.Generator(device=card).manual_seed(14)
    pick = torch.randint(0, 4, planes[1].shape, generator=gen, device=card)
    planes[1] = torch.tensor([0.0, 1.0, 64.0, 63.0], device=card)[pick]
    zeros = torch.randint(0, 8, planes[0].shape, generator=gen, device=card)
    planes[0] = torch.where(zeros == 0, 0.0, planes[0])
    planes[0] = torch.where(zeros == 1, -0.0, planes[0])
    out = _k3_matches_plain(planes, rest)
    assert out[1].max().item() == 64.0
    assert (torch.signbit(out[0]) & (out[0] == 0)).any()  # a -0 came out


def test_k3_more_frames_than_a_launch_takes(card):
    """F > MAX_FRAMES is split into launches in frame order."""
    F = MAX_FRAMES + 4
    planes, rest = _k3_case(card, 512, _spread(300), n_frames=F)
    _k3_matches_plain(planes, rest, n_launches=2)


def test_k3_wrapper_refuses_nonpositive_scale_and_trunc(card):
    planes, rest = _k3_case(card, 512, _spread(8))
    with profiling.recording() as rec:
        for i, bad in ((9, 0.0), (9, -0.05), (10, 0.0), (10, -1000.0)):
            args = list(rest)
            args[i] = bad
            with pytest.raises(ValueError, match="must be > 0"):
                brick_integrate_fixed(*planes, *args)
    assert rec.counters == {}


def test_k3_on_two_streams_and_beside_k1(card):
    """Two K3 launches on two streams at once, then a K1 and a K3 launch at
    once, neither waiting for the other: each equals its plain version
    (K3 keeps no state between launches, and K1's counters are its own)."""
    cases = [_k3_case(card, 4096, _spread(1500, seed=s), seed=s)
             for s in (15, 16)]
    outs = [[a.clone() for a in planes] for planes, _ in cases]
    refs = [_k3_reference_planes(planes, rest) for planes, rest in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card) for _ in cases]
    for _ in range(3):
        for stream, out, (_, rest) in zip(streams, outs, cases):
            with torch.cuda.stream(stream):
                brick_integrate_fixed(*out, *rest)
        torch.cuda.synchronize()
        for i, (out, ref) in enumerate(zip(outs, refs)):
            assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
            refs[i] = _k3_reference_planes(ref, cases[i][1])
    # K1 on one stream, K3 on the other
    bd = (16, 16, 8)
    NB = bd[0] * bd[1] * bd[2]
    fb = torch.randint(0, 256, (NB,), generator=torch.Generator()
                       .manual_seed(17), dtype=torch.int32)
    k1_planes, k1_rest = _k1_case(card, 8, bd, WIDE_ORIGIN, WIDE_VOX, fb,
                                  False)
    k1_rest[2] = torch.tensor([NB - 3], dtype=torch.int32, device=card)
    k1_out = [a.clone() for a in k1_planes[:2]]
    k1_ref = [a.clone() for a in k1_planes[:2]]
    brick_integrate_reference(*k1_ref, None, *k1_rest)
    k3_planes, k3_rest = cases[0]
    k3_out = [a.clone() for a in k3_planes]
    k3_ref = _k3_reference_planes(k3_planes, k3_rest)
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.cuda.stream(streams[0]):
            brick_integrate(*k1_out, None, *k1_rest)
        with torch.cuda.stream(streams[1]):
            brick_integrate_fixed(*k3_out, *k3_rest)
        torch.cuda.synchronize()
        assert (k1_out[0] - k1_ref[0]).abs().max().item() <= 1e-6
        assert torch.equal(k1_out[1], k1_ref[1])
        assert torch.equal(k3_out[0], k3_ref[0])
        assert torch.equal(k3_out[1], k3_ref[1])
        brick_integrate_reference(*k1_ref, None, *k1_rest)
        k3_ref = _k3_reference_planes(k3_ref, k3_rest)


# --- the ablation arms on K1's schedule (K4/K5) ----------------------------


def _edge_state(card, NB, seed=21):
    """Prior planes that meet every exact skip: weights of 0, 1 and 64
    (the weight cap), sdf of +0, -0, +-1 and random values."""
    gen = torch.Generator(device=card).manual_seed(seed)
    shape = (NB + 1, 8, 128)
    w = torch.tensor([0.0, 1.0, 64.0], device=card)[
        torch.randint(0, 3, shape, generator=gen, device=card)]
    pick = torch.randint(0, 5, shape, generator=gen, device=card)
    sdf = torch.rand(shape, generator=gen, device=card) * 2 - 1
    for k, v in enumerate((0.0, -0.0, 1.0, -1.0)):
        sdf = torch.where(pick == k, torch.full_like(sdf, v), sdf)
    return [sdf, w]


@pytest.mark.parametrize("arm", AS_K1_ARMS)
def test_ablate_arm_equals_k1_bitwise_at_the_schedules_edges(card, arm):
    """n_live = 0, 1, one past the persistent grid and max_active, on
    prior weights of 0 / 1 / 64 and sdf of +-0: the arm's planes equal
    K1's depth-only planes bit for bit, twice in a row (the arm's work
    counter is back at zero after each launch)."""
    bd = (16, 16, 8)
    NB = bd[0] * bd[1] * bd[2]
    fb = torch.randint(0, 256, (NB,), generator=torch.Generator()
                       .manual_seed(22), dtype=torch.int32)
    fb[::7] = 0
    _, rest = _k1_case(card, 8, bd, WIDE_ORIGIN, WIDE_VOX, fb, False)
    planes = _edge_state(card, NB)
    assert (planes[0].view(torch.int32) == -(1 << 31)).any()  # a -0
    G = ablate_grid_size(arm, card, NB)
    assert arm == "pr1_full" or G == grid_size(False, card, NB)
    touched = False
    for n in (0, 1, grid_size(False, card, NB) + 1, NB):
        rest[2] = torch.tensor([n], dtype=torch.int32, device=card)
        k1 = [a.clone() for a in planes]
        brick_integrate(*k1, None, *rest)
        out = [a.clone() for a in planes]
        depth_rest = rest[:6] + rest[7:]
        for _ in range(2):
            again = [a.clone() for a in planes]
            brick_ablate(arm, *again, *depth_rest)
            torch.cuda.synchronize()
            assert _same_bits(again[0], k1[0]) and _same_bits(again[1], k1[1])
        if n == 0:
            assert all(_same_bits(a, b) for a, b in zip(k1, out))
        touched |= not torch.equal(k1[1], planes[1])
    assert touched


@pytest.mark.parametrize("arm", ["full", "static_stride", "smem_window"])
def test_ablate_arm_and_k1_on_two_streams_at_once(card, arm):
    """K1 on one stream and an arm on another, neither waiting for the
    other: the two libraries' work counters are apart, so each equals its
    plain version."""
    bd = (16, 16, 8)
    NB = bd[0] * bd[1] * bd[2]
    fb = torch.randint(0, 256, (NB,), generator=torch.Generator()
                       .manual_seed(23), dtype=torch.int32)
    (p1, r1), (p2, r2) = (_k1_case(card, 8, bd, WIDE_ORIGIN, WIDE_VOX, fb,
                                   False, seed=s) for s in (24, 25))
    for r in (r1, r2):
        r[2] = torch.tensor([NB - 3], dtype=torch.int32, device=card)
    d2 = r2[:6] + r2[7:]
    out1, out2 = [a.clone() for a in p1[:2]], [a.clone() for a in p2[:2]]
    ref1, ref2 = [a.clone() for a in p1[:2]], [a.clone() for a in p2[:2]]
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(card), torch.cuda.Stream(card)
    for _ in range(3):
        with torch.cuda.stream(s1):
            brick_integrate(*out1, None, *r1)
        with torch.cuda.stream(s2):
            brick_ablate(arm, *out2, *d2)
        torch.cuda.synchronize()
        brick_integrate_reference(*ref1, None, *r1)
        brick_ablate_reference(arm, *ref2, *d2)
        for out, ref in ((out1, ref1), (out2, ref2)):
            assert (out[0] - ref[0]).abs().max().item() <= 1e-6
            assert torch.equal(out[1], ref[1])


def test_ablate_wrapper_refuses_nonpositive_scale_and_trunc(chunk, card):
    planes, rest = _ablate_case(card, chunk["d"], chunk["T"], chunk["intr"],
                                chunk["origin"], (8, 8, 4))
    with profiling.recording() as rec:
        with pytest.raises(ValueError, match="depth_scale and trunc"):
            brick_ablate("full", *planes, *rest[:10], 0.0, *rest[11:])
        with pytest.raises(ValueError, match="unknown ablation arm"):
            brick_ablate("full2", *planes, *rest)
    assert rec.counters == {}


def test_an_empty_id_list_counts_no_launch(chunk, card):
    """Neither K1's wrapper nor an arm's launches, or counts, on no ids."""
    planes, rest = _ablate_case(card, chunk["d"], chunk["T"], chunk["intr"],
                                chunk["origin"], (8, 8, 4))
    none = (rest[0][:0], rest[1][:0], torch.zeros_like(rest[2])) + rest[3:]
    out = [a.clone() for a in planes]
    with profiling.recording() as rec:
        brick_ablate("full", *out, *none)
        brick_integrate(*out, None, *none[:6], None, *none[6:])
    torch.cuda.synchronize()
    assert rec.counters == {}
    assert all(torch.equal(a, b) for a, b in zip(out, planes))


# --- the kinematics on the card ----------------------------------------------


@pytest.fixture(scope="module")
def ur10_pair(card):
    """The scan problem's UR10 with no device given (the card), and on
    the CPU."""
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin import make_robot

    opts = load_problem("ur10", "rot_free")
    return make_robot(opts), make_robot(opts, device="cpu")


def test_robot_without_a_device_lands_on_the_card(ur10_pair):
    from reconplan_tpu_torch.kin import Planar

    on_card, _ = ur10_pair
    assert on_card.device.type == "cuda"
    for a in on_card.model[2:]:
        assert a.device.type == "cuda" and a.dtype == torch.float32
    assert on_card._spheres["self"][1].device.type == "cuda"
    planar = Planar("planar_5", [[-0.5, 0.5], [-0.5, 0.5], [0, 0]], [0, 0, 1])
    assert planar.device.type == "cuda"
    assert planar.solve_fk_batch(planar.sample(4)).__getitem__(0).is_cuda


def test_paths_and_so3_grid_on_the_card_equal_the_cpu(card):
    """With no device given their quaternion maths runs on the card."""
    from reconplan_tpu_torch.core import grids
    from reconplan_tpu_torch.grr import paths

    obj = [0.75, 0.75, 0.0]
    np.testing.assert_allclose(
        paths.scan_arc(obj, num_points=64),
        paths.scan_arc(obj, num_points=64, device="cpu"), rtol=0, atol=1e-6)
    start = np.array([0.4, 0.1, 0.3, 0.0, 0.0, 0.0, 1.0])
    goal = np.array([0.1, 0.5, 0.2, 0.0, 0.7071068, 0.0, 0.7071068])
    axis = np.array([0.0, 0.0, 0.0, 0.0, 0.0, np.pi / 2])
    for a, b in ((paths.get_arc_path(start, axis, 2.0, 5),
                  paths.get_arc_path(start, axis, 2.0, 5, device="cpu")),
                 (paths.get_linear_path(start, goal, 2.0, 5),
                  paths.get_linear_path(start, goal, 2.0, 5, device="cpu"))):
        np.testing.assert_allclose(np.stack([x[1] for x in a]),
                                   np.stack([x[1] for x in b]), rtol=0,
                                   atol=1e-6)
    # two neighbours: the next and the one before, with no tie between
    # equally far points for a last bit of the quaternions to decide
    q, e = grids.get_so3_grid(8, [0, 0, 1], [-np.pi, 0.0, 0.0], 2)
    qc, ec = grids.get_so3_grid(8, [0, 0, 1], [-np.pi, 0.0, 0.0], 2,
                                device="cpu")
    np.testing.assert_allclose(q, qc, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(e, ec)


def test_fk_on_the_card_equals_the_cpu(ur10_pair):
    on_card, on_cpu = ur10_pair
    configs = on_cpu.sample(500, rng=np.random.default_rng(0))
    for a, b in zip(on_card.solve_fk_batch(configs),
                    on_cpu.solve_fk_batch(configs)):
        assert a.is_cuda and (a.cpu() - b).abs().max().item() <= 2e-6
    pts = on_card.fk_point_batch(configs)
    assert (pts.cpu() - on_cpu.fk_point_batch(configs)).abs().max() <= 2e-6
    assert torch.equal(on_card._validate_batch(configs).cpu(),
                       on_cpu._validate_batch(configs))


@pytest.mark.parametrize("use_rotation", [True, False])
def test_ik_on_the_card_equals_the_cpu_in_lock_step(ur10_pair, use_rotation):
    """Three iterations from seeds 0.1 rad off a solution: configurations
    to 1e-5, iterations and success equal."""
    from reconplan_tpu_torch.core import maths
    from reconplan_tpu_torch.kin.ik import dls_ik_batch

    on_card, on_cpu = ur10_pair
    rng = np.random.default_rng(1)
    qs = on_cpu.sample(64, rng=rng)
    pts = on_cpu.fk_point_batch(qs)
    seeds = torch.as_tensor(
        (qs + rng.normal(0, 0.1, qs.shape)).astype(np.float32))
    rot = maths.quat_to_matrix(pts[:, 3:7])
    res = []
    for rob in (on_card, on_cpu):
        dev = rob.device
        res.append(dls_ik_batch(
            rob.model, rob._active_tuple, rob.ee_link, pts[:, :3].to(dev),
            rot.to(dev), seeds.to(dev), rob._q_rest, max_iters=3,
            use_rotation=use_rotation))
    a, b = res
    assert a.config.is_cuda
    assert (a.config.cpu() - b.config).abs().max().item() <= 1e-5
    assert torch.equal(a.iters.cpu(), b.iters)
    assert torch.equal(a.success.cpu(), b.success)


def test_ik_chunk_graph_equals_the_eager_loop(ur10_pair):
    """On the card ``dls_ik_batch`` replays a CUDA graph of 4 LM
    iterations on lanes padded to a power of two (37 -> 64): the same
    iterations, successes and configurations (within 1e-6) as the
    eager loop of the same steps on the 37 lanes, the second call from the
    kept graph."""
    from reconplan_tpu_torch.kin import ik

    on_card, _ = ur10_pair
    rng = np.random.default_rng(3)
    qs = on_card.sample(37, rng=rng)
    pts = on_card.fk_point_batch(qs)
    pos, rot, _ = on_card._ik_targets(pts)
    seeds = torch.as_tensor((qs + rng.normal(0, 0.4, qs.shape)).astype(
        np.float32), device="cuda")
    step = ik._LMStep(on_card.model, on_card._active_tuple, on_card.ee_link,
                       pos, rot, on_card._q_rest, 100, 1e-3, 6)
    state = step.start(seeds, torch.full((37,), 0.1, device="cuda"),
                       torch.zeros(37, dtype=torch.int32, device="cuda"))
    for it in range(100):
        if it % ik.CHECK_EVERY == 0 and not bool(step.live(state).any()):
            break
        state = step(state)
    for _ in range(2):
        res = ik.dls_ik_batch(on_card.model, on_card._active_tuple,
                              on_card.ee_link, pos, rot, seeds,
                              on_card._q_rest)
        assert torch.equal(res.iters, state[6])
        assert torch.equal(res.success, state[4] < 1e-3)
        assert (res.config - state[0]).abs().max().item() <= 1e-6
    assert int(res.success.sum()) > 0


def test_solve_ik_batch_on_the_card_reaches_its_targets(ur10_pair):
    on_card, _ = ur10_pair
    rng = np.random.default_rng(2)
    qs = on_card.sample(64, rng=rng)
    pts = on_card.fk_point_batch(qs)
    seeds = (qs + rng.normal(0, 0.3, qs.shape)).astype(np.float32)
    q, ok = on_card.solve_ik_batch(pts, seeds)
    assert q.is_cuda and ok.float().mean().item() > 0.3
    reach = (on_card.fk_point_batch(q)[:, :3] - pts[:, :3]).norm(dim=-1)
    assert reach[ok].max().item() < 1e-3


# --- the mesh layer on the card ---------------------------------------------


@pytest.mark.parametrize("n_shards", [4, 17])
def test_z_sharded_dense_on_the_card_equals_one_grid(card, n_shards):
    """A (272, 256, 256) grid is two z-chunks of 136 rows, the bench
    sphere across their boundary (4 mm voxels): 4 slabs of 68 and 17 of
    16 (one spans row 136) on the card, gathered, give the one grid's
    sdf, weight and color bit for bit."""
    from reconplan_tpu_torch.parallel import (
        gather_grid, make_sharded_grid, sharded_integrate_frames)

    depths, poses, K = make_frames(4, H=120, W=160, fx=150.0, fy=150.0)
    gen = torch.Generator(device=card).manual_seed(0)
    colors = torch.rand((4, 120, 160, 3), generator=gen, device=card)
    dims, vox = (272, 256, 256), 0.004
    origin = (-0.512, -0.512, -136 * vox)
    one = ttsdf.integrate_frames(
        ttsdf.make_grid(dims, origin, vox, with_color=True, device=card),
        depths, poses, *K, colors=colors)
    assert (one.weight[:136] > 0).sum() > 10_000
    assert (one.weight[136:] > 0).sum() > 10_000
    mesh = make_mesh(devices=[card] * n_shards)
    g = make_sharded_grid(dims, origin, vox, mesh=mesh, with_color=True)
    got = gather_grid(sharded_integrate_frames(g, depths, poses, *K,
                                               colors=colors))
    assert got.sdf.is_cuda
    for a, b in zip((got.sdf, got.weight, got.color),
                    (one.sdf, one.weight, one.color)):
        assert torch.equal(a, b)


def test_sharded_ik_on_the_card_equals_one_batch(card):
    """256 problems of the scan arc over 4 shards of 64 on the card
    against one ``dls_ik_batch`` of 256 (graphs of 64 lanes against one
    of 256)."""
    from reconplan_tpu_torch.grr import scan_arc
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin import make_robot
    from reconplan_tpu_torch.kin.ik import dls_ik_batch
    from reconplan_tpu_torch.parallel import sharded_ik_solve

    robot = make_robot(load_problem("ur10", "rot_free"))
    arc = scan_arc([0.75, 0.75, 0.0], radius=0.3, height=0.15, num_points=16)
    targets = np.repeat(arc[:, :3], 16, axis=0)
    seeds = robot.sample(len(targets), rng=np.random.default_rng(0))
    pos, rot, use_rot = robot._ik_targets(targets)
    ref = dls_ik_batch(robot.model, robot._active_tuple, robot.ee_link, pos,
                       rot, robot._tensor(seeds), robot._q_rest,
                       use_rotation=use_rot)
    q, ok = sharded_ik_solve(robot, targets, seeds,
                             mesh=make_mesh(devices=[card] * 4))
    assert q.is_cuda and int(ok.sum()) > 0
    assert torch.equal(ok, ref.success) and torch.equal(q, ref.config)


# --- the roadmap layer and the scan on the card ---------------------------


ROADMAP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "graph", "ur10", "rot_free")


def test_solve_batch_on_the_card_equals_the_cpu(ur10_pair):
    """The first 32 waypoints of the scan arc through the committed
    roadmap: the same waypoints solved, configurations within 1e-4 rad."""
    from reconplan_tpu_torch.apps.scan import make_arc_schedule
    from reconplan_tpu_torch.grr import RedundancyResolution

    arc = make_arc_schedule(1, 500, device="cpu")[0][:32]
    out = []
    for rob in ur10_pair:
        res = RedundancyResolution(rob, rob.device)
        res.load_resolution_graph(os.path.join(ROADMAP, "resolution.npz"))
        res.load_workspace_graph(os.path.join(ROADMAP, "workspace.npz"))
        assert res.configs_t.device.type == rob.device.type
        out.append(res.solve_batch(arc, return_track=True))
    (qc, okc, trc), (q, ok, tr) = out
    np.testing.assert_array_equal(okc, ok)
    assert ok.sum() >= 30
    d = np.abs((qc - q + np.pi) % (2 * np.pi) - np.pi)[ok]
    assert d.max() <= 1e-4
    np.testing.assert_allclose(trc, tr, rtol=0, atol=1e-5)


def _timed_golden():
    times, qs = [], []
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "data", "golden", "ctraj.txt")) as f:
        for line in f:
            t, rest = line.split(",", 1)
            times.append(float(t))
            qs.append([float(x) for x in re.findall(
                r"-?\d+\.?\d*(?:[eE][+-]?\d+)?", rest)])
    return np.asarray(times, np.float32), np.asarray(qs, np.float32)


def test_servo_scan_on_the_card_equals_the_cpu(ur10_pair):
    """``ServoExecutor.execute`` of the 500 timed golden configurations
    (2,401 ticks): the card's trace within 1e-5 of the CPU's, and the
    tracking statistics ``tests/test_kin.py`` asks of it."""
    from reconplan_tpu_torch.kin.dynamics import ServoExecutor

    times, qs = _timed_golden()
    on_card, on_cpu = (ServoExecutor(rob, device=rob.device).execute(
        times, qs) for rob in ur10_pair)
    assert ServoExecutor(ur10_pair[0]).device.type == "cuda"
    for key in ("q_ticks", "qd_ticks"):
        assert np.abs(on_card[key] - on_cpu[key]).max() <= 1e-5, key
    assert on_card["joint_err_mean"] < 0.05
    assert on_card["ee_err_mean_mm"] < 25.0


def test_grr_tick_on_the_card_equals_the_cpu(ur10_pair):
    """One batched GRR tick of 16 rows on the committed rot_free roadmap
    (toward points a few mm off other nodes; the last row out of reach):
    the flags equal, ``q_t`` and the current points within 1e-4."""
    from reconplan_tpu_torch.grr import RedundancyResolution
    from reconplan_tpu_torch.grr.teleop_batch import make_grr_tick

    out = []
    for rob in ur10_pair:
        res = RedundancyResolution(rob, rob.device)
        res.load_resolution_graph(os.path.join(ROADMAP, "resolution.npz"))
        res.load_workspace_graph(os.path.join(ROADMAP, "workspace.npz"))
        rng = np.random.default_rng(7)
        M = len(res.points)
        a = rng.integers(0, M, 16)
        b = (a + np.arange(1, 17) * 3) % M
        qs = res.configs[a] + rng.normal(0, 0.01, (16, 6)).astype(np.float32)
        targets = res.points[b][:, :3] + rng.uniform(-0.01, 0.01, (16, 3))
        targets[-1] = [2.0, 2.0, 2.0]
        out.append([x.cpu().numpy() for x in make_grr_tick(res, 3)(
            targets, qs)])
    (cq, cok, cpts, ccont, cdeep), (q, ok, pts, cont, deep) = out
    for a, b in ((cok, ok), (ccont, cont), (cdeep, deep)):
        np.testing.assert_array_equal(a, b)
    assert ok[:-1].sum() >= 8 and not ok[-1]
    d = np.abs((cq - q + np.pi) % (2 * np.pi) - np.pi)[ok]
    assert d.max() <= 1e-4
    assert np.abs(cpts - pts).max() <= 1e-4


def test_graphcore_is_native_on_the_cards_machine(card):
    from reconplan_tpu_torch.utils.native import GraphCore

    g = GraphCore(4, [[0, 1], [1, 2], [2, 3]])
    assert g.native
    assert g.shortest_path(0, 3) == [0, 1, 2, 3]


def test_run_scan_without_a_device_lands_on_the_card(card, tmp_path):
    from reconplan_tpu_torch.apps.scan import run_scan

    with profiling.recording() as rec:
        out = run_scan(roadmap_dir=ROADMAP, n_waypoints=24, n_images=3,
                       grid_dim=64, reconstruct="fuse", close_mesh=False,
                       out_dir=str(tmp_path), verbose=False)
    assert torch.device(out["device"]).type == "cuda"
    assert out["plan"]["waypoints"] == 24
    assert out["plan"]["carried"] + out["plan"]["rescued"] >= 22
    # the card's default engine is the brick engine: K2 and K1 launched
    assert launches(rec, "active_mask") > 0
    assert launches(rec, "brick_integrate") > 0
    assert out["fuse_chamfer_mm"] < 10.0


# --- the reconstruct half on the card --------------------------------------


BANANA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "objects", "011_banana", "poisson",
    "nontextured.ply")


def _bumpy(n, seed=0, r0=0.5):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = r0 + 0.05 * np.sin(5 * d[:, 0]) + 0.04 * np.cos(7 * d[:, 1])
    return (d * r[:, None]).astype(np.float32), d.astype(np.float32)


def test_pointcloud_ops_on_the_card_equal_the_cpu(card):
    from reconplan_tpu_torch.ops import pointcloud as pc

    rng = np.random.default_rng(0)
    depth = rng.uniform(300, 3500, (120, 160)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0
    color = rng.integers(0, 255, (120, 160, 3)).astype(np.uint8)
    a = pc.backproject_depth(depth, 100.0, 101.0, 80.0, 60.0, color=color)
    b = pc.backproject_depth(depth, 100.0, 101.0, 80.0, 60.0, color=color,
                             device="cpu")
    assert a.points.is_cuda
    assert torch.equal(a.valid.cpu(), b.valid)
    assert (a.points.cpu() - b.points).abs().max().item() <= 1e-6
    assert (a.colors.cpu() - b.colors).abs().max().item() <= 1e-7
    # a surface: its normals are well defined (a blob's inner points have
    # two near-equal small eigenvalues, and cuSOLVER and LAPACK then
    # return different vectors of that plane). 40,000 points take
    # estimate_normals past one eigh batch (EIGH_BATCH)
    pts, _ = _bumpy(40_000)
    pts = pts + np.float32([0.3, -0.2, 2.0])
    valid = rng.uniform(size=len(pts)) > 0.1
    ca, cb = pc.make_cloud(pts, valid=valid), pc.make_cloud(
        pts, valid=valid, device="cpu")
    da, db = pc.voxel_downsample(ca, 0.01), pc.voxel_downsample(cb, 0.01)
    assert torch.equal(da.valid.cpu(), db.valid)
    assert (da.points.cpu() - db.points)[db.valid].abs().max() <= 1e-6
    assert len(pts) > pc.EIGH_BATCH
    na = pc.estimate_normals(ca, k=30).normals.cpu()
    nb = pc.estimate_normals(cb, k=30).normals
    assert (na * nb).sum(-1)[valid].min().item() > 1 - 1e-5
    assert torch.equal(pc.remove_statistical_outliers(ca).valid.cpu(),
                       pc.remove_statistical_outliers(cb).valid)


def test_icps_on_the_card_equal_the_cpu(card):
    """The same iteration counts, T within 1e-5 (the live flag keeps the
    frozen iterations on the card, read every few)."""
    from reconplan_tpu_torch.ops import icp, pointcloud as pc

    pts, _ = _bumpy(1500)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.02, -0.01, 0.015]
    dst = (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    cols = np.repeat(0.5 + 0.5 * np.sin(7 * pts[:, :1]), 3, 1).astype(
        np.float32)
    res = []
    for dev in ("cuda", "cpu"):
        src = pc.make_cloud(pts, colors=cols, device=dev)
        tgt = pc.estimate_normals(pc.make_cloud(dst, colors=cols,
                                                device=dev), k=12)
        res.append([icp.icp_point_to_point(src, tgt, 0.1),
                    icp.icp_point_to_plane(src, tgt, 0.1),
                    icp.colored_icp(src, tgt, icp.color_gradients(tgt), 0.1)])
    for a, b in zip(*res):
        assert a.transformation.is_cuda
        assert int(a.iterations) == int(b.iterations)
        assert (a.transformation.cpu() - b.transformation).abs().max() <= 1e-5
        assert abs(float(a.fitness) - float(b.fitness)) <= 1e-6


def _icp_pair(kind, case, device):
    """(source, target, gradients or None) for a K9 test: ``bumpy``, 1,500
    points of the bumpy sphere shifted 2 cm; ``cell``, the stitch cell's
    shape, 8,192 slots a cloud of a 10 cm bumpy sphere, about 1,500 valid
    in each at scattered slots and a 5 mm shift; ``zero_inliers``,
    ``cell`` with the target 10 m away; ``no_valid_source``, ``cell``
    with no valid source slot."""
    from reconplan_tpu_torch.ops import icp, pointcloud as pc

    rng = np.random.default_rng(3)
    if case == "bumpy":
        pts, _ = _bumpy(1500)
        shift, src_valid, tgt_valid = [0.02, -0.01, 0.015], None, None
    else:
        pts, _ = _bumpy(8192, seed=1, r0=0.1)
        shift = [0.004, -0.002, 0.003]
        src_valid = rng.uniform(size=8192) < 1500 / 8192
        tgt_valid = rng.uniform(size=8192) < 1500 / 8192
        if case == "zero_inliers":
            shift = [10.0, 0.0, 0.0]
        if case == "no_valid_source":
            src_valid[:] = False
    cols = np.repeat(0.5 + 0.5 * np.sin(7 * pts[:, :1] / pts.std()), 3,
                     1).astype(np.float32)
    src = pc.make_cloud(pts, colors=cols, valid=src_valid, device=device)
    tgt = pc.estimate_normals(pc.make_cloud(
        pts + np.float32(shift), colors=cols, valid=tgt_valid,
        device=device), k=12)
    grads = icp.color_gradients(tgt) if kind == "colored" else None
    return src, tgt, grads


def _icp_solve(kind, src, tgt, grads, dist):
    """The public solve of ``kind`` at its defaults."""
    from reconplan_tpu_torch.ops import icp

    if kind == "colored":
        return icp.colored_icp(src, tgt, grads, dist)
    return icp.icp_point_to_plane(src, tgt, dist)


@pytest.mark.parametrize("case", ["bumpy", "cell", "zero_inliers",
                                  "no_valid_source"])
@pytest.mark.parametrize("kind", ["point_to_plane", "colored"])
def test_icp_step_kernel_equals_its_plain_version(card, monkeypatch, kind,
                                                  case):
    """K9 against the plain version on the card (the eager chain, which
    ``takes_plain`` picks when patched): the same iterations, T within
    1e-5, fitness within 1e-6; each step the host issued launched the
    kernel pair once (``kernel.icp_step`` = ``icp.steps``)."""
    k9 = importlib.import_module(
        "reconplan_tpu_torch.ops.kernels.icp_step")

    dist = 0.1 if case == "bumpy" else 0.02
    src, tgt, grads = _icp_pair(kind, case, card)
    with profiling.recording() as rec:
        got = _icp_solve(kind, src, tgt, grads, dist)
    assert rec.counters["kernel.icp_step"] == rec.counters["icp.steps"] > 0
    with monkeypatch.context() as m:
        m.setattr(k9, "takes_plain", lambda name, dev: True)
        with profiling.recording() as rec_plain:
            want = _icp_solve(kind, src, tgt, grads, dist)
    assert "kernel.icp_step" not in rec_plain.counters
    assert got.transformation.is_cuda and want.transformation.is_cuda
    assert int(got.iterations) == int(want.iterations)
    assert (got.transformation - want.transformation).abs().max() <= 1e-5
    assert abs(float(got.fitness) - float(want.fitness)) <= 1e-6
    assert abs(float(got.inlier_rmse) - float(want.inlier_rmse)) <= 1e-6
    if case in ("zero_inliers", "no_valid_source"):
        assert int(got.iterations) == 2 and float(got.fitness) == 0.0
        assert torch.equal(got.transformation.cpu(), torch.eye(4))


@pytest.mark.parametrize("kind", ["point_to_plane", "colored"])
def test_icp_step_kernel_repeats_its_bits(card, kind):
    """No float atomics: two solves of the cell's shape give the same
    bits."""
    src, tgt, grads = _icp_pair(kind, "cell", card)
    a, b = (_icp_solve(kind, src, tgt, grads, 0.02) for _ in range(2))
    for x, y in zip(a, b):
        assert x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()


@pytest.mark.parametrize("kind", ["point_to_plane", "colored"])
def test_frozen_icp_step_changes_nothing(card, kind):
    """A step with ``live`` off writes nothing: the solve's whole buffer
    keeps its bits, and the step still counts as launched."""
    k9 = importlib.import_module(
        "reconplan_tpu_torch.ops.kernels.icp_step")

    src, tgt, grads = _icp_pair(kind, "cell", card)
    kw = ({"gradients": grads, "lambda_geometric": 0.968}
          if kind == "colored" else {})
    solve = k9.icp_solve(
        k9.COLORED if kind == "colored" else k9.POINT_TO_PLANE, src, tgt,
        torch.eye(4, device=card), 0.02, 1e-6, None, None, **kw)
    k9.icp_step(solve)
    assert int(solve.iters) == 1 and int(solve.live) == 1
    solve.live.zero_()
    before = solve.buf.clone()
    with profiling.recording() as rec:
        for _ in range(3):
            k9.icp_step(solve)
    torch.cuda.synchronize()
    assert rec.counters["kernel.icp_step"] == 3
    assert torch.equal(solve.buf.view(torch.int32),
                       before.view(torch.int32))


def test_ransac_scores_on_the_card_equal_the_cpu(card):
    from reconplan_tpu_torch.ops import features, pointcloud as pc

    pts, _ = _bumpy(800)
    dst = pts + np.float32([0.2, -0.1, 0.3])
    out = []
    for dev in ("cuda", "cpu"):
        s = pc.estimate_normals(pc.make_cloud(pts, device=dev), k=16)
        d = pc.estimate_normals(pc.make_cloud(dst, device=dev), k=16)
        out.append((features.fpfh(s), s, d))
    assert (out[0][0].cpu() - out[1][0]).abs().max() <= 1e-5
    picks = torch.randint(0, 800, (256, 3),
                          generator=torch.Generator().manual_seed(0))
    corr = torch.arange(800)
    ok = torch.ones(800, dtype=torch.bool)
    Ta, sa, ba = features._score_hypotheses(
        out[0][1].points, out[0][2].points, corr.cuda(), ok.cuda(),
        picks.cuda(), 0.05)
    Tb, sb, bb = features._score_hypotheses(
        out[1][1].points, out[1][2].points, corr, ok, picks, 0.05)
    assert int(ba) == int(bb) and int(sa[ba]) == int(sb[bb]) == 800


def test_poisson_on_the_card_equals_the_cpu(card):
    """The splat adds atomically on the card, in no fixed order: chi
    within 1e-4 of its peak, triangle counts within 1%."""
    from reconplan_tpu_torch.recon import poisson

    d = np.random.default_rng(0).normal(size=(20000, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts, nrm = (0.1 * d).astype(np.float32), d.astype(np.float32)
    ta, ga = poisson.poisson_reconstruct(pts, nrm, depth=96, return_grid=True)
    tb_, gb = poisson.poisson_reconstruct(pts, nrm, depth=96,
                                          return_grid=True, device="cpu")
    assert ta.is_cuda
    peak = gb.sdf.abs().max().item()
    assert (ga.sdf.cpu() - gb.sdf).abs().max().item() <= 1e-4 * peak
    assert abs(len(ta) - len(tb_)) <= 0.01 * len(tb_)


def test_stitch_on_the_card_equals_the_cpu(card):
    """A pose-seeded stitch of three 160x120 pictures: model counts
    within 1%, transforms within the two-cycle spread of the CPU test
    (``tests/test_torch_stitch.py``)."""
    from reconplan_tpu_torch.io.render import SplatCamera
    from reconplan_tpu_torch.recon.stitcher import (
        PinholeIntrinsic,
        RGBDStitcher,
    )

    cam = SplatCamera(width=160, height=120, fx=100, fy=100, cx=80, cy=60,
                      samples_per_mesh=300_000, device="cpu")
    cam.add_mesh_file(BANANA, translate=(0.75, 0.75, 0.0))
    shots = [cam.take_picture(e, [0.75, 0.75, 0.0]) for e in
             ([0.45, 0.45, 0.3], [0.48, 0.43, 0.31], [0.5, 0.42, 0.32])]
    out = []
    for dev in ("cuda", "cpu"):
        st = RGBDStitcher(PinholeIntrinsic(160, 120, 100, 100, 80, 60),
                          device=dev)
        st.voxel_size, st.distance_threshold, st.model_capacity = (
            0.004, 0.02, 2048)
        cloud = st.stitch_sequence([s[1] for s in shots],
                                   [s[0] for s in shots],
                                   poses=np.stack([s[2] for s in shots]))
        out.append((cloud, st))
    (ca, sa), (cb, sb) = out
    assert ca.points.is_cuda
    assert abs(ca.count() - cb.count()) <= 0.01 * cb.count()
    assert np.abs(sa.last_transforms - sb.last_transforms)[:, :3, 3].max() \
        < 1e-3
    assert np.abs(sa.last_transforms - sb.last_transforms).max() < 5e-3


def test_run_scan_defaults_on_the_card(card, tmp_path):
    """Every route of the scan (fuse, Poisson close with its gate, the
    stitch) with no device given."""
    from reconplan_tpu_torch.apps.scan import run_scan

    out = run_scan(roadmap_dir=ROADMAP, n_waypoints=24, n_images=3,
                   grid_dim=64, reconstruct="both", close_mesh="auto",
                   close_depth=64, out_dir=str(tmp_path), verbose=False)
    assert torch.device(out["device"]).type == "cuda"
    for key in ("fuse_chamfer_mm", "closed_chamfer_mm", "best_chamfer_mm",
                "stitch_chamfer_mm"):
        assert 0 < out[key] < 20, key
    assert out["best_mesh"] == out["close_gate"]["best"]


def test_smallest_ties_on_the_card_equal_the_cpu(card):
    """``ops.nn._smallest`` picks ties by (value, index) on the card as on
    the CPU (where ``tests/test_torch_nn_ties.py`` holds it against
    ``lax.top_k``): all-zero, ``inf``-padded and integer rows, and one
    row as wide as ``bench_nn``'s point set."""
    from reconplan_tpu_torch.ops.nn import _smallest

    rng = np.random.default_rng(0)
    rows = [np.zeros((4, 8), np.float32),
            np.array([[np.inf] * 40 + [0.5] * 2], np.float32),
            rng.integers(0, 4, (64, 5000)).astype(np.float32),
            rng.integers(0, 3, (2, 1_000_000)).astype(np.float32),
            rng.normal(size=(64, 5000)).astype(np.float32)]
    for d in rows:
        for k in (1, 4, 8):
            a = _smallest(torch.as_tensor(d, device=card), k).cpu()
            b = _smallest(torch.as_tensor(d), k)
            assert torch.equal(a, b), (d.shape, k)
    assert _smallest(torch.as_tensor(rows[1], device=card),
                     4).tolist() == [[40, 41, 0, 1]]


def test_posefree_registration_within_one_arc_on_the_card(card):
    """``benchmarks.diag_posefree`` at 8 frames of one arc (steps of 19-41
    degrees) and the default 65,536 / 16,384 slots: every frame
    registers, each pose error within 5 deg and 25 mm (measured on the
    card: at most 0.94 deg and 5.14 mm). On a CPU these slots take
    minutes a frame, so the CPU tests hold the error arithmetic exactly
    and the registration by outcome at smaller slots."""
    from reconplan_tpu_torch.benchmarks import diag_posefree

    rows = diag_posefree.main(["--frames", "8", "--arcs", "1",
                               "--device", str(card)])
    assert [r["frame"] for r in rows] == list(range(1, 8))
    assert not any(r["arc_jump"] for r in rows)
    assert max(r["rot_deg"] for r in rows) <= 5.0
    assert max(r["trans_mm"] for r in rows) <= 25.0
    assert min(r["fit"] for r in rows) > 0.5
