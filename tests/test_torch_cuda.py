"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels are CUDA C++ and have no CPU mode. This file imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

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
)
from reconplan_tpu_torch.ops.kernels.brick_ablate import ARMS, footprint
from reconplan_tpu_torch.ops.kernels.brick_integrate import _voxel_world
from reconplan_tpu_torch.ops.kernels.gather_probe import ARMS as PROBE_ARMS
from reconplan_tpu_torch.parallel import (
    gather_brick_grid,
    make_sharded_brick_grid,
    sharded_integrate_frames_bricked,
)

pytestmark = pytest.mark.cuda

DIMS = (64, 64, 64)
ORIGIN = (-0.16, -0.16, -0.16)
VOX = 0.32 / 63


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
    occ0, occ1, binp = tb._build_depth_occupancy(chunk["d"], 1000.0, 3.0, 8)
    args = ((8, 8, 4), chunk["origin"], VOX, 5 * VOX, occ0, occ1, binp,
            chunk["T"], *chunk["intr"])
    before = active_mask.launches
    bits = active_mask(*args, mip_cell=8)
    torch.cuda.synchronize()
    assert active_mask.launches == before + 1
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
    before = brick_integrate.launches
    brick_integrate(*planes, *rest)
    torch.cuda.synchronize()
    assert brick_integrate.launches == before + 1
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
    k1, k2 = brick_integrate.launches, active_mask.launches
    g, n_active = tb.integrate_frames_bricked_device(
        g, chunk["depths"], chunk["poses"], *K)
    assert brick_integrate.launches > k1 and active_mask.launches > k2
    dense = ttsdf.integrate_frames(
        ttsdf.make_grid(DIMS, ORIGIN, VOX, device=card), chunk["depths"],
        chunk["poses"], *K)
    sdf_b, w_b = tb.to_dense(g)
    same = (w_b > 0) & (w_b == dense.weight)
    assert same.sum().item() > 1000 and int(n_active) > 0
    assert (sdf_b - dense.sdf)[same].abs().max().item() <= 1e-6


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
    before = brick_integrate_fixed.launches
    brick_integrate_fixed(*planes, *rest)
    torch.cuda.synchronize()
    assert brick_integrate_fixed.launches == before + 1
    brick_integrate_fixed_reference(*ref, *rest)
    assert (planes[0] - ref[0]).abs().max().item() <= 1e-6
    assert torch.equal(planes[1], ref[1])
    assert not torch.equal(planes[1], ref[1].new_zeros(ref[1].shape))
    assert torch.equal(planes[0][-1], ref[0][-1])  # the scratch row


def test_bricked_and_sharded_paths_launch_k3(chunk, card):
    """The host-compacted path against the dense engine, and four shards on
    the one card bit-identical to it (one chunk, no dilation)."""
    K = chunk["K"]
    before = brick_integrate_fixed.launches
    g = tb.make_brick_grid(DIMS, ORIGIN, VOX, device=card)
    g, n_active = tb.integrate_frames_bricked(
        g, chunk["depths"], chunk["poses"], *K, dilate_active=False)
    assert brick_integrate_fixed.launches == before + 1 and n_active > 0
    dense = ttsdf.integrate_frames(
        ttsdf.make_grid(DIMS, ORIGIN, VOX, device=card), chunk["depths"],
        chunk["poses"], *K)
    sdf_b, w_b = tb.to_dense(g)
    seen = w_b > 0
    assert torch.equal(w_b[seen], dense.weight[seen])
    assert (sdf_b - dense.sdf)[seen].abs().max().item() <= 1e-6
    g_nbl = make_sharded_brick_grid(DIMS, ORIGIN, VOX, devices=[card] * 4)
    g_nbl, n_sh = sharded_integrate_frames_bricked(
        g_nbl, chunk["depths"], chunk["poses"], *K,
        max_active_per_device=64)
    assert brick_integrate_fixed.launches == before + 5
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


def _check_arm(arm, planes, rest):
    """The arm's kernel against its plain version (sdf within 1e-6, weight
    identical) and, for full and smem_window, against K1 bit for bit."""
    out = [a.clone() for a in planes]
    ref = [a.clone() for a in planes]
    before = brick_ablate.launches[arm]
    brick_ablate(arm, *out, *rest)
    torch.cuda.synchronize()
    assert brick_ablate.launches[arm] == before + 1
    brick_ablate_reference(arm, *ref, *rest)
    assert (out[0] - ref[0]).abs().max().item() <= 1e-6
    assert torch.equal(out[1], ref[1])
    if arm == "rw_only":
        assert all(torch.equal(a, b) for a, b in zip(out, planes))
    else:
        assert not torch.equal(out[1], planes[1])
    if arm in ("full", "smem_window"):
        k1 = [a.clone() for a in planes]
        brick_integrate(*k1, None, *rest[:6], None, *rest[6:])
        assert torch.equal(out[0], k1[0]) and torch.equal(out[1], k1[1])


@pytest.mark.parametrize("arm", ARMS)
def test_ablate_arm_matches_plain(chunk, card, arm):
    planes, rest = _ablate_case(card, chunk["d"], chunk["T"], chunk["intr"],
                                chunk["origin"], (8, 8, 4))
    _check_arm(arm, planes, rest)


@pytest.mark.parametrize("arm", ["full", "smem_window", "one_row"])
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


@pytest.mark.parametrize("s0", [0, 5])
@pytest.mark.parametrize("arm", PROBE_ARMS)
def test_probe_arm_matches_plain(card, arm, s0):
    x = torch.rand((32, 256), generator=torch.Generator(device=card)
                   .manual_seed(3), device=card)
    before = gather_probe.launches[arm]
    out = gather_probe(arm, x, s0)
    torch.cuda.synchronize()
    assert gather_probe.launches[arm] == before + 1
    assert torch.equal(out, gather_probe_reference(arm, x, s0))
