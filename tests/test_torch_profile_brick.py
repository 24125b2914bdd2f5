"""The pieces of ``reconplan_tpu_torch.benchmarks.profile_brick`` that run
on the CPU: the top-k compaction of its A/B against the production
``compact_ids`` and JAX's ``jnp.nonzero(size=, fill_value=)``, and the
stage functions it times one by one, which in order must give
``chunk_active_set``'s result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu_torch.benchmarks.profile_brick import compact_topk
from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.ops.kernels import active_mask
from test_tsdf_marching import make_sphere_depths
from torch_parity import f32, t

ORIGIN = (-0.15, -0.15, -0.15)


@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_compact_topk_matches_compact_ids_and_jax(density):
    mask = np.random.default_rng(0).random(4096) < density
    size, fill = 512, 4096
    ref = np.asarray(jnp.nonzero(jnp.asarray(mask), size=size,
                                 fill_value=fill)[0])
    m = torch.from_numpy(mask)
    np.testing.assert_array_equal(compact_topk(m, size, fill).numpy(), ref)
    np.testing.assert_array_equal(tb.compact_ids(m, size, fill).numpy(), ref)


@pytest.mark.parametrize("max_active", [16, 4096])
def test_chunk_active_set_is_its_stages_in_order(max_active):
    # 16 live bricks at most: the cap cuts the 64^3 sphere's active set
    depths, poses, K = make_sphere_depths(n_views=8, H=120, W=160,
                                          fx=100.0, fy=100.0)
    vox = 0.3 / 63
    trunc = 5.0 * vox
    bd, nb = (8, 8, 4), 256
    d = t(depths)
    T = torch.linalg.inv(t(poses)).contiguous()
    intr = tuple(map(f32, K))
    origin = t(ORIGIN, torch.float32)
    want = tb.chunk_active_set(d, T, intr, origin, bd, vox, trunc,
                               max_active, nb)
    cell = tb._occupancy_cell(*d.shape[1:])
    occ = tb._build_depth_occupancy(d, 1000.0, 3.0, cell)
    bits = active_mask(bd, origin, vox, trunc, *occ, T, *intr,
                       mip_cell=cell)
    bits = tb.refine_frame_bits(bits, d, T, intr, origin, bd, vox, trunc,
                                max_active)
    got = tb.compact_active(bits, max_active, nb)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    n_live, n_mask = int(want[2].item()), int(want[3].item())
    assert n_live == min(n_mask, max_active) and n_live > 0
    assert (want[1][:n_live] != 0).all()
