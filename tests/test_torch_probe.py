"""The microprobe's plain arms against the TPU microprobe kernel
``_mk(kind)`` of ``benchmarks/probe_sublane_ops.py`` (loaded by its path:
``benchmarks/`` is no package), run on the CPU under the Pallas TPU
interpreter at the probe's own shapes and grid of 2048. Both sides add the
same rows in the same order in f32, so they agree bit for bit.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu_torch.ops.kernels import gather_probe
from reconplan_tpu_torch.ops.kernels.gather_probe import (
    ARMS,
    H,
    LOOP,
    TPU_KIND,
    W,
)
from torch_parity import pallas_tpu_interpret

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_probe():
    spec = importlib.util.spec_from_file_location(
        "tpu_probe_sublane_ops", os.path.join(REPO, "benchmarks",
                                              "probe_sublane_ops.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def window():
    return np.random.default_rng(0).random((H, W), dtype=np.float32)


@pytest.mark.parametrize("s0", [0, 5])
@pytest.mark.parametrize("arm", ARMS)
def test_probe_arm_matches_tpu_kernel(window, arm, s0):
    probe = _load_probe()
    assert (probe.H, probe.W, probe.LOOP) == (H, W, LOOP)
    with pallas_tpu_interpret():
        ref = np.asarray(probe._mk(TPU_KIND[arm])(
            jnp.asarray([s0], jnp.int32), jnp.asarray(window)))
    out = gather_probe(arm, torch.from_numpy(window), s0).numpy()
    np.testing.assert_array_equal(out, ref)
    # the probe's own numpy oracle, to float rounding
    rows = window[:H] if arm == "baseline" else np.roll(window, -s0, 0)[:LOOP]
    np.testing.assert_allclose(out[0], rows[:, :128].sum(0), rtol=1e-6)


def test_probe_rejects_out_of_window_rows(window):
    x = torch.from_numpy(window)
    with pytest.raises(ValueError):
        gather_probe("rowload", x, H - LOOP + 1)
    with pytest.raises(ValueError):
        gather_probe("roll", x, 0)
    # the clamp of lax.dynamic_slice: a late start reads the last rows
    np.testing.assert_array_equal(gather_probe("smem_slice", x, H - 1),
                                  gather_probe("smem_slice", x, H - LOOP))


@pytest.mark.parametrize("arm", ARMS)
def test_probe_step_count_leaves_the_output(window, arm):
    """Every step computes the same sums, so the output is that of one
    step whatever the count; a count below 1 is refused."""
    x = torch.from_numpy(window)
    once = gather_probe(arm, x, 5, steps=1)
    assert torch.equal(gather_probe(arm, x, 5), once)
    assert torch.equal(gather_probe(arm, x, 5, steps=4096), once)
    with pytest.raises(ValueError, match="steps"):
        gather_probe(arm, x, 5, steps=0)
