"""Shared helpers for the ``test_torch_*`` files, which hold the PyTorch
port (``reconplan_tpu_torch``) against the JAX package on the same inputs.

Two things keep the comparison about the algorithm and not about rounding:

* ``jax_eager()``: XLA:CPU contracts multiply-adds into FMAs inside a
  compiled computation; run op by op (``jax.disable_jit``) the JAX
  functions round every operation on its own, as PyTorch does, so the two
  packages agree bit for bit.
* ``same_inverse()``: LAPACK's 4x4 inverse under JAX and under PyTorch
  differ in the last bit, so the JAX side is given PyTorch's w2c poses.

``pallas_tpu_interpret()`` runs every ``pallas_call`` under the TPU
interpreter, so the Mosaic kernels (K1's DMA ring) execute on the CPU.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu


@contextlib.contextmanager
def same_inverse():
    """``jnp.linalg.inv`` computed by ``torch.linalg.inv`` (a host callback,
    so it also works inside jit)."""
    orig = jnp.linalg.inv

    def torch_inv(p):
        return np.ascontiguousarray(
            torch.linalg.inv(torch.from_numpy(np.array(p))).numpy())

    def inv(p):
        return jax.pure_callback(
            torch_inv, jax.ShapeDtypeStruct(p.shape, p.dtype), p)

    jnp.linalg.inv = inv
    try:
        yield
    finally:
        jnp.linalg.inv = orig


@contextlib.contextmanager
def jax_eager():
    """Op-by-op JAX with PyTorch's inverse: no FMA contraction."""
    with jax.disable_jit(), same_inverse():
        yield


@contextlib.contextmanager
def pallas_tpu_interpret():
    """Every ``pallas_call`` under ``pltpu.InterpretParams()``, overriding
    an explicit ``interpret=False``; caches are cleared on both sides so no
    other test reuses an interpret-traced jit."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = pltpu.InterpretParams()
        return orig(*args, **kwargs)

    jax.clear_caches()
    pl.pallas_call = patched
    try:
        yield
    finally:
        pl.pallas_call = orig
        jax.clear_caches()


def t(a, dtype=None):
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    return torch.as_tensor(np.array(a, order="C"), dtype=dtype)


def f32(v):
    """A Python float rounded to f32, as JAX stores intrinsics."""
    return float(np.float32(v))


def unpack_rgb(p):
    p = np.asarray(p)
    return np.stack([p & 255, (p >> 8) & 255, (p >> 16) & 255], axis=-1)
