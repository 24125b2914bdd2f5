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

``jax_ik_lanes()`` runs the JAX package's batched IK and its batched
validity check in batches of one width, so that XLA compiles each once
and not once for every batch size a roadmap build makes (the IK loop
takes 6-9 s to compile on the CPU).
"""

import contextlib
import os

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


def _in_lanes(fn, lanes, n):
    """``fn(start, stop)`` over [0, n) in slices of ``lanes``, the pytrees
    it returns concatenated."""
    parts = [fn(s, s + lanes) for s in range(0, n, lanes)]
    return jax.tree.map(lambda *xs: jnp.concatenate(xs), *parts)


def _padded(a, pad):
    a = jnp.asarray(a)
    return jnp.concatenate([a, jnp.repeat(a[-1:], pad, axis=0)])


@contextlib.contextmanager
def jax_ik_lanes(lanes=64):
    """The JAX package's ``dls_ik_batch`` (as its robot and its expansion
    solver call it) and ``Robot._validate_batch``, on batches padded to a
    multiple of ``lanes`` (the last row repeated) and run ``lanes`` at a
    time; a single problem goes as it is. Both map one function over the
    batch, and each lane of the IK loop runs to its own end, so a row's
    answer does not depend on the batch it rides in. Calls traced under
    ``jit`` or ``lax.scan`` (``solve_batch``) are left alone."""
    from reconplan_tpu.grr import solver as jsolver
    from reconplan_tpu.kin import ik as jik
    from reconplan_tpu.kin import robot as jrobot

    ik, validate = jik.dls_ik_batch, jrobot.Robot._validate_batch

    def ik_in_lanes(model, active, ee_link, pos, rot, init, q_rest, **kw):
        n = pos.shape[0]
        if n <= 1 or isinstance(pos, jax.core.Tracer):
            return ik(model, active, ee_link, pos, rot, init, q_rest, **kw)
        pad = (-n) % lanes
        pos, rot, init = (_padded(a, pad) for a in (pos, rot, init))
        out = _in_lanes(lambda a, b: ik(model, active, ee_link, pos[a:b],
                                        rot[a:b], init[a:b], q_rest, **kw),
                        lanes, n + pad)
        return jax.tree.map(lambda x: x[:n], out)

    def validate_in_lanes(self, configs):
        n = len(configs)
        if n <= 1 or isinstance(configs, jax.core.Tracer):
            return validate(self, configs)
        q = _padded(configs, (-n) % lanes)
        return _in_lanes(lambda a, b: validate(self, q[a:b]), lanes,
                         len(q))[:n]

    jsolver.dls_ik_batch = jrobot.dls_ik_batch = ik_in_lanes
    jrobot.Robot._validate_batch = validate_in_lanes
    try:
        yield
    finally:
        jsolver.dls_ik_batch = jrobot.dls_ik_batch = ik
        jrobot.Robot._validate_batch = validate


def t(a, dtype=None):
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    return torch.as_tensor(np.array(a, order="C"), dtype=dtype)


def f32(v):
    """A Python float rounded to f32, as JAX stores intrinsics."""
    return float(np.float32(v))


def unpack_rgb(p):
    p = np.asarray(p)
    return np.stack([p & 255, (p >> 8) & 255, (p >> 16) & 255], axis=-1)


GRAPH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "graph", "ur10")


def wrapped(a, b):
    """|a - b| with angles taken modulo 2 pi."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs((d + np.pi) % (2 * np.pi) - np.pi)


def se3_points(n, seed):
    """n seeded workspace points [position, unit quaternion], f32."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([rng.normal(size=(n, 3)) * 0.5, q],
                          -1).astype(np.float32)


def ur10_pair(problem="rot_free", floor_check=None):
    """The UR10 of ``problem`` in the JAX package and in the port on the
    CPU."""
    from reconplan_tpu.kin import robot as jrobot
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin import robot as trobot

    opts = load_problem("ur10", problem)
    return (jrobot.make_robot(opts, floor_check=floor_check),
            trobot.make_robot(opts, floor_check=floor_check, device="cpu"))


def roadmap_pair(robots, name, solver=True):
    """The committed roadmap ``graph/ur10/<name>`` loaded into a JAX and a
    port RedundancyResolution over the two ``robots``."""
    from reconplan_tpu.grr import resolution as jres
    from reconplan_tpu_torch.grr import resolution as tres

    pair = (jres.RedundancyResolution(robots[0]),
            tres.RedundancyResolution(robots[1], device="cpu"))
    folder = os.path.join(GRAPH, name)
    for res in pair:
        res.load_resolution_graph(os.path.join(folder, "resolution.npz"))
        res.load_workspace_graph(os.path.join(folder, "workspace.npz"))
        if solver:
            res.load_solver_graph(os.path.join(folder, "solver.npz"))
    return pair


def small_roadmap_pair(folder):
    """``tests/test_grr.py``'s ``small_roadmap`` recipe (40 random arc
    nodes of the rot_free UR10, expanded from the problem's seed
    configurations), built by the port on the CPU in about 3 s and saved
    to ``folder``, and the same arrays loaded into a JAX
    RedundancyResolution: (JAX, port). The JAX package's own build of the
    recipe takes about 38 s on the CPU and gives configurations within
    2.4e-7 rad of the port's."""
    from reconplan_tpu.grr import resolution as jres
    from reconplan_tpu_torch.grr import resolution as tres
    from reconplan_tpu_torch.io.config import load_problem

    jr, tr = ur10_pair("rot_free")
    opts = load_problem("ur10", "rot_free")
    port = tres.RedundancyResolution(tr, device="cpu")
    port.sample_workspace([0.75, 0.75, 0.0], 40, 1, "random")
    port.global_expansion(np.asarray(opts["init_configs"], np.float32),
                          verbose=False)
    port.build_resolution_graph_and_nn()
    names = ("workspace", "solver", "resolution")
    for name in names:
        getattr(port, f"save_{name}_graph")(os.path.join(folder,
                                                         f"{name}.npz"))
    ref = jres.RedundancyResolution(jr)
    for name in names:
        getattr(ref, f"load_{name}_graph")(os.path.join(folder,
                                                        f"{name}.npz"))
    return ref, port
