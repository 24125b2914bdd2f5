"""Every public function of a ported module takes what its JAX counterpart
takes: a call that names a reference parameter must not raise
``TypeError`` in the port.

The walk pairs the modules of ``reconplan_tpu_torch`` with those of
``reconplan_tpu`` by path, and in each pair every public function,
class constructor and public method that both define. The stated
exceptions, and no other:

* ``mesh`` (a ``jax.sharding.Mesh``) is ``devices`` (a list of torch
  devices) in the port;
* ``interpret`` (run a Pallas kernel in interpret mode) has no
  counterpart: a wrapper picks its kernel or its plain version by the
  tensors' device;
* ``key`` (a ``jax.random`` key) is ``generator`` (a ``torch.Generator``).
"""

import importlib
import inspect

import pytest

MODULES = [
    "core.grids", "core.maths", "grr.paths", "io.checkpoint", "io.config",
    "io.frames", "io.meshio", "io.render", "kin.chain", "kin.collision",
    "kin.ik", "kin.rob_parser", "kin.robot", "ops.marching", "ops.nn",
    "ops.tsdf", "ops.tsdf_brick", "parallel.brick", "recon.fusion",
    "recon.metrics", "utils.profiling",
]
RENAMED = {"mesh": "devices", "key": "generator"}
DROPPED = {"interpret"}


def _callables(module):
    """name -> callable for the module's own public functions, its public
    classes' constructors and their public methods."""
    out = {}
    for name, obj in vars(module).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != \
                module.__name__:
            continue
        if inspect.isclass(obj):
            out[name] = obj
            for m, fn in vars(obj).items():
                if not m.startswith("_") and inspect.isfunction(
                        getattr(fn, "__wrapped__", fn)):
                    out[f"{name}.{m}"] = fn
        elif callable(obj):
            out[name] = obj
    return out


def _parameters(fn):
    fn = inspect.unwrap(fn)
    try:
        return [p for p in inspect.signature(fn).parameters if p != "self"]
    except (TypeError, ValueError):
        return None


@pytest.mark.parametrize("path", MODULES)
def test_port_takes_every_reference_parameter(path):
    ref = _callables(importlib.import_module("reconplan_tpu." + path))
    port = _callables(importlib.import_module("reconplan_tpu_torch." + path))
    shared = sorted(set(ref) & set(port))
    assert shared, f"no public callable of {path} is in both packages"
    missing = {}
    for name in shared:
        theirs, ours = _parameters(ref[name]), _parameters(port[name])
        if theirs is None or ours is None:
            continue
        lacks = [p for p in theirs
                 if p not in DROPPED and RENAMED.get(p, p) not in ours]
        if lacks:
            missing[name] = lacks
    assert not missing, f"{path}: the port lacks {missing}"
