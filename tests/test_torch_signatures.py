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

Not parameters, so not walked here: the scan's and the teleop
benchmark's command lines take ``--device`` where the JAX ones take
``--platform``.
"""

import importlib
import inspect

import pytest

MODULES = [
    "apps.eval_roadmap", "apps.record", "apps.redundancy", "apps.scan",
    "apps.stitch", "apps.teleop", "core.grids", "core.maths",
    "grr.experiment", "grr.nearest_neighbors", "grr.paths", "grr.quality",
    "grr.resolution", "grr.solver", "grr.teleop_batch", "grr.workspace",
    "io.checkpoint", "io.config", "io.drivers", "io.frames", "io.meshio",
    "io.render", "kin.chain", "kin.collision", "kin.dynamics", "kin.ik",
    "kin.relaxed", "kin.rob_parser", "kin.robot", "ops.features",
    "ops.icp", "ops.marching", "ops.nn", "ops.pointcloud", "ops.tsdf",
    "ops.tsdf_brick", "parallel.brick", "recon.fusion", "recon.metrics",
    "recon.poisson", "recon.stitcher", "utils.native", "utils.profiling",
    "viz.html_export", "viz.plots", "viz.teleop_server",
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
