"""Per-stage timing and ``torch.profiler`` tracing.

Port of ``reconplan_tpu.utils.profiling``. Every pipeline app can carry a
:class:`StageTimer`, a tiny struct of named stage durations, and any
region can be wrapped in a profiler trace via :func:`trace` or the
``RECONPLAN_TRACE_DIR`` environment variable.

Fencing: PyTorch returns from a CUDA launch before the device finishes,
so a stage that launched work on the card is charged up to a
``torch.cuda.synchronize`` of that card. On the CPU the timer is a plain
wall clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

__all__ = ["StageTimer", "trace", "maybe_trace"]


def _fence_device(fence):
    """The CUDA device to synchronize for ``fence``: a device, a tensor, a
    zero-arg callable returning either, or None (then no fence)."""
    if fence is None:
        return None
    if callable(fence):
        fence = fence()
    dev = fence.device if isinstance(fence, torch.Tensor) else torch.device(
        fence)
    return dev if dev.type == "cuda" else None


class StageTimer:
    """Named stage durations for one pipeline run.

    Usage::

        timer = StageTimer()
        with timer.stage("plan"):
            ...
        with timer.stage("fuse", fence=lambda: grid.weight):
            grid = integrate(...)
        print(timer.report())

    ``fence`` is a device, a tensor, or a zero-arg callable returning one
    (called when the stage ends, so it may name the stage's own output);
    the stage is charged up to the completion of everything queued on
    that card. A CPU fence, or none, leaves the wall clock as it is.
    """

    def __init__(self):
        self.stages = []  # list of (name, seconds) in completion order

    @contextlib.contextmanager
    def stage(self, name, fence=None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dev = _fence_device(fence)
            if dev is not None:
                torch.cuda.synchronize(dev)
            self.stages.append((name, time.perf_counter() - t0))

    def add(self, name, seconds):
        self.stages.append((name, float(seconds)))

    @property
    def total(self):
        return sum(s for _, s in self.stages)

    def as_dict(self):
        return {name: round(s, 4) for name, s in self.stages}

    def report(self, prefix="stage timings"):
        rows = "  ".join(f"{n}={s:.2f}s" for n, s in self.stages)
        return f"{prefix}: {rows}  (total {self.total:.2f}s)"

    def dump(self, path):
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1)


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` wrapper: records the CPU and, with a card, the
    CUDA activity of the region and writes a Chrome trace
    (``<log_dir>/trace.json``, viewable in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` sums the kernels by
    name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))


@contextlib.contextmanager
def maybe_trace(log_dir=None, env="RECONPLAN_TRACE_DIR"):
    """Trace when ``log_dir`` or the ``env`` variable is set; no-op
    otherwise — lets every CLI grow a --profile flag for free."""
    target = log_dir or os.environ.get(env)
    if not target:
        yield
        return
    with trace(target):
        yield
    print(f"torch profiler trace written to {target}")
