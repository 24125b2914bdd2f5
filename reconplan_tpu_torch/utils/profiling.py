"""Per-stage timing, ``torch.profiler`` tracing, and the program's own
spans and counters.

Port of ``reconplan_tpu.utils.profiling``. Every pipeline app can carry a
:class:`StageTimer`, a tiny struct of named stage durations, and any
region can be wrapped in a profiler trace via :func:`trace` or the
``RECONPLAN_TRACE_DIR`` environment variable.

Spans and counters. The hot paths open :func:`span` around their stages
and :func:`count` what the host already knows (calls, graph replays,
chunks, reads of the card: :func:`to_host`). Both are off by default,
and then cost one check of two flags and nothing else: no launch, no
read of the card, no allocation. They are on inside :func:`recording`
(which :func:`trace` enters) and whenever a ``torch.profiler`` session
runs. On, a span is a ``record_function`` range named ``reconplan:<name>``
in the profiler's trace, and is also kept with its ``time.time_ns()``
start and end, the clock of the profiler's host events, so that a reader
can line the program's stages up with the card's busy intervals. Under a
profiler outside :func:`recording`, spans and counters go to
:data:`UNDER_PROFILER`, which lives for the process: the program is not
told when a session starts, so a reader of one traced window takes what
it holds after the window (and clears it before another).

Fencing: PyTorch returns from a CUDA launch before the device finishes,
so a stage that launched work on the card is charged up to a
``torch.cuda.synchronize`` of that card. On the CPU the timer is a plain
wall clock.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd.profiler import record_function

__all__ = ["StageTimer", "trace", "maybe_trace", "span", "spanned", "count",
           "recording", "to_host", "Recording", "UNDER_PROFILER"]

# the program's ranges in a profiler trace; a harness keeps its own prefix
SPAN_PREFIX = "reconplan:"


class Recording:
    """What the spans and counters recorded while on: ``counters``, name
    -> int, and ``spans``, a list of (name, start ns, end ns) on
    ``time.time_ns()`` in the order the spans closed (a parent after its
    children)."""

    __slots__ = ("counters", "spans")

    def __init__(self):
        self.counters = {}
        self.spans = []

    def clear(self):
        self.counters.clear()
        self.spans.clear()


# where spans and counters go under a torch profiler outside recording()
UNDER_PROFILER = Recording()
_NULL = contextlib.nullcontext()
_recording = None  # the open recording(), if any


def _active():
    """The recording spans and counters go to now, or None when off."""
    if _recording is not None:
        return _recording
    return UNDER_PROFILER if _autograd_profiler._is_profiler_enabled else None


class _Span:
    __slots__ = ("_rec", "_name", "_range", "_t0")

    def __init__(self, rec, name):
        self._rec, self._name = rec, name

    def __enter__(self):
        self._range = record_function(SPAN_PREFIX + self._name)
        self._range.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self._range.__exit__(*exc)
        self._rec.spans.append((self._name, self._t0, t1))
        return False


def span(name):
    """A context manager around one stage of the program. Off, the shared
    ``nullcontext``; on, a ``record_function`` range ``reconplan:<name>``
    kept with its host start and end (see the module's docstring)."""
    rec = _active()
    return _NULL if rec is None else _Span(rec, name)


def spanned(name):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned_call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned_call
    return wrap


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while on; nothing otherwise. Count
    only what the host knows without asking the card."""
    rec = _active()
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def to_host(t):
    """``t.cpu()``: every read of a tensor's values on the host goes
    through here and counts one ``host.reads`` (on the card, a copy that
    waits for the stream; on the CPU, the same point in the program)."""
    count("host.reads")
    return t.cpu()


@contextlib.contextmanager
def recording():
    """Turn spans and counters on, into a fresh :class:`Recording`, which
    it yields (its ``counters`` dict and its ``spans``); off again, or
    back to an enclosing recording, on exit."""
    global _recording
    outer, rec = _recording, Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = outer


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
    Each stage is also a :func:`span`, named ``span_prefix + name``.
    """

    def __init__(self, span_prefix=""):
        self.stages = []  # list of (name, seconds) in completion order
        self.span_prefix = span_prefix

    @contextlib.contextmanager
    def stage(self, name, fence=None):
        """Time the stage ``name``, inside ``span(span_prefix + name)``."""
        with span(self.span_prefix + name):
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
    (``<log_dir>/trace.json``, viewable in Perfetto or chrome://tracing)
    that holds the program's spans (``reconplan:<name>``), under
    :func:`recording`. Yields the profiler, whose ``key_averages()`` sums
    the kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with recording(), profile(activities=activities) as prof:
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
