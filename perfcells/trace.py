"""The traced window: ``torch.profiler`` over the measured loop, reduced
to device intervals, host launch calls and the harness's own spans.

The raw kineto events are read (``prof.profiler.kineto_results``), not
``prof.events()``, whose Python objects cost tens of microseconds an
event. Device time is the union of the intervals of every kernel, copy
and set on the card, so concurrent kernels are not counted twice.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np

SPAN_PREFIX = "perfcells:"
# host API calls that put work on the card: kernel and graph launches,
# copies and sets (a CUDA graph capture would cut these)
LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "Memcpy", "Memset")


class Spans:
    """The harness's spans around the calls it makes into the program.
    They are profiler ranges in a traced run and cost nothing otherwise."""

    def __init__(self, traced):
        self.traced = traced

    def __call__(self, name):
        if not self.traced:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)


def merge(intervals):
    """``intervals`` (N, 2) merged into sorted disjoint ones."""
    iv = np.asarray(intervals, dtype=np.int64).reshape(-1, 2)
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s > out[-1][1]:
            out.append([s, e])
        elif e > out[-1][1]:
            out[-1][1] = e
    return np.asarray(out, dtype=np.int64)


def clip_length(busy, windows):
    """Length of the merged ``busy`` intervals inside the ``windows``."""
    total = 0
    for ws, we in np.asarray(windows, dtype=np.int64).reshape(-1, 2):
        s = np.maximum(busy[:, 0], ws)
        e = np.minimum(busy[:, 1], we)
        total += int(np.clip(e - s, 0, None).sum())
    return total


@dataclass
class Trace:
    """A traced window, reduced. Times in ns on the profiler's clock."""

    window_ns: int
    device: np.ndarray  # (N, 2) device intervals, merged
    launches: int
    spans: dict = field(default_factory=dict)  # name -> (K, 2) intervals
    ops: dict = field(default_factory=dict)  # device op name -> ns
    gaps: dict = field(default_factory=dict)  # open span -> idle ns

    @property
    def busy_ns(self):
        return int((self.device[:, 1] - self.device[:, 0]).sum()) \
            if len(self.device) else 0

    def span_busy_ns(self, name):
        """Device time inside the spans called ``name``."""
        if name not in self.spans or not len(self.device):
            return 0
        return clip_length(self.device, self.spans[name])

    def breakdown(self, n=10):
        top = lambda d: [[k, v / 1e9] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(self.ops), "idle_gaps": top(self.gaps)}


def reduce(prof, t0_ns, t1_ns):
    """A :class:`Trace` of the profiler's events between ``t0_ns`` and
    ``t1_ns`` (``time.time_ns()`` at the window's start and end): every
    event on the card but the profiler's own ranges is device work, and
    every CUDA API call on the host that launches or copies is a launch."""
    from torch.autograd import DeviceType

    dev, spans, ops = [], {}, {}
    launches = 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith(SPAN_PREFIX)):
                dev.append((s, s + e.duration_ns()))
                ops[name] = ops.get(name, 0) + e.duration_ns()
        elif name.startswith(SPAN_PREFIX):
            spans.setdefault(name[len(SPAN_PREFIX):], []).append(
                (s, s + e.duration_ns()))
        elif name.startswith("cu") and any(c in name for c in LAUNCH_CALLS):
            launches += 1
    busy = merge(dev)
    if len(busy):
        busy = np.clip(busy, t0_ns, t1_ns)
        busy = busy[busy[:, 1] > busy[:, 0]]
    spans = {k: np.asarray(v, dtype=np.int64) for k, v in spans.items()}
    return Trace(window_ns=t1_ns - t0_ns, device=busy, launches=launches,
                 spans=spans, ops=ops,
                 gaps=_idle_gaps(busy, spans, t0_ns, t1_ns))


def _idle_gaps(busy, spans, t0, t1):
    """Idle ns of the card inside the window, by the innermost harness span
    open at the start of each gap ("outside" when none is)."""
    edges = np.concatenate([[t0], busy.reshape(-1), [t1]]).reshape(-1, 2)
    s = np.maximum(edges[:, 0], t0)
    e = np.minimum(edges[:, 1], t1)
    keep = e > s
    s, e = s[keep], e[keep]
    owner = np.full(len(s), -1)
    owner_len = np.full(len(s), np.iinfo(np.int64).max)
    names = list(spans)
    for k, n in enumerate(names):
        iv = spans[n][np.argsort(spans[n][:, 0], kind="stable")]
        i = np.searchsorted(iv[:, 0], s, side="right") - 1
        j = np.clip(i, 0, None)
        ln = iv[j, 1] - iv[j, 0]
        inner = (i >= 0) & (iv[j, 1] > s) & (ln < owner_len)
        owner = np.where(inner, k, owner)
        owner_len = np.where(inner, ln, owner_len)
    gaps = {}
    for k, ln in zip(owner, e - s):
        name = names[k] if k >= 0 else "outside"
        gaps[name] = gaps.get(name, 0) + int(ln)
    return gaps


@contextlib.contextmanager
def profiled():
    """Profile CPU and CUDA activity; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
