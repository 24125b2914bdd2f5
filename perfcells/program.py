"""The program's own spans and counters in a traced window.

``reconplan_tpu_torch.utils.profiling`` records them whenever a
``torch.profiler`` session runs, as the traced window does: each span
as (name, start ns, end ns) on ``time.time_ns()``, the clock of the
profiler's host events and of the window's ``t0`` and ``t1``, and each
counter as a count of what the host knew (calls, graph replays, chunks,
reads of the card). The readers of ``metrics/`` take them from here.

A program that records none (one older than its spans) gives None, and
so does every reader: a metric new to the program is then left out of
the line.
"""

from __future__ import annotations

import numpy as np

from perfcells.trace import _idle_gaps, merge


def recorded():
    """The program's recording of the traced window, or None."""
    try:
        from reconplan_tpu_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "UNDER_PROFILER", None)
    if rec is None or not (rec.spans or rec.counters):
        return None
    return rec


def intervals(rec, names):
    """(K, 2) int64 start and end ns of the program's spans called any of
    ``names`` (a name or a collection of names), in closing order."""
    names = {names} if isinstance(names, str) else set(names)
    iv = [(s, e) for n, s, e in rec.spans if n in names]
    return np.asarray(iv, dtype=np.int64).reshape(-1, 2)


def busy_between(busy, a, b):
    """Card busy ns in each [a, b) of the arrays ``a``, ``b``, under the
    merged sorted ``busy`` intervals (N, 2): a difference of the running
    busy time, so any number of windows costs two searches."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    if not len(busy):
        return np.zeros(a.shape, dtype=np.int64)
    length = busy[:, 1] - busy[:, 0]
    before = np.concatenate([[0], np.cumsum(length)])

    def upto(t):
        i = np.searchsorted(busy[:, 0], t, side="right")
        j = np.clip(i - 1, 0, None)
        part = np.clip(t - busy[j, 0], 0, length[j])
        return before[j] + np.where(i > 0, part, 0)

    return upto(b) - upto(a)


def idle_inside(trace, iv):
    """Card idle ns inside the union of the intervals ``iv`` (K, 2)."""
    u = merge(iv)
    if not len(u):
        return 0
    return int((u[:, 1] - u[:, 0]).sum()
               - busy_between(trace.device, u[:, 0], u[:, 1]).sum())


def stage_gaps(trace, rec, t0_ns, t1_ns):
    """Idle ns of the card in the window by the innermost span open at the
    start of each gap, among the harness's spans and the program's
    ("outside" when none is): ``trace.gaps`` with the program's stages
    laid inside the harness's spans."""
    spans = dict(trace.spans)
    for name in {n for n, _, _ in rec.spans}:
        spans[name] = intervals(rec, name)
    return _idle_gaps(trace.device, spans, t0_ns, t1_ns)


def tail_windows(trace, name, q=95):
    """The harness's spans called ``name`` whose durations are at or above
    their ``q``-th percentile, (K, 2); None when there are none."""
    iv = trace.spans.get(name)
    if iv is None or not len(iv):
        return None
    dur = iv[:, 1] - iv[:, 0]
    return iv[dur >= np.percentile(dur, q)]


def inside(rec, windows):
    """The program's spans that lie wholly inside one of ``windows``."""
    w = windows[np.argsort(windows[:, 0], kind="stable")]
    out = []
    for span in rec.spans:
        i = np.searchsorted(w[:, 0], span[1], side="right") - 1
        if i >= 0 and span[2] <= w[i, 1]:
            out.append(span)
    return out


def per_unit(ctx, counter, unit):
    """The program's ``counter`` over the traced window per ``unit`` of
    the cell's counts; None when the program kept no such counter."""
    rec = recorded()
    n = ctx.out["counts"].get(unit, 0)
    if rec is None or counter not in rec.counters or not n:
        return None
    return rec.counters[counter] / n


def nesting(spans):
    """For spans (name, start, end) opened and closed in a stack, as
    context managers on one thread are: the index of each one's parent
    (-1 for none), in the order of ``spans``."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    parent = [-1] * len(spans)
    stack = []
    for i in order:
        _, s, e = spans[i]
        while stack and spans[stack[-1]][2] <= s:
            stack.pop()
        if stack and e <= spans[stack[-1]][2]:
            parent[i] = stack[-1]
        stack.append(i)
    return parent


def table(trace, rec, launch_ns=None):
    """Per program span name: ``calls``, ``host_s`` (summed durations),
    ``self_s`` (durations less what child spans cover), ``idle_s`` (card
    idle while the span is the innermost open program span) and, given
    the host start ns of every launch call, ``launches`` inside it."""
    spans = rec.spans
    if not spans:
        return {}
    iv = np.asarray([(s, e) for _, s, e in spans], dtype=np.int64)
    dur = iv[:, 1] - iv[:, 0]
    idle = dur - busy_between(trace.device, iv[:, 0], iv[:, 1])
    child_dur = np.zeros(len(spans), dtype=np.int64)
    child_idle = np.zeros(len(spans), dtype=np.int64)
    for i, p in enumerate(nesting(spans)):
        if p >= 0:
            child_dur[p] += dur[i]
            child_idle[p] += idle[i]
    if launch_ns is not None:
        launch_ns = np.sort(np.asarray(launch_ns, dtype=np.int64))
        inside = (np.searchsorted(launch_ns, iv[:, 1], side="right")
                  - np.searchsorted(launch_ns, iv[:, 0], side="left"))
    out = {}
    for k, (name, _, _) in enumerate(spans):
        row = out.setdefault(name, {"calls": 0, "host_s": 0.0, "self_s": 0.0,
                                    "idle_s": 0.0})
        row["calls"] += 1
        row["host_s"] += dur[k] / 1e9
        row["self_s"] += (dur[k] - child_dur[k]) / 1e9
        row["idle_s"] += (idle[k] - child_idle[k]) / 1e9
        if launch_ns is not None:
            row["launches"] = row.get("launches", 0) + int(inside[k])
    return out
