"""Readers that several per-layer metrics share (each metric's own file
under ``metrics/`` names one of these or holds its own)."""


def device_idle(ctx):
    """% of the traced window in which nothing ran on the card."""
    t = ctx.trace
    if t.window_ns <= 0:
        return None
    return 100.0 * (1.0 - t.busy_ns / t.window_ns)


def launches_per(ctx, unit):
    """Host launch and copy API calls in the traced window per ``unit``
    of the driver's counts."""
    n = ctx.out["counts"].get(unit, 0)
    if not n or not ctx.trace.launches:
        return None
    return ctx.trace.launches / n
