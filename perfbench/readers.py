"""The arithmetic of the per-layer metrics, over a traced run's context:
``ctx.trace`` (a ``tracing.TraceSummary``), ``ctx.units`` (arrivals or
calls in the traced window), ``ctx.flops_per_unit`` and
``ctx.peak_flops`` (the model's matrix-product operations a unit and the
peak they are held against), and the shapes of the kernels' functions.
Each reader returns None where its run gives it nothing to read; a
share of a roofline or a peak is never 0 for want of a reading."""
from __future__ import annotations

from typing import Iterable, Optional


def idle_share(ctx) -> Optional[float]:
    """The window's time in which no operation ran on the device, %."""
    tr = ctx.trace
    if not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(ctx) -> Optional[float]:
    """The model's matrix-product operations over the window, as a share
    of the peak, %."""
    if not ctx.units:
        return None
    return 100.0 * ctx.flops_per_unit * ctx.units / ctx.trace.window_s \
        / ctx.peak_flops


def span_ms(ctx, names: Iterable[str]) -> Optional[float]:
    """Device ms a unit launched from inside the spans ``names`` (the
    innermost span of each launch)."""
    names = list(names)
    if not ctx.units or not any(n in ctx.trace.span_s for n in names):
        return None
    return 1e3 * sum(ctx.trace.span_s.get(n, 0.0) for n in names) \
        / ctx.units


def roofline(ctx, pattern: str, bound_s: float) -> Optional[float]:
    """The function's least time over the mean time of the device
    operations whose name holds ``pattern``, %."""
    total, count = ctx.trace.kernel(pattern)
    if not count:
        return None
    return 100.0 * bound_s / (total / count)
