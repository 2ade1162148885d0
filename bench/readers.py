"""Reductions the per-layer readers share.  A reader takes a
:class:`bench.run.Context` and returns a number, or None where it finds
nothing to read (the harness then leaves the metric out)."""
from __future__ import annotations

from typing import Optional

from bench import yardstick


def direction_counts(ctx) -> Optional[list]:
    counts = [c.counters.get("direction_counts") for _, c in ctx.calls]
    if not counts or any(x is None for x in counts):
        return None
    return counts


def roofline_pct(ctx) -> Optional[float]:
    """The least time of the traced calls' work over the device's busy
    time in those calls, in percent.  On several cards the work's least
    time is spread over them all (``ctx.chips``) and set against the
    cards' mean busy time."""
    s = ctx.summary
    if s is None or ctx.busy_s <= 0 or not ctx.calls:
        return None
    least = sum(yardstick.least_seconds(
        yardstick.call_bytes(ctx.graph, c.sources), ctx.kind)
        for _, c in ctx.calls) / ctx.chips
    return 100.0 * least / ctx.busy_s


def idle_pct(ctx) -> Optional[float]:
    """The share of the traced window in which no operation ran on the
    device, in percent (on several cards, of the cards' mean seconds, as
    ``device.busy_s`` and ``device.window_s`` give them)."""
    s = ctx.summary
    if s is None or s.n_device_ops == 0 or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
