"""General per-layer readers.  A metric file `vctbench/metrics/<name>.json`
names one of these by its "kind" and gives its parameters.  A reader that
finds nothing to read returns None, and the metric is left out."""

from __future__ import annotations

from typing import Optional


def stage_sum(ctx, params) -> Optional[float]:
    """Device ms a step of the named stages ("stages"), averaged over
    every step of the traced window."""
    got = [ctx.stage_ms[s] for s in params["stages"] if s in ctx.stage_ms]
    if not got or not ctx.steps:
        return None
    return sum(got) / ctx.steps


def syncs_per_step(ctx, params) -> Optional[float]:
    """Host synchronisations a step, averaged over the traced window."""
    n = ctx.syncs
    return sum(n) / len(n) if n else None


def idle_share(ctx, params) -> Optional[float]:
    """100 (1 - busy / window) over the profiled steps, where busy is the
    union of the device operations' intervals."""
    p = ctx.profile
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
