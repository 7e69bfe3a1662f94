"""The device's idle time charged to the program's host spans.

The program opens a host range `vct.<name>` around each stage and part
of its work while torch's profiler collects (vct_tpu_torch/stages.py
`span`).  Here the profile of a traced run (vctbench/trace.py Profile)
is cut into its profiled steps, and in each step the device's idle time
(the step's time less the union of the device operations' intervals) is
intersected with the host's time inside spans.  A step runs from its
own start to the next step's start (the last to its end), so the steps
cover the profiled window and their idle adds up to the profile's.
Every reader returns None where the profile holds no span of the
program at all (a program without spans)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from vctbench.trace import _union

PREFIX = "vct."
OUTER = ("frame", "build", "tables")

Intervals = List[Tuple[float, float]]


def _clip(intervals, lo: float, hi: float) -> Intervals:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _overlap(a, b) -> float:
    """Length of the intersection of two merged, sorted interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _steps(profile) -> List[Tuple[float, float]]:
    """Each profiled step's slot: its start to the next step's start."""
    starts = sorted(profile.spans.values())
    ends = [s for s, _ in starts[1:]] + [starts[-1][1]]
    return [(s, e) for (s, _), e in zip(starts, ends)]


def _idle(profile, lo: float, hi: float) -> Intervals:
    """The device's idle intervals inside [lo, hi]."""
    out, t = [], lo
    for s, e in _clip(profile.busy, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def _spans(profile, names: Sequence[str]) -> Optional[Intervals]:
    """The merged host intervals of the spans `names`; None where the
    profile holds no span of the program."""
    want = {PREFIX + n for n in names}
    if not any(n.startswith(PREFIX) for _, _, n in profile.host_ops):
        return None
    return _union([(s, e) for s, e, n in profile.host_ops if n in want])


def idle_ms(ctx, names: Sequence[str]) -> Optional[List[float]]:
    """Per profiled step, the device's idle ms while the host is inside
    any span of `names` (nested spans count once)."""
    p = ctx.profile
    inside = None if p is None else _spans(p, names)
    if inside is None:
        return None
    return [1e3 * _overlap(_idle(p, lo, hi), _clip(inside, lo, hi))
            for lo, hi in _steps(p)]


def outside_ms(ctx) -> Optional[List[float]]:
    """Per profiled step, the device's idle ms while the host is in no
    `frame`, `build` or `tables` span."""
    p = ctx.profile
    outer = None if p is None else _spans(p, OUTER)
    if outer is None:
        return None
    return [1e3 * (_length(_idle(p, lo, hi))
                   - _overlap(_idle(p, lo, hi), _clip(outer, lo, hi)))
            for lo, hi in _steps(p)]


def mean(values: Optional[List[float]]) -> Optional[float]:
    """The mean a step, or None."""
    return sum(values) / len(values) if values else None
