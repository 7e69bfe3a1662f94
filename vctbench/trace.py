"""What a traced run reads: CUDA events at the program's stage marks,
host synchronisations a step, and a torch.profiler trace of a stretch of
steps.

Stage marks: the program calls `stages.mark(name)` right after it
enqueues a stage's work; here each mark records a CUDA event, so a
stage's device time is the time between its event and the one before it
(the step's start for the first): the time the stage holds the stream,
gaps included.  Syncs: torch's CUDA sync debug mode warns at every
synchronising call; the warnings of a step are counted.  The profile
gives the kernels' intervals: their union is the device's busy time.
"""

from __future__ import annotations

import bisect
import contextlib
import warnings
from typing import Dict, List, Sequence, Tuple

import torch


class StageEvents:
    """CUDA events at each step's start and at every stage mark in it."""

    def __init__(self):
        self.steps: List[List[Tuple[str, torch.cuda.Event]]] = []

    def _event(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def begin_step(self) -> None:
        self.steps.append([("step", self._event())])

    def mark(self, name: str) -> None:
        if self.steps:
            self.steps[-1].append((name, self._event()))

    def stage_ms(self) -> Dict[str, float]:
        """{stage: device ms summed over every step} (after a sync)."""
        out: Dict[str, float] = {}
        for evs in self.steps:
            for (_, a), (name, b) in zip(evs, evs[1:]):
                out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


class SyncCounter:
    """Host synchronisations per step, from the sync debug mode's
    warnings (as the port's profile_stages counts them)."""

    def __init__(self):
        self.per_step: List[int] = []
        self._caught: list = []
        self._seen = 0

    @contextlib.contextmanager
    def active(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                self._caught = caught
                yield self
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def end_step(self) -> None:
        n = sum("synchroniz" in str(w.message) for w in self._caught)
        self.per_step.append(n - self._seen)
        self._seen = n


def _union(intervals: Sequence[Tuple[float, float]]):
    """Merged, sorted intervals of [(start, end)]."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Profile:
    """A torch.profiler trace of some steps, reduced: each step's span,
    every device operation's interval and name, and the host operations
    (for what the host was doing during an idle gap).  Times in seconds
    on the trace's clock."""

    def __init__(self, spans: Dict[int, Tuple[float, float]],
                 device_ops: List[Tuple[float, float, str]],
                 host_ops: List[Tuple[float, float, str]]):
        self.spans = spans
        self.device_ops = device_ops
        self.host_ops = sorted(host_ops)
        t0 = min(s for s, _ in spans.values())
        t1 = max(e for _, e in spans.values())
        self.window = (t0, t1)
        self.busy = _union([(max(s, t0), min(e, t1))
                            for s, e, _ in device_ops if e > t0 and s < t1])

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def kernel_seconds(self, pattern: str, steps: Sequence[int]) -> float:
        """Summed time of the device operations whose name holds `pattern`
        inside the spans of `steps` (each step ends in a synchronise, so
        its kernels run inside its span)."""
        total = 0.0
        for i in steps:
            s0, s1 = self.spans[i]
            total += sum(e - s for s, e, n in self.device_ops
                         if pattern in n and s >= s0 and e <= s1)
        return total

    def top_device_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, n in self.device_ops:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:96], t] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The idle time inside the window, summed by the innermost host
        operation running at each gap's middle."""
        t0, t1 = self.window
        edges = [t0] + [x for iv in self.busy for x in iv] + [t1]
        starts = [s for s, _, _ in self.host_ops]
        by: Dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            name = "(host between operations)"
            j = bisect.bisect_right(starts, mid) - 1
            while j >= 0:
                s, e, n = self.host_ops[j]
                if e >= mid:
                    name = n
                    break
                j -= 1
            by[name] = by.get(name, 0.0) + (b - a)
        return [[n[:96], t] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def profile_steps(run_step, steps: Sequence[int]) -> Profile:
    """run_step(i) for each step under torch.profiler (host and device
    activity), each in a span of its own and ended by a synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in steps:
            with record_function(f"vctbench.step.{i}"):
                run_step(i)
                torch.cuda.synchronize()
    spans, dev, host = {}, [], []
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        step = e.name.startswith("vctbench.step.")
        if e.device_type == DeviceType.CUDA:
            if not step:      # a span's mirror on the device's timeline
                dev.append((s, t, e.name))
        elif step:
            spans[int(e.name.rsplit(".", 1)[1])] = (s, t)
        else:
            host.append((s, t, e.name))
    return Profile(spans, dev, host)

