"""Stage timing for the CLI and a trace scope (port of
vct_tpu/utils/profiling.py).

The reference computes a frame delta and never shows it (main.cpp:83-87);
here each stage of a CLI run is timed on the host clock, ending in a
synchronize of the card when the stage's result lies there, and
`perfetto_trace` writes a torch.profiler Chrome trace (which Perfetto
opens).  Per-stage device times come from vct_tpu_torch/profile_stages.py.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time
from typing import List, Optional, Tuple

import torch


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card ("NVIDIA H100
    80GB HBM3, 700.00 W"): every figure on the card is kept beside it.
    Raises where nvidia-smi fails."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        raise RuntimeError(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def sync(x) -> None:
    """Wait for the card when x (a tensor, or a list or tuple of them)
    lies there; CPU tensors are done when they return."""
    leaves = x if isinstance(x, (list, tuple)) else [x]
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()


class StageTimer:
    """Wall-clock stage timing with device synchronization.

    with timer.stage("voxelize") as box:
        box["result"] = ...      # the stage ends in a sync on it
    """

    def __init__(self, log=None):
        self.records: List[Tuple[str, float]] = []
        self._log = log

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            if "result" in box:
                sync(box["result"])
            dt = time.perf_counter() - t0
            self.records.append((name, dt))
            if self._log:
                self._log(f"[{name}] {dt * 1e3:.1f} ms")

    def report(self) -> str:
        total = sum(dt for _, dt in self.records)
        lines = [f"{name:<24s} {dt * 1e3:10.1f} ms  {dt / total * 100:5.1f}%"
                 for name, dt in self.records]
        lines.append(f"{'total':<24s} {total * 1e3:10.1f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def perfetto_trace(trace_dir: Optional[str]):
    """torch.profiler trace scope (the card's kernels too, where there is
    one) -> trace_dir/trace.json, a Chrome trace Perfetto opens; no-op
    when trace_dir is None."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", file=sys.stderr)
