"""The program's tracing: stage marks, host spans and device counters.

Marks.  The voxel build and the frame call `mark(name)` right after they
enqueue each stage's work; by default that does nothing.  A profiler
(vct_tpu_torch/profile_stages.py) sets `MARK` to a callable that records
a CUDA event, so the device time between two marks is the named
stage's.

Spans.  `with span(name):` wraps the code of one stage and calls
`mark(name)` when it leaves without an error, so the marks fire where
they always did.  While torch's profiler collects, a span also opens a
host range named `vct.<name>` at RecordScope.FUNCTION, the scope of an
operator: the profiler puts it on the host's timeline only, never on the
device's (record_function's user scope is mirrored there).  With
`mark=False` a span only opens the range; outer spans (`frame`, `build`,
`tables`) and the parts of a stage are such.  With no profiler and no
`MARK`, a span is one shared null context.

Counters.  `count(name, value)` adds a 0-d device tensor into a device
accumulator, with no host read, while marks or a profiler are on;
`counters()` gives {name: (sum, calls)}.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
from torch.autograd import profiler as _profiler

MARK = None

_NULL = contextlib.nullcontext()
_COUNTS: Dict[str, list] = {}


def mark(name: str) -> None:
    if MARK is not None:
        MARK(name)


class _Span:
    __slots__ = ("_name", "_marks", "_range")

    def __init__(self, name: str, marks: bool, ranged: bool):
        self._name = name
        self._marks = marks
        self._range = (torch._C._profiler._RecordFunctionFast("vct." + name)
                       if ranged else None)

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()

    def __exit__(self, *exc):
        if exc[0] is None and self._marks:
            mark(self._name)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, mark: bool = True):
    """A context manager around one stage's code (module docstring)."""
    if _profiler._is_profiler_enabled:
        return _Span(name, mark, True)
    if mark and MARK is not None:
        return _Span(name, True, False)
    return _NULL


def counting() -> bool:
    """Are counters collected (marks set or a profiler on)?"""
    return MARK is not None or _profiler._is_profiler_enabled


def count(name: str, value: torch.Tensor) -> None:
    """Add the 0-d tensor `value` into counter `name` on its device, and
    count the call; nothing when counting() is false."""
    if not counting():
        return
    c = _COUNTS.get(name)
    if c is None:
        c = _COUNTS[name] = [torch.zeros((), dtype=value.dtype,
                                         device=value.device), 0]
    c[0].add_(value.detach())
    c[1] += 1


def counters() -> Dict[str, Tuple[torch.Tensor, int]]:
    """{name: (the summed device tensor, calls)}."""
    return {k: (v[0], v[1]) for k, v in _COUNTS.items()}


def reset_counters() -> None:
    _COUNTS.clear()
