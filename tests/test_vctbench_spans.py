"""vctbench/spans.py and the per-layer metrics read from the program's
spans and counters, on a hand-built profile (times in seconds):

    step 0 [0, 10.5)            step 1 [10.5, 20]
    device   [1,2] [4,6]        [12,13]
    idle     [0,1] [2,4] [6,10.5]    [10.5,12] [13,20]
    host     vct.frame [0.5,9]  vct.build [11,19]
             vct.bin [1.5,3] and vct.pack_rows [3,5] (adjacent),
             vct.alpha_resolve [5,8] holding vct.alpha_resolve.kernel
             [6.5,7.5]; vct.light_volume [11,14] holding vct.dense.plan
             [11.5,12.5]; aten::mul [2,3] (not the program's)
"""

from pathlib import Path

import pytest
import torch

from vctbench import spans as SP
from vctbench import spec
from vctbench.trace import Profile

ROOT = Path(__file__).resolve().parents[1]


class Ctx:
    def __init__(self, profile):
        self.profile = profile


def _profile(host=True):
    ops = [(0.5, 9.0, "vct.frame"), (1.5, 3.0, "vct.bin"),
           (3.0, 5.0, "vct.pack_rows"), (5.0, 8.0, "vct.alpha_resolve"),
           (6.5, 7.5, "vct.alpha_resolve.kernel"), (2.0, 3.0, "aten::mul"),
           (11.0, 19.0, "vct.build"), (11.0, 14.0, "vct.light_volume"),
           (11.5, 12.5, "vct.dense.plan")]
    if not host:
        ops = [o for o in ops if not o[2].startswith("vct.")]
    return Profile({0: (0.0, 10.0), 1: (10.5, 20.0)},
                   [(1.0, 2.0, "k"), (4.0, 6.0, "k"), (12.0, 13.0, "k")],
                   ops)


def test_idle_inside_adjacent_spans():
    assert SP.idle_ms(Ctx(_profile()), ["pack_rows", "bin"]) == [2000.0, 0.0]


def test_idle_inside_nested_spans_counts_once():
    ctx = Ctx(_profile())
    assert SP.idle_ms(ctx, ["alpha_resolve"]) == [2000.0, 0.0]
    assert SP.idle_ms(ctx, ["alpha_resolve", "alpha_resolve.kernel"]) == [
        2000.0, 0.0]
    assert SP.idle_ms(ctx, ["alpha_resolve.kernel"]) == [1000.0, 0.0]
    assert SP.idle_ms(ctx, ["dense.plan"]) == [0.0, 500.0]


def test_outside_and_the_whole_window():
    """Outside plus inside the outer spans is every step's idle, and the
    steps' idle is the profile's."""
    p = _profile()
    ctx = Ctx(p)
    out = SP.outside_ms(ctx)
    assert out == [2000.0, 1500.0]
    inside = SP.idle_ms(ctx, SP.OUTER)
    assert inside == [5500.0, 7000.0]
    assert sum(out) + sum(inside) == pytest.approx(
        1e3 * (p.window_s - p.busy_s))
    assert SP.mean(out) == 1750.0


def test_empty_windows_and_no_spans():
    assert SP.idle_ms(Ctx(None), ["bin"]) is None
    assert SP.outside_ms(Ctx(None)) is None
    assert SP.idle_ms(Ctx(_profile(host=False)), ["bin"]) is None
    assert SP.outside_ms(Ctx(_profile(host=False))) is None
    assert SP.mean(None) is None and SP.mean([]) is None
    # a name the program never opened reads zero idle, not nothing
    assert SP.idle_ms(Ctx(_profile()), ["specmarch"]) == [0.0, 0.0]
    # a step with no device work is idle throughout
    p = Profile({0: (0.0, 4.0)}, [], [(1.0, 3.0, "vct.frame")])
    assert SP.idle_ms(Ctx(p), ["frame"]) == [2000.0]
    assert SP.outside_ms(Ctx(p)) == [2000.0]


@pytest.mark.parametrize("name,want", [
    ("binning_idle_ms.frame", 1000.0), ("recast_idle_ms.frame", 1000.0),
    ("shade_idle_ms.frame", 0.0), ("specmarch_idle_ms.frame", 0.0),
    ("outside_idle_ms.frame", 1750.0), ("outside_idle_ms.relight", 1750.0),
    ("splat_idle_ms.relight", 0.0), ("march_tables_idle_ms.relight", 250.0),
])
def test_span_metrics(name, want):
    read = spec.metric_reader(ROOT, name)
    assert read(Ctx(_profile())) == want
    assert read(Ctx(_profile(host=False))) is None
    assert read(Ctx(None)) is None


def test_dropped_metric(monkeypatch):
    from vct_tpu_torch import stages
    read = spec.metric_reader(ROOT, "binning_dropped.frame")
    monkeypatch.setattr(stages, "_COUNTS", {})
    assert read(Ctx(None)) is None
    monkeypatch.setattr(stages, "_COUNTS", {
        "binning.dropped": [torch.tensor(9), 3]})
    assert read(Ctx(None)) == 3.0
    # a program without counters: nothing to read
    monkeypatch.delattr(stages, "counters")
    assert read(Ctx(None)) is None
