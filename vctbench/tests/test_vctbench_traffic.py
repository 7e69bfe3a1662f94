"""The traffic generator and the loop at a tiny size on the CPU."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest

from vctbench import harness, spec
from vctbench.inputs import traffic as T

REPO = Path(__file__).resolve().parents[2]

SEED = 2 ** 31 + 12345        # seeds may pass 32 signed bits


def _mix(name):
    return json.loads((REPO / "vctbench" / "traffic" /
                       f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["walk", "relight"])
def test_paths_are_the_seeds_and_stay_in_the_hall(name):
    mix = _mix(name)
    a = T.make_paths(mix, SEED, 500)
    b = T.make_paths(mix, SEED, 500)
    c = T.make_paths(mix, SEED + 1, 500)
    assert np.array_equal(a.position, b.position)
    assert not np.array_equal(a.position, c.position)
    assert len(T.make_paths(mix, -SEED, 3)) == 3     # any whole number
    cam = mix["camera"]
    for ax, k in ((0, "x"), (2, "z")):
        lo, hi = cam[k]
        assert lo <= a.position[:, ax].min() and a.position[:, ax].max() <= hi
    assert np.all(a.position[:, 1] == cam["y"])
    assert np.abs(a.pitch).max() <= cam["pitch_deg"]
    # small moves a step
    assert np.abs(np.diff(a.position, axis=0)).max() < 1.0
    if name == "relight":
        el = np.degrees(np.arcsin(a.light[:, 1]))
        lo, hi = mix["light"]["elevation_deg"]
        assert lo - 1e-9 <= el.min() and el.max() <= hi + 1e-9
        assert np.allclose(np.linalg.norm(a.light, axis=1), 1.0)
        assert all(a.rebuilds(i) for i in range(10))
    else:
        assert a.light is None and not any(a.rebuilds(i) for i in range(10))


def test_every_seed_visits_the_same_ranges():
    mix = _mix("walk")
    spans = []
    for seed in (1, 2, 3, SEED):
        p = T.make_paths(mix, seed, 1200)
        spans.append((p.position[:, 0].min(), p.position[:, 0].max(),
                      np.percentile(p.pitch, 90)))
    spans = np.array(spans)
    assert np.ptp(spans[:, 0]) < 2.0 and np.ptp(spans[:, 1]) < 2.0
    assert np.ptp(spans[:, 2]) < 2.0


@pytest.mark.parametrize("cell", ["sponza256.walk", "sponza256.relight",
                                  "sponza256_exact_specular.walk"])
def test_the_loop_at_a_tiny_size(tiny_root, cell):
    res = harness.run_cell(tiny_root, cell, SEED, 0.5, False,
                           time.perf_counter(), device="cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    want = {m["name"] for m in spec.load_cell(tiny_root, cell).end_to_end}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(spec.load_cell(tiny_root, cell).limits)
