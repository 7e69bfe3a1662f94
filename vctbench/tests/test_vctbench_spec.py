"""BENCHMARK.json against the shape the harness relies on, and it picking up
a configuration, a mix, a limit file and a metric that are new files in
a temporary copy."""

from __future__ import annotations

import json
import re
import time
from pathlib import Path

from vctbench import harness, spec

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_shape():
    s = spec.load_spec(REPO)
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["vctbench"] and 1 <= s["run_seconds"] <= 51
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    cells = {w["name"]: w for w in s["workloads"]}
    for c in s["configs"]:
        assert NAME.match(c["name"]) and (REPO / c["file"]).exists()
        assert c["file"].startswith("vctbench/")
    for w in cells.values():
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (REPO / "vctbench" / "traffic" / f"{w['traffic']}.json"
                ).exists()
        assert (REPO / "vctbench" / "limits" / f"{w['name']}.json").exists()
        cell = spec.load_cell(REPO, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
    for m in s["per_layer"]:
        assert NAME.match(m["name"]) and m["moves"] in e2e
        assert callable(spec.metric_reader(REPO, m["name"]))
    assert len(json.dumps(s)) < 64 * 1024


def test_new_files_are_picked_up(tiny_root, tmp_path):
    """A later PR adds a mix, a limit file, a metric file and entries:
    the harness finds them by name, with no edit of its code."""
    import shutil
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    b = root / "vctbench"
    mix = json.loads((b / "traffic" / "walk.json").read_text())
    mix["camera"]["pitch_deg"] = 5.0
    (b / "traffic" / "glance.json").write_text(json.dumps(mix))
    cfg = json.loads((b / "configs" / "sponza256.json").read_text())
    cfg["config"]["render"]["alpha_mask_depth"] = 0
    (b / "configs" / "nomask.json").write_text(json.dumps(cfg))
    (b / "limits" / "nomask.glance.json").write_text(
        (b / "limits" / "sponza256.walk.json").read_text())
    (b / "metrics" / "rays_ms.frame.json").write_text(
        json.dumps({"kind": "stage_sum", "stages": ["rays"]}))
    (b / "metrics" / "steps.frame.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "nomask", "source": "x",
                         "file": "vctbench/configs/nomask.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "nomask.glance", "config": "nomask",
                           "traffic": "glance", "chips": 1, "why": "x"})
    for m in s["end_to_end"]:
        if "workloads" in m and "sponza256.walk" in m["workloads"]:
            m["workloads"].append("nomask.glance")
    for n in ("rays_ms.frame", "steps.frame"):
        s["per_layer"].append({"name": n, "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "x",
                               "moves": "frame_ms",
                               "workloads": ["nomask.glance"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    cell = spec.load_cell(root, "nomask.glance")
    assert cell.traffic["camera"]["pitch_deg"] == 5.0
    assert {m["name"] for m in cell.per_layer} == {"rays_ms.frame",
                                                  "steps.frame"}

    class Ctx:
        stage_ms = {"rays": 6.0}
        steps = 3
    assert spec.metric_reader(root, "rays_ms.frame")(Ctx) == 2.0
    assert spec.metric_reader(root, "steps.frame")(Ctx) == 3.0
    res = harness.run_cell(root, "nomask.glance", 9, 0.3, False,
                           time.perf_counter(), device="cpu")
    assert res["correct"] and set(res["metrics"]) == {
        "setup_s", "frame_ms", "frame_p95_ms"}
