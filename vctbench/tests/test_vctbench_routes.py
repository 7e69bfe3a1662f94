"""The reference a configuration names, and the program's route: a
configuration file's "reference" key is honoured by the harness and the
calibration, a bad one fails when the cell loads, the program builds
frame tables exactly where the port takes its fast path, and the check
compares the shadow map."""

from __future__ import annotations

import dataclasses
import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from vctbench import calibrate, check, harness, spec
from vctbench.program import Program
from vctbench.reference import pipeline
from vctbench.tests import standin_reference

REPO = Path(__file__).resolve().parents[2]
CELLS = ("sponza256.walk", "sponza256.relight",
         "sponza256_exact_specular.walk")
STANDIN = "vctbench.tests.standin_reference"


def oracle_tree() -> dict:
    """The aniso128 preset's config tree (anisotropic 6-direction mips,
    per-cone diffuse and specular: off the fast path), cut to 16^3 and
    24x24."""
    from vct_tpu_torch import config as PC
    cfg = PC.preset("aniso128")
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=16),
        render=dataclasses.replace(cfg.render, width=24, height=24))
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def add_config(root: Path, name: str, config: dict, traffic="walk"):
    """A configuration file and a cell `<name>.<traffic>` under `root`,
    with the walk's limits."""
    b = root / "vctbench"
    (b / "configs" / f"{name}.json").write_text(json.dumps(config))
    (b / "limits" / f"{name}.{traffic}.json").write_text(
        (b / "limits" / "sponza256.walk.json").read_text())
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": name, "source": "x", "reduced": [],
                         "file": f"vctbench/configs/{name}.json", "why": "x"})
    s["workloads"].append({"name": f"{name}.{traffic}", "config": name,
                           "traffic": traffic, "chips": 1, "why": "x"})
    for m in s["end_to_end"]:
        if f"sponza256.{traffic}" in m.get("workloads", ()):
            m["workloads"].append(f"{name}.{traffic}")
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    return f"{name}.{traffic}"


@pytest.fixture
def root(tiny_root, tmp_path) -> Path:
    dest = tmp_path / "copy"
    shutil.copytree(tiny_root, dest)
    return dest


def test_existing_configurations_take_the_frozen_reference():
    for cell in CELLS:
        c = spec.load_cell(REPO, cell)
        assert "reference" not in c.config
        assert spec.reference_module(c.config) == spec.DEFAULT_REFERENCE
        assert c.reference is pipeline.Reference


@pytest.mark.parametrize("path,why", [
    ("vctbench.no_such_reference.pipeline", "does not exist"),
    ("vctbench.check", "defines no class Reference"),
    ("os.path", "not a module inside"),
    ("vctbench", "not a module inside"),
    ("vctbench..reference", "not a module inside"),
])
def test_a_bad_reference_fails_at_load(root, path, why):
    cfg = json.loads((REPO / "vctbench/configs/sponza256.json").read_text())
    cfg["reference"] = path
    cell = add_config(root, "badref", cfg)
    with pytest.raises(ValueError, match=why) as e:
        spec.load_cell(root, cell)
    assert repr(path) in str(e.value)

    def never(*a):
        raise AssertionError("set-up started")
    with pytest.raises(ValueError, match=why):
        harness.run_cell(root, cell, 5, 0.1, False, time.perf_counter(),
                         device="cpu", make_program=never)


def _marks(program, light):
    seen = []
    program.set_marks(seen.append)
    try:
        return program.build(light), seen
    finally:
        program.set_marks(None)


def test_program_route(tiny_root):
    base, frame = harness.scenes({"frame_subdivisions": 0})
    fast = json.loads((tiny_root / "vctbench/configs/sponza256.json"
                       ).read_text())["config"]
    state, seen = _marks(Program(fast, base, frame, "cpu"), (0.2, 1.0, 0.3))
    assert state.tables is not None and seen[-1] == "frame_tables"
    assert seen.count("frame_tables") == 1

    program = Program(oracle_tree(), base, base, "cpu")
    state, seen = _marks(program, None)
    assert state.tables is None and "frame_tables" not in seen
    assert state.voxels.radiance_mips[1].dim() == 5     # 6 directions
    r = torch.zeros(4, 4, 3)
    img = program.frame(state, r, r + torch.tensor([0.0, 0.0, -1.0]),
                        torch.zeros(3))
    assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())


def test_an_oracle_configuration_runs_with_the_reference_it_names(root):
    cell = add_config(root, "oracle16", {"frame_subdivisions": 0,
                                         "reference": STANDIN,
                                         "config": oracle_tree()})
    calls = standin_reference.Reference.calls
    calls.clear()
    res = harness.run_cell(root, cell, 31, 0.2, False, time.perf_counter(),
                           device="cpu")
    assert res["attempted"] >= 1 and set(res["metrics"]) == {
        "setup_s", "frame_ms", "frame_p95_ms"}
    assert set(res["checks"]) == {"image_max_err", "image_mean_err"}
    kinds = [c[0] for c in calls]
    assert kinds[0] == "init" and calls[0][1] is False
    assert "build" in kinds and ("frame", (24, 24, 3)) in calls

    calls.clear()
    rows = calibrate.calibrate(root, cell, [31], [32], device="cpu")
    assert [k for k, _, _ in rows] == ["program", "control"]
    assert [c[1] for c in calls if c[0] == "init"] == [False, True]
    assert ("frame", (24, 24, 3)) in calls


def test_the_shadow_map_is_compared():
    def state(shadow_map):
        return SimpleNamespace(radiance_mips=(torch.ones(4, 4, 4, 4),),
                               unlit_mips=(torch.ones(4, 4, 4, 4),),
                               shadow_map=shadow_map)
    sm = torch.rand(8, 8, generator=torch.Generator().manual_seed(3))
    img = torch.zeros(2, 2, 3)
    same = check.numbers(img, img, state(sm.clone()), state(sm))
    assert same["state_rel_rms"] == 0.0
    moved = sm.clone()
    moved[2, 3] += 0.5
    assert check.numbers(img, img, state(moved), state(sm))[
        "state_rel_rms"] > 1e-3
    assert check.numbers(img, img, state(None), state(sm))[
        "state_rel_rms"] == float("inf")
