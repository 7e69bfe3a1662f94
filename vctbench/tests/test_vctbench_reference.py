"""The reference against the program at a tiny size on the CPU (where
the program runs its plain versions: equal bit for bit), and the
lower-precision control against the repository's limits: it has to
fail them."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vctbench import check, harness, spec
from vctbench.calibrate import calibrate, summary
from vctbench.inputs import traffic as T
from vctbench.program import Program
from vctbench.reference.pipeline import Reference

REPO = Path(__file__).resolve().parents[2]
SUN = np.array([0.3, 0.8, -0.2]) / np.linalg.norm([0.3, 0.8, -0.2])


@pytest.mark.parametrize("name", ["sponza256", "sponza256_exact_specular"])
def test_reference_equals_the_program_on_the_cpu(tiny_root, name):
    cfg = json.loads((tiny_root / "vctbench" / "configs" /
                      f"{name}.json").read_text())
    base, frame = harness.scenes(cfg)
    tree = cfg["config"]
    prog = Program(tree, base, frame, "cpu")
    ref = Reference(tree, base, frame, "cpu")
    paths = T.make_paths(json.loads((tiny_root / "vctbench" / "traffic" /
                                     "walk.json").read_text()), 5, 3)
    rm = T.RayMaker(96, 64, 45.0, "cpu")
    o, d, p = rm.rays(rm.basis(paths)[2])
    for light in (None, SUN):
        ps, rs = prog.build(light), ref.build(light)
        errs = check.state_errors(ps.voxels, rs.voxels)
        assert errs and max(errs.values()) == 0.0
        assert torch.equal(prog.frame(ps, o, d, p), ref.frame(rs, o, d, p))


@pytest.mark.parametrize("cell", ["sponza256.walk", "sponza256.relight",
                                  "sponza256_exact_specular.walk"])
def test_the_control_fails_the_limits(tiny_root, cell):
    """The control (the reference one precision down) read on three
    seeds: each sample fails one of the cell's limits."""
    limits = spec.load_cell(tiny_root, cell).limits
    rows = calibrate(tiny_root, cell, [], [3, 4, 2 ** 31 + 9], "cpu")
    assert len(rows) == 3
    for _, _, nums in rows:
        assert nums and not any(check.passes(n, limits) for n in nums)
    s = summary(rows)
    assert set(s) == set(limits)
