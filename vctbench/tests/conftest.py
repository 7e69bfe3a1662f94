"""Fixtures of the benchmark's own tests (run them with
`python -m pytest vctbench/tests`): a tiny copy of the benchmark's data
(16^3, 96x64, the atrium subdivided once) for CPU runs, and the card
marker: a test that needs a CUDA card takes the `card` fixture, which
skips it where there is none."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
    # several test workers share the host's cores
    import torch
    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def make_tiny_root(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's data files under `dest`, each
    configuration cut to 16^3 and 96x64 on the atrium subdivided once
    (4,488 triangles: the binned raycast), each mix to short checks.  The
    limits are the repository's own."""
    (dest / "vctbench").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", dest)
    for d in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(REPO / "vctbench" / d, dest / "vctbench" / d)
    for p in (dest / "vctbench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["config"]["grid"]["dim"] = 16
        c["config"]["render"].update(width=96, height=64)
        c["frame_subdivisions"] = 1
        p.write_text(json.dumps(c))
    for p in (dest / "vctbench" / "traffic").glob("*.json"):
        m = json.loads(p.read_text())
        m.update(max_steps=64, warmup_steps=1,
                 check={"samples": 2, "within": 3})
        p.write_text(json.dumps(m))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
