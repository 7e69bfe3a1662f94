"""BENCHMARK.json and the files it names, found by name under a root
(the checkout's): a cell's configuration file, its traffic mix
(`vctbench/traffic/<traffic>.json`), its limits
(`vctbench/limits/<cell>.json`) and each per-layer metric's reader
(`vctbench/metrics/<metric>.json` or `.py`).  A later cell, mix or
metric is a new file and a new entry; nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

PKG = "vctbench"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration file
    traffic: dict         # the traffic mix
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_spec(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The workload `name` of BENCHMARK.json under `root`, with its files;
    an unknown name raises KeyError."""
    root = Path(root)
    spec = load_spec(root)
    wl = {w["name"]: w for w in spec["workloads"]}[name]
    cfg = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    return Cell(
        name=name,
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads(
            (root / PKG / "traffic" / f"{wl['traffic']}.json").read_text()),
        limits=json.loads(
            (root / PKG / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def metric_reader(root: Path, name: str) -> Callable:
    """The reader of per-layer metric `name`: read(ctx) -> value or None.
    `<name>.json` names a general reader of vctbench/readers.py by its
    "kind" and gives its parameters; `<name>.py` defines read(ctx)."""
    base = Path(root) / PKG / "metrics"
    data = base / f"{name}.json"
    if data.exists():
        from vctbench import readers
        params = json.loads(data.read_text())
        general = getattr(readers, params["kind"])
        return lambda ctx: general(ctx, params)
    path = base / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"vctbench_metric_{name.replace('.', '_')}", path)
    if mod_spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} in {base}")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
