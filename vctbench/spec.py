"""BENCHMARK.json and the files it names, found by name under a root
(the checkout's): a cell's configuration file, its traffic mix
(`vctbench/traffic/<traffic>.json`), its limits
(`vctbench/limits/<cell>.json`), the plain reference its configuration
names and each per-layer metric's reader (`vctbench/metrics/<metric>.json`
or `.py`).  A later cell, mix, reference or metric is a new file and a
new entry; nothing here changes.

The reference.  A configuration file may carry a top-level key
"reference": the dotted path of a module inside the vctbench package
that defines `Reference`; without it the path is DEFAULT_REFERENCE (the
frozen copy of the fast path's plain PyTorch).  A configuration off that
route (anisotropic mips, per-cone cones, the shadow map, a wider frame)
brings a reference package of its own, which may import the frozen
`vctbench.reference` modules and override only what differs, and loads
nothing of vct_tpu_torch, vct_tpu or jax.  The harness and the
calibration use it for the reference and for its lower-precision
control, through this interface:

    Reference(config_tree, scene_base, scene_frame, device,
              lower_precision=False)
        config_tree: the configuration file's "config"; the scenes are
        the benchmark's (vctbench/inputs/scene.py): the voxel build's
        and the frame's.  lower_precision=True is the control: the same
        reference computed one precision below what the configuration
        states.
    .build(light=None, works=None) -> an object with .cfg and .voxels
        The state under `light` (toward the light, (3,)), or the
        configuration's own light.  .voxels holds the fields that
        vctbench/check.py compares (check.STATE_FIELDS), each None where
        the route builds no such field.  `works`, a list, collects
        (bytes, float operations) of each dense march.
    .frame(built, origins, dirs, position) -> (H, W, 3) linear RGB
    .march_work(light) -> [(bytes, float operations)] of each dense
        march of a build under `light` (the march roofline's numerator).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

PKG = "vctbench"
DEFAULT_REFERENCE = f"{PKG}.reference.pipeline"
_MODULE = re.compile(rf"{PKG}(\.[A-Za-z_][A-Za-z0-9_]*)+")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration file
    traffic: dict         # the traffic mix
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    reference: type       # the Reference class the configuration names


def load_spec(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reference_module(config: dict) -> str:
    """The dotted path of the reference module a configuration file
    names (DEFAULT_REFERENCE without the key); a path outside the
    vctbench package raises ValueError."""
    path = config.get("reference", DEFAULT_REFERENCE)
    if not isinstance(path, str) or not _MODULE.fullmatch(path):
        raise ValueError(f"the configuration's reference {path!r} is not "
                         f"a module inside the {PKG} package")
    return path


def reference_class(config: dict) -> type:
    """The `Reference` of the module a configuration file names; a
    module that is missing, or that defines no Reference, raises
    ValueError naming it."""
    path = reference_module(config)
    try:
        mod = importlib.import_module(path)
    except ModuleNotFoundError as e:
        if e.name is None or not (path + ".").startswith(e.name + "."):
            raise                        # a module it imports is missing
        raise ValueError(f"the configuration's reference module {path!r} "
                         f"does not exist") from e
    ref = getattr(mod, "Reference", None)
    if not isinstance(ref, type):
        raise ValueError(f"the configuration's reference module {path!r} "
                         f"defines no class Reference")
    return ref


def load_cell(root: Path, name: str) -> Cell:
    """The workload `name` of BENCHMARK.json under `root`, with its files
    and its reference; an unknown name raises KeyError, a bad reference
    ValueError."""
    root = Path(root)
    spec = load_spec(root)
    wl = {w["name"]: w for w in spec["workloads"]}[name]
    cfg = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    return Cell(
        name=name,
        config=config,
        traffic=json.loads(
            (root / PKG / "traffic" / f"{wl['traffic']}.json").read_text()),
        limits=json.loads(
            (root / PKG / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        reference=reference_class(config))


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
