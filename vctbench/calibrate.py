"""The readings the comparison's limits are set from, for one cell, in
one process: the program's numbers over many seeds (the lower readings)
and the lower-precision control's over a few (the upper readings).

    python3 -m vctbench.calibrate --workload sponza256.walk \\
        --seeds 11,12,13 --control-seeds 11,12,13

For each seed the program runs the mix's steps up to the last one its
check samples (as a run's window would, untimed), and the sampled
outputs are compared with the reference, as in a run.  For each control
seed the control (the reference the configuration names, with
lower_precision; spec.reference_class) is put in the program's place on
the same sampled steps.  One JSON line a seed and kind on stdout, then a
summary line: per number the largest program reading and the smallest
control reading.  It needs the cell's CUDA card; --device cpu runs it on
the CPU (tests, tiny configs).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from vctbench import harness, spec
from vctbench.inputs import traffic as T
from vctbench.program import Program

ROOT = Path(__file__).resolve().parents[1]


def calibrate(root: Path, name: str, seeds, control_seeds, device="cuda"):
    """[(kind, seed, [numbers of each sample])] for the program's seeds,
    then the control's."""
    cell = spec.load_cell(root, name)
    mix, tree = cell.traffic, cell.config["config"]
    dev = torch.device(device)
    base, frame = harness.scenes(cell.config)
    r = tree["render"]
    rays = T.RayMaker(r["width"], r["height"], r["fov_degrees"], dev)
    program = Program(tree, base, frame, dev)
    reference = cell.reference(tree, base, frame, dev)
    control = cell.reference(tree, base, frame, dev, lower_precision=True)
    fixed = None
    out = []
    for kind, seed in ([("program", s) for s in seeds]
                       + [("control", s) for s in control_seeds]):
        sample = harness.sample_steps(mix, seed)
        paths = T.make_paths(mix, seed, max(sample) + 1)
        basis = rays.basis(paths)
        kept = {}
        if kind == "program":
            state = None
            if not paths.rebuild_every:
                fixed = fixed or program.build(None)
                state = fixed
            for i in range(max(sample) + 1):
                if paths.rebuilds(i):
                    state = None
                    state = program.build(paths.light[i])
                if i in sample:
                    o, d, p = rays.rays(basis[i])
                    kept[i] = (state, program.frame(state, o, d, p))
            state = None
        else:
            fixed = None
            ctl = control.build(None) if not paths.rebuild_every else None
            for i in sorted(sample):
                b = ctl or control.build(paths.light[i])
                o, d, p = rays.rays(basis[i])
                kept[i] = (b, control.frame(b, o, d, p))
        nums = harness.check_samples(reference, kept, paths, rays, basis)
        out.append((kind, seed, nums))
        print(json.dumps({"kind": kind, "seed": seed, "samples": nums}),
              flush=True)
    return out


def summary(rows) -> dict:
    """Per number: the program's largest reading, the control's smallest."""
    res: dict = {}
    for kind, _, nums in rows:
        for n in nums:
            for k, v in n.items():
                d = res.setdefault(k, {"program_max": 0.0,
                                       "control_min": float("inf")})
                if kind == "program":
                    d["program_max"] = max(d["program_max"], v)
                else:
                    d["control_min"] = min(d["control_min"], v)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        harness.log("calibrate: CUDA is not available")
        return 1
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    rows = calibrate(ROOT, args.workload, ints(args.seeds),
                     ints(args.control_seeds), args.device)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
