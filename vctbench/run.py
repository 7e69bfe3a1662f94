"""Run one cell of the benchmark once.

    python3 -m vctbench.run --workload sponza256.walk --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout, on a machine with the cell's CUDA cards.
Prints one JSON line on stdout: `correct`, `attempted` (the steps of the
window), `failed` (the samples that failed the comparison), `metrics`
(the cell's end-to-end metrics with --trace 0, its per-layer metrics
with --trace 1), `device`, with --trace 1 `breakdown`, and last `checks`
(each number compared, its largest reading and its limit).  The same
checks are the last lines on stderr.  Without CUDA, with fewer cards than
the cell asks for, or if a JAX module is loaded once the window has
closed, it exits 1 and prints no result.

The process runs with one intra-op CPU thread (OpenMP, MKL, OpenBLAS):
one host thread dispatches the program's work, and a pool of threads
spinning on the host's cores beside it makes each step's host side
slower and its time less steady.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# before torch and numpy load their thread pools
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from vctbench import harness, spec
    chips = {w["name"]: w["chips"]
             for w in spec.load_spec(ROOT)["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"vctbench: the cell needs {chips} CUDA card(s); "
                    f"available: {torch.cuda.is_available()}")
        return 1
    res = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"vctbench: forbidden modules loaded: {bad}")
        return 1
    for k, v in res["checks"].items():
        harness.log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
