"""One run of one cell: set-up, warm-up, the measured window, the traced
readings, then the comparison with the plain reference.

The loop is closed: one viewer, each step ends when its image has been
synchronised (`torch.cuda.synchronize`), and the next starts then.  A
step of a mix whose steps rebuild (`rebuild_every`) first builds the
voxel state (and on the fast path the frame tables) under its own sun;
every step then renders one frame on its own rays.  The end-to-end
metrics, named by the mix's `step` ("frame" or "relight"): `<step>_ms`,
the window's time over the steps completed in it, and `<step>_p95_ms`,
the 95th percentile of every step's time in it; `setup_s`, the
process's start to the first timed step.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vctbench import check, spec
from vctbench import trace as TR
from vctbench.inputs import scene as S
from vctbench.inputs import traffic as T

FORBIDDEN = ("jax", "jaxlib", "flax", "vct_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (vct_tpu_torch is not vct_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def scenes(config: dict):
    """(the voxel build's scene, the frame's scene) of a configuration
    file: the atrium, and the atrium subdivided `frame_subdivisions`
    times (the same surfaces in 4**n times the triangles)."""
    base = S.atrium()
    return base, S.subdivide_scene(base, int(config["frame_subdivisions"]))


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def sample_steps(mix: dict, seed: int) -> set:
    """The seed-chosen steps whose outputs the check compares (the
    slowest step of the window joins them)."""
    chk = mix["check"]
    return set(_rng(seed, 1).choice(int(chk["within"]), int(chk["samples"]),
                                    replace=False).tolist())


def check_samples(reference, kept: Dict[int, tuple], paths: T.Paths,
                  rays: T.RayMaker, basis) -> List[Dict[str, float]]:
    """The numbers compared for each kept step {i: (program state, image)}
    against the reference on the same inputs; `kept` is emptied as it
    goes, so the program's outputs are freed one by one."""
    rebuild = bool(paths.rebuild_every)
    ref_states: Dict[object, object] = {}
    out = []
    for i in sorted(kept):
        prog_state, prog_img = kept.pop(i)
        key = i if rebuild else None
        if key not in ref_states:
            ref_states.clear()
            ref_states[key] = reference.build(
                paths.light[i] if rebuild else None)
        rs = ref_states[key]
        o, d, p = rays.rays(basis[i])
        ref_img = reference.frame(rs, o, d, p)
        nums = check.numbers(prog_img, ref_img,
                             prog_state.voxels if rebuild else None,
                             rs.voxels if rebuild else None)
        del prog_state, prog_img, ref_img
        out.append(nums)
        log(f"check step {i}: " + ", ".join(f"{k} {v:.6g}"
                                             for k, v in nums.items()))
    return out


class TraceContext:
    """What a per-layer reader reads (vctbench/readers.py and the metric
    files): stage ms summed over the window's steps and their count, host
    syncs a step, the profile of the profiled steps, and for the march
    roofline the seed-chosen profiled steps that rebuilt, their suns and
    the reference that counts their work."""

    def __init__(self, stage_ms, steps, syncs, profile, work_steps, light,
                 reference, kind):
        self.stage_ms: Dict[str, float] = stage_ms
        self.steps: int = steps
        self.syncs: List[int] = syncs
        self.profile: Optional[TR.Profile] = profile
        self.work_steps: List[int] = work_steps
        self.light = light
        self.reference = reference
        self.kind = kind


def run_cell(root: Path, name: str, seed: int, seconds: float,
             trace: bool, t_start: float, device="cuda",
             make_program: Optional[Callable] = None) -> dict:
    """The result line of one run (see run.py), against the reference the
    cell's configuration names (spec.reference_class); `make_program`
    stands in for the program (vctbench/program.py)."""
    cell = spec.load_cell(root, name)
    mix = cell.traffic
    tree = cell.config["config"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if make_program is None:
        from vctbench.program import Program as make_program

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    base, frame = scenes(cell.config)
    paths = T.make_paths(mix, seed, int(mix["max_steps"]))
    program = make_program(tree, base, frame, dev)
    r = tree["render"]
    rays = T.RayMaker(r["width"], r["height"], r["fov_degrees"], dev)
    basis = rays.basis(paths)
    box = {"state": None if paths.rebuild_every else program.build(None)}

    def step(i: int):
        if paths.rebuilds(i):
            box["state"] = None          # free the last state first
            box["state"] = program.build(paths.light[i])
        o, d, p = rays.rays(basis[i])
        return box["state"], program.frame(box["state"], o, d, p)

    # warm-up: the mix's own poses, spread over a turn of the camera
    for i in np.linspace(0, mix["camera"]["periods"]["yaw"],
                         int(mix["warmup_steps"]), endpoint=False):
        step(int(i))
    sync()

    sample = sample_steps(mix, seed)
    kept: Dict[int, tuple] = {}
    slowest = (-1.0, -1, None)
    times: List[float] = []
    events = syncs = None
    if trace and cuda:
        events, syncs = TR.StageEvents(), TR.SyncCounter()
        program.set_marks(events.mark)
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    with (syncs.active() if syncs else contextlib.nullcontext()):
        t_end = t_w0
        while t_end - t_w0 < seconds and len(times) < len(paths):
            i = len(times)
            if events:
                events.begin_step()
            t0 = time.perf_counter()
            out = step(i)
            sync()
            t_end = time.perf_counter()
            if syncs:
                syncs.end_step()
            dt = t_end - t0
            times.append(dt)
            if i in sample:
                kept[i] = out
            if dt > slowest[0]:
                slowest = (dt, i, out)
            del out
    window_s = t_end - t_w0
    n = len(times)
    program.set_marks(None)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kept.setdefault(slowest[1], slowest[2])
    slowest = None
    log(f"window: {n} steps in {window_s:.3f} s, setup {setup_s:.3f} s, "
        f"peak memory {peak} bytes")

    result = {"correct": False, "attempted": n, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if cuda
                         else "cpu", "count": 1,
                         "memory_peak_bytes": int(peak)}}
    step_name = mix["step"]
    e2e = {"setup_s": setup_s,
           f"{step_name}_ms": window_s / n * 1e3,
           f"{step_name}_p95_ms": float(np.percentile(times, 95)) * 1e3}
    profile = None
    work_steps: List[int] = []
    if trace:
        stage_ms = events.stage_ms() if events else {}
        if cuda:
            prof_steps = list(range(n, min(n + int(mix["profile_steps"]),
                                           len(paths))))
            profile = TR.profile_steps(step, prof_steps)
            rebuilt = [i for i in prof_steps if paths.rebuilds(i)]
            k = min(int(mix.get("work_steps", 0)), len(rebuilt))
            work_steps = sorted(_rng(seed, 2).choice(
                rebuilt, k, replace=False).tolist()) if k else []
            result["device"]["busy_s"] = profile.busy_s
            result["device"]["window_s"] = profile.window_s
            result["breakdown"] = {"device_ops": profile.top_device_ops(),
                                   "idle_gaps": profile.idle_gaps()}
    # the program's state goes before the reference runs
    box.clear()
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    reference = cell.reference(tree, base, frame, dev)
    samples = check_samples(reference, kept, paths, rays, basis)
    failed = sum(not check.passes(s, cell.limits) for s in samples)

    if trace:
        ctx = TraceContext(stage_ms, n, syncs.per_step if syncs else [],
                           profile, work_steps, paths.light, reference,
                           result["device"]["kind"])
        for m in cell.per_layer:
            v = spec.metric_reader(root, m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    result["failed"] = failed
    result["correct"] = bool(samples) and failed == 0
    result["checks"] = check.worst(samples, cell.limits)
    return result
