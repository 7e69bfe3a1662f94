"""Where the time goes: per-stage device times of the voxel build and the
1080p frame on the card, for one scene of the port's slice.

    python -m vct_tpu_torch.profile_stages --scene atrium --reps 5
    python -m vct_tpu_torch.profile_stages --preset sponza256_exact_specular

--preset (default sponza256, or sponza256_exact_specular: the exact
per-pixel specular march in place of the specular field) at 1920x1080,
on the scenes and cameras of chip_smoke.py:
"cornell" (40 triangles), "atrium" (1,122) and "atrium287k", bench.py's
frame: the atrium subdivided 4 times (287,232 triangles, the binned
raycast) on the voxel state of the base atrium's samples.
Prints the card (nvidia-smi name and power limit), then one JSON line per
measurement:
  * "build" and "frame": device ms per stage, medians over --reps runs,
    from CUDA events recorded at the vct_tpu_torch.stages marks (a stage
    is the work enqueued between its mark and the previous one), and the
    whole call's ms between a start and an end event;
  * "syncs": host synchronizations in one frame, counted by torch's CUDA
    sync debug mode;
  * "profile": over --reps frames under torch.profiler, the summed device
    time of all kernels against the host wall time of the loop (the
    device's busy share), the kernel count, and the ten largest kernels
    by device time per frame.
It needs a card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
import warnings

import torch

from vct_tpu_torch import stages
from vct_tpu_torch.config import preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.scene.mesh import subdivide_scene
from vct_tpu_torch.utils.profiling import card_line

BENCH_CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0)   # bench.py:122
CAMERAS = {"cornell": dict(position=(3.0, 2.0, 40.0)),
           "atrium": BENCH_CAMERA, "atrium287k": BENCH_CAMERA}
SUBDIVIDE = {"atrium287k": 4}      # the frame's scene: 4**levels x triangles


def _scene(name):
    if name == "cornell":
        from vct_tpu_torch.scene.cornell import cornell_box
        return cornell_box(size=100.0)
    from vct_tpu_torch.scene.atrium import atrium
    return atrium()


def stage_ms(fn, reps: int):
    """({stage: median device ms}, [total ms per rep]) of fn().  A stage
    marked more than once in a run (render_rays marks each chunk's) counts
    the sum of its pieces."""
    per, totals = {}, []
    for rep in range(reps + 1):               # the first run warms up
        events = []

        def record(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        record("start")
        stages.MARK = record
        try:
            fn()
        finally:
            stages.MARK = None
        record("end")
        torch.cuda.synchronize()
        if rep == 0:
            continue
        run = {}
        for (_, a), (name, b) in zip(events, events[1:]):
            run[name] = run.get(name, 0.0) + a.elapsed_time(b)
        for name, ms in run.items():
            per.setdefault(name, []).append(ms)
        totals.append(events[0][1].elapsed_time(events[-1][1]))
    return {k: statistics.median(v) for k, v in per.items()}, totals


def count_syncs(fn) -> int:
    return sum(syncs_by_stage(fn).values())


def syncs_by_stage(fn) -> dict:
    """Host synchronizations in one fn() by stage: {stage: count}, where a
    stage holds the syncs after the previous vct_tpu_torch.stages mark up
    to its own ("end": after the last mark)."""
    counts, seen = {}, [0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")

            def record(name):
                n = sum("synchroniz" in str(w.message) for w in caught)
                counts[name] = counts.get(name, 0) + n - seen[0]
                seen[0] = n

            stages.MARK = record
            try:
                fn()
            finally:
                stages.MARK = None
            record("end")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return counts


def profile(fn, reps: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only: an operator's row repeats its kernels'
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    return {"wall_ms_per_frame": wall_ms / reps,
            "device_ms_per_frame": busy / reps,
            "busy_share": busy / wall_ms if wall_ms else None,
            "kernels_per_frame": sum(r[1] for r in rows) / reps,
            "top": [{"name": k[:80], "ms_per_frame": ms / reps,
                     "calls_per_frame": n / reps} for ms, n, k in rows[:10]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=sorted(CAMERAS), default="atrium")
    ap.add_argument("--preset", default="sponza256",
                    choices=("sponza256", "sponza256_exact_specular"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_stages: CUDA is not available", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    cfg = preset(args.preset)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, width=1920, height=1080))
    dev = torch.device("cuda")
    camera = CAM.Camera(**CAMERAS[args.scene])
    scene = _scene(args.scene)
    ds, mats, samples = R.prepare_scene(cfg, scene, device=dev)
    levels = SUBDIVIDE.get(args.scene, 0)
    if levels:
        # the same surfaces in more triangles: the base scene's samples
        ds, _, _ = R.prepare_scene(cfg, subdivide_scene(scene, levels),
                                   samples=samples, device=dev)
    voxels = R.build_voxel_state(cfg, samples, mats)
    tables = F.build_frame_tables(cfg, voxels, mats)
    origins, dirs = CAM.primary_rays(camera, 1920, 1080, device=dev)
    cam = torch.as_tensor(camera.position, dtype=torch.float32, device=dev)

    def frame():
        return F.render_frame(cfg, ds, tables, mats, origins, dirs, cam)

    common = {"scene": args.scene, "preset": args.preset,
              "triangles": ds.v0.shape[0], "card": card}
    b, bt = stage_ms(lambda: R.build_voxel_state(cfg, samples, mats),
                     max(1, args.reps // 2))
    print(json.dumps({"build": b, "total_ms": bt, **common}), flush=True)
    f, ft = stage_ms(frame, args.reps)
    print(json.dumps({"frame": f, "total_ms": ft, **common}), flush=True)
    print(json.dumps({"syncs": count_syncs(frame), **common}), flush=True)
    print(json.dumps({"profile": profile(frame, args.reps), **common}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
