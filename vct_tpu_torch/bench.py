"""Benchmark: cone-samples/s/chip at the operating point (port of bench.py).

    python -m vct_tpu_torch.bench

Environment, as bench.py reads it: VCT_BENCH_SCALE (frame size
1920x1080 times it, default 1.0), VCT_BENCH_DIM (grid, default 256),
VCT_BENCH_REPS (timed builds, default 5), VCT_BENCH_SUBDIV (the frame's
subdivisions of the atrium, default 4: 287,232 triangles) and
VCT_BENCH_CHUNK (render_rays' chunk when the config is off the fast
path, default 65536).  It needs a CUDA card and exits non-zero without
one; there is no CPU fallback.  run() does the work; the tests call it
with device="cpu".

What it measures, as bench.py does (bench.py:104-271):
  * the voxel build (render/renderer.build_voxel_state) of the atrium at
    `dim`^3 under preset sponza256 with its grid replaced by
    GridConfig(dim=dim, world_size=150.0), as bench.py:114-118 replaces
    it: the dense marches run in float32.  "cone-sample" = one
    quadrilinear fetch of the dense march, counted by count_dense_samples
    from the schedules (3,598.7 M at 256^3); value = samples over the
    median build time.  The preset's own bfloat16 march is built and
    timed beside it (`build_ms_bf16`, a labelled stderr line);
  * the diffuse-field march (shading.build_cone_field over the diffuse
    schedule) alone, one launch of the dense-march kernel (csrc/dense.cu)
    on the card: its bytes and float operations come from its shapes
    (ops/dense.march_work: each pyramid level it taps read once, the tap
    and step tables, the field written once; the operations of the steps
    each cell and direction takes before its early-out, the kernel's own
    count), march_achieved_gbps is those bytes over its time, and
    march_bound_share the least time the card could take for that work
    (the larger of bytes over the memory rate and operations over the
    float32 rate, halved as the kernel rounds every operation on its own)
    over its time.  Before the kernel the bytes were the eager march's
    op-by-op traffic, which a dispatch mode no longer sees on the kernel
    route.  march_mxu_util is null, as the march runs no matmul (it
    gathers and lerps);
  * the primary raycast at the frame's triangle count, itemized: above
    raycast.MAX_TRIANGLES the binned pipeline (binrast.pack_rows,
    bin_triangles, then the kernel, which writes the G-buffer itself on
    the card; on the CPU the plain walk and finish_binned), at or below
    it raycast.pack_tables and raycast_gbuf24;
  * the 1080p frame of the atrium subdivided VCT_BENCH_SUBDIV times
    (voxel state from the base atrium's samples) from the bench camera
    (48, -10, 0), yaw 180: render_frame on the fast path, else
    render_rays.

How the timing differs from bench.py's: PyTorch queues kernels as JAX
does, but the build and render_frame read values back to the host
(render_frame 2-3 times a frame), so queueing N calls and reading back
once (bench.py's framing) does not carry over.  Every time here is one
call between two CUDA events after a warm-up call, and each figure is
the median over the repetitions, with min and max beside it: builds
over VCT_BENCH_REPS, the march and the raycast over the same count, the
frame over max(VCT_BENCH_REPS, 5) frames.  bench.py's frame figure is
the mean of 5 queued frames.

Prints one JSON line on stdout with bench.py's keys (metric, value,
unit, vs_baseline, frame_ms_1080p, fps_1080p, fast_path, frame_tris,
raycast_ms, march_achieved_gbps, peak_gbps, march_mxu_util, build_ms)
and device (the card's name), power_limit_w (nvidia-smi's power limit),
dense_samples, build_ms_bf16, march_ms, march_bytes, march_ops,
march_bound_ms, march_bound_share, raycast_split_ms and frame_ms
(min/median/max); diagnostics go to stderr.  vs_baseline
keeps bench.py's definition: samples/s over the no-reuse roofline, the
card's peak bytes/s over BYTES_PER_SAMPLE (16 taps of RGBA float32).
On the CPU the device keys are null and the host-clock times sit under
host_ms.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time

import torch

from vct_tpu_torch.config import GridConfig, VCTConfig, preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.ops import binrast as BR
from vct_tpu_torch.ops import dense as OD
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.render import shading
from vct_tpu_torch.scene.atrium import atrium
from vct_tpu_torch.scene.mesh import subdivide_scene
from vct_tpu_torch.utils.profiling import card_line

# peak HBM bytes/s by torch.cuda.get_device_name (NVIDIA's data sheet:
# H100 SXM, 80 GB HBM3)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
# dense float32 operations a second outside the tensor cores (a fused
# multiply-add counted as two); the march rounds every operation on its
# own, one instruction each, so its rate is half of it
FP32_OPS_PER_S = {"NVIDIA H100 80GB HBM3": 67e12}
BYTES_PER_SAMPLE = 16 * 4 * 4   # quadrilinear: 16 taps x RGBA x f32
CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0)   # bench.py:122


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def peak_bytes_per_s(kind: str) -> float:
    """The card's peak memory bytes/s; an unknown card raises (bench.py
    fell back to a TPU v5e's figure)."""
    try:
        return HBM_BYTES_PER_S[kind]
    except KeyError:
        raise ValueError(f"no peak memory rate for device {kind!r}; known: "
                         f"{sorted(HBM_BYTES_PER_S)}") from None


def power_limit_w(line: str) -> float:
    """The watts of a card line: 'NVIDIA H100 80GB HBM3, 700.00 W'."""
    return float(line.rsplit(",", 1)[1].strip().split()[0])


def count_dense_samples(cfg: VCTConfig) -> int:
    """Cone samples evaluated by one build_voxel_state's dense marches
    (bench.py:79-94)."""
    dim = cfg.grid.dim
    df = shading.field_dim(cfg)
    b = cfg.cones.field_basis
    total = 0
    if cfg.shadow.mode == "volume":
        total += shading.shadow_schedule(cfg).num_steps * dim ** 3
    if cfg.cones.diffuse_mode == "field":
        total += b * shading.diffuse_schedule(cfg).num_steps * df ** 3
    if cfg.cones.trace_specular and cfg.cones.specular_mode == "field":
        # the field build marches the coarser field schedule
        total += b * shading.specular_field_schedule(cfg).num_steps * df ** 3
    return total


def _split_ms(dev: torch.device, stages):
    """Run stages [(name, fn(prev) -> out)] in turn; returns (last out,
    {name: ms}) with an event (or the host clock) between each two."""
    cuda = dev.type == "cuda"
    marks = []

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    out = None
    mark()
    for _, fn in stages:
        out = fn(out)
        mark()
    if cuda:
        torch.cuda.synchronize(dev)
        times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        times = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return out, {name: t for (name, _), t in zip(stages, times)}


def _ms(dev: torch.device, fn):
    """(fn(), its ms): between two CUDA events on the card, by the host
    clock on the CPU."""
    out, t = _split_ms(dev, (("call", lambda _: fn()),))
    return out, t["call"]


def _spread(xs) -> dict:
    return {"min": min(xs), "median": statistics.median(xs),
            "max": max(xs), "reps": len(xs)}


def bench_configs(dim: int, width: int, height: int):
    """(bench.py's config: sponza256 with GridConfig(dim, world 150),
    float32 marches; the preset's own config at that dim, bfloat16)."""
    base = preset("sponza256")
    render = dataclasses.replace(base.render, width=width, height=height)
    f32 = dataclasses.replace(base, grid=GridConfig(dim=dim,
                                                    world_size=150.0),
                              render=render)
    bf16 = dataclasses.replace(
        base, grid=dataclasses.replace(base.grid, dim=dim), render=render)
    return f32, bf16


def run(dim: int = 256, width: int = 1920, height: int = 1080,
        subdiv: int = 4, reps: int = 5, device="cuda",
        chunk: int = 65536) -> dict:
    """bench.py's measurements at `dim`^3 and width x height on `device`;
    returns the result dict (see the module docstring)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, cfg_bf16 = bench_configs(dim, width, height)
    scene = atrium()
    camera = CAM.Camera(**CAMERA)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    log(f"device: {kind}")

    t0 = time.perf_counter()
    _, mats, samples = R.prepare_scene(cfg, scene, device=dev)
    log(f"scene prep: {samples.positions.shape[0]} surface samples, "
        f"{time.perf_counter() - t0:.1f}s")

    # --- the dense marches: the voxel build, float32 and bfloat16 -------
    def build_times(c):
        """(the last build's state, each timed build's ms), a warm-up
        first; one state is held at a time."""
        state, _ = _ms(dev, lambda: R.build_voxel_state(c, samples, mats))
        times = []
        for _ in range(reps):
            del state
            state, t = _ms(dev, lambda: R.build_voxel_state(c, samples,
                                                            mats))
            times.append(t)
        return state, times

    voxels, build_ts = build_times(cfg)
    build_ms = statistics.median(build_ts)
    dense_samples = count_dense_samples(cfg)
    sps = dense_samples / (build_ms * 1e-3)
    log(f"voxel build steady ({cfg.grid.compute} march): median "
        f"{build_ms:.1f} ms over {reps} (min {min(build_ts):.1f}, max "
        f"{max(build_ts):.1f}); dense march samples: "
        f"{dense_samples / 1e6:.1f}M -> {sps:.3e} samples/s")
    bf16_ts = build_times(cfg_bf16)[1]
    log(f"voxel build steady, preset sponza256's {cfg_bf16.grid.compute} "
        f"march (not the metric): median {statistics.median(bf16_ts):.1f} "
        f"ms over {reps} (min {min(bf16_ts):.1f}, max {max(bf16_ts):.1f}) "
        f"-> {dense_samples / (statistics.median(bf16_ts) * 1e-3):.3e} "
        f"samples/s")

    # --- the diffuse-field march alone: time, bytes and operations -------
    def march():
        return shading.build_cone_field(cfg, voxels.radiance_mips,
                                        shading.diffuse_schedule(cfg))

    march_ts = [_ms(dev, march)[1] for _ in range(reps)]
    march_ms = statistics.median(march_ts)
    mips = voxels.radiance_mips
    plan = D.march_plan(
        mips, D.direction_basis(cfg.cones.field_basis),
        shading.diffuse_schedule(cfg), cfg.grid.world_size,
        field_dim=shading.field_dim(cfg), max_alpha=cfg.cones.max_alpha,
        occlusion_falloff=cfg.cones.occlusion_falloff,
        compute_dtype=shading.march_compute_dtype(cfg))
    walked = torch.empty(plan.shape + (plan.nb,), dtype=torch.int32,
                         device=dev)
    OD.dense_march(mips, plan, walked)
    march_bytes, march_ops = OD.march_work(mips, plan, walked)
    log(f"dense march (diffuse field): median {march_ms:.1f} ms over "
        f"{reps} (min {min(march_ts):.1f}, max {max(march_ts):.1f}); "
        f"from its shapes {march_bytes / 1e9:.4f} GB and "
        f"{march_ops / 1e9:.3f} G float operations (the steps taken "
        f"before each early-out)")
    if cuda:
        bw = peak_bytes_per_s(kind)
        rate = FP32_OPS_PER_S[kind] / 2
        march_gbps = march_bytes / (march_ms * 1e-3) / 1e9
        march_bound = max(march_bytes / bw, march_ops / rate) * 1e3
        log(f"dense march achieved {march_gbps:.1f} GB/s "
            f"({march_gbps * 1e9 / bw:.4f} of the {bw / 1e9:.0f} GB/s "
            f"peak); bound {march_bound:.4f} ms, {march_bound / march_ms:.4f}"
            f" of it reached; march_mxu_util null: the march gathers and "
            f"lerps, it runs no matmul")

    # --- the frame: the atrium subdivided, on the base samples -----------
    scene_hi = subdivide_scene(scene, subdiv) if subdiv else scene
    ds_hi, _, _ = R.prepare_scene(cfg, scene_hi, samples=samples, device=dev)
    frame_tris = int(ds_hi.v0.shape[0])
    log(f"frame geometry: {frame_tris} triangles (subdiv {subdiv})")
    origins, dirs = CAM.primary_rays(camera, width, height, device=dev)
    cam_pos = torch.as_tensor(camera.position, dtype=torch.float32,
                              device=dev)
    fast = R.use_fast_path(cfg)
    raycast_ms = split = None
    if fast:
        tables = F.build_frame_tables(cfg, voxels, mats)
        hp = -(-height // F.TSY) * F.TSY
        wp = -(-width // 64) * 64          # binned raycast strip granularity
        dpad = F._pad_edge(dirs, hp, wp)
        dflat = F._tile_order(dpad, hp, wp).contiguous()
        origin0 = origins.reshape(-1, 3)[0].contiguous()
        if frame_tris <= RP.MAX_TRIANGLES:
            stages = (
                ("pack", lambda _: RP.pack_tables(
                    ds_hi, origin0, mats.albedo, mats.specular,
                    mats.shininess)),
                ("raycast", lambda t: RP.raycast_gbuf24(dflat, origin0,
                                                        *t)))
        else:
            stages = (
                ("pack", lambda _: BR.pack_rows(
                    ds_hi, origin0, mats.albedo, mats.specular,
                    mats.shininess)),
                ("bin", lambda t: (BR.bin_triangles(
                    ds_hi, origin0, dflat, dpad, t[0])[:2], t[1])),
                # the kernel writes the G-buffer (finish_binned) itself
                ("raycast", lambda t: BR.raycast_binned(
                    dflat, origin0, *t[0], t[1])))
        _split_ms(dev, stages)                                 # warm-up
        splits = [_split_ms(dev, stages)[1] for _ in range(reps)]
        totals = [sum(s.values()) for s in splits]
        raycast_ms = statistics.median(totals)
        split = {k: statistics.median(s[k] for s in splits)
                 for k in splits[0]}
        log(f"raycast share at {frame_tris} tris: median {raycast_ms:.3f} "
            f"ms (min {min(totals):.3f}, max {max(totals):.3f}); stages "
            + json.dumps({k: round(v, 4) for k, v in split.items()}))

        def frame():
            return F.render_frame(cfg, ds_hi, tables, mats, origins, dirs,
                                  cam_pos)
    else:
        def frame():
            return R.render_rays(cfg, ds_hi, voxels, mats, origins, dirs,
                                 cam_pos, chunk_size=chunk)
    t0 = time.perf_counter()
    img = frame()
    if cuda:
        torch.cuda.synchronize(dev)
    log(f"first frame: {time.perf_counter() - t0:.1f}s "
        f"mean={float(img.mean()):.4f} fast_path={fast}")
    frame_ts = [_ms(dev, frame)[1] for _ in range(max(reps, 5))]
    frame_ms = statistics.median(frame_ts)
    log(f"steady frame: median {frame_ms:.3f} ms over {len(frame_ts)} "
        f"(min {min(frame_ts):.3f}, max {max(frame_ts):.3f}; "
        f"{width}x{height}, {1e3 / frame_ms:.2f} fps)")

    timed = {
        "value": sps, "build_ms": build_ms, "build_ms_range":
        _spread(build_ts), "build_ms_bf16": _spread(bf16_ts),
        "march_ms": march_ms, "raycast_ms": raycast_ms,
        "raycast_split_ms": split, "frame_ms_1080p": frame_ms,
        "fps_1080p": 1e3 / frame_ms, "frame_ms": _spread(frame_ts)}
    res = {
        "metric": "cone_samples_per_s_per_chip", "value": None,
        "unit": "samples/s", "vs_baseline": None, "frame_ms_1080p": None,
        "fps_1080p": None, "fast_path": fast, "frame_tris": frame_tris,
        "raycast_ms": None, "march_achieved_gbps": None, "peak_gbps": None,
        "march_mxu_util": None, "build_ms": None, "device": kind,
        "power_limit_w": None, "dense_samples": dense_samples,
        "march_bytes": march_bytes, "march_ops": march_ops,
        "march_bound_ms": None, "march_bound_share": None}
    if cuda:
        sol = bw / BYTES_PER_SAMPLE
        log(f"HBM no-reuse SoL: {sol:.3e} samples/s; fraction: "
            f"{sps / sol:.3f}")
        res.update(timed, vs_baseline=sps / sol,
                   march_achieved_gbps=march_gbps, peak_gbps=bw / 1e9,
                   march_bound_ms=march_bound,
                   march_bound_share=march_bound / march_ms,
                   power_limit_w=power_limit_w(card_line()))
    else:
        # host-clock times of CPU kernels: none of them is a device figure
        res["host_ms"] = timed
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: CUDA is not available (no CPU fallback)",
              file=sys.stderr)
        return 1
    scale = float(os.environ.get("VCT_BENCH_SCALE", "1.0"))
    line = card_line()
    log(f"card: {line}")
    res = run(dim=int(os.environ.get("VCT_BENCH_DIM", "256")),
              width=int(1920 * scale), height=int(1080 * scale),
              subdiv=int(os.environ.get("VCT_BENCH_SUBDIV", "4")),
              reps=int(os.environ.get("VCT_BENCH_REPS", "5")),
              chunk=int(os.environ.get("VCT_BENCH_CHUNK", "65536")))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
