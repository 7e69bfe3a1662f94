#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vct_tpu_torch) once on one GPU and check it.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each reported on its own lines:
  (a) the card (nvidia-smi name and power limit) and the kernel build;
  (c) the main path at full size: preset("sponza256") (256^3 grid, bf16
      dense march, 128^3 x 208-channel fields, 1920x1080) on the Cornell
      box, through prepare_scene -> build_voxel_state ->
      build_frame_tables -> render_camera_pass, with every kernel's launch
      count read around that one run; then build/frame timings, a
      determinism check (two builds, bit-identical radiance), and a small
      32^3 render on the card against the plain PyTorch path on the CPU;
  (b) each kernel against its plain PyTorch version on the card, at the
      shapes the main path gives it, with its time beside the plain one;
  (d) the result: a JSON line of kernels, then {"ok": true, ...} last.
Any failure raises: the script exits non-zero and prints no result line.
It exits non-zero at once when CUDA is unavailable.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
DIM = None              # None: the preset's 256^3 grid
WIDTH, HEIGHT = 1920, 1080
BUILD_REPS, FRAME_REPS, KERNEL_REPS = 3, 5, 10
SEED = 0


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def say(*parts):
    print(*parts, flush=True)


def elapsed_ms(fn, reps: int) -> list:
    """Per-rep device time of fn() in ms, by CUDA events (one warm-up)."""
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def sync():
    torch.cuda.synchronize()


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def slice_config(dim, width, height, compute=None):
    from vct_tpu.config import preset
    cfg = preset("sponza256")
    grid = cfg.grid
    if dim is not None:
        grid = dataclasses.replace(grid, dim=dim)
    if compute is not None:
        grid = dataclasses.replace(grid, compute=compute)
    cones = cfg.cones
    if dim is not None:
        cones = dataclasses.replace(cones, field_dim=min(dim, 128))
    return dataclasses.replace(
        cfg, grid=grid, cones=cones,
        render=dataclasses.replace(cfg.render, width=width, height=height))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from vct_tpu.scene.cornell import cornell_box
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.ops import _build, mip, prepass, raycast, tap
    from vct_tpu_torch.render import fast as F
    from vct_tpu_torch.render import renderer as R

    kernels = {"mip": mip, "raycast": raycast, "prepass": prepass,
               "tap": tap}

    # ---- (a) the card and the build ------------------------------------
    say(card_line())          # nvidia-smi: name, power limit
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    say(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say("  ptxas:", line.strip())

    # ---- (c) the main path, once, with launch counts around it ----------
    dev = torch.device(DEVICE)
    cfg = slice_config(DIM, WIDTH, HEIGHT)
    scene = cornell_box(size=100.0)
    camera = CAM.Camera(position=(3.0, 2.0, 40.0))
    for mod in kernels.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    ds, mats, samples = R.prepare_scene(cfg, scene, device=dev)
    voxels = R.build_voxel_state(cfg, samples, mats)
    tables = F.build_frame_tables(cfg, voxels, mats)
    origins, dirs = CAM.primary_rays(camera, cfg.render.width,
                                     cfg.render.height, device=dev)
    cam = torch.as_tensor(camera.position, dtype=torch.float32, device=dev)
    img = R.render_camera_pass(cfg, ds, voxels, mats, origins, dirs, cam,
                               frame_tables=tables)
    sync()
    first_s = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    say(f"main path: sponza256 on the Cornell box ({ds.v0.shape[0]} "
        f"triangles, {samples.positions.shape[0]} surface samples), grid "
        f"{cfg.grid.dim}^3 {cfg.grid.compute}, fields "
        f"{tuple(voxels.diffuse_field.shape)} x2, "
        f"{cfg.render.width}x{cfg.render.height}; first run {first_s:.2f} s")
    say("launches in the main path:", json.dumps(launches))
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the main path")

    if tuple(img.shape) != (cfg.render.height, cfg.render.width, 3):
        fail(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        fail("image has non-finite values")
    hw = cfg.render.height, cfg.render.width
    hp, wp = -(-hw[0] // F.TSY) * F.TSY, -(-hw[1] // 64) * 64
    d_tiled = F._tile_order(F._pad_edge(dirs, hp, wp), hp, wp).contiguous()
    origin = origins.reshape(-1, 3)[0].contiguous()
    isect, attrs = raycast.pack_tables(ds, origin, mats.albedo,
                                       mats.specular, mats.shininess)
    gbuf = raycast.raycast_gbuf24(d_tiled, origin, isect, attrs)
    hit_frac = float((F._untile(gbuf[:, 19], hp, wp)[:hw[0], :hw[1]]
                      > 0.5).float().mean())
    say(f"image: finite, mean {float(img.mean()):.6f}, hit fraction "
        f"{hit_frac:.6f}")
    if hit_frac < 0.9:
        fail(f"only {hit_frac:.3f} of the pixels hit the box")

    build_ms = elapsed_ms(lambda: R.build_voxel_state(cfg, samples, mats),
                          BUILD_REPS)
    tables_ms = elapsed_ms(lambda: F.build_frame_tables(cfg, voxels, mats),
                           BUILD_REPS)
    frame_ms = elapsed_ms(lambda: F.render_frame(
        cfg, ds, tables, mats, origins, dirs, cam), FRAME_REPS)
    say(f"build_voxel_state ms: median {statistics.median(build_ms):.3f} "
        f"over {build_ms}")
    say(f"build_frame_tables ms: median {statistics.median(tables_ms):.3f} "
        f"over {tables_ms}")
    say(f"render_frame ms ({cfg.render.width}x{cfg.render.height}): median "
        f"{statistics.median(frame_ms):.3f} over {frame_ms}")

    again = R.build_voxel_state(cfg, samples, mats)
    for name in ("radiance_mips", "unlit_mips"):
        if not torch.equal(getattr(again, name)[0], getattr(voxels, name)[0]):
            fail(f"two builds differ in {name}[0] (splat not deterministic)")
    say("determinism: two builds give bit-identical radiance_mips[0] and "
        "unlit_mips[0]")
    del again

    # small input: the card's path against the plain path on the CPU
    small = slice_config(32, 64, 48, compute="float32")
    imgs = []
    for d in (dev, torch.device("cpu")):
        s_ds, s_mats, s_samples = R.prepare_scene(small, scene, device=d)
        s_vox = R.build_voxel_state(small, s_samples, s_mats)
        s_o, s_d = CAM.primary_rays(camera, 64, 48, device=d)
        imgs.append(R.render_camera_pass(
            small, s_ds, s_vox, s_mats, s_o, s_d,
            torch.as_tensor(camera.position, dtype=torch.float32,
                            device=d)).cpu())
    err = (imgs[0] - imgs[1]).abs()
    say(f"small input (32^3, 64x48) card vs CPU plain: mean err "
        f"{float(err.mean()):.3e}, max {float(err.max()):.3e} (bound 1e-3)")
    if float(err.max()) > 1e-3:
        fail("the card's small render disagrees with the CPU plain path")

    # ---- (b) each kernel against its plain version ----------------------
    report = []

    def kernel_row(name, source, replaces, err, tol, ms, plain_ms):
        say(f"kernel {name}: max_abs_err {err:.3e} (tolerance {tol:g}), "
            f"{statistics.median(ms):.4f} ms vs plain "
            f"{statistics.median(plain_ms):.4f} ms")
        if not err <= tol:
            fail(f"kernel {name} disagrees with its plain version")
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[name],
                       "max_abs_err": err, "ms": statistics.median(ms),
                       "plain_ms": statistics.median(plain_ms)})

    rng = np.random.default_rng(SEED)
    d0 = cfg.grid.dim
    grid = torch.as_tensor(rng.random((d0, d0, d0, 4), dtype=np.float32),
                           device=dev)
    err = 0.0
    for mode in ("mean", "max"):
        err = max(err, float((mip.downsample2x_cuda(grid, mode)
                              - mip.downsample2x_plain(grid, mode)).abs().max()))
    kernel_row("mip", "vct_tpu_torch/ops/csrc/mip.cu",
               "vct_tpu/ops/mip_pallas.py:145", err, 1e-6,
               elapsed_ms(lambda: mip.downsample2x_cuda(grid), KERNEL_REPS),
               elapsed_ms(lambda: mip.downsample2x_plain(grid), KERNEL_REPS))
    del grid

    g_plain = raycast.raycast_plain(d_tiled, origin, isect, attrs)
    if not (torch.equal(gbuf[:, 19], g_plain[:, 19])
            and torch.equal(gbuf[:, 17], g_plain[:, 17])):
        fail("raycast hit or material ids differ from the plain version")
    kernel_row("raycast", "vct_tpu_torch/ops/csrc/raycast.cu",
               "vct_tpu/ops/raycast_pallas.py:342",
               float((gbuf - g_plain).abs().max()), 1e-4,
               elapsed_ms(lambda: raycast.raycast_cuda(
                   d_tiled, origin, isect, attrs), KERNEL_REPS),
               elapsed_ms(lambda: raycast.raycast_plain(
                   d_tiled, origin, isect, attrs), 3))
    del g_plain

    pkw = dict(light_dims=tuple(m.shape[0] for m in tables.light_mips),
               field_dims=tuple(m.shape[0] for m in tables.field_mips),
               voxel=cfg.grid.voxel_world_size,
               world_size=cfg.grid.world_size,
               shadow_offset=cfg.shadow.normal_offset)
    scal = prepass.prepass_cuda(gbuf, **pkw)
    kernel_row("prepass", "vct_tpu_torch/ops/csrc/prepass.cu",
               "vct_tpu/ops/prepass_pallas.py:315",
               float((scal - prepass.prepass_plain(gbuf, **pkw)).abs().max()),
               0.0,
               elapsed_ms(lambda: prepass.prepass_cuda(gbuf, **pkw),
                          KERNEL_REPS),
               elapsed_ms(lambda: prepass.prepass_plain(gbuf, **pkw), 3))

    nb = cfg.cones.field_basis
    bumpn = torch.cat([gbuf[:, 3:6], torch.zeros_like(gbuf[:, :1])],
                      dim=1).contiguous()
    tkw = dict(cfield=8 * nb, nb=nb, world_size=cfg.grid.world_size,
               voxel=cfg.grid.voxel_world_size,
               shadow_offset=cfg.shadow.normal_offset,
               power_diffuse=int(cfg.cones.basis_power_diffuse),
               power_specular=int(cfg.cones.basis_power_specular),
               cones_static=F._cones_static(cfg))
    targs = (gbuf, scal, bumpn, cam, tables.light_mips, tables.field_mips)
    t_err = float((tap.tap_cuda(*targs, **tkw)
                   - tap.tap_plain(*targs, **tkw)).abs().max())
    kernel_row("tap", "vct_tpu_torch/ops/csrc/tap.cu",
               "vct_tpu/ops/tap_pallas.py:534", t_err, 1e-4,
               elapsed_ms(lambda: tap.tap_cuda(*targs, **tkw), KERNEL_REPS),
               elapsed_ms(lambda: tap.tap_plain(*targs, **tkw), 3))

    say(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- (d) the result ------------------------------------------------
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
