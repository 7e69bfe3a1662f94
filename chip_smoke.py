#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vct_tpu_torch) once on one GPU and check it.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each reported on its own lines:
  (a) the card (nvidia-smi name and power limit), the kernel build with
      ptxas's registers and spills, and for the tap, raycast, streamed
      raycast, binned raycast, specular march, prepass and material
      kernels the registers, spill and shared bytes and resident warps
      per SM the card reports;
  (c) seven paths at full width, each through prepare_scene ->
      build_voxel_state (-> build_frame_tables on the fast path) ->
      render_camera_pass with every kernel's launch count set to 0 just
      before and read just after, and each naming the kernels it must
      and must not launch; paths 1-4 at 1920x1080, paths 1-3 on
      preset("sponza256") (256^3 grid, bf16 dense march, 128^3 x
      208-channel fields):
        1. the Cornell box (40 triangles, no textures): mip, raycast,
           prepass and tap;
        2. the textured atrium (1,122 triangles, 8 materials, a 256^2
           atlas) from the bench camera: those four plus the material
           half of the prepass, the material fetch and the alpha re-cast
           through the streamed raycast;
        3. bench.py's frame: the atrium subdivided 4 times (287,232
           triangles) on the base atrium's samples, through the binned
           raycast in place of the whole-table one;
        4. preset("sponza256_exact_specular") on the atrium: no specular
           field, a diffuse-only tap (104 channels) and the exact
           per-pixel specular march, once each per frame;
        5. preset("cornell64_full") unchanged (64^3, 256x256, 6 diffuse
           and 1 specular cone a pixel) on the Cornell box from (0, 0,
           140) through the per-cone oracle render_rays: the build
           launches the mip kernel and the frame none; build and frame
           times, the stage split, host syncs, peak memory and the
           profiler's busy share; cornell64 and inverse forward and the
           atrium under cornell64_full, each timed; a 32^3 render on the
           card against the CPU; and the fast path against render_rays
           in field mode (tests/test_fast.py's bounds) and field against
           percone (tests/test_field_mode.py's bounds), at field_dim 64;
        6. inverse rendering (vct_tpu_torch/diff) through prepare_scene
           and make_step_fn, the kernels' autograd routes under grad:
           6a preset("inverse") unchanged (64^3, 128x128) on the Cornell
           box from (0, 0, 140) through render_rays, 8 Adam steps each
           for albedo (from gray 0.4), light (from 0.2) and radiance
           (from zero) at tests/test_inverse.py's learning rates: every
           loss finite and the last below the first; per step the
           forward, backward and Adam ms by CUDA events (the first step
           apart), host syncs, peak memory and the mip forward and
           backward launches; 6b the fast pass at that size with
           tests/test_inverse_fast.py's overrides from (3, 2, 140): the
           radiance gradient against the xla pass's (held to the JAX
           package's own figures at this size,
           scripts/jax_inverse_pairing.py), then 8 steps each of
           radiance and albedo; 6c the exact-
           specular fast pass on the atrium (textures, 4 steps: material,
           specmarch and the alpha re-cast under grad); then each
           backward route (raycast, tap, material, specmarch) against
           autograd of its plain version at the path's shapes, timed, and
           the mip backward kernel against downsample2x_bwd_plain on the
           path's own grids, exact;
        7. the shadow map and the anisotropic mips, counts read after the
           build and after the frame: 7a preset("reference") unchanged
           (128^3, 1280x720, a 4096^2 map, 5x5 PCF with the /9 quirk) on
           the atrium from the bench camera through render_rays (mip 14
           launches in the build, every other kernel 0), its map on the
           card against the CPU's from the same samples (bit for bit),
           the per-sample PCF flips counted, and a 32^3, 64x64, map-256
           render against the CPU's plain run over the pixels whose PCF
           did not flip; 7b preset("aniso128") unchanged (128^3
           anisotropic mips, 512x512) on the Cornell box from (0, 0, 140)
           (mip 7, the unlit chain), its pyramid against the CPU's, the
           dense anisotropic march against cone_march at voxel centers
           at 32^3 (tests/test_aniso.py's bounds); 7c aniso128 with
           field cones through the fast path (raycast, prepass, tap);
           build split, frame ms, host syncs, peak memory and the
           profiler's busy and gather shares of 7a and 7b;
      then per path: timings, a small render on the card against the
      plain PyTorch path on the CPU, and for Cornell a determinism check,
      the whole-table raycast against its plain version (hit, material id
      and t bit for bit) and the prepass's scal8 against its plain
      version; the streamed raycast on three alpha re-cast inputs, at
      287k and on the atrium: (a) the frame's own first pass at the bench
      camera (fast.recast_inputs; no candidate there is masked), (b) the
      stress input, every candidate re-cast (recast_inputs without the
      alpha test), (c) the frame's own first pass at EDGE_CAMERA, which
      sees the banners' masked edge; each against its plain version, its
      kept-row counts against stream_walk_plain's, timed and bounded;
  (b) each kernel against its plain PyTorch version on the card, at the
      shapes the atrium paths give it (the binned raycast at 287,232
      triangles, also against the whole-table kernel; the specular march
      and the diffuse-only tap on path 4's frame), with its time
      beside the plain one, the least time the card could take (bound),
      and, where one PyTorch call computes the same function, that
      call's time (the whole-table and binned raycasts' bounds count the
      tests their per-tile cull leaves, `raycast.tile_cull_plain` and
      `binrast.walk_cull_plain`, beside the bound of every ray against
      every row; the binned kernel's own count of kept rows must equal
      `walk_cull_plain`'s; the prepass and material rows print the sector
      floor beside the bound: the bytes the 32-byte sectors of the
      G-buffer columns they read make them move); the prepass and the
      material fetch also on `prepass.stress_gbuffer`'s tiles (all miss,
      one hit, 64 materials, huge uv, wrap corners), bit for bit; the
      streamed raycast timed from a CUDA graph of its launches, since on
      inputs with few live rays it runs faster than its Python wrapper
      launches, and by CUDA events around launches from Python beside
      (the way every other kernel, and the parent's, is timed);
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
import types

import numpy as np
import torch

DEVICE = "cuda"
WIDTH, HEIGHT = 1920, 1080
BUILD_REPS, FRAME_REPS, KERNEL_REPS, PLAIN_REPS = 3, 5, 10, 3
KERNEL_BATCH = 10        # kernel launches per timing sample
SEED = 0
CORNELL_CAMERA = dict(position=(3.0, 2.0, 40.0))
ATRIUM_CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0)  # bench.py:122
# above the nave: sees the banners' alpha-masked edge, which the bench
# camera does not (tests/test_torch_atrium.py EDGE_CAMERA)
EDGE_CAMERA = dict(position=(48.0, 20.0, 0.0), yaw=180.0, pitch=-10.0)
# the per-cone oracle's camera on the Cornell box (tests/test_renderer.py,
# __graft_entry__._tiny_setup)
ORACLE_CAMERA = dict(position=(0.0, 0.0, 140.0))

# H100 SXM peaks (NVIDIA data sheet) for the bound: HBM bytes/s and dense
# float32 outside the tensor cores.  67e12 counts a fused multiply-add as
# two operations; kernels that round every operation on its own (raycast,
# raycast_stream, binrast, specmarch: the *_rn helpers of csrc/common.cuh)
# issue each as its own instruction, so their operation floor is half
# that rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP32_RN_OPS_PER_S = FP32_OPS_PER_S / 2
# float operations every ray-triangle test does (raycast_common.cuh
# hit_test): 3 dot3s (9 mul + 6 add) and the sign tests (5 mul + 1 add);
# the division and the t, u, v multiplies run only for hits
OPS_PER_HIT_TEST = 21
# float operations of the specular march (csrc/specmarch.cu): per step
# the point (3 mul + 3 add), its texture coordinate (3 x div, mul, add)
# and the composite (2 for the early-out test, 6 color, 3 occlusion, 2
# transmittance); per tap the corner coordinates (mul, sub, floor, sub,
# 1 - f per axis) and 7 lerps of 3 operations for each of 4 channels; per
# mip lerp 1 - w and 4 lerps
OPS_PER_MARCH_STEP = 28
OPS_PER_TAP = 99
OPS_PER_MIP_LERP = 13


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def say(*parts):
    print(*parts, flush=True)


def sync():
    torch.cuda.synchronize()


def elapsed_ms(fn, reps: int, batch: int = 1) -> list:
    """Per-call device time of fn() in ms, by CUDA events (one warm-up):
    `reps` samples, each over `batch` calls back to back.  Kernels are
    timed in batches, so that the host queues launches ahead of the card
    and a sample is the kernel's device time, not its launch overhead."""
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        stop.record()
        sync()
        out.append(start.elapsed_time(stop) / batch)
    return out


def graph_ms(fn, reps: int, batch: int) -> list:
    """Per-call device time of fn() in ms from a CUDA graph of `batch`
    calls, replayed `reps` times between CUDA events (after a warm-up):
    for a kernel faster than its Python wrapper, elapsed_ms times the
    host's launches, and the graph pays them once, at capture."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        sync()
        out.append(start.elapsed_time(stop) / batch)
    del graph
    return out


def host_ms(fn) -> float:
    """Host-clock time of fn() ending in a synchronize, in ms."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def slice_config(dim, width, height, compute=None, name="sponza256"):
    from vct_tpu_torch.config import preset
    cfg = preset(name)
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


def bound(nbytes: float, ops: float, rate: float = FP32_OPS_PER_S):
    """(least ms, what bounds it): bytes over HBM rate or float32 ops over
    `rate`, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def piece_bytes(cols, piece: int) -> int:
    """Bytes of a G-buffer row that reading float32 columns `cols` moves
    when memory moves in `piece`-byte pieces: 32 (the L2 cache's sectors)
    or 64 (what the card's memory moves, by chip_smoke's read probe)."""
    return piece * len({4 * c // piece for c in cols})


def unique_count(keys: torch.Tensor) -> int:
    return int(torch.unique(keys.reshape(-1)).numel())


def corner_keys(uvw: torch.Tensor, lv: torch.Tensor, dims) -> torch.Tensor:
    """Cell ids, levels counted back to back, of the 8 corners that
    grid.trilinear_sample reads for each point at its level."""
    keys, base = [], 0
    for li, dl in enumerate(dims):
        t = uvw[lv == li] * dl - 0.5
        i = torch.floor(t).long()
        i0, i1 = torch.clamp(i, 0, dl - 1), torch.clamp(i + 1, 0, dl - 1)
        for k in range(8):
            ix = [i1[:, a] if k >> (2 - a) & 1 else i0[:, a]
                  for a in range(3)]
            keys.append(base + (ix[0] * dl + ix[1]) * dl + ix[2])
        base += dl ** 3
    return torch.cat(keys)


# ---- path 6: inverse rendering ----------------------------------------
# Adam steps a target in 6a and 6b, and in 6c; tests/test_inverse.py's
# learning rates and the starts the JAX tests use: gray albedo 0.4 (alpha
# 1), light 0.2, a black radiance grid
INVERSE_STEPS = 8
INVERSE_ATRIUM_STEPS = 4
INVERSE_TARGETS = (("albedo", 5e-2), ("light", 1e-1), ("radiance", 1e-2))
FAST_PASS_CAMERA = dict(position=(3.0, 2.0, 140.0))  # test_inverse_fast.py
# tests/test_inverse_fast.py's bounds on the "fast" radiance gradient
# against the "xla" one of the same config and target, measured at 32^3 /
# 64x64.  At preset inverse's 64^3 / 128x128 the JAX package misses them
# itself (scripts/jax_inverse_pairing.py --dim 64 --size 128 on the CPU:
# cosine 0.882797, ratio 0.833776; ROADMAP Queue 3), so at a size listed
# in JAX_FAST_FIGURES the card is held to the JAX package's (cosine,
# ratio) within FAST_MARGIN, and elsewhere to the test's bounds
FAST_COS_MIN, FAST_RATIO = 0.9, (0.85, 1.15)
JAX_FAST_FIGURES = {(64, 128): (0.882797, 0.833776)}   # (dim, width)
FAST_MARGIN = 0.005
BWD_REL = 1e-5            # a backward route against autograd of its plain


def fast_inverse_cfg(base, specular_mode="field"):
    """tests/test_inverse_fast.py's overrides of a preset inverse config:
    field diffuse and specular (or percone) cones, volume shadows, a
    6-direction basis, 2 diffuse cones, field_dim equal to the grid's."""
    return dataclasses.replace(
        base, cones=dataclasses.replace(
            base.cones, diffuse_mode="field", specular_mode=specular_mode,
            field_dim=base.grid.dim, field_basis=6, num_diffuse_cones=2),
        shadow=dataclasses.replace(base.shadow, mode="volume"))


def inverse_path(h, base_cfg, dev):
    """Path 6: preset inverse (base_cfg) as an optimization loop through
    prepare_scene and diff/inverse.make_step_fn, counts set to 0 just
    before each run and read just after.  h carries chip_smoke's helpers
    (say, fail, expect, maxerr, reset_counts, read_counts, elapsed_ms,
    kernel_row, row_launches, sync) and adds the mip backward's row to the
    kernels line, with its launches in 6a."""
    from vct_tpu_torch import stages
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.core import grid as G
    from vct_tpu_torch.diff import inverse as I
    from vct_tpu_torch.core import cones as C
    from vct_tpu_torch.ops import (material, mip, prepass, raycast,
                                   specmarch, tap)
    from vct_tpu_torch.profile_stages import count_syncs
    from vct_tpu_torch.render import fast as F
    from vct_tpu_torch.render import renderer as R
    from vct_tpu_torch.scene import textures as TX
    from vct_tpu_torch.scene.atrium import atrium
    from vct_tpu_torch.scene.cornell import cornell_box

    def leaf(x):
        return x.detach().clone().requires_grad_()

    def setup(run_cfg, scene, camera):
        ds, mats, samples = R.prepare_scene(run_cfg, scene, device=dev)
        origins, dirs = CAM.primary_rays(camera, run_cfg.render.width,
                                         run_cfg.render.height, device=dev)
        with torch.no_grad():
            voxels = R.build_voxel_state(run_cfg, samples, mats)
        return dict(ds=ds, mats=mats, samples=samples, origins=origins,
                    dirs=dirs, cam=G.constant(camera.position, dev),
                    voxels=voxels)

    def args(s, target):
        return (s["samples"], s["mats"], s["origins"], s["dirs"], target)

    def run_steps(run_cfg, s, inv, params, target, nsteps, what, must):
        """nsteps of make_step_fn's step with CUDA events at the step's
        marks; fails unless every loss is finite, the last below the
        first, and every kernel in `must` launched.  Returns the run's
        launches."""
        step, make_opt = I.make_step_fn(inv, run_cfg, s["ds"], s["cam"])
        opt = make_opt(params)
        losses, split = [], []
        h.sync()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        h.reset_counts()
        for _ in range(nsteps):
            events = {}

            def record(name, events=events):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events[name] = ev

            record("start")
            stages.MARK = record
            try:
                params, opt, loss = step(params, opt, *args(s, target))
            finally:
                stages.MARK = None
            losses.append(loss)
            split.append(events)
        h.sync()
        launches = h.read_counts()
        peak = torch.cuda.max_memory_allocated()
        ms = [(e["start"].elapsed_time(e["loss"]),
               e["loss"].elapsed_time(e["backward"]),
               e["backward"].elapsed_time(e["optimizer"])) for e in split]
        syncs = count_syncs(lambda: step(params, opt, *args(s, target)))
        losses = [float(x) for x in losses]
        rest = ms[1:]

        def med(k):
            return statistics.median(m[k] for m in rest)

        per = {k: launches[k] / nsteps for k in ("mip", "mip_bwd")}
        shown = json.dumps([float(f"{x:.6e}") for x in losses])
        h.say(f"{what}: {nsteps} Adam steps, loss {losses[0]:.6e} -> "
              f"{losses[-1]:.6e} ({shown}); "
              f"step ms forward / backward / Adam: first "
              f"{ms[0][0]:.3f} / {ms[0][1]:.3f} / {ms[0][2]:.3f}, median of "
              f"the rest {med(0):.3f} / {med(1):.3f} / {med(2):.3f} (step "
              f"{med(0) + med(1) + med(2):.3f}, backward/forward "
              f"{med(1) / med(0):.2f}); host syncs a step {syncs}; peak "
              f"device memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} "
              f"GiB held before); mip launches a step forward "
              f"{per['mip']:g}, backward {per['mip_bwd']:g}")
        h.say(f"launches in {what}:", json.dumps(launches))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"{what}: the loss does not fall ({losses})")
        h.expect(launches, must, (), what)
        return launches

    def grad_of(run_cfg, s, inv, params, target):
        loss = I.make_loss_fn(inv, run_cfg, s["ds"], s["cam"])(
            params, *args(s, target))
        (g,) = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), g

    def frame_inputs(run_cfg, s):
        """What render_frame gives the raycast, tap, material and specular
        march Functions on this state's frame, rebuilt as _shade makes
        them (for the backward checks below), and the fast pass's largest
        mip input, the fused field grid."""
        v, m, ds = s["voxels"], s["mats"], s["ds"]
        ws, voxel = run_cfg.grid.world_size, run_cfg.grid.voxel_world_size
        nb = run_cfg.cones.field_basis
        spec_field = run_cfg.cones.specular_mode == "field"
        with torch.no_grad():
            t = F.build_frame_tables(run_cfg, v, m)
            fields = [v.diffuse_field]
            if spec_field:
                fields.append(v.specular_field)
            hh, ww = s["dirs"].shape[:2]
            hp, wp = -(-hh // F.TSY) * F.TSY, -(-ww // 64) * 64
            d = F._tile_order(F._pad_edge(s["dirs"], hp, wp), hp,
                              wp).contiguous()
            origin = s["origins"].reshape(-1, 3)[0].contiguous()
            isect, attrs = raycast.pack_tables(ds, origin, m.albedo,
                                               m.specular, m.shininess)
            g = raycast.raycast_gbuf24(d, origin, isect, attrs)
            out = dict(raycast=(d, origin, isect, attrs),
                       fgrid=torch.cat(fields, dim=-1))
            pkw = dict(light_dims=tuple(x.shape[0] for x in t.light_mips),
                       field_dims=tuple(x.shape[0] for x in t.field_mips),
                       voxel=voxel, world_size=ws,
                       shadow_offset=run_cfg.shadow.normal_offset)
            nrm = shade_n = g[:, 3:6]
            if t.atlas_pages is None:
                scal = prepass.prepass_tiles(g, **pkw)
            else:
                g = F.alpha_resolve(run_cfg, ds, m, g, d, origin)
                nrm = shade_n = g[:, 3:6]
                res = material.pages_resolution(t.atlas_pages)
                scal, mscal, mlists, mslots = prepass.prepass_tiles(
                    g, atlas=prepass.AtlasShape(t.atlas_pages.shape[0], res,
                                                res.bit_length()), **pkw)
                out["material"] = (g, mslots, mscal, mlists, t.atlas_pages,
                                   res, tap.TILE)
                mout = material.material_tiles(g, mslots, mscal, mlists,
                                               t.atlas_pages, resolution=res)
                shade_n = TX.bump_normal_from_heights(
                    mout[:, 7], mout[:, 8], mout[:, 9], g[:, 9:12],
                    g[:, 12:15], nrm)
            kw = dict(cfield=4 * nb * (2 if spec_field else 1), nb=nb,
                      world_size=ws, voxel=voxel,
                      shadow_offset=run_cfg.shadow.normal_offset,
                      power_diffuse=int(run_cfg.cones.basis_power_diffuse),
                      power_specular=int(run_cfg.cones.basis_power_specular),
                      cones_static=F._cones_static(run_cfg))
            bumpn = torch.cat([shade_n, torch.zeros_like(shade_n[:, :1])],
                              dim=1)
            out["tap"] = (kw, g, scal, bumpn, s["cam"], t.light_mips,
                          t.field_mips)
            if run_cfg.cones.specular_mode == "percone":
                eye = C.normalize(s["cam"] - g[:, 0:3])
                out["specmarch"] = (
                    dict(world_size=ws, max_alpha=run_cfg.cones.max_alpha),
                    *F.spec_march_inputs(run_cfg, t.spec_mips, g[:, 0:3],
                                         nrm, shade_n, eye,
                                         g[:, 19] > 0.5)[:4],
                    t.spec_mips)
        return out

    cornell = cornell_box(size=100.0)
    nd = ("raycast", "raycast_stream", "binrast", "prepass", "material",
          "tap", "specmarch")

    # 6a: preset inverse unchanged through render_rays
    s = setup(base_cfg, cornell, CAM.Camera(**ORACLE_CAMERA))
    with torch.no_grad():
        target = R.render_rays(base_cfg, s["ds"], s["voxels"], s["mats"],
                               s["origins"], s["dirs"], s["cam"],
                               chunk_size=I.InverseConfig().chunk_size)
    h.say(f"main path 6a: preset inverse on the Cornell box through "
          f"render_rays ({base_cfg.grid.dim}^3 {base_cfg.grid.compute}, "
          f"{base_cfg.render.width}x{base_cfg.render.height}, "
          f"{base_cfg.cones.num_diffuse_cones} diffuse cones and "
          f"{int(base_cfg.cones.trace_specular)} specular cone a pixel, "
          f"shadow mode {base_cfg.shadow.mode}, {base_cfg.light.gi_bounces} "
          f"bounces), target the true scene's render")
    starts = {"albedo": torch.cat([torch.full_like(s["mats"].albedo[:, :3],
                                                   0.4),
                                   s["mats"].albedo[:, 3:]], dim=1),
              "light": torch.full((3,), 0.2, device=dev),
              "radiance": torch.zeros_like(s["voxels"].radiance_mips[0])}
    bwd_6a = 0
    for name, lr in INVERSE_TARGETS:
        inv = I.InverseConfig(optimize=(name,), learning_rate=lr,
                              num_steps=INVERSE_STEPS)
        got = run_steps(base_cfg, s, inv, {name: leaf(starts[name])}, target,
                        INVERSE_STEPS, f"main path 6a ({name})",
                        ("mip", "mip_bwd"))
        h.expect(got, (), nd, f"main path 6a ({name})")
        bwd_6a += got["mip_bwd"]
    unlit6, lit6 = s["voxels"].unlit_mips, s["voxels"].radiance_mips
    del s, target, starts

    # 6b: the fast camera pass at preset inverse's size
    fcfg = fast_inverse_cfg(base_cfg)
    s = setup(fcfg, cornell, CAM.Camera(**FAST_PASS_CAMERA))
    with torch.no_grad():
        target = R.render_rays(fcfg, s["ds"], s["voxels"], s["mats"],
                               s["origins"], s["dirs"], s["cam"],
                               chunk_size=I.InverseConfig().chunk_size)
    t2 = target * 0.7 + 0.05            # test_inverse_fast.py: off the truth
    grads = {}
    for cpass in ("xla", "fast"):
        inv = I.InverseConfig(optimize=("radiance",), camera_pass=cpass)
        params = I.init_params(inv, fcfg, s["mats"], s["voxels"])
        h.reset_counts()
        grads[cpass] = grad_of(fcfg, s, inv, params, t2)
        h.sync()
        counts = h.read_counts()
        if cpass == "fast":
            h.say("launches in one fast-pass loss and gradient:",
                  json.dumps(counts))
            h.expect(counts, ("mip", "mip_bwd", "raycast", "prepass", "tap"),
                     ("binrast", "raycast_stream", "material", "specmarch"),
                     "main path 6b gradient")
    (lx, gx), (lf, gf) = grads["xla"], grads["fast"]
    gx64, gf64 = gx.double().flatten(), gf.double().flatten()
    cos = float(gx64 @ gf64 / (gx64.norm() * gf64.norm()))
    ratio = float(gf64.norm() / gx64.norm())
    met = cos > FAST_COS_MIN and FAST_RATIO[0] < ratio < FAST_RATIO[1]
    jax_ref = JAX_FAST_FIGURES.get((fcfg.grid.dim, fcfg.render.width))
    h.say(f"main path 6b: the fast pass at preset inverse's size "
          f"({fcfg.grid.dim}^3, {fcfg.render.width}x{fcfg.render.height}, "
          f"field diffuse and specular, basis 6, 2 diffuse cones, volume "
          f"shadows), Cornell from {FAST_PASS_CAMERA['position']}: radiance "
          f"gradient fast vs xla cosine {cos:.6f}, norm ratio {ratio:.6f}; "
          f"tests/test_inverse_fast.py's bounds (cosine > {FAST_COS_MIN}, "
          f"ratio in {FAST_RATIO}, set at 32^3/64x64) "
          f"{'met' if met else 'missed'}; the JAX package's own on the "
          f"CPU at this size: "
          f"{'not recorded' if jax_ref is None else jax_ref} (held within "
          f"{FAST_MARGIN} where recorded); losses fast {lf:.6e}, xla "
          f"{lx:.6e}")
    if jax_ref is None and not met:
        fail("the fast pass's radiance gradient misses "
             "tests/test_inverse_fast.py's bounds against the xla pass")
    if jax_ref is not None and not (abs(cos - jax_ref[0]) <= FAST_MARGIN and
                                    abs(ratio - jax_ref[1]) <= FAST_MARGIN):
        fail("the fast pass's radiance gradient against the xla pass is not "
             "the JAX package's at this size")
    del grads, gx, gf, gx64, gf64
    fast_starts = {
        "radiance": torch.zeros_like(s["voxels"].radiance_mips[0]),
        "albedo": torch.cat([torch.full_like(s["mats"].albedo[:, :3], 0.4),
                             s["mats"].albedo[:, 3:]], dim=1)}
    for name, lr in (("radiance", 1e-2), ("albedo", 5e-2)):
        inv = I.InverseConfig(optimize=(name,), learning_rate=lr,
                              camera_pass="fast")
        got = run_steps(fcfg, s, inv, {name: leaf(fast_starts[name])},
                        target, INVERSE_STEPS, f"main path 6b ({name})",
                        ("mip", "mip_bwd", "raycast", "prepass", "tap"))
        h.expect(got, (), ("binrast", "raycast_stream", "material",
                           "specmarch"), f"main path 6b ({name})")
    inputs_b = frame_inputs(fcfg, s)
    del s, target, t2, fast_starts

    # 6c: the exact-specular fast pass on the textured atrium
    xcfg = fast_inverse_cfg(base_cfg, specular_mode="percone")
    s = setup(xcfg, atrium(), CAM.Camera(**ATRIUM_CAMERA))
    atlas = s["mats"].atlas
    with torch.no_grad():
        target = R.render_camera_pass(xcfg, s["ds"], s["voxels"], s["mats"],
                                      s["origins"], s["dirs"], s["cam"])
    tex0 = torch.cat([atlas.albedo[..., :3] * 0.5 + 0.25,
                      atlas.albedo[..., 3:]], dim=-1)
    inv = I.InverseConfig(optimize=("textures",), learning_rate=2e-2,
                          camera_pass="fast")
    run_steps(xcfg, s, inv, {"textures": leaf(tex0)}, target,
              INVERSE_ATRIUM_STEPS,
              f"main path 6c (textures: the atrium, "
              f"{s['ds'].v0.shape[0]} triangles, atlas "
              f"{tuple(atlas.albedo.shape)}, exact specular, "
              f"{xcfg.grid.dim}^3, {xcfg.render.width}x"
              f"{xcfg.render.height}, the bench camera)",
              ("mip", "mip_bwd", "raycast", "prepass", "tap",
               "material", "specmarch", "raycast_stream"))
    inputs_c = frame_inputs(xcfg, s)
    del s, target, tex0

    # each backward route against autograd of its plain version, at the
    # path's shapes, one seeded cotangent
    rng = np.random.default_rng(SEED)

    def cotangent(shape):
        return torch.as_tensor(rng.standard_normal(tuple(shape)).astype(
            np.float32), device=dev)

    def packed(levels):
        flat = torch.cat([m.reshape(-1) for m in levels]).detach() \
            .requires_grad_()
        views, off = [], 0
        for m in levels:
            views.append(flat[off:off + m.numel()].view(m.shape))
            off += m.numel()
        return flat, tuple(views)

    def route(name, make, kernel, plain, out_shape):
        """make() -> (leaves, inputs); kernel(inputs) through the autograd
        Function, plain(inputs) the plain version under autograd."""
        ct = cotangent(out_shape)
        leaves, inp = make()
        out_k = kernel(inp)
        gk = torch.autograd.grad(out_k, leaves, ct, retain_graph=True,
                                 allow_unused=True)
        leaves_p, inp_p = make()
        gp = torch.autograd.grad(plain(inp_p), leaves_p, ct,
                                 allow_unused=True)
        err = 0.0
        for a, b in zip(gk, gp):
            if (a is None) != (b is None):
                fail(f"{name} backward: a gradient is missing")
            if b is not None:
                scale = max(float(b.float().abs().max()), 1e-30)
                err = max(err, h.maxerr(a, b) / scale)
        bwd = h.elapsed_ms(lambda: torch.autograd.grad(
            out_k, leaves, ct, retain_graph=True, allow_unused=True),
            KERNEL_REPS)
        with torch.no_grad():
            fwd = h.elapsed_ms(lambda: kernel(inp), KERNEL_REPS,
                               KERNEL_BATCH)
        h.say(f"backward route {name} at path 6's shapes "
              f"(output {tuple(out_shape)}): max error {err:.3e} of the "
              f"gradient's largest value (bound {BWD_REL:g}); backward ms "
              f"median {statistics.median(bwd):.4f} over {bwd}, kernel "
              f"forward {statistics.median(fwd):.4f} ms")
        if not err <= BWD_REL:
            fail(f"the {name} backward route disagrees with autograd of its "
                 f"plain version")
        return statistics.median(bwd)

    bwd_ms = {}
    d, o, i, a = inputs_b["raycast"]
    bwd_ms["raycast"] = route(
        "raycast", lambda: ([leaf(a)],) * 2,
        lambda inp: raycast.Raycast.apply(d, o, i, inp[0],
                                          raycast.raycast_cuda),
        lambda inp: raycast.raycast_plain(d, o, i, inp[0]),
        (d.shape[0], raycast.NOUT))
    kw, g, sc, b, c, light_lv, field_lv = inputs_b["tap"]
    nl, lv = len(light_lv), (*light_lv, *field_lv)

    def make_tap():
        flat, views = packed(lv)
        leaves = [leaf(g), leaf(b), leaf(c), flat]
        return leaves, leaves[:3] + [views]

    bwd_ms["tap"] = route(
        "tap", make_tap,
        lambda inp: tap.Tap.apply(kw, nl, tap.tap_cuda, inp[0], sc, inp[1],
                                  inp[2], *inp[3]),
        lambda inp: tap.tap_plain(inp[0], sc, inp[1], inp[2], inp[3][:nl],
                                  inp[3][nl:], **kw),
        (g.shape[0], tap.NOUT))
    g, sl, ms_, ml, pg, res, tl = inputs_c["material"]
    bwd_ms["material"] = route(
        "material", lambda: ([leaf(g), leaf(pg)],) * 2,
        lambda inp: material.Material.apply(inp[0], sl, ms_, ml, inp[1], res,
                                            tl, material.material_cuda),
        lambda inp: material.material_plain(inp[0], sl, ms_, ml, inp[1], res,
                                            tl),
        (g.shape[0], material.NOUT))
    skw, s4, r4, slv, swt, pyr = inputs_c["specmarch"]

    def make_spec():
        flat, views = packed(pyr)
        leaves = [leaf(s4), leaf(r4), flat]
        return leaves, leaves[:2] + [views]

    bwd_ms["specmarch"] = route(
        "specmarch", make_spec,
        lambda inp: specmarch.SpecMarch.apply(
            skw, specmarch.spec_march_cuda, inp[0], inp[1], slv, swt,
            *inp[2]),
        lambda inp: specmarch.spec_march_plain(inp[0], inp[1], slv, swt,
                                               inp[2], **skw),
        (s4.shape[0], 4))

    # the mip backward kernel against downsample2x_bwd_plain on the path's
    # own grids: each level of 6a's 64^3 unlit (max) and lit (mean)
    # pyramids and 6b's fused field pyramid's first level (mean), exact
    fgrid = inputs_b["fgrid"]
    err = 0.0
    for mips_, mode in ((unlit6, "max"), (lit6, "mean")):
        for fine, coarse in zip(mips_, mips_[1:]):
            ct = cotangent(coarse.shape)
            alpha = fine[..., -1].contiguous() if mode == "max" else None
            err = max(err, h.maxerr(mip.downsample2x_bwd_cuda(ct, alpha, mode),
                                    mip.downsample2x_bwd_plain(ct, alpha,
                                                               mode)))
    fct = cotangent((fgrid.shape[0] // 2,) * 3 + (fgrid.shape[-1],))
    plain_f = mip.downsample2x_bwd_plain(fct, None, "mean")
    err = max(err, h.maxerr(mip.downsample2x_bwd_cuda(fct, None, "mean"),
                            plain_f))
    cf = fgrid.permute(3, 0, 1, 2)[None]       # channels-first views
    fct_cf = fct.permute(3, 0, 1, 2)[None]

    def library():
        return torch.ops.aten.avg_pool3d_backward(
            fct_cf, cf, [2, 2, 2], [2, 2, 2], [0, 0, 0], False, True, None)

    lib_err = h.maxerr(library()[0].permute(1, 2, 3, 0), plain_f)
    amax = unlit6[0][..., -1].contiguous()
    act = cotangent(unlit6[1].shape)
    max_ms = h.elapsed_ms(lambda: mip.downsample2x_bwd_cuda(act, amax, "max"),
                          KERNEL_REPS, KERNEL_BATCH)
    h.say(f"mip backward kernel at path 6's shapes (6a's {unlit6[0].shape[0]}"
          f"^3 x 4 pyramids to 1^3 in max and mean mode, 6b's field grid "
          f"{tuple(fgrid.shape)} in mean mode): max_abs_err {err:.3e} "
          f"(tolerance 0); avg_pool3d_backward against the plain adjoint "
          f"{lib_err:.3e}; max mode on the unlit level 0 "
          f"{statistics.median(max_ms):.4f} ms")
    if err != 0.0:
        fail("the mip backward kernel differs from downsample2x_bwd_plain")
    h.row_launches["mip_bwd"] = bwd_6a
    h.kernel_row(
        "mip_bwd", "vct_tpu_torch/ops/csrc/mip.cu",
        "vct_tpu/ops/mip_pallas.py:112", err, 0.0,
        h.elapsed_ms(lambda: mip.downsample2x_bwd_cuda(fct, None, "mean"),
                     KERNEL_REPS, KERNEL_BATCH),
        h.elapsed_ms(lambda: mip.downsample2x_bwd_plain(fct, None, "mean"),
                     KERNEL_REPS),
        (fct.numel() + fgrid.numel()) * 4, fgrid.numel(),
        h.elapsed_ms(library, KERNEL_REPS, KERNEL_BATCH))
    h.say("backward routes at path 6's shapes, ms: " + json.dumps(
        {k: round(v, 4) for k, v in bwd_ms.items()}))


# ---- path 7: the shadow map and the anisotropic mips ------------------
FLIP_SHARE = 1e-3         # PCF flips allowed, tests/test_torch_shadowmap.py
CHUNK = 16384             # render_camera_pass's render_rays chunk
SMALL_MAP = 256           # the card-vs-CPU render's map (32^3, 64x64)


def pcf_taps(cfg, value, normalization):
    """PCF values -> lit taps (the reference quirk scales by 0.111)."""
    if normalization == "main" and cfg.shadow.pcf_normalization == "reference":
        return torch.round(value.double() / 0.111)
    return torch.round(value.double() * (2 * cfg.shadow.pcf_radius + 1) ** 2)


def map_aniso_path(h, dev):
    """Path 7: 7a preset("reference") unchanged (the shadow map, 4096^2,
    5x5 PCF with the /9 quirk) on the atrium from the bench camera, 7b
    preset("aniso128") unchanged (the anisotropic pyramid) on the Cornell
    box from (0, 0, 140), both through render_camera_pass, which takes
    render_rays; 7c aniso128 with field diffuse and field specular cones
    through the fast path.  Counts set to 0 just before the build and
    again before the frame, read just after each.  h carries chip_smoke's
    helpers (say, expect, maxerr, reset_counts, read_counts, check_image,
    sync, counters, raycast_equal, small_check)."""
    from vct_tpu_torch.config import preset
    from vct_tpu_torch.core import aniso as A
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.core import dense as D
    from vct_tpu_torch.core import march as M
    from vct_tpu_torch.ops import mip
    from vct_tpu_torch.ops import prepass as PP
    from vct_tpu_torch.ops import raycast as RC
    from vct_tpu_torch.ops import tap as TP
    from vct_tpu_torch.profile_stages import count_syncs, profile, stage_ms
    from vct_tpu_torch.render import fast as F
    from vct_tpu_torch.render import gbuffer as GB
    from vct_tpu_torch.render import renderer as R
    from vct_tpu_torch.render import shadowmap as SM
    from vct_tpu_torch.scene.atrium import atrium
    from vct_tpu_torch.scene.cornell import cornell_box

    cpu = torch.device("cpu")
    only_mip = tuple(k for k in h.counters if k != "mip")
    result = {}

    def drive(cfg, scene, camera, what, fast=False):
        """prepare -> build (counted) -> frame (counted), as a user calls
        them; returns the run's tensors and both launch counts."""
        h.sync()
        t0 = time.perf_counter()
        ds, mats, samples = R.prepare_scene(cfg, scene, device=dev)
        h.reset_counts()
        voxels = R.build_voxel_state(cfg, samples, mats)
        tables = F.build_frame_tables(cfg, voxels, mats) if fast else None
        h.sync()
        build_launches = h.read_counts()
        built = "build and frame tables" if fast else "build"
        origins, dirs = CAM.primary_rays(camera, cfg.render.width,
                                         cfg.render.height, device=dev)
        cam = torch.as_tensor(camera.position, dtype=torch.float32,
                              device=dev)
        h.reset_counts()
        img = R.render_camera_pass(cfg, ds, voxels, mats, origins, dirs, cam,
                                   frame_tables=tables)
        h.sync()
        frame_launches = h.read_counts()
        first_s = time.perf_counter() - t0
        h.say(f"{what}: launches in the {built} {json.dumps(build_launches)}, "
              f"in the frame {json.dumps(frame_launches)}; first run "
              f"{first_s:.2f} s")
        h.check_image(img, what, (cfg.render.width, cfg.render.height))
        if not (0.01 < float(img.mean()) < 1.0 and float(img.min()) >= 0.0):
            fail(f"{what}: image mean {float(img.mean())}, min "
                 f"{float(img.min())}")
        return (dict(ds=ds, mats=mats, samples=samples, voxels=voxels,
                     tables=tables, origins=origins, dirs=dirs, cam=cam,
                     img=img), build_launches, frame_launches)

    def measure(cfg, q, what, chunks=None):
        """Build split, frame split and ms (medians of 3 after a warm-up),
        host syncs and peak memory, and under the profiler the busy share
        and the gather kernels' share of the device time: of 3 frames, or
        with `chunks` of render_rays' first chunks of the frame, the same
        calls on fewer rays (a frame of ~10^5 kernels takes the profiler
        minutes to sum)."""
        def build():
            return R.build_voxel_state(cfg, q["samples"], q["mats"])

        def frame():
            return R.render_camera_pass(cfg, q["ds"], q["voxels"], q["mats"],
                                        q["origins"], q["dirs"], q["cam"])

        def part():
            n = chunks * CHUNK
            return R.render_rays(cfg, q["ds"], q["voxels"], q["mats"],
                                 q["origins"].reshape(-1, 3)[:n],
                                 q["dirs"].reshape(-1, 3)[:n], q["cam"],
                                 chunk_size=CHUNK)

        h.sync()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        split, build_total = stage_ms(build, 3)
        build_peak = torch.cuda.max_memory_allocated()
        h.sync()
        torch.cuda.reset_peak_memory_stats()
        fsplit, frame_ms = stage_ms(frame, 3)
        frame_peak = torch.cuda.max_memory_allocated()
        syncs = (count_syncs(build), count_syncs(frame))
        out = dict(build_ms=statistics.median(build_total),
                   frame_ms=statistics.median(frame_ms), syncs=syncs,
                   build_peak_gib=build_peak / 2**30,
                   frame_peak_gib=frame_peak / 2**30)
        h.say(f"{what} build_voxel_state device ms by stage (medians of 3): "
              + json.dumps({k: round(v, 4) for k, v in split.items()})
              + f", whole build median {out['build_ms']:.3f} over "
              f"{[round(x, 3) for x in build_total]}")
        h.say(f"{what} render_camera_pass (render_rays, chunks of {CHUNK}) ms: "
              f"median {out['frame_ms']:.3f} over "
              f"{[round(x, 3) for x in frame_ms]}; stages "
              + json.dumps({k: round(v, 4) for k, v in fsplit.items()}))
        h.say(f"{what}: host syncs build {syncs[0]}, frame {syncs[1]}; peak "
              f"device memory build {out['build_peak_gib']:.3f} GiB, frame "
              f"{out['frame_peak_gib']:.3f} GiB ({held / 2**30:.3f} GiB held "
              f"before)")
        if chunks is None:
            prof, run = profile(frame, 3), "3 frames, per frame"
        else:
            n_chunks = -(-q["dirs"][..., 0].numel() // CHUNK)
            prof = profile(part, 1)
            run = f"the frame's first {chunks} of {n_chunks} chunks"
        h.say(f"{what} under torch.profiler ({run}): busy share "
              f"{prof['busy_share']:.4f}, device ms "
              f"{prof['device_ms_per_frame']:.3f} of wall ms "
              f"{prof['wall_ms_per_frame']:.3f}, kernels "
              f"{prof['kernels_per_frame']:.0f}; top: " + json.dumps(
                  [(r["name"][:48], round(r["ms_per_frame"], 4))
                   for r in prof["top"][:5]]))
        gather = sum(r["ms_per_frame"] for r in prof["top"]
                     if "gather" in r["name"].lower())
        out["busy"] = prof["busy_share"]
        out["gather_share"] = gather / max(prof["device_ms_per_frame"], 1e-9)
        h.say(f"{what}: gather kernels {gather:.3f} of "
              f"{prof['device_ms_per_frame']:.3f} device ms (share "
              f"{out['gather_share']:.4f})")
        return out

    def mip_check(chains, what):
        """The mip kernel at this path's shapes, as path 5 holds it: each
        level of the path's own pyramids (mips, alpha mode) through the
        kernel and its plain version, and the path's next level against
        the plain one."""
        err, n = 0.0, 0
        for mips, mode in chains:
            for fine, coarse in zip(mips, mips[1:]):
                plain = mip.downsample2x_plain(fine, mode)
                err = max(err, h.maxerr(mip.downsample2x_cuda(fine, mode),
                                        plain), h.maxerr(coarse, plain))
                n += 1
        h.say(f"{what}: mip kernel on the {n} levels of the path's own "
              f"pyramids ({', '.join(f'{m[0].shape[0]}^3 x {m[0].shape[-1]} '
                                     f'{mode}' for m, mode in chains)}) "
              f"against its plain version: max_abs_err {err:.3e} "
              f"(tolerance 1e-6)")
        if not err <= 1e-6:
            fail(f"{what}: kernel mip disagrees with its plain version at "
                 f"this path's shapes")

    def flips(cfg, a, b, normalization, what):
        """Points whose PCF differs between a and b: at most 0.1%, each by
        whole taps (the values are whole taps by construction)."""
        fa, fb = pcf_taps(cfg, a, normalization), pcf_taps(cfg, b,
                                                           normalization)
        flipped = fa != fb
        share = float(flipped.double().mean())
        h.say(f"{what}: {int(flipped.sum())} of {flipped.numel()} points "
              f"flip (share {share:.3e}, bound {FLIP_SHARE:g}), by at most "
              f"{float((fa - fb).abs().max()):g} taps")
        if share > FLIP_SHARE:
            fail(f"{what}: too many PCF flips")
        return flipped

    # ---- 7a: preset reference on the atrium ----------------------------
    t7 = time.perf_counter()
    rcfg = preset("reference")
    bench = CAM.Camera(**ATRIUM_CAMERA)
    qa, build_a, frame_a = drive(rcfg, atrium(), bench, "7a reference")
    levels = rcfg.grid.num_levels - 1
    if build_a["mip"] != 2 * levels or frame_a["mip"] != 0:
        fail(f"7a: mip launches {build_a['mip']} in the build (expected "
             f"{2 * levels}: unlit and lit chains) and {frame_a['mip']} in "
             f"the frame (expected 0)")
    h.expect(build_a, (), only_mip, "7a build")
    h.expect(frame_a, (), only_mip, "7a frame")
    mip_check(((qa["voxels"].unlit_mips, "max"),
               (qa["voxels"].radiance_mips, "mean")), "7a")
    smap = qa["voxels"].shadow_map
    pos = qa["samples"].positions
    smap_cpu = SM.build_shadow_map(rcfg, pos.cpu())
    same = torch.equal(smap.cpu(), smap_cpu)
    err = h.maxerr(smap.cpu(), smap_cpu)
    covered = float((smap < 1.0).float().mean())
    h.say(f"7a shadow map {tuple(smap.shape)} from {pos.shape[0]} surface "
          f"samples: card against the CPU from the same samples bit-equal "
          f"{same}, max error {err:.3e} (tolerance 0); {covered:.4f} of the "
          f"texels covered")
    if not same:
        fail("7a: the card's shadow map differs from the CPU's")
    flips(rcfg, SM.pcf_shadow(rcfg, smap, pos, "voxelize").cpu(),
          SM.pcf_shadow(rcfg, smap_cpu, pos.cpu(), "voxelize"),
          "voxelize", "7a per-sample PCF, card vs CPU")
    result["7a"] = measure(rcfg, qa, "7a reference", chunks=2)
    del qa, smap, smap_cpu, pos

    # a small render on the card against the CPU's plain run, the PCF
    # flips of the main pass counted and left out of the image bound
    small = dataclasses.replace(
        rcfg, grid=dataclasses.replace(rcfg.grid, dim=32),
        shadow=dataclasses.replace(rcfg.shadow, map_size=SMALL_MAP),
        render=dataclasses.replace(rcfg.render, width=64, height=64))
    imgs, pcfs = [], []
    for d in (dev, cpu):
        s_ds, s_mats, s_samples = R.prepare_scene(small, atrium(), device=d)
        s_vox = R.build_voxel_state(small, s_samples, s_mats)
        s_o, s_d = CAM.primary_rays(bench, 64, 64, device=d)
        imgs.append(R.render_camera_pass(
            small, s_ds, s_vox, s_mats, s_o, s_d,
            torch.as_tensor(bench.position, dtype=torch.float32,
                            device=d)).cpu())
        o = s_o.reshape(-1, 3)[0]
        g = GB.raycast_chunk_pinhole(s_ds, GB.pinhole_constants(s_ds, o), o,
                                     s_d.reshape(-1, 3))
        g = R.alpha_mask_recast(small, s_ds, GB.pinhole_constants(s_ds, o),
                                o, s_d.reshape(-1, 3), g, s_mats)
        pcfs.append(SM.pcf_shadow(small, s_vox.shadow_map, g.position,
                                  "main").cpu())
    flipped = flips(small, pcfs[0], pcfs[1], "main",
                    "7a small render (32^3, 64x64, map 256) main-pass PCF, "
                    "card vs CPU").reshape(64, 64)
    err = (imgs[0] - imgs[1]).abs()[~flipped]
    h.say(f"7a small render card vs CPU plain over the unflipped pixels: "
          f"mean err {float(err.mean()):.3e}, max {float(err.max()):.3e} "
          f"(bound 1e-3)")
    if float(err.max()) > 1e-3:
        fail("7a: the card's small render disagrees with the CPU plain path")

    # ---- 7b: preset aniso128 on the Cornell box ------------------------
    acfg = preset("aniso128")
    ocam = CAM.Camera(**ORACLE_CAMERA)
    qb, build_b, frame_b = drive(acfg, cornell_box(size=100.0), ocam,
                                 "7b aniso128")
    levels = acfg.grid.num_levels - 1
    if build_b["mip"] != levels or frame_b["mip"] != 0:
        fail(f"7b: mip launches {build_b['mip']} in the build (expected "
             f"{levels}: the unlit chain) and {frame_b['mip']} in the frame")
    h.expect(build_b, (), only_mip, "7b build")
    h.expect(frame_b, (), only_mip, "7b frame")
    mip_check(((qb["voxels"].unlit_mips, "max"),), "7b")
    rad = qb["voxels"].radiance_mips
    if not A.is_aniso_stack(rad):
        fail("7b: the radiance pyramid is not anisotropic")
    ref = A.build_aniso_mips(rad[0].cpu(), acfg.grid.num_levels)
    err = max(h.maxerr(a.cpu(), b) for a, b in zip(rad, ref))
    h.say(f"7b anisotropic pyramid {[tuple(m.shape) for m in rad[:2]]}... "
          f"({len(rad)} levels) on the card against the CPU's from the same "
          f"level 0: max error {err:.3e} (tolerance 1e-6)")
    if not err <= 1e-6:
        fail("7b: the card's anisotropic pyramid differs from the CPU's")
    del ref
    result["7b"] = measure(acfg, qb, "7b aniso128")
    del qb, rad

    # the dense anisotropic march against the per-point march at voxel
    # centers, 32^3, tests/test_aniso.py TestDenseAniso's bounds
    rng = np.random.default_rng(SEED + 7)
    dim, ws = 32, 150.0
    mips32 = A.build_aniso_mips(torch.as_tensor(
        rng.uniform(0, 0.5, (dim, dim, dim, 4)).astype(np.float32),
        device=dev))
    sched = M.march_schedule(0.577, ws / dim, 75.0)
    dirv = np.array([0.6, -0.64, 0.48])
    dirv /= np.linalg.norm(dirv)
    field = D.directional_march(mips32, dirv, sched, ws)
    idx = np.stack(np.meshgrid(*[np.arange(dim)] * 3, indexing="ij"), -1)
    centers = torch.as_tensor(((idx + 0.5) / dim * ws - ws / 2).astype(
        np.float32), device=dev)
    color, occ, _ = M.cone_march(
        mips32, centers, torch.as_tensor(dirv, dtype=torch.float32,
                                         device=dev).expand(centers.shape),
        sched, ws)
    excess = max(float(((field[..., :3] - color).abs()
                        - (1e-5 + 1e-4 * color.abs())).max()),
                 float(((field[..., 3] - occ).abs()
                        - (1e-5 + 1e-4 * occ.abs())).max()))
    h.say(f"7b dense anisotropic march (32^3, {sched.num_steps} steps) "
          f"against cone_march at the voxel centers on the card: max "
          f"error {h.maxerr(field[..., :3], color):.3e} color, "
          f"{h.maxerr(field[..., 3], occ):.3e} occlusion; largest excess "
          f"over atol 1e-5 + rtol 1e-4: {excess:.3e} (must be <= 0)")
    if excess > 0:
        fail("7b: the dense anisotropic march disagrees with cone_march")
    del mips32, field, centers, color, occ

    # ---- 7c: aniso128 in field mode through the fast path --------------
    fcfg = dataclasses.replace(acfg, cones=dataclasses.replace(
        acfg.cones, diffuse_mode="field", specular_mode="field"))
    if not R.use_fast_path(fcfg):
        fail("7c: the anisotropic field config does not take the fast path")
    qc, build_c, frame_c = drive(fcfg, cornell_box(size=100.0), ocam,
                                 "7c aniso128 field", fast=True)
    h.expect(build_c, ("mip",), (), "7c build")
    h.expect(frame_c, ("raycast", "prepass", "tap"), (), "7c frame")
    # each kernel of 7c at the path's own shapes: the pyramids of the
    # build and of the frame tables, and the frame's G-buffer, prepass and
    # taps on its own tables (paths 1-4's comparisons)
    vc, tc = qc["voxels"], qc["tables"]
    mip_check(((vc.unlit_mips, "max"),
               (F._mips_to(vc.light_volume, TP.BRICK_L), "mean"),
               (F._mips_to(torch.cat([vc.diffuse_field, vc.specular_field],
                                     dim=-1), TP.BRICK_F), "mean")), "7c")
    width, height = fcfg.render.width, fcfg.render.height
    hp, wp = -(-height // F.TSY) * F.TSY, -(-width // 64) * 64
    d_t = F._tile_order(F._pad_edge(qc["dirs"], hp, wp), hp,
                        wp).contiguous()
    origin = qc["origins"].reshape(-1, 3)[0].contiguous()
    mats = qc["mats"]
    rargs = (d_t, origin) + RC.pack_tables(qc["ds"], origin, mats.albedo,
                                           mats.specular, mats.shininess)
    g = RC.raycast_cuda(*rargs)
    h.raycast_equal(g, RC.raycast_plain(*rargs), "7c aniso128 field")
    pkw = dict(light_dims=tuple(m.shape[0] for m in tc.light_mips),
               field_dims=tuple(m.shape[0] for m in tc.field_mips),
               voxel=fcfg.grid.voxel_world_size,
               world_size=fcfg.grid.world_size,
               shadow_offset=fcfg.shadow.normal_offset)
    scal = PP.prepass_cuda(g, **pkw)
    same = torch.equal(scal, PP.prepass_plain(g, **pkw))
    nb = fcfg.cones.field_basis
    tkw = dict(cfield=8 * nb, nb=nb, world_size=fcfg.grid.world_size,
               voxel=fcfg.grid.voxel_world_size,
               shadow_offset=fcfg.shadow.normal_offset,
               power_diffuse=int(fcfg.cones.basis_power_diffuse),
               power_specular=int(fcfg.cones.basis_power_specular),
               cones_static=F._cones_static(fcfg))
    bumpn = torch.cat([g[:, 3:6], torch.zeros_like(g[:, :1])],
                      dim=1).contiguous()
    targs = (g, scal, bumpn, qc["cam"], tc.light_mips, tc.field_mips)
    t_err = h.maxerr(TP.tap_cuda(*targs, **tkw), TP.tap_plain(*targs, **tkw))
    h.say(f"7c prepass on the frame ({g.shape[0] // TP.TILE} tiles): scal8 "
          f"bit-equal to the plain version {same}; tap ({8 * nb} channels, "
          f"anisotropic fields) max_abs_err {t_err:.3e} (tolerance 1e-4)")
    if not same:
        fail("7c: the prepass kernel differs from its plain version")
    if not t_err <= 1e-4:
        fail("7c: the tap kernel disagrees with its plain version")
    del qc, vc, tc, g, scal, targs, rargs
    small = slice_config(32, 64, 64, compute="float32", name="aniso128")
    h.small_check(cornell_box(size=100.0), ocam, 64, 64, "7c aniso128 field",
                  small=dataclasses.replace(small, cones=dataclasses.replace(
                      small.cones, diffuse_mode="field",
                      specular_mode="field")))
    seconds = time.perf_counter() - t7
    h.say(f"path 7 took {seconds:.1f} s")
    h.say("path 7 summary: " + json.dumps(
        {k: {m: (round(v, 4) if isinstance(v, float) else v)
             for m, v in r.items()} for k, r in result.items()}))
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from vct_tpu_torch.config import preset
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.core import cones as C
    from vct_tpu_torch.core import grid as G
    from vct_tpu_torch.ops import (_build, binrast, material, mip, prepass,
                                   raycast, specmarch, tap)
    from vct_tpu_torch.profile_stages import count_syncs, profile, stage_ms
    from vct_tpu_torch.render import fast as F
    from vct_tpu_torch.render import gbuffer as GB
    from vct_tpu_torch.render import renderer as R
    from vct_tpu_torch.render import shading
    from vct_tpu_torch.scene import textures as TX
    from vct_tpu_torch.scene.atrium import atrium
    from vct_tpu_torch.scene.cornell import cornell_box
    from vct_tpu_torch.scene.mesh import subdivide_scene

    counters = {"mip": (mip, "LAUNCHES"), "raycast": (raycast, "LAUNCHES"),
                "prepass": (prepass, "LAUNCHES"), "tap": (tap, "LAUNCHES"),
                "material": (material, "LAUNCHES"),
                "raycast_stream": (raycast, "STREAM_LAUNCHES"),
                "binrast": (binrast, "LAUNCHES"),
                "specmarch": (specmarch, "LAUNCHES"),
                "mip_bwd": (mip, "BWD_LAUNCHES")}

    def reset_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    # ---- (a) the card and the build ------------------------------------
    card = card_line()
    say(card)                 # nvidia-smi: name, power limit
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    say(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if line.startswith("==") or "registers" in line or "spill" in line:
                say("  ptxas:", line.strip())

    dev = torch.device(DEVICE)
    cfg = slice_config(None, WIDTH, HEIGHT)
    nb = cfg.cones.field_basis
    for what, reporter, args in (
            (f"tap, {8 * nb} channels", "vct_tap_occupancy", (nb, 8 * nb)),
            (f"tap, {4 * nb} channels", "vct_tap_occupancy", (nb, 4 * nb)),
            ("raycast", "vct_raycast_occupancy", ()),
            ("raycast_stream", "vct_raycast_stream_occupancy", ()),
            ("binrast", "vct_binrast_occupancy", ()),
            ("specmarch", "vct_specmarch_occupancy", ()),
            ("prepass", "vct_prepass_occupancy", ()),
            ("material", "vct_material_occupancy", ())):
        occ = _build.occupancy(reporter, *args)
        say(f"kernel {what}: {occ['registers']} registers, "
            f"{occ['spill_bytes']} spill bytes a thread, "
            f"{occ['shared_bytes']} shared bytes a block, "
            f"{occ['warps_per_sm']} resident warps per SM")
    hp, wp = -(-HEIGHT // F.TSY) * F.TSY, -(-WIDTH // 64) * 64

    def prepass_kw(tables, atlas=None):
        """The prepass's arguments for a frame of these tables."""
        return dict(light_dims=tuple(m.shape[0] for m in tables.light_mips),
                    field_dims=tuple(m.shape[0] for m in tables.field_mips),
                    voxel=cfg.grid.voxel_world_size,
                    world_size=cfg.grid.world_size,
                    shadow_offset=cfg.shadow.normal_offset, atlas=atlas)

    def run_path(scene, camera, samples=None, run_cfg=cfg, fast=True):
        """The main path once, counts set to 0 just before, read after.
        fast=False: the per-cone oracle's path, which builds no frame
        tables (render_camera_pass takes render_rays)."""
        reset_counts()
        t0 = time.perf_counter()
        ds, mats, samples = R.prepare_scene(run_cfg, scene, samples=samples,
                                            device=dev)
        voxels = R.build_voxel_state(run_cfg, samples, mats)
        tables = F.build_frame_tables(run_cfg, voxels, mats) if fast else None
        origins, dirs = CAM.primary_rays(camera, run_cfg.render.width,
                                         run_cfg.render.height, device=dev)
        cam = torch.as_tensor(camera.position, dtype=torch.float32,
                              device=dev)
        img = R.render_camera_pass(run_cfg, ds, voxels, mats, origins, dirs,
                                   cam, frame_tables=tables)
        sync()
        first_s = time.perf_counter() - t0
        return (read_counts(), first_s,
                dict(ds=ds, mats=mats, samples=samples, voxels=voxels,
                     tables=tables, origins=origins, dirs=dirs, cam=cam,
                     img=img))

    def expect(launches, must, must_not, what):
        for name in must:
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched by the {what} path")
        for name in must_not:
            if launches[name] != 0:
                fail(f"kernel {name} was launched by the {what} path")

    def maxerr(a, b):
        return float((a.float() - b.float()).abs().max())

    def raycast_equal(gk, gp, what):
        """The whole-table kernel's G-buffer against its plain version's:
        hit, material id and t bit for bit, every column within 1e-4."""
        same = [torch.equal(gk[:, c], gp[:, c]) for c in (19, 17, 18)]
        err = maxerr(gk, gp)
        say(f"raycast on the {what} frame ({gk.shape[0]} rays): hit, "
            f"material id, t bit-equal to the plain version {same}; max "
            f"error {err:.3e} (tolerance 1e-4)")
        if not (all(same) and err <= 1e-4):
            fail(f"the raycast kernel disagrees with its plain version on "
                 f"the {what} frame")
        return err

    def check_image(img, what, size=(WIDTH, HEIGHT)):
        if tuple(img.shape) != (size[1], size[0], 3):
            fail(f"{what}: image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()):
            fail(f"{what}: image has non-finite values")

    def camera_rays(origins, dirs):
        """Tile-ordered rays and their origin, as render_frame makes them."""
        d = F._tile_order(F._pad_edge(dirs, hp, wp), hp, wp).contiguous()
        return d, origins.reshape(-1, 3)[0].contiguous()

    def primary_gbuf(p):
        d, origin = camera_rays(p["origins"], p["dirs"])
        m = p["mats"]
        isect, attrs = raycast.pack_tables(p["ds"], origin, m.albedo,
                                           m.specular, m.shininess)
        return d, origin, isect, attrs

    def edge_gbuf(ds, mats, binned):
        """The G-buffer at EDGE_CAMERA through the whole-table or the binned
        raycast: (G-buffer, tile-ordered rays, origin)."""
        origins, dirs = CAM.primary_rays(CAM.Camera(**EDGE_CAMERA), WIDTH,
                                         HEIGHT, device=dev)
        d, origin = camera_rays(origins, dirs)
        if not binned:
            return raycast.raycast_gbuf24(d, origin, *raycast.pack_tables(
                ds, origin, mats.albedo, mats.specular,
                mats.shininess)), d, origin
        rows, attrs = binrast.pack_rows(ds, origin, mats.albedo,
                                        mats.specular, mats.shininess)
        scal, table, _ = binrast.bin_triangles(
            ds, origin, d, F._pad_edge(dirs, hp, wp), rows)
        return binrast.raycast_binned(d, origin, scal, table, attrs), d, origin

    def n_candidates(g0, mats):
        """The alpha re-cast's candidates: hit pixels of maskable
        materials."""
        return int(F._candidates(g0, F._maskable(
            mats, cfg.render.alpha_threshold)).sum())

    def stream_case(what, g0, d_t, ds, origin, mats, alpha_test=True,
                    plain_chunk=16384):
        """The streamed raycast on the first alpha re-cast pass of this
        G-buffer, as fast.recast_inputs builds it (alpha_test False: every
        candidate re-cast, through its private _recast_inputs).  The kernel against raycast_stream_plain (hit
        and material ids equal, max error <= 1e-4, t bit-equal expected);
        its own kept-row counts against stream_walk_plain's over
        stream_cull_plain's rows, which must be equal; its time and bound.
        The bound counts, per warp part (stream_parts), its live rays
        (stream_live) times its kept rows of the needed chunks: the first
        listed and every later one whose near bound lies below the final
        best t of a live ray of the part; and the bytes of the rays and
        minimum and miss distances in, the G-buffer out, the needed list
        words and the needed chunks' table rows (the winners' attribute
        rows left out).  Beside it the tile bound: every ray against every
        row of the chunks its tile needs by the tile's farthest best t,
        dead rays included, and the whole table read once.  Returns (args,
        max error, kernel ms, bytes, hit tests needed)."""
        _, masked, d_s, tmin = F._recast_inputs(cfg, mats, g0, d_t,
                                                alpha_test=alpha_test)
        s_isect, s_attrs, spheres = raycast.pack_tables_stream(
            ds, origin, mats.albedo, mats.specular, mats.shininess)
        lists, counts = raycast.select_chunks(
            d_s.reshape(-1, raycast.TILE, 3), spheres)
        miss = raycast.miss_distance(d_s, spheres)
        sargs = (d_s, origin, s_isect, s_attrs, lists, counts, tmin, miss)
        n, gsz = d_s.shape[0], raycast.GROUP
        ng = n // gsz
        kept_k = torch.zeros(ng, dtype=torch.int32, device=dev)
        gs_k = raycast.raycast_stream_cuda(*sargs, kept=kept_k)
        gs_p = raycast.raycast_stream_plain(*sargs, chunk=plain_chunk)
        err = maxerr(gs_k, gs_p)
        same = [torch.equal(gs_k[:, c], gs_p[:, c]) for c in (19, 17, 18)]
        if not (same[0] and same[1] and err <= 1e-4):
            fail(f"the streamed raycast disagrees with its plain version on "
                 f"{what}: hit, material, t equal {same}, max error {err:.3e}")
        keep = raycast.stream_cull_plain(d_s, s_isect, lists, counts, tmin,
                                         miss)
        gs_w, kept_p = raycast.stream_walk_plain(*sargs, keep)
        same_kept = torch.equal(kept_k, kept_p)
        if not same_kept:
            fail(f"the streamed kernel's kept rows differ from "
                 f"stream_walk_plain's on {what}: "
                 f"{int((kept_k != kept_p).sum())} groups")
        ms = graph_ms(lambda: raycast.raycast_stream_cuda(*sargs),
                      KERNEL_REPS, KERNEL_BATCH)
        launch_ms = elapsed_ms(lambda: raycast.raycast_stream_cuda(*sargs),
                               KERNEL_REPS, KERNEL_BATCH)

        parts = raycast.stream_parts(d_s, tmin, miss)
        n_split = int(parts[:, 1].any(dim=1).sum())
        live = raycast.stream_live(d_s, tmin, miss).reshape(ng, gsz)
        walks = live[:, None, :] & parts
        best = torch.where(gs_p[:, 19] > 0.5, gs_p[:, 18], miss)
        length = keep.shape[2]
        tile = torch.arange(ng, device=dev) // (raycast.TILE // gsz)
        pos = torch.arange(length, device=dev)[None, :]
        listed = pos < counts[tile][:, None].long()
        near = (lists[tile, :length] >> 16).float()
        top = torch.where(walks, best.reshape(ng, 1, gsz),
                          -raycast.BIG).amax(dim=2)
        needed = (listed[:, None] & walks.any(dim=2)[:, :, None]
                  & ((pos == 0) | (near[:, None] < top[:, :, None])))
        kept_needed = (keep & needed[..., None]).sum(dim=3)
        tests = int((walks.sum(dim=2) * kept_needed.sum(dim=2)).sum())
        chunks = (lists[tile, :length] & 0xFFFF)[needed.any(dim=1)]
        nbytes = (n * (12 + 4 + 4 + raycast.NOUT * 4) + counts.numel() * 4
                  + int(needed.any(dim=1).reshape(-1, raycast.TILE // gsz,
                                                  length)
                        .any(dim=1).sum()) * 4
                  + unique_count(chunks) * raycast.CHUNK * raycast.NISECT * 4)
        # the tile bound
        tmax = best.reshape(-1, raycast.TILE).amax(dim=1)
        tpos = torch.arange(lists.shape[1], device=dev)[None, :]
        old_needed = int(((tpos < counts[:, None]) & (
            (tpos == 0) | ((lists >> 16).float() < tmax[:, None]))).sum())
        old_bytes = (n * (12 + 4 + 4 + 128) + lists.numel() * 4
                     + s_isect.shape[0] * 4 * (16 + 48))
        new_b = bound(nbytes, tests * OPS_PER_HIT_TEST, FP32_RN_OPS_PER_S)
        old_b = bound(old_bytes, old_needed * raycast.CHUNK * raycast.TILE
                      * OPS_PER_HIT_TEST, FP32_RN_OPS_PER_S)
        walking = live.any(dim=1)
        kept_walk = kept_k[walking].float()
        say(f"streamed raycast, {what}: {n_candidates(g0, mats)} candidate "
            f"pixels, {int(masked.sum())} masked and re-cast (alpha test "
            f"{alpha_test}); {n} rays, {int(live.sum())} live in "
            f"{int(walking.sum())} of {ng} warps; lists hold "
            f"{int(counts.sum())} chunks (mean "
            f"{float(counts.float().mean()):.2f} a tile), the warps' parts "
            f"need {int(needed.sum())} (part, chunk) pairs; kept rows a "
            f"walking warp over the chunks it tested: mean "
            f"{float(kept_walk.mean()) if kept_walk.numel() else 0.0:.3f}, "
            f"max {int(kept_k.max())}, {int(kept_k.sum())} in all, equal to "
            f"stream_walk_plain's {same_kept}; hit tests: {tests} needed "
            f"(live rays x kept rows of needed chunks), "
            f"{int(kept_k.sum()) * gsz} made; max error {err:.3e} (tolerance "
            f"1e-4), hit, material, t bit-equal {same}, the walk bit-equal "
            f"to the plain version {torch.equal(gs_w, gs_p)}; "
            f"{n_split} warps split; {statistics.median(ms):.4f} ms (CUDA "
            f"graph of {KERNEL_BATCH} launches, median over {ms}; by events "
            f"around {KERNEL_BATCH} launches from Python "
            f"{statistics.median(launch_ms):.4f}); bound "
            f"{new_b[0]:.4f} ms ({new_b[1]}: {nbytes:.4g} B, "
            f"{tests * OPS_PER_HIT_TEST:.4g} ops at "
            f"{FP32_RN_OPS_PER_S:.4g}/s);"
            f" tile bound {old_b[0]:.4f} ms ({old_b[1]}: {old_needed} "
            f"(tile, chunk) pairs needed, {old_bytes:.4g} B)")
        return sargs, err, ms, nbytes, tests

    def timings(p, what, builds=True, run_cfg=cfg):
        ms = {}
        if builds:
            ms["build_voxel_state"] = elapsed_ms(lambda: R.build_voxel_state(
                run_cfg, p["samples"], p["mats"]), BUILD_REPS)
            ms["build_frame_tables"] = elapsed_ms(
                lambda: F.build_frame_tables(run_cfg, p["voxels"], p["mats"]),
                BUILD_REPS)
        ms["render_frame"] = elapsed_ms(lambda: F.render_frame(
            run_cfg, p["ds"], p["tables"], p["mats"], p["origins"],
            p["dirs"], p["cam"]), FRAME_REPS)
        for k, v in ms.items():
            say(f"{what} {k} ms: median {statistics.median(v):.3f} over {v}")
        return ms

    def small_check(scene, camera, w, h, what, name="sponza256", small=None):
        """A 32^3 render on the card against the CPU's plain run; `small`
        replaces the preset `name` cut to that size."""
        if small is None:
            small = slice_config(32, w, h, compute="float32", name=name)
        imgs = []
        for d in (dev, torch.device("cpu")):
            s_ds, s_mats, s_samples = R.prepare_scene(small, scene, device=d)
            s_vox = R.build_voxel_state(small, s_samples, s_mats)
            s_o, s_d = CAM.primary_rays(camera, w, h, device=d)
            imgs.append(R.render_camera_pass(
                small, s_ds, s_vox, s_mats, s_o, s_d,
                torch.as_tensor(camera.position, dtype=torch.float32,
                                device=d)).cpu())
        err = (imgs[0] - imgs[1]).abs()
        say(f"{what} small input (32^3, {w}x{h}) card vs CPU plain: mean err "
            f"{float(err.mean()):.3e}, max {float(err.max()):.3e} "
            f"(bound 1e-3)")
        if float(err.max()) > 1e-3:
            fail(f"{what}: the card's small render disagrees with the CPU "
                 "plain path")

    def stress_check(pkw):
        """The prepass and material kernels against their plain versions
        on prepass.stress_gbuffer (tiles all miss, with one hit, with all
        64 materials so the slots clamp, uv up to 1e7 so the bases clip,
        |tu| near 2^24, on wrap corners at level 0 and R_l = 4) over the
        pages of 64 random materials at 64^2: the prepass bit for bit, the
        material fetch with max error 0."""
        sres = 64
        satlas = prepass.AtlasShape(prepass.MAX_MATERIALS, sres,
                                    sres.bit_length())
        gs = torch.as_tensor(prepass.stress_gbuffer(
            SEED, world_size=cfg.grid.world_size, resolution=sres),
            device=dev)
        srng = np.random.default_rng(SEED)
        spages = material.atlas_mip_pages(*(torch.as_tensor(srng.random(
            (satlas.num_materials, sres, sres, c), dtype=np.float32),
            device=dev) for c in (4, 3, 1)))
        skw = dict(pkw, atlas=satlas)
        sk = prepass.prepass_cuda(gs, **skw)
        sp = prepass.prepass_plain(gs, **skw)
        same = [torch.equal(a, b) for a, b in zip(sk, sp)]
        mk = material.material_cuda(gs, sk[3], sk[1], sk[2], spages, sres)
        mp = material.material_plain(gs, sp[3], sp[1], sp[2], spages, sres)
        err = maxerr(mk, mp)
        distinct, loads = material.corner_texels(gs, sp[3], sp[1], sp[2],
                                                 sres)
        nt = gs.shape[0] // tap.TILE
        clamped = int((sp[1][:, 0] == prepass.NSLOT).sum())
        clipped = int((sp[2][:, :4 * (prepass.NSLOT - 1)].reshape(nt, -1, 4)
                       [..., 2:].abs() == prepass.BCLIP).any(dim=2)
                      .sum()) + int((sp[1][:, 3:].abs() == prepass.BCLIP)
                                    .any(dim=1).sum())
        say(f"stress G-buffer ({nt} tiles: {' | '.join(prepass.STRESS_KINDS)};"
            f" 64 materials at {sres}^2): prepass scal8, mscal, mlists, "
            f"mslots bit-equal to the plain version {same}; {clamped} tiles "
            f"with their slots clamped, {clipped} entries with a clipped "
            f"base; material max error {err:.3e} (tolerance 1e-5, expected "
            f"0); corners a pixel: up to {int(distinct.max())} distinct "
            f"texels, up to {int(loads.max())} height loads")
        if not all(same):
            fail("the prepass kernel differs from its plain version on the "
                 "stress G-buffer")
        if err != 0.0:
            fail("the material kernel is not bit-equal to its plain version "
                 "on the stress G-buffer")
        if clamped == 0 or clipped == 0 or int(distinct.max()) <= 8:
            fail("the stress G-buffer lacks the tiles it is made for")

    # ---- (c1) the Cornell box ------------------------------------------
    cornell = cornell_box(size=100.0)
    camera = CAM.Camera(**CORNELL_CAMERA)
    launches, first_s, p = run_path(cornell, camera)
    say(f"main path 1: sponza256 on the Cornell box ({p['ds'].v0.shape[0]} "
        f"triangles, {p['samples'].positions.shape[0]} surface samples), "
        f"grid {cfg.grid.dim}^3 {cfg.grid.compute}, fields "
        f"{tuple(p['voxels'].diffuse_field.shape)} x2, {WIDTH}x{HEIGHT}; "
        f"first run {first_s:.2f} s")
    say("launches in main path 1 (Cornell):", json.dumps(launches))
    expect(launches, ("mip", "raycast", "prepass", "tap"),
           ("material", "raycast_stream", "binrast", "specmarch"), "Cornell")
    check_image(p["img"], "Cornell")
    g = raycast.raycast_gbuf24(*primary_gbuf(p))
    raycast_equal(g, raycast.raycast_plain(*primary_gbuf(p)), "Cornell")
    ckw = prepass_kw(p["tables"])
    same = torch.equal(prepass.prepass_cuda(g, **ckw),
                       prepass.prepass_plain(g, **ckw))
    say(f"prepass on the Cornell frame ({g.shape[0] // tap.TILE} tiles, no "
        f"atlas): scal8 bit-equal to the plain version {same}")
    if not same:
        fail("prepass scal8 differs from the plain version on the Cornell "
             "frame")
    hit_frac = float((F._untile(g[:, 19], hp, wp)[:HEIGHT, :WIDTH]
                      > 0.5).float().mean())
    say(f"Cornell image: finite, mean {float(p['img'].mean()):.6f}, hit "
        f"fraction {hit_frac:.6f}")
    if hit_frac < 0.9:
        fail(f"only {hit_frac:.3f} of the pixels hit the box")
    timings(p, "Cornell")
    again = R.build_voxel_state(cfg, p["samples"], p["mats"])
    for name in ("radiance_mips", "unlit_mips"):
        if not torch.equal(getattr(again, name)[0],
                           getattr(p["voxels"], name)[0]):
            fail(f"two builds differ in {name}[0] (splat not deterministic)")
    say("determinism: two builds give bit-identical radiance_mips[0] and "
        "unlit_mips[0]")
    del again, p, g
    small_check(cornell, camera, 64, 48, "Cornell")

    # ---- (c2) the textured atrium: the slice's main path -----------------
    scene = atrium()
    camera = CAM.Camera(**ATRIUM_CAMERA)
    prep_ms = [host_ms(lambda: R.prepare_scene(cfg, scene, device=dev))
               for _ in range(BUILD_REPS)]
    launches, first_s, p = run_path(scene, camera)
    mats = p["mats"]
    say(f"main path 2: sponza256 on the atrium ({p['ds'].v0.shape[0]} "
        f"triangles, {mats.albedo.shape[0]} materials, atlas "
        f"{tuple(mats.atlas.albedo.shape)}, "
        f"{p['samples'].positions.shape[0]} surface samples), "
        f"{WIDTH}x{HEIGHT}; first run {first_s:.2f} s")
    say("launches in main path 2 (atrium):", json.dumps(launches))
    expect(launches, ("mip", "raycast", "prepass", "tap", "material",
                      "raycast_stream"), ("binrast", "specmarch"), "atrium")
    check_image(p["img"], "atrium")
    say(f"atrium image: finite, mean {float(p['img'].mean()):.6f}")
    say(f"atrium prepare_scene ms (host clock): median "
        f"{statistics.median(prep_ms):.3f} over {prep_ms}")
    atrium_ms = timings(p, "atrium")

    # the alpha re-cast's first pass at 1080p, as alpha_resolve sees it
    d_t, origin, isect, attrs = primary_gbuf(p)
    g0 = raycast.raycast_gbuf24(d_t, origin, isect, attrs)
    n_cand = n_candidates(g0, mats)
    say(f"alpha re-cast at {WIDTH}x{HEIGHT}: {n_cand} candidate pixels "
        f"(hit pixels of maskable materials), budget "
        f"{cfg.render.alpha_mask_budget}, streamed-raycast launches "
        f"{launches['raycast_stream']}")
    if n_cand == 0:
        fail("no alpha candidates from the bench camera")

    small_check(scene, camera, 96, 64, "atrium")

    # ---- (b) each kernel against its plain version -----------------------
    report = []
    row_launches = dict(launches)     # path 2's; binrast's from path 3

    def kernel_row(name, source, replaces, err, tol, ms, plain_ms, nbytes,
                   ops, library_ms=None, rate=FP32_OPS_PER_S, floor=None):
        """One kernels-line row.  `floor`, where given, is (G-buffer rows,
        the columns the kernel reads of each, its other bytes): printed
        beside the bound as the sector floor (the 32-byte sectors of those
        columns) and the 64-byte floor (the 64-byte pieces)."""
        bound_ms, bound_by = bound(nbytes, ops, rate)
        floors = ""
        if floor is not None:
            rows, cols, other = floor
            for what, piece in (("sector", 32), ("64-byte", 64)):
                fb = rows * piece_bytes(cols, piece) + other
                floors += (f", {what} floor {bound(fb, ops, rate)[0]:.4f} ms "
                           f"({fb:.4g} B)")
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": row_launches[name],
               "max_abs_err": err, "ms": statistics.median(ms),
               "plain_ms": statistics.median(plain_ms),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": (None if library_ms is None
                              else statistics.median(library_ms))}
        say(f"kernel {name}: max_abs_err {err:.3e} (tolerance {tol:g}), "
            f"{row['ms']:.4f} ms vs plain {row['plain_ms']:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {nbytes:.4g} B, {ops:.4g} ops "
            f"at {rate:.4g}/s)"
            + ("" if library_ms is None
               else f", library {row['library_ms']:.4f} ms")
            + floors)
        if not err <= tol:
            fail(f"kernel {name} disagrees with its plain version")
        report.append(row)

    # mip: the 256^3 x 4 albedo/occupancy grid of the build
    rng = np.random.default_rng(SEED)
    d0 = cfg.grid.dim
    grid = torch.as_tensor(rng.random((d0, d0, d0, 4), dtype=np.float32),
                           device=dev)
    err = max(maxerr(mip.downsample2x_cuda(grid, m),
                     mip.downsample2x_plain(grid, m))
              for m in ("mean", "max"))
    cf = grid.permute(3, 0, 1, 2)[None]         # channels-first view
    lib = torch.nn.functional.avg_pool3d
    err = max(err, maxerr(lib(cf, 2)[0].permute(1, 2, 3, 0),
                          mip.downsample2x_plain(grid, "mean")))
    kernel_row("mip", "vct_tpu_torch/ops/csrc/mip.cu",
               "vct_tpu/ops/mip_pallas.py:145", err, 1e-6,
               elapsed_ms(lambda: mip.downsample2x_cuda(grid), KERNEL_REPS,
                          KERNEL_BATCH),
               elapsed_ms(lambda: mip.downsample2x_plain(grid), KERNEL_REPS),
               grid.numel() * 4 * (1 + 1 / 8), grid.numel() / 8 * 8,
               elapsed_ms(lambda: lib(cf, 2), KERNEL_REPS, KERNEL_BATCH))
    del grid, cf

    # raycast: the atrium's primary rays, whole table; the kernel tests
    # each 256-ray block against the rows its cone keeps (tile_cull_plain
    # predicts them exactly), so the bound counts those tests
    n_rays, n_tris = d_t.shape[0], isect.shape[0]
    r_err = raycast_equal(g0, raycast.raycast_plain(d_t, origin, isect, attrs),
                          "atrium")
    kept = raycast.tile_cull_plain(d_t, isect).sum(dim=1)
    kept_pairs = int(kept.sum())
    r_bytes = n_rays * (12 + 128) + n_tris * 4 * (16 + 48)
    uncut = bound(r_bytes, n_rays * n_tris * OPS_PER_HIT_TEST,
                  FP32_RN_OPS_PER_S)
    say(f"raycast cull on the atrium frame: {kept.shape[0]} blocks keep "
        f"{kept_pairs} (block, row) pairs of {kept.shape[0] * n_tris}, mean "
        f"{float(kept.float().mean()):.3f} and max {int(kept.max())} rows a "
        f"block; bound of every ray against every row {uncut[0]:.4f} ms "
        f"({uncut[1]})")
    kernel_row("raycast", "vct_tpu_torch/ops/csrc/raycast.cu",
               "vct_tpu/ops/raycast_pallas.py:342", r_err, 1e-4,
               elapsed_ms(lambda: raycast.raycast_cuda(d_t, origin, isect,
                                                       attrs), KERNEL_REPS,
                          KERNEL_BATCH),
               elapsed_ms(lambda: raycast.raycast_plain(d_t, origin, isect,
                                                        attrs), PLAIN_REPS),
               r_bytes, kept_pairs * raycast.TILE * OPS_PER_HIT_TEST,
               rate=FP32_RN_OPS_PER_S)

    # the frame's G-buffer after the alpha re-cast, as _shade gets it
    g = F.alpha_resolve(cfg, p["ds"], mats, g0, d_t, origin)
    pages = p["tables"].atlas_pages
    res = material.pages_resolution(pages)
    atlas = prepass.AtlasShape(pages.shape[0], res, res.bit_length())
    tables = p["tables"]
    pkw = prepass_kw(tables, atlas)
    # what reading some columns of every G-buffer row costs the card: a
    # reduction over the columns, which reads each once
    probe = {f"{c0}-{c1 - 1}": statistics.median(elapsed_ms(
        lambda: torch.amax(g[:, c0:c1]), KERNEL_REPS, KERNEL_BATCH))
        for c0, c1 in ((0, raycast.NOUT), (0, 8), (0, 16), (16, 18),
                       (15, 17))}
    say("G-buffer read probe (amax over the columns of every row, ms): "
        + json.dumps({k: round(v, 4) for k, v in probe.items()}) + "; "
        "columns 15-16 lie in two 32-byte sectors that straddle the row's "
        "64-byte halves")
    outs = prepass.prepass_cuda(g, **pkw)
    plains = prepass.prepass_plain(g, **pkw)
    for a, b, what in zip(outs, plains, ("scal8", "mscal", "mlists",
                                         "mslots")):
        if not torch.equal(a, b):
            fail(f"prepass {what} differs from the plain version")
    ntiles = g.shape[0] // tap.TILE
    # the prepass reads 13 float32 columns of the G-buffer's 32 (0-8, 15-17,
    # 19) and writes a slot a pixel and scal8, mscal and mlists a tile; the
    # sector floor counts the 32-byte sectors those columns lie in
    p_cols = (*range(9), 15, 16, 17, 19)
    p_tile_bytes = ntiles * 4 * (8 + prepass.NSCAL + prepass.NWORDS)
    kernel_row("prepass", "vct_tpu_torch/ops/csrc/prepass.cu",
               "vct_tpu/ops/prepass_pallas.py:315",
               max(maxerr(a, b) for a, b in zip(outs, plains)), 0.0,
               elapsed_ms(lambda: prepass.prepass_cuda(g, **pkw),
                          KERNEL_REPS, KERNEL_BATCH),
               elapsed_ms(lambda: prepass.prepass_plain(g, **pkw),
                          PLAIN_REPS),
               g.shape[0] * (len(p_cols) * 4 + 4) + p_tile_bytes, 0.0,
               floor=(g.shape[0], p_cols, g.shape[0] * 4 + p_tile_bytes))
    scal, mscal, mlists, mslots = outs

    # material: the frame's pixels, entries and atlas pages
    m_k = material.material_cuda(g, mslots, mscal, mlists, pages, res)
    m_p = material.material_plain(g, mslots, mscal, mlists, pages, res)
    # texels this frame's fetches touch: 4 corners of 3 taps per pixel
    mt, lvl, cnt = material._entries(mscal, mlists, mslots, tap.TILE)
    lvl = lvl.long()
    rl = torch.clamp_min(torch.full_like(lvl, res) >> lvl, 1)
    v0 = pages.shape[2] // material.C8
    texels = []
    for du, dv in ((0, 0), (1, 0), (0, -1)):     # main, +u, -v (in texels)
        tu = g[:, 15] * rl + du * rl / res - 0.5
        tv = (1.0 - g[:, 16]) * rl + dv * rl / res - 0.5
        i0 = torch.remainder(torch.floor(tu).long(), rl)
        j0 = torch.remainder(torch.floor(tv).long(), rl)
        for a in (0, 1):
            for b in (0, 1):
                texels.append(((mt * pages.shape[1] + lvl * v0 + j0 + a) * v0
                               + i0 + b)[cnt > 0])
    n_texels = unique_count(torch.cat(texels))
    del texels
    distinct, loads = material.corner_texels(g, mslots, mscal, mlists, res)
    fetch = distinct > 0
    say(f"material fetch on the atrium frame: {int(fetch.sum())} pixels "
        f"fetch, their three taps read {float(distinct[fetch].float().mean()):.4f}"
        f" distinct texels a pixel (max {int(distinct.max())}); the kernel "
        f"loads 4 texels and {float(loads[fetch].float().mean()):.4f} "
        f"heights a pixel (max {int(loads.max())}) of the 12 corners; "
        f"{n_texels} distinct texels in all")
    m_err = maxerr(m_k, m_p)
    if m_err != 0.0:
        fail(f"the material kernel is not bit-equal to its plain version on "
             f"the atrium frame: max error {m_err:.3e}")
    # the kernel reads columns 15-16 of the G-buffer, which lie in two
    # sectors
    m_cols = (15, 16)
    m_fixed = (g.shape[0] * (4 + material.NOUT * 4)
               + ntiles * 4 * (prepass.NSCAL + prepass.NWORDS)
               + n_texels * 16)
    kernel_row("material", "vct_tpu_torch/ops/csrc/material.cu",
               "vct_tpu/ops/material_pallas.py:400", m_err, 1e-5,
               elapsed_ms(lambda: material.material_cuda(
                   g, mslots, mscal, mlists, pages, res), KERNEL_REPS,
                          KERNEL_BATCH),
               elapsed_ms(lambda: material.material_plain(
                   g, mslots, mscal, mlists, pages, res), PLAIN_REPS),
               g.shape[0] * len(m_cols) * 4 + m_fixed,
               g.shape[0] * 3 * (4 * 8 * 3 + 8),
               floor=(g.shape[0], m_cols, m_fixed))
    stress_check(pkw)

    # streamed raycast on the atrium: (a) the frame's own first re-cast
    # pass, (b) every candidate re-cast (the kernels line's row), (c) the
    # frame's own pass at EDGE_CAMERA
    stream_case("atrium (a) the frame's own input, bench camera", g0, d_t,
                p["ds"], origin, mats)
    sargs, s_err, s_ms, s_bytes, s_tests = stream_case(
        "atrium (b) stress: every candidate re-cast, bench camera", g0, d_t,
        p["ds"], origin, mats, alpha_test=False)
    g_e, d_e, origin_e = edge_gbuf(p["ds"], mats, binned=False)
    stream_case("atrium (c) the frame's own input, edge camera", g_e, d_e,
                p["ds"], origin_e, mats)
    del g_e, d_e
    kernel_row("raycast_stream", "vct_tpu_torch/ops/csrc/raycast_stream.cu",
               "vct_tpu/ops/raycast_pallas.py:769", s_err, 1e-4, s_ms,
               elapsed_ms(lambda: raycast.raycast_stream_plain(*sargs),
                          PLAIN_REPS),
               s_bytes, s_tests * OPS_PER_HIT_TEST, rate=FP32_RN_OPS_PER_S)

    # tap: the frame's pixels at their prepass levels
    voxel = cfg.grid.voxel_world_size
    bumpn = torch.cat([g[:, 3:6], torch.zeros_like(g[:, :1])],
                      dim=1).contiguous()
    cfield = 8 * nb
    tkw = dict(cfield=cfield, nb=nb, world_size=cfg.grid.world_size,
               voxel=voxel, shadow_offset=cfg.shadow.normal_offset,
               power_diffuse=int(cfg.cones.basis_power_diffuse),
               power_specular=int(cfg.cones.basis_power_specular),
               cones_static=F._cones_static(cfg))
    targs = (g, scal, bumpn, p["cam"], tables.light_mips, tables.field_mips)
    t_err = maxerr(tap.tap_cuda(*targs, **tkw), tap.tap_plain(*targs, **tkw))
    # table cells this frame's taps touch: 8 trilinear corners per pixel at
    # its tile's level, light (1 bf16) and field (cfield bf16)
    hitpx = g[:, 19] > 0.5
    cells = {}
    for which, col, off, mips, lev in (
            ("light", 6, voxel * cfg.shadow.normal_offset, tables.light_mips,
             scal[:, 0]),
            ("field", 3, voxel, tables.field_mips, scal[:, 4])):
        uvw = (g[:, 0:3] + g[:, col:col + 3] * off) / (
            cfg.grid.world_size * 0.5) * 0.5 + 0.5
        lv = lev.long().repeat_interleave(tap.TILE)
        cells[which] = unique_count(corner_keys(
            uvw[hitpx], lv[hitpx], [m.shape[0] for m in mips]))
    n_px = g.shape[0]
    ncones = len(tkw["cones_static"][1])
    kernel_row("tap", "vct_tpu_torch/ops/csrc/tap.cu",
               "vct_tpu/ops/tap_pallas.py:534", t_err, 1e-4,
               elapsed_ms(lambda: tap.tap_cuda(*targs, **tkw), KERNEL_REPS,
                          KERNEL_BATCH),
               elapsed_ms(lambda: tap.tap_plain(*targs, **tkw), PLAIN_REPS),
               n_px * (16 * 4 + 16 + tap.NOUT * 4) + ntiles * 32
               + cells["light"] * 2 + cells["field"] * cfield * 2,
               n_px * (16 * (cfield + 1) + 10 * nb * (ncones + 1)
                       + 2 * cfield))
    say(f"tap table cells touched: light {cells['light']}, field "
        f"{cells['field']}")
    say(f"peak device memory (paths 1-2 and their kernels): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del g, g0, outs, plains, m_k, m_p, targs, sargs

    # ---- (c3) bench.py's frame: the atrium subdivided 4 times -----------
    # the same surfaces in 287,232 triangles, on the base atrium's samples
    # (bench.py:182-184): the voxel state must come out bit-identical
    scene_hi = subdivide_scene(scene, 4)
    launches3, first_s, p3 = run_path(scene_hi, camera,
                                      samples=p["samples"])
    ds_hi = p3["ds"]
    say(f"main path 3: sponza256 on the atrium subdivided 4 times "
        f"({ds_hi.v0.shape[0]} triangles) on the base atrium's "
        f"{p['samples'].positions.shape[0]} samples, {WIDTH}x{HEIGHT}; "
        f"first run {first_s:.2f} s")
    say("launches in main path 3 (atrium x4):", json.dumps(launches3))
    check_image(p3["img"], "atrium x4")
    for name in ("radiance_mips", "unlit_mips"):
        if not torch.equal(getattr(p3["voxels"], name)[0],
                           getattr(p["voxels"], name)[0]):
            fail(f"the subdivided atrium's {name}[0] differs from the "
                 "atrium's on the same samples")
    if not (torch.equal(p3["mats"].albedo, mats.albedo)
            and torch.equal(p3["mats"].atlas.albedo, mats.atlas.albedo)):
        fail("the subdivided atrium's material table differs")
    img_err = float((p3["img"] - p["img"]).abs().mean())
    say(f"atrium x4 image: finite, mean {float(p3['img'].mean()):.6f}; "
        f"voxel state and material table equal path 2's; mean abs "
        f"difference from the 1,122-triangle image {img_err:.3e}")
    del p3["voxels"]       # the build is path 2's: time the frame only
    atrium4_ms = timings(p3, "atrium x4", builds=False)

    d3, origin3, _, _ = primary_gbuf(p3)
    dimg3 = F._pad_edge(p3["dirs"], hp, wp)
    m3 = p3["mats"]
    isect3, attrs3 = binrast.pack_rows(ds_hi, origin3, m3.albedo,
                                       m3.specular, m3.shininess)
    scal3, table3, n_col = binrast.bin_triangles(ds_hi, origin3, d3, dimg3,
                                                 isect3)
    nb_col = binrast._budgets(ds_hi.v0.shape[0])[1]
    gangs = scal3[1] + scal3[3]
    say(f"binning at {ds_hi.v0.shape[0]} triangles: {scal3.shape[1]} "
        f"strips, table {table3.shape[0]} rows, gangs per strip mean "
        f"{float(gangs.float().mean()):.3f} max {int(gangs.max())} (strip "
        f"{int(scal3[1].sum())}, column {int(scal3[3].sum())}); column "
        f"tier {int(n_col)} of its budget {nb_col}")
    if int(n_col) > nb_col:
        fail("the column tier overflowed its budget: geometry was dropped")
    for name, fn in (
            ("pack_rows", lambda: binrast.pack_rows(
                ds_hi, origin3, m3.albedo, m3.specular, m3.shininess)),
            ("bin", lambda: binrast.bin_triangles(ds_hi, origin3, d3, dimg3,
                                                  isect3))):
        ms = elapsed_ms(fn, KERNEL_REPS)
        say(f"atrium x4 {name} ms: median {statistics.median(ms):.3f} "
            f"over {ms}")
    torch.cuda.reset_peak_memory_stats()
    st, st_total = stage_ms(lambda: F.render_frame(
        cfg, ds_hi, p3["tables"], m3, p3["origins"], p3["dirs"], p3["cam"]),
        3)
    say("atrium x4 frame stages, device ms (medians of 3):",
        json.dumps({k: round(v, 4) for k, v in st.items()}),
        f"total {st_total}")
    say(f"peak device memory in the atrium x4 frame: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the binned kernel against its plain version over the whole frame,
    # through the G-buffer: the winner's attribute row (picked by its
    # triangle id) and material exact with the hit, t and the interpolated
    # u, v within 1e-6; the kernel also counts the walk rows each tile's
    # cull keeps
    ntile3 = d3.shape[0] // raycast.TILE
    kept3 = torch.zeros(ntile3, dtype=torch.int32, device=dev)
    gb_k = binrast.raycast_binned_cuda(d3, origin3, scal3, table3, attrs3,
                                       kept=kept3)
    o8_p = binrast.raycast_binned_plain(d3, scal3, table3)
    gb_p = binrast.finish_binned(d3, origin3, o8_p, attrs3)
    hit3 = o8_p[:, 4] > 0.5
    if not (torch.equal(gb_k[:, 19], gb_p[:, 19])
            and torch.equal(gb_k[:, 17], gb_p[:, 17])
            and torch.equal(gb_k[:, 6:9], gb_p[:, 6:9])
            and torch.equal(gb_k[:, 20:28], gb_p[:, 20:28])):
        fail("binned raycast hits or winners' attribute rows differ from "
             "the plain version")
    t_rel = float(((gb_k[:, 18] - gb_p[:, 18]).abs()
                   / gb_p[:, 18].abs().clamp_min(1.0))[hit3].max())
    uv_err = maxerr(gb_k[:, 15:17], gb_p[:, 15:17])
    if not max(t_rel, uv_err) <= 1e-6:
        fail(f"binned raycast t/u/v differ from the plain version: t "
             f"{t_rel:.3e} (relative), u/v {uv_err:.3e}")
    # against the whole-table kernel on the same 287,232 triangles: the
    # binning drops nothing (hit exact, t within 1e-6)
    t0 = time.perf_counter()
    gb_w = raycast.raycast_cuda(d3, origin3, *raycast.pack_tables(
        ds_hi, origin3, m3.albedo, m3.specular, m3.shininess))
    sync()
    whole_s = time.perf_counter() - t0
    t_w = maxerr(gb_k[:, 18], gb_w[:, 18])
    close = float(torch.isclose(gb_k, gb_w, rtol=1e-4, atol=1e-4).all(1)
                  .float().mean())
    say(f"binned vs plain: G-buffer bitwise {torch.equal(gb_k, gb_p)}, t rel "
        f"{t_rel:.3e}, u/v {uv_err:.3e}; vs the whole-table kernel "
        f"({whole_s:.3f} s): hit equal "
        f"{torch.equal(gb_k[:, 19], gb_w[:, 19])}, t err {t_w:.3e}, rows "
        f"within 1e-4 {close:.6f}; hit fraction "
        f"{float(hit3.float().mean()):.6f}")
    if not (torch.equal(gb_k[:, 19], gb_w[:, 19]) and t_w <= 1e-6
            and close >= 0.99):
        fail("the binned raycast disagrees with the whole-table kernel")
    del gb_w

    # the alpha re-cast at 287k: inputs (a), (b) and (c), as on the atrium
    n_cand3 = n_candidates(gb_k, m3)
    say(f"alpha re-cast at {ds_hi.v0.shape[0]} triangles: {n_cand3} "
        f"candidate pixels, {-(-ds_hi.v0.shape[0] // raycast.CHUNK)} chunks; "
        f"streamed-raycast launches {launches3['raycast_stream']}")
    expect(launches3, ("mip", "prepass", "tap", "material", "binrast")
           + (("raycast_stream",) if n_cand3 else ()),
           ("raycast", "specmarch"), "atrium x4")
    for what, test in (("(a) the frame's own input", True),
                       ("(b) stress: every candidate re-cast", False)):
        stream_case(f"atrium x4 {what}, bench camera", gb_k, d3, ds_hi,
                    origin3, m3, alpha_test=test, plain_chunk=1024)
    g_e, d_e, origin_e = edge_gbuf(ds_hi, m3, binned=True)
    stream_case("atrium x4 (c) the frame's own input, edge camera", g_e, d_e,
                ds_hi, origin_e, m3, plain_chunk=1024)
    del g_e, d_e

    # binrast's row: the hit tests left after each tile's cull of its
    # strip's walk (walk_cull_plain predicts the kept rows exactly, and the
    # kernel's own counts must agree), the rays in, the G-buffer out, the
    # table rows some walk reads (a column's gangs once, however many
    # strips share them; the table's unused tail is never read) and the
    # winners' attribute rows, each read once
    row_launches["binrast"] = launches3["binrast"]
    n3 = d3.shape[0]
    kept_tile = binrast.walk_cull_plain(d3, scal3, table3).sum(dim=1)
    same_kept = torch.equal(kept3, kept_tile.to(torch.int32))
    kept_pairs3 = int(kept_tile.sum())
    walk_pairs = int(gangs.sum()) * binrast.GANGW * (binrast.STRIPE
                                                     // raycast.TILE)
    wrows, wlive = binrast._walk(
        scal3, torch.arange(scal3.shape[1], device=dev),
        int(gangs.max()) * binrast.GANGW)
    read_rows = unique_count(wrows[wlive & (wrows < table3.shape[0])])
    del wrows, wlive
    winners = unique_count(o8_p[hit3, 1])
    b_bytes = (n3 * (12 + raycast.NOUT * 4) + read_rows * raycast.NISECT * 4
               + scal3.numel() * 4 + winners * raycast.NATTR * 4)
    culled3 = bound(b_bytes, kept_pairs3 * raycast.TILE * OPS_PER_HIT_TEST,
                    FP32_RN_OPS_PER_S)
    uncut3 = bound(b_bytes, walk_pairs * raycast.TILE * OPS_PER_HIT_TEST,
                   FP32_RN_OPS_PER_S)
    say(f"binned cull at {ds_hi.v0.shape[0]} triangles: {ntile3} tiles "
        f"keep {kept_pairs3} (tile, walk row) pairs of {walk_pairs} "
        f"({100 * kept_pairs3 / max(walk_pairs, 1):.2f}%), a tile mean "
        f"{float(kept_tile.float().mean()):.3f}, median "
        f"{int(kept_tile.median())}, max {int(kept_tile.max())}; the "
        f"kernel's own counts equal walk_cull_plain's on the card: "
        f"{same_kept}; the walks read {read_rows} distinct table rows of "
        f"{table3.shape[0]}; bound culled {culled3[0]:.4f} ms ({culled3[1]}), "
        f"uncut (every ray against its whole walk) {uncut3[0]:.4f} ms "
        f"({uncut3[1]})")
    if not same_kept:
        fail("the binned kernel's kept rows differ from walk_cull_plain's")
    kernel_row("binrast", "vct_tpu_torch/ops/csrc/binrast.cu",
               "vct_tpu/ops/binrast_pallas.py:463", maxerr(gb_k, gb_p), 1e-4,
               elapsed_ms(lambda: binrast.raycast_binned_cuda(
                   d3, origin3, scal3, table3, attrs3), KERNEL_REPS,
                          KERNEL_BATCH),
               elapsed_ms(lambda: binrast.raycast_binned_plain(
                   d3, scal3, table3), PLAIN_REPS),
               b_bytes, kept_pairs3 * raycast.TILE * OPS_PER_HIT_TEST,
               rate=FP32_RN_OPS_PER_S)
    small_check(subdivide_scene(scene, 1), camera, 128, 64, "atrium x1")
    del p3, gb_k, gb_p, o8_p, table3, scal3, isect3, attrs3, d3, dimg3
    del kept3, kept_tile

    # ---- (c4) sponza256_exact_specular on the atrium ---------------------
    # the exact per-pixel specular march (tan 0.07) in place of the
    # specular field: the build makes no specular field, the tap kernel
    # runs diffuse-only, and the march runs once per frame
    xcfg = slice_config(None, WIDTH, HEIGHT, name="sponza256_exact_specular")
    nb = xcfg.cones.field_basis
    launches4, first_s, p4 = run_path(scene, camera, run_cfg=xcfg)
    t4 = p4["tables"]
    dims4 = specmarch.pyramid_dims(t4.spec_mips)
    groups4 = specmarch.plan_groups(shading.specular_schedule(xcfg),
                                    len(dims4))
    plan4 = specmarch.plan_entries(groups4, len(dims4))
    say(f"main path 4: sponza256_exact_specular on the atrium "
        f"({p4['ds'].v0.shape[0]} triangles), {WIDTH}x{HEIGHT}; field "
        f"channels {t4.field_mips[0].shape[-1]}, pyramid {list(dims4)}; "
        f"march plan: {plan4.nsteps} steps in {len(groups4)} groups at "
        f"levels {[l0 for l0, _ in groups4]}, {len(plan4.entries)} "
        f"entries, {plan4.rows} sample rows per pixel; first run "
        f"{first_s:.2f} s")
    say("launches in main path 4 (exact specular):", json.dumps(launches4))
    expect(launches4, ("mip", "raycast", "prepass", "tap", "material",
                       "raycast_stream", "specmarch"), ("binrast",),
           "exact-specular")
    if launches4["specmarch"] != 1 or launches4["tap"] != 1:
        fail("the exact-specular frame must launch specmarch and tap once "
             "each")
    if p4["voxels"].specular_field is not None:
        fail("the exact-specular build made a specular field")
    if t4.field_mips[0].shape[-1] != 4 * nb:
        fail(f"the exact-specular field tables carry "
             f"{t4.field_mips[0].shape[-1]} channels, not {4 * nb}")
    check_image(p4["img"], "exact specular")
    x_ms = timings(p4, "exact specular", run_cfg=xcfg)

    # the frame's own march inputs, as _shade makes them
    d4, origin4, isect4, attrs4 = primary_gbuf(p4)
    g4 = F.alpha_resolve(xcfg, p4["ds"], p4["mats"], raycast.raycast_gbuf24(
        d4, origin4, isect4, attrs4), d4, origin4)
    pages4 = t4.atlas_pages
    res4 = material.pages_resolution(pages4)
    scal4, mscal4, mlists4, mslots4 = prepass.prepass_tiles(
        g4, **dict(pkw, atlas=prepass.AtlasShape(pages4.shape[0], res4,
                                                 res4.bit_length())))
    mout4 = material.material_tiles(g4, mslots4, mscal4, mlists4, pages4,
                                    resolution=res4)
    shade_n = TX.bump_normal_from_heights(mout4[:, 7], mout4[:, 8],
                                          mout4[:, 9], g4[:, 9:12],
                                          g4[:, 12:15], g4[:, 3:6])
    hit4 = g4[:, 19] > 0.5
    eye4 = C.normalize(p4["cam"] - g4[:, 0:3])
    margs = F.spec_march_inputs(xcfg, t4.spec_mips, g4[:, 0:3], g4[:, 3:6],
                                shade_n, eye4, hit4)[:4]
    mkw = dict(world_size=xcfg.grid.world_size,
               max_alpha=xcfg.cones.max_alpha)
    so_k = specmarch.spec_march_cuda(*margs, t4.spec_mips, **mkw)
    so_p = specmarch.spec_march_plain(*margs, t4.spec_mips, **mkw)
    hit_s = margs[0][:, 3] > 0.5
    lit = float((so_k[hit_s, 0:3].amax(dim=1) > 0).float().mean())
    loose = int(((so_k - so_p).abs().amax(dim=1) > 1e-6).sum())
    say(f"specular march on path 4's frame: {int(hit_s.sum())} hit pixels "
        f"of {so_k.shape[0]} in {margs[2].shape[0]} groups, nonzero "
        f"specular on {lit:.6f} of them (mean rgb "
        f"{float(so_k[hit_s, 0:3].mean()):.6f}); {loose} pixels differ from "
        f"the plain version by more than 1e-6")
    if lit == 0.0:
        fail("the exact specular term is zero on every hit pixel")

    # the diffuse-only tap (cfield 104) at this frame's shapes
    bumpn4 = torch.cat([shade_n, torch.zeros_like(shade_n[:, :1])],
                       dim=1).contiguous()
    tkw4 = dict(tkw, cfield=4 * nb)
    targs4 = (g4, scal4, bumpn4, p4["cam"], t4.light_mips, t4.field_mips)
    tap_k = tap.tap_cuda(*targs4, **tkw4)
    tap_err = maxerr(tap_k, tap.tap_plain(*targs4, **tkw4))
    tap_ms = elapsed_ms(lambda: tap.tap_cuda(*targs4, **tkw4), KERNEL_REPS,
                        KERNEL_BATCH)
    say(f"diffuse-only tap (cfield {4 * nb}) on path 4's frame: max_abs_err "
        f"{tap_err:.3e} (tolerance 1e-4), specular columns all zero "
        f"{bool((tap_k[:, 5:9] == 0).all())}, median "
        f"{statistics.median(tap_ms):.4f} ms over {tap_ms}")
    if not (tap_err <= 1e-4 and bool((tap_k[:, 5:9] == 0).all())):
        fail("the diffuse-only tap disagrees with its plain version")

    # what the march needs on these inputs, walked as the plain version
    # walks it: the steps before each pixel's early-out, the second taps
    # (nonzero mip weight) and the distinct pyramid cells all taps read
    touched = torch.zeros(sum(d ** 3 for d in dims4), dtype=torch.bool,
                          device=dev)
    pos_s, trans, refl_s = margs[0][:, 0:3], margs[0][:, 3:4], margs[1][:, :3]
    n_steps = n_second = 0
    for k in range(margs[2].shape[1]):
        lv = margs[2][:, k].long().repeat_interleave(specmarch.TILE)
        lv1 = torch.clamp(lv + 1, max=len(dims4) - 1)
        dist, w, _ = margs[3][:, k].repeat_interleave(
            specmarch.TILE, dim=0).split(1, dim=1)
        active = ((1.0 - trans) < mkw["max_alpha"])[:, 0]
        second = active & (w[:, 0] != 0)
        uvw = G.world_to_uvw(pos_s + dist * refl_s, mkw["world_size"])
        touched[corner_keys(uvw[active], lv[active], dims4)] = True
        touched[corner_keys(uvw[second], lv1[second], dims4)] = True
        n_steps += int(active.sum())
        n_second += int(second.sum())
        smp = (specmarch.sample_levels(t4.spec_mips, lv, uvw) * (1.0 - w)
               + specmarch.sample_levels(t4.spec_mips, lv1, uvw) * w)
        trans = torch.where(active[:, None], trans * (1.0 - smp[:, 3:4]),
                            trans)
    n_cells = int(touched.sum())
    n4 = so_k.shape[0]
    say(f"march work: {n_steps} steps "
        f"({n_steps / max(int(hit_s.sum()), 1):.3f} per hit pixel of "
        f"{margs[2].shape[1]}), {n_steps + n_second} taps, {n_cells} "
        f"distinct pyramid cells of {touched.numel()}")
    # tolerance 1e-5: the kernel rounds every operation alone in the plain
    # version's order, so the two agree bit for bit; a pixel whose
    # transmittance sat within rounding of 1 - max_alpha would flip one
    # step's contribution (the early-out), which this bound catches and
    # the count of pixels above 1e-6 printed above shows
    row_launches["specmarch"] = launches4["specmarch"]
    kernel_row("specmarch", "vct_tpu_torch/ops/csrc/specmarch.cu",
               "vct_tpu/ops/specmarch_pallas.py:644", maxerr(so_k, so_p), 1e-5,
               elapsed_ms(lambda: specmarch.spec_march_cuda(
                   *margs, t4.spec_mips, **mkw), KERNEL_REPS,
                          KERNEL_BATCH),
               elapsed_ms(lambda: specmarch.spec_march_plain(
                   *margs, t4.spec_mips, **mkw), PLAIN_REPS),
               n4 * 16 * 3 + margs[2].numel() * 4 + margs[3].numel() * 4
               + n_cells * 8,
               n_steps * OPS_PER_MARCH_STEP
               + (n_steps + n_second) * OPS_PER_TAP
               + n_second * OPS_PER_MIP_LERP, rate=FP32_RN_OPS_PER_S)
    del touched, so_p, tap_k, targs4, g4, mout4

    def frame4():
        return F.render_frame(xcfg, p4["ds"], t4, p4["mats"], p4["origins"],
                              p4["dirs"], p4["cam"])

    sync()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st4, st4_total = stage_ms(frame4, 3)
    peak4 = torch.cuda.max_memory_allocated()
    say("exact-specular frame stages, device ms (medians of 3):",
        json.dumps({k: round(v, 4) for k, v in st4.items()}),
        f"total {st4_total}")
    say(f"exact-specular frame: host syncs {count_syncs(frame4)}, peak "
        f"device memory {peak4 / 2**30:.2f} GiB ({held / 2**30:.2f} GiB "
        f"held before it)")
    small_check(scene, camera, 96, 64, "exact specular",
                name="sponza256_exact_specular")

    # ---- (c5) the per-cone oracle renderer: preset cornell64_full -------
    # the percone cone modes take render_rays: the build launches the mip
    # kernel and the frame none (its raycast and march are plain PyTorch,
    # as they are XLA in the JAX package: the oracle checks the kernels)
    del p4, t4, margs
    ocfg = preset("cornell64_full")
    osize = (ocfg.render.width, ocfg.render.height)
    ocam = CAM.Camera(**ORACLE_CAMERA)
    not_oracle = ("raycast", "raycast_stream", "binrast", "prepass",
                  "material", "tap", "specmarch")

    def oracle_frame(q, run_cfg):
        return lambda: R.render_camera_pass(
            run_cfg, q["ds"], q["voxels"], q["mats"], q["origins"],
            q["dirs"], q["cam"])

    def oracle_run(scene_, camera_, run_cfg, what):
        launches_, first, q = run_path(scene_, camera_, run_cfg=run_cfg,
                                       fast=False)
        say(f"launches in the {what} oracle run:", json.dumps(launches_))
        if R.use_fast_path(run_cfg):
            fail(f"{what} routes to the fast path")
        expect(launches_, ("mip",), not_oracle, what)
        check_image(q["img"], what, (run_cfg.render.width,
                                     run_cfg.render.height))
        return launches_, first, q

    steps5 = {k: fn(ocfg).num_steps for k, fn in (
        ("diffuse", shading.diffuse_schedule),
        ("specular", shading.specular_schedule),
        ("shadow", shading.shadow_schedule))}
    launches5, first_s, p5 = oracle_run(cornell, ocam, ocfg, "cornell64_full")
    img5 = p5["img"]
    # the mip kernel at this path's shapes, 64^3 x 4 down to 1^3: each
    # level of the path's own pyramids (the unlit one in max-alpha mode,
    # the lit one in mean mode) through the kernel and its plain version,
    # and the path's next level against the plain one
    mip5 = 0.0
    for mips5, mode5 in ((p5["voxels"].unlit_mips, "max"),
                         (p5["voxels"].radiance_mips, "mean")):
        for fine5, coarse5 in zip(mips5, mips5[1:]):
            plain5 = mip.downsample2x_plain(fine5, mode5)
            mip5 = max(mip5, maxerr(mip.downsample2x_cuda(fine5, mode5),
                                    plain5), maxerr(coarse5, plain5))
    say(f"mip kernel at path 5's shapes ({ocfg.grid.dim}^3 x 4 to 1^3, "
        f"max and mean): max_abs_err {mip5:.3e} (tolerance 1e-6) beside the "
        f"path's {launches5['mip']} mip launches")
    if not mip5 <= 1e-6:
        fail("kernel mip disagrees with its plain version at path 5's shapes")
    say(f"main path 5: cornell64_full on the Cornell box through render_rays "
        f"({ocfg.grid.dim}^3, {osize[0]}x{osize[1]}, "
        f"{ocfg.cones.num_diffuse_cones} diffuse cones and 1 specular cone "
        f"a pixel, shadow mode {ocfg.shadow.mode}, {ocfg.light.gi_bounces} "
        f"bounces); march steps a cone {json.dumps(steps5)} (the shadow "
        f"schedule runs in the build's dense light volume); first run "
        f"{first_s:.2f} s")
    # the repo's plausibility check (tests/test_renderer.py): the red wall
    # tints the left of the image, the green wall the right
    row0 = osize[1] // 2 - 16
    left = img5[row0:row0 + 32, 8:32]
    right = img5[row0:row0 + 32, osize[0] - 32:osize[0] - 8]
    say(f"cornell64_full image: finite, mean {float(img5.mean()):.6f}, min "
        f"{float(img5.min()):.6f}; left rgb "
        f"{[round(float(x), 4) for x in left.mean(dim=(0, 1))]}, right "
        f"{[round(float(x), 4) for x in right.mean(dim=(0, 1))]}")
    if not (0.01 < float(img5.mean()) < 1.0 and float(img5.min()) >= 0.0
            and float(left[..., 0].mean()) > float(left[..., 1].mean())
            and float(right[..., 1].mean()) > float(right[..., 0].mean())):
        fail("the cornell64_full image is not the Cornell box")
    frame5 = oracle_frame(p5, ocfg)
    build5 = elapsed_ms(lambda: R.build_voxel_state(ocfg, p5["samples"],
                                                    p5["mats"]), BUILD_REPS)
    frame5_ms = elapsed_ms(frame5, FRAME_REPS)
    sync()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st5, st5_total = stage_ms(frame5, 3)
    peak5 = torch.cuda.max_memory_allocated()
    say(f"cornell64_full build_voxel_state ms: median "
        f"{statistics.median(build5):.3f} over {build5}")
    say(f"cornell64_full render_camera_pass (render_rays, chunks of 16384) "
        f"ms: median {statistics.median(frame5_ms):.3f} over {frame5_ms}")
    say("cornell64_full frame stages, device ms (medians of 3, each summed "
        "over the frame's chunks):",
        json.dumps({k: round(v, 4) for k, v in st5.items()}),
        f"total {st5_total}")
    say(f"cornell64_full frame: host syncs {count_syncs(frame5)}, peak "
        f"device memory {peak5 / 2**30:.3f} GiB ({held / 2**30:.3f} GiB "
        f"held before it)")
    prof5 = profile(frame5, 3)
    say("cornell64_full frame under torch.profiler (3 frames): busy share "
        f"{prof5['busy_share']:.4f}, device ms a frame "
        f"{prof5['device_ms_per_frame']:.3f} of wall ms "
        f"{prof5['wall_ms_per_frame']:.3f}, kernels a frame "
        f"{prof5['kernels_per_frame']:.0f}; top: " + json.dumps(
            [(t["name"][:48], round(t["ms_per_frame"], 4))
             for t in prof5["top"][:5]]))

    # the other presets that only render_rays serves, forward, full size
    other5 = {}
    for name in ("cornell64", "inverse"):
        c5 = preset(name)
        _, _, q5 = oracle_run(cornell, ocam, c5, name)
        other5[name] = elapsed_ms(oracle_frame(q5, c5), FRAME_REPS)
        say(f"{name} ({c5.grid.dim}^3, {c5.render.width}x{c5.render.height},"
            f" {c5.cones.num_diffuse_cones} diffuse cones, specular "
            f"{c5.cones.trace_specular}) render_camera_pass ms through "
            f"render_rays: median {statistics.median(other5[name]):.3f} over "
            f"{other5[name]}")
        del q5

    # the textured atrium at the bench camera: the alpha re-cast and the
    # bump normal through the oracle
    _, _, pa = oracle_run(scene, camera, ocfg, "cornell64_full atrium")
    oa = pa["origins"].reshape(-1, 3)[0]
    ga = GB.raycast_chunk_pinhole(pa["ds"], GB.pinhole_constants(pa["ds"],
                                                                 oa),
                                  oa, pa["dirs"].reshape(-1, 3))
    masked5 = int((ga.hit & (pa["mats"].sample_albedo(ga.material, ga.uv)
                             [:, 3] < ocfg.render.alpha_threshold)).sum())
    atrium5_ms = elapsed_ms(oracle_frame(pa, ocfg), FRAME_REPS)
    say(f"cornell64_full on the atrium ({pa['ds'].v0.shape[0]} triangles, "
        f"atlas {tuple(pa['mats'].atlas.albedo.shape)}), bench camera: "
        f"{int(ga.hit.sum())} hit pixels of {ga.hit.numel()}, {masked5} "
        f"masked in the first pass; image mean "
        f"{float(pa['img'].mean()):.6f}; render_camera_pass ms: median "
        f"{statistics.median(atrium5_ms):.3f} over {atrium5_ms}")
    del pa, ga
    small_check(cornell, ocam, 64, 64, "cornell64_full oracle",
                name="cornell64_full")

    # the fast path against the oracle on the card, paired as the repo's
    # tests pair them, at field_dim 64 with float32 dense marches:
    # tests/test_fast.py holds the fast path to render_rays at the same
    # field-mode config (mean < 0.01, p99 < 0.06: per-tile levels, bf16
    # tables), tests/test_field_mode.py field mode to percone (mean <
    # 0.02, p95 < 0.08: the basis fields' own error); the percone image is
    # path 5's (field_dim and compute do not enter it); cornell64_full's
    # dense marches are float32 already
    fcfg = dataclasses.replace(
        ocfg, cones=dataclasses.replace(ocfg.cones, field_dim=64,
                                        diffuse_mode="field",
                                        specular_mode="field"))
    if not R.use_fast_path(fcfg):
        fail("the field config does not take the fast path")
    v5 = R.build_voxel_state(fcfg, p5["samples"], p5["mats"])
    fast5 = R.render_camera_pass(fcfg, p5["ds"], v5, p5["mats"],
                                 p5["origins"], p5["dirs"], p5["cam"])
    rays5 = R.render_rays(fcfg, p5["ds"], v5, p5["mats"], p5["origins"],
                          p5["dirs"], p5["cam"], chunk_size=16384)
    pairs = {}
    for what, a5, b5 in (("fast path vs render_rays, field mode", fast5,
                          rays5),
                         ("fast path (field) vs render_rays (percone)",
                          fast5, img5)):
        e5 = (a5 - b5).abs().flatten()
        pairs[what] = {k: float(v) for k, v in (
            ("mean", e5.mean()), ("p95", torch.quantile(e5, 0.95)),
            ("p99", torch.quantile(e5, 0.99)), ("max", e5.max()))}
        say(f"{what} on the card, cornell64_full {osize[0]}x{osize[1]}, "
            f"field_dim 64, {fcfg.grid.compute}: " + json.dumps(
                {k: float(f"{v:.4e}") for k, v in pairs[what].items()}))
    like, modes = pairs.values()
    if not (like["mean"] < 0.01 and like["p99"] < 0.06):
        fail("the fast path disagrees with render_rays at its config "
             "(tests/test_fast.py bounds)")
    if not (modes["mean"] < 0.02 and modes["p95"] < 0.08):
        fail("field mode disagrees with the percone oracle "
             "(tests/test_field_mode.py bounds)")
    del p5, v5, fast5, rays5

    # ---- (c6) inverse rendering: preset inverse, optimized --------------
    t6 = time.perf_counter()
    inverse_path(types.SimpleNamespace(
        say=say, expect=expect, maxerr=maxerr, reset_counts=reset_counts,
        read_counts=read_counts, elapsed_ms=elapsed_ms, kernel_row=kernel_row,
        row_launches=row_launches, sync=sync), preset("inverse"), dev)
    say(f"path 6 took {time.perf_counter() - t6:.1f} s")

    # ---- (c7) the shadow map and the anisotropic mips -------------------
    r7 = map_aniso_path(types.SimpleNamespace(
        say=say, expect=expect, maxerr=maxerr, reset_counts=reset_counts,
        read_counts=read_counts, check_image=check_image, sync=sync,
        counters=counters, raycast_equal=raycast_equal,
        small_check=small_check), dev)

    say(f"frame ms medians on {card}: atrium "
        f"{statistics.median(atrium_ms['render_frame']):.3f}, atrium x4 "
        f"{statistics.median(atrium4_ms['render_frame']):.3f}, exact "
        f"specular {statistics.median(x_ms['render_frame']):.3f}, "
        f"cornell64_full oracle {statistics.median(frame5_ms):.3f}, "
        f"reference {r7['7a']['frame_ms']:.3f}, aniso128 "
        f"{r7['7b']['frame_ms']:.3f}")

    # ---- (d) the result ------------------------------------------------
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
