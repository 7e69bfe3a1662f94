#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vct_tpu_torch) once on one GPU and check it.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each reported on its own lines:
  (a) the card (nvidia-smi name and power limit), the kernel build with
      ptxas's registers and spills, and for the tap, raycast, streamed
      raycast, binned raycast, specular march, prepass, material,
      dense-march and per-cone march kernels the registers, spill and
      shared bytes and resident warps per SM the card reports;
  (c) twelve paths at full width, each through prepare_scene ->
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
           launches the mip kernel and the dense march (its light
           volume), the frame the per-cone march kernel twice a chunk
           (diffuse and specular) and nothing else; build and frame
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
           (from zero) at tests/test_inverse.py's learning rates, the
           per-cone march kernel under grad (its backward the twin's
           replay): every loss finite and the last below the first; per
           step the
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
           launches in the build, every other kernel 0; the per-cone
           march twice a chunk in the frame, nothing else), its map on the
           card against the CPU's from the same samples (bit for bit),
           the per-sample PCF flips counted, the per-cone march kernel on
           the frame's first 65,536-ray chunk of the isotropic 128^3
           pyramid against its twin (bit for bit) and core/march (atol
           1e-5 away from early-out ties), and a 32^3, 64x64, map-256
           render against the CPU's plain run over the pixels whose PCF
           did not flip; 7b preset("aniso128") unchanged (128^3
           anisotropic mips, 512x512) on the Cornell box from (0, 0, 140)
           (mip 7, the unlit chain; the anisotropic pyramid kernel 7,
           the radiance pyramid; the dense march once, the light
           volume; the per-cone march twice a chunk in the frame), its
           pyramid against the CPU's bit for bit, the per-cone march
           kernel on the frame's first 65,536-ray chunk against its twin
           (bit for bit) and core/march (atol 1e-5 away from early-out
           ties), timed beside its bound and the twin (the kernels
           line's row, with the 7b frame's launches), the
           anisotropic pyramid kernel against its plain version on the
           path's pyramid and at 256^3 x 4 (bit for bit, and timed), the
           dense anisotropic march against cone_march at voxel centers
           at 32^3 (tests/test_aniso.py's bounds); 7c aniso128 with
           field cones through the fast path (raycast, prepass, tap; the
           dense march 3 times in the build, held to its plain version on
           the anisotropic stack);
           build split, frame ms, host syncs, peak memory and the
           profiler's busy and gather shares of 7a and 7b;
        8. parallel/ on preset("multihost512") (512^3 float32, 1920x1080,
           6 + 1 cones, volume shadows, a 4 x 2 ('data', 'model') mesh)
           on the atrium from the bench camera: 8a the preset on one rank
           (the mesh cut to 1 x 1) through render_rays, prepare ms, build
           and frame split, syncs, peak memory, mip 18 and the dense
           march once in the build and in the frame the per-cone march
           twice a chunk, nothing else; 8b its
           model axis, 2 ranks on the card, the 512^3 build sharded
           (samples over 'model', the light volume brick-sharded, one
           dense-march launch a rank) against the unsharded one
           (test_brick.py's bounds), halos, bytes staged and build ms
           per rank; 8c its
           whole 4 x 2 mesh, 8 ranks on the card at 128^3, the
           tile-sharded camera pass (0 torch.distributed calls counted),
           its gathered image against one rank's (test_parallel.py's
           bounds), mip 14 and the dense march once a rank in the build,
           and dryrun_multichip(8)
           with 3 falling losses and its mip and mip_bwd launches
           counted; the ranks share the card, so their process group is
           gloo and collectives stage through the host;
        9. the CLI, `python -m vct_tpu_torch` as subprocesses: render
           under sponza256 on the atrium at 1920x1080 (the fast path's
           kernels counted in the subprocess), orbit and debug at 32^3 /
           96x96, their PNGs under chiprun_out/cli/ and stage reports;
       10. the asset path at full size (vct_tpu_torch.asset_path.run under
           sponza256 at 1920x1080): scripts/bench_asset_path.py's scene
           written to a temporary directory (the atrium subdivided 4
           times, 287,232 triangles, as an OBJ with 20 textured
           materials, 14 PNG and 6 JPEG pages), load_obj through the
           native parser, prepare_scene (11,283,968 native samples),
           build_voxel_state, build_frame_tables and render_frame from
           the bench camera, the counts read after each phase; each
           phase's time (the load split into the geometry parse and the
           texture decode, prepare into geometry, atlas, sampling and
           the host-to-device copy), the frame's min, median and max
           over 5 after a warm-up, peak memory over what is held, host
           syncs in a build and a frame; on this host at full size the
           native OBJ arrays bit-equal to the Python parser's and the
           native samples to numpy's after a stable sort by tri_ids; the
           binning's column tier within its budget; the binning kernels
           (csrc/binning.cu) against pack_rows_plain and
           bin_triangles_plain on the same tensors, isect, attrs, scal,
           table and n_col_total bit for bit, at the bench camera and
           three poses of vctbench's walk (seed 2200000022, steps 0, 50,
           100), and on the scene subdivided once more (1,148,928
           triangles: the stable sort) at two of them; binrast, prepass,
           material, tap and mip against their plain versions on this
           scene (paths 2's, 3's and 5's tolerances); the streamed
           raycast's launches beside the alpha candidates (none: the MTL
           has no map_d); the build's and the frame's device ms by stage;
       11. the operating point (chip_smoke.operating_point_path): 11a
           vct_tpu_torch.bench.run at bench.py's defaults (256^3 float32
           marches, 1920x1080, the atrium subdivided 4 times, 5 builds
           and the preset's bf16 builds), its JSON line with bench.py's
           keys; 11b vct_tpu_torch.fidelity.run at tests/test_fidelity.py's
           settings (sponza256 on the atrium, 480x272, 1,024 pixels, df
           128), failing unless its four bounds hold; on 11b's own inputs
           the whole-table raycast against raycast_plain and the specular
           march against spec_march_plain;
       12. the scaling sweep and the forward step (chip_smoke.scaling_path):
           vct_tpu_torch.bench_scaling.run, strong and weak, at
           bench_scaling.py's defaults (64^3 float32, 512x512, the Cornell
           box, 1, 2, 4 and 8 ranks spawned on the card over gloo, 3
           reps), each record's work held to bench_scaling.py's formulas,
           0 torch.distributed calls in the camera pass, 12 mip launches
           a rank's build, the dense march 3 times a rank's build and
           once a timed march, no other kernel (the camera pass's cones
           are field cones), the march slabs of 2 ranks gathered
           bit-equal to one rank's march; then
           vct_tpu_torch.entry.entry()'s forward (cornell64_full at 32^3,
           64x64) on the card against its CPU run (test_torch_oracle.py's
           render_rays bounds), mip 10, the dense march once, the
           per-cone march twice a chunk;
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
      triangles, also against the whole-table kernel; the binning's
      pack and bin together at 287,232, bit for bit; the specular march
      and the diffuse-only tap on path 4's frame), with its time
      beside the plain one, the least time the card could take (bound),
      and, where one PyTorch call computes the same function, that
      call's time (the dense march at the operating point's three
      marches, on path 2's own pyramids: the 256^3 light volume and the
      two 128^3 x 26-direction fields, in bf16 and float32, over bf16
      levels, and sponza256_aniso's 6-direction fields, each bit-equal
      to its plain version, its steps taken against the plain
      version's, its packed copy and pack launches checked, and the
      bf16 outputs against the build's; every build of paths
      1-12 marches through it: 3 launches a sponza256 build, the
      brick-sharded light volume once a rank in 8b and 8c, and path 10's
      marches make no host sync; the whole-table and binned raycasts' bounds count the
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
  (d) the result: a JSON line of kernels (each row's `launches` from the
      path its times were taken on, `launches_path10` from path 10's run
      from the load to the first frame, `launches_path11` from 11a and
      11b, `launches_path12` from path 12's ranks and its entry() run),
      then {"ok": true, ...} last.
Any failure raises: the script exits non-zero and prints no result line.
It exits non-zero at once when CUDA is unavailable.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

from vct_tpu_torch.ops import _build

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
# bytes of one triangle the binning's pack reads: v0, e1, e2, vn, vt, vb,
# vuv, face_normal, material (gbuffer.DeviceScene)
TRI_INPUT_BYTES = 3 * 12 + 3 * 36 + 24 + 12 + 4
# csrc/binning.cu kernels a frame above raycast.MAX_TRIANGLES: the pack,
# then strips, envelopes, triangles, scan, ranks, bounds, padding, table
BINNING_LAUNCHES = 9


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
    (say, fail, expect, maxerr, elapsed_ms, kernel_row, row_launches,
    sync) and adds the mip backward's row to the
    kernels line, with its launches in 6a."""
    from vct_tpu_torch import stages
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.core import grid as G
    from vct_tpu_torch.diff import inverse as I
    from vct_tpu_torch.core import cones as C
    from vct_tpu_torch.core import dense as D
    from vct_tpu_torch.ops import dense as OD
    from vct_tpu_torch.ops import (material, mip, prepass, raycast,
                                   specmarch, tap)
    from vct_tpu_torch.profile_stages import count_syncs
    from vct_tpu_torch.render import shading
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
        _build.reset_launches()
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
        launches = _build.launches()
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
                       fgrid=torch.cat(fields, dim=-1),
                       march=v.radiance_mips)
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
    nd = ("raycast", "raycast_stream", "binrast", "binning", "prepass",
          "material", "tap", "specmarch")

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
                        ("mip", "mip_bwd", "dense_march", "percone"))
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
        _build.reset_launches()
        grads[cpass] = grad_of(fcfg, s, inv, params, t2)
        h.sync()
        counts = _build.launches()
        if cpass == "fast":
            h.say("launches in one fast-pass loss and gradient:",
                  json.dumps(counts))
            h.expect(counts, ("mip", "mip_bwd", "raycast", "prepass", "tap",
                              "dense_march"),
                     ("binrast", "binning", "raycast_stream", "material",
                      "specmarch"), "main path 6b gradient")
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
                        ("mip", "mip_bwd", "raycast", "prepass", "tap",
                         "dense_march"))
        h.expect(got, (), ("binrast", "binning", "raycast_stream",
                           "material", "specmarch"), f"main path 6b ({name})")
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
               "material", "specmarch", "raycast_stream", "dense_march"))
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
        lambda inp: _build.Replay.apply(
            tap.flat(tap.tap_cuda, nl, **kw),
            tap.flat(tap.tap_plain, nl, **kw), (), inp[0], sc, inp[1],
            inp[2], *inp[3]),
        lambda inp: tap.tap_plain(inp[0], sc, inp[1], inp[2], inp[3][:nl],
                                  inp[3][nl:], **kw),
        (g.shape[0], tap.NOUT))
    g, sl, ms_, ml, pg, res, tl = inputs_c["material"]
    bwd_ms["material"] = route(
        "material", lambda: ([leaf(g), leaf(pg)],) * 2,
        lambda inp: _build.Replay.apply(
            lambda *t: material.material_cuda(*t, res, tl),
            lambda *t: material.material_plain(*t, res, tl), (), inp[0], sl,
            ms_, ml, inp[1]),
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
        lambda inp: _build.Replay.apply(
            specmarch.flat(specmarch.spec_march_cuda, **skw),
            specmarch.flat(specmarch.spec_march_plain, **skw),
            specmarch.FROZEN, inp[0], inp[1], slv, swt, *inp[2]),
        lambda inp: specmarch.spec_march_plain(inp[0], inp[1], slv, swt,
                                               inp[2], **skw),
        (s4.shape[0], 4))
    # the dense march: 6b's diffuse field from its radiance pyramid, the
    # kernel's forward and the plain version's replay (_build.Replay)
    dmips = inputs_b["march"]
    dplan = D.march_plan(
        dmips, D.direction_basis(fcfg.cones.field_basis),
        shading.diffuse_schedule(fcfg), fcfg.grid.world_size,
        field_dim=shading.field_dim(fcfg), max_alpha=fcfg.cones.max_alpha,
        occlusion_falloff=fcfg.cones.occlusion_falloff,
        compute_dtype=shading.march_compute_dtype(fcfg))

    def make_march():
        flat, views = packed(dmips)
        return [flat], views

    bwd_ms["dense_march"] = route(
        "dense_march", make_march,
        lambda inp: _build.Replay.apply(
            lambda *lv: OD.dense_march_cuda(lv, dplan),
            lambda *lv: OD.dense_march_plain(lv, dplan), (), *inp),
        lambda inp: OD.dense_march_plain(inp, dplan),
        dplan.shape + (dplan.nb * dplan.channels,))

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
CHUNK = 65536             # render_camera_pass's render_rays chunk
SMALL_MAP = 256           # the card-vs-CPU render's map (32^3, 64x64)


def pcf_taps(cfg, value, normalization):
    """PCF values -> lit taps (the reference quirk scales by 0.111)."""
    if normalization == "main" and cfg.shadow.pcf_normalization == "reference":
        return torch.round(value.double() / 0.111)
    return torch.round(value.double() * (2 * cfg.shadow.pcf_radius + 1) ** 2)


def percone_launches(cfg, rays: int) -> int:
    """render_rays' launches of the per-cone march kernel over `rays`
    camera rays in render_camera_pass's chunks: one a chunk for each cone
    mode that is "percone"."""
    from vct_tpu_torch.render import renderer as R
    ca = cfg.cones
    calls = int(ca.diffuse_mode == "percone") + int(
        ca.trace_specular and ca.specular_mode == "percone")
    return -(-rays // R.CAMERA_CHUNK) * calls


def expect_oracle_frame(h, launches, cfg, what):
    """A render_rays frame's launches: percone_launches of the per-cone
    march kernel, no other kernel."""
    want = percone_launches(cfg, cfg.render.width * cfg.render.height)
    if launches["percone"] != want:
        fail(f"{what}: per-cone march launches {launches['percone']}, "
             f"expected {want} (diffuse and specular a chunk)")
    h.expect(launches, (), tuple(k for k in launches if k != "percone"),
             what)


def percone_twin_check(h, cfg, q, what):
    """The per-cone march kernel on the first 65,536-ray chunk of q's
    frame (render_rays' G-buffer, cone axes and reflection axis), both
    marches: against its twin bit for bit, against core/march within
    atol 1e-5 on the rays whose alpha comes nowhere near max_alpha (1e-5;
    at a tie the loop's exit and core/march's mask may stop a step
    apart).  Returns the chunk's start, the marches' (dirs, call
    arguments, tan half-angle), the samples scheduled, the steps run and
    the largest error."""
    from vct_tpu_torch.core import cones as C
    from vct_tpu_torch.core import grid as G
    from vct_tpu_torch.core import march as M
    from vct_tpu_torch.ops import percone as PC
    from vct_tpu_torch.render import gbuffer as GB
    from vct_tpu_torch.render import renderer as R
    from vct_tpu_torch.render import shading

    ca, ws = cfg.cones, cfg.grid.world_size
    mips = q["voxels"].radiance_mips
    o = q["origins"].reshape(-1, 3)[0]
    d = q["dirs"].reshape(-1, 3)[:R.CAMERA_CHUNK]
    pc = GB.pinhole_constants(q["ds"], o)
    g = R.alpha_mask_recast(cfg, q["ds"], pc, o, d,
                            GB.raycast_chunk_pinhole(q["ds"], pc, o, d),
                            q["mats"])
    start = (g.position + g.normal * cfg.grid.voxel_world_size).contiguous()
    cone_dirs = shading.pixel_cone_dirs(cfg, g.normal, g.tangent,
                                        g.bitangent).contiguous()
    eye = C.normalize(q["cam"] - g.position)
    refl = shading.reflect_eye(g.normal, eye).contiguous()
    weights = tuple(float(w) for w in C.CONE_WEIGHTS[:ca.num_diffuse_cones])
    marches = (("diffuse", shading.diffuse_schedule(cfg), cone_dirs, weights,
                ca.diffuse_tan_half_angle),
               ("specular", shading.specular_schedule(cfg), refl[:, None],
                (1.0,), ca.specular_tan_half_angle))
    n = start.shape[0]
    calls, samples, walked_all, worst = [], 0, 0, 0.0
    for march, sched, dirs, w, tan in marches:
        table, levels = PC.read_levels(PC.step_table(sched, len(mips),
                                                     ca.occlusion_falloff))
        read = [mips[lv] for lv in levels]
        kw = dict(table=table, weights=w, world_size=ws,
                  max_alpha=ca.max_alpha)
        walked = torch.zeros((), dtype=torch.int64, device=start.device)
        kern = PC.gather_cuda(start, dirs, *read, walked=walked, **kw)
        twin_walked = torch.zeros_like(walked)
        twin = PC.gather_plain(start, dirs, *read, walked=twin_walked, **kw)
        if march == "diffuse":
            rgb, occ = M.cone_march_multi(mips, start, dirs, w, sched, ws,
                                          ca.max_alpha, ca.occlusion_falloff)
        else:
            rgb, occ, _ = M.cone_march(mips, start, refl, sched, ws,
                                       ca.max_alpha, ca.occlusion_falloff)
        pts = start[:, None, None, :] + (G.constant(sched.dists, start.device)
                                         [:, None] * dirs[:, :, None, :])
        smp = M.sample_schedule(mips, pts, sched.lods, ws, direction=dirs)
        alpha = 1.0 - torch.cumprod(1.0 - smp[..., 3], dim=-1)
        tie = ((alpha - ca.max_alpha).abs() <= 1e-5).flatten(1).any(dim=1)
        far = ~tie
        err = max(float((kern[far, :3] - rgb[far]).abs().max()),
                  float((kern[far, 3] - occ[far]).abs().max()))
        same = torch.equal(kern, twin) and int(walked) == int(twin_walked)
        h.say(f"percone kernel, {what}'s {march} march on its first chunk "
              f"({n} rays, {dirs.shape[1]} cones, {len(table)} steps, "
              f"levels {list(levels)} of {len(mips)}, "
              f"{'6-direction' if mips[-1].dim() == 5 else 'isotropic'}): "
              f"bit-equal to its twin {same} (steps run {int(walked)} of "
              f"{n * dirs.shape[1] * len(table)}); against core/march max "
              f"error {err:.3e} on {int(far.sum())} rays away from ties "
              f"(tolerance 1e-5), {int(tie.sum())} rays near a tie")
        if not same:
            fail(f"percone kernel ({what}, {march}) differs from its twin")
        if not err <= 1e-5:
            fail(f"percone kernel ({what}, {march}) disagrees with "
                 f"core/march")
        worst = max(worst, err)
        samples += n * dirs.shape[1] * len(table)
        walked_all += int(walked)
        calls.append((dirs, read, kw, tan))
        del kern, twin, rgb, occ, pts, smp, alpha
    return start, calls, samples, walked_all, worst


def percone_check(h, cfg, q, frame_launches):
    """The kernels line's `percone` row from path 7b (aniso128): the twin
    check on the frame's first chunk (percone_twin_check), then the two
    launches timed beside the twin and the bound: the least work of
    vctbench/reference_oracle's march_work over the steps run (the
    kernel's own count), operations at the rate of separately rounded
    ones.  Its launches are the 7b frame's own (frame_launches)."""
    from vct_tpu_torch.ops import percone as PC
    from vct_tpu_torch.render import renderer as R
    from vctbench.reference_oracle import march as RM

    ca = cfg.cones
    mips = q["voxels"].radiance_mips
    start, calls, samples, walked_all, err = percone_twin_check(
        h, cfg, q, "7b aniso128")

    def kernel():
        for dirs, read, kw, _ in calls:
            PC.gather_cuda(start, dirs, *read, **kw)

    def plain():
        for dirs, read, kw, _ in calls:
            PC.gather_plain(start, dirs, *read, **kw)

    h.row_launches["percone"] = frame_launches
    chunks = -(-cfg.render.width * cfg.render.height // R.CAMERA_CHUNK)
    voxel = cfg.grid.voxel_world_size
    cones = [RM.cone_steps(tan, voxel, ca.max_distance, ca.max_steps)
             for dirs, _, _, tan in calls for _ in range(dirs.shape[1])]
    nbytes, ops = RM.march_work(start.shape[0], cones,
                                [tuple(m.shape) for m in mips],
                                walked_all / samples)
    occ = _build.occupancy("vct_percone_occupancy", ca.num_diffuse_cones)
    h.say(f"percone kernel: {occ['registers']} registers, "
          f"{occ['spill_bytes']} spill bytes a thread at "
          f"{ca.num_diffuse_cones} cones; launches in 7b's frame "
          f"{frame_launches} ({chunks} chunks, 2 a chunk); active share on "
          f"the first chunk {walked_all / samples:.4f}")
    h.kernel_row("percone", "vct_tpu_torch/ops/csrc/percone.cu",
                 "(XLA) vct_tpu/core/march.py cone_march_multi, cone_march",
                 err, 1e-5, elapsed_ms(kernel, KERNEL_REPS, KERNEL_BATCH),
                 elapsed_ms(plain, PLAIN_REPS), nbytes, ops,
                 rate=FP32_RN_OPS_PER_S)


def drive(h, dev, cfg, scene, camera, what, fast=False):
    """prepare -> build (counted) -> frame (counted), as a user calls
    them; returns the run's tensors and both launch counts (paths 7 and
    8; h carries chip_smoke's helpers)."""
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.render import fast as F
    from vct_tpu_torch.render import renderer as R
    h.sync()
    t0 = time.perf_counter()
    ds, mats, samples = R.prepare_scene(cfg, scene, device=dev)
    _build.reset_launches()
    voxels = R.build_voxel_state(cfg, samples, mats)
    tables = F.build_frame_tables(cfg, voxels, mats) if fast else None
    h.sync()
    build_launches = _build.launches()
    built = "build and frame tables" if fast else "build"
    origins, dirs = CAM.primary_rays(camera, cfg.render.width,
                                     cfg.render.height, device=dev)
    cam = torch.as_tensor(camera.position, dtype=torch.float32,
                          device=dev)
    _build.reset_launches()
    img = R.render_camera_pass(cfg, ds, voxels, mats, origins, dirs, cam,
                               frame_tables=tables)
    h.sync()
    frame_launches = _build.launches()
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


def measure(h, cfg, q, what, chunks=None):
    """Build split, frame split and ms (medians of 3 after a warm-up),
    host syncs and peak memory, and under the profiler the busy share
    and the gather kernels' share of the device time: of 3 frames, or
    with `chunks` of render_rays' first chunks of the frame, the same
    calls on fewer rays (a frame of ~10^5 kernels takes the profiler
    minutes to sum)."""
    from vct_tpu_torch.profile_stages import count_syncs, profile, stage_ms
    from vct_tpu_torch.render import renderer as R

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


DENSE_REPS = 5            # the dense march's timing samples, one launch each
TAP_SUNS = 64             # suns of the relight traffic's path for the taps
TAP_SUN_SEED = 2_700_000_027


def dense_path(h, cfg, voxels):
    """The dense-march kernel (csrc/dense.cu) against its plain version on
    the card at the operating point's three marches, built from this
    config's own pyramids as build_voxel_state marches them: the light
    volume over the unlit (max-alpha) pyramid, the diffuse and the
    specular field over the radiance pyramid, each in bfloat16 (the
    preset's compute, its outputs held equal to the build's) and in
    float32.  Per march: the cells, directions and steps, the steps the
    kernel took before its early-outs (its own count, held equal to the
    plain version's), unequal elements (none allowed: bit for bit), the
    packed copy the kernel read (ops/dense.pack_levels_cuda: its
    dense_kernel_pack launches, one a march and none where every level is
    already packed, its bytes, and the copy equal to pack_levels_plain's),
    the kernel's time (CUDA events around one launch, the pack included),
    the plain version's, and the bound from ops/dense.march_work; and the
    plan (march_plan: the direction-free half from core/dense.py's memo,
    the tap table from one dense_kernel_taps launch) equal field for field
    to the host build (direction_taps through ops/dense.make_plan).  Then
    the same checks on the three marches over the pyramids in bfloat16
    (bfloat16 compute: the fields read their levels as they are) and on
    sponza256_aniso's two field marches over the 6-direction pyramid of
    the build's level 0 (ops/aniso), in bfloat16, float32 and over
    bfloat16 levels.  The kernels line's row is the bfloat16 build's three
    marches together.  Last the tap table alone (tap_path)."""
    from vct_tpu_torch import bench
    from vct_tpu_torch.core import dense as D
    from vct_tpu_torch.ops import aniso as OA
    from vct_tpu_torch.ops import dense as OD
    from vct_tpu_torch.render import shading

    light = np.asarray(cfg.light.direction, np.float64)
    light = (light / np.linalg.norm(light))[None]
    basis = D.direction_basis(cfg.cones.field_basis)
    ws, df = cfg.grid.world_size, shading.field_dim(cfg)
    field_kw = dict(field_dim=df, max_alpha=cfg.cones.max_alpha,
                    occlusion_falloff=cfg.cones.occlusion_falloff)
    light_kw = dict(field_dim=cfg.grid.dim,
                    opacity_gain=cfg.shadow.opacity_gain,
                    transmittance_only=True)

    def marches(unlit, radiance, built=(None, None, None)):
        return (("light volume", unlit, light, shading.shadow_schedule(cfg),
                 light_kw, built[0]),
                ("diffuse field", radiance, basis,
                 shading.diffuse_schedule(cfg), field_kw, built[1]),
                ("specular field", radiance, basis,
                 shading.specular_field_schedule(cfg), field_kw, built[2]))

    built = marches(voxels.unlit_mips, voxels.radiance_mips,
                    (voxels.light_volume, voxels.diffuse_field,
                     voxels.specular_field))
    samples = sum(int(np.prod(out.shape[:3])) * dirs.shape[0]
                  * sched.num_steps
                  for _, _, dirs, sched, _, out in built)
    if samples != bench.count_dense_samples(cfg):
        fail(f"the three marches hold {samples} samples, not "
             f"bench.count_dense_samples' {bench.count_dense_samples(cfg)}")

    def check(tag, what, mips, dirs, sched, kw, as_built, compute,
              plain_reps):
        """One march through the kernel against its plain version; returns
        (mips, plan, bytes, ops)."""
        plan = D.march_plan(mips, dirs, sched, ws, compute_dtype=compute,
                            **kw)
        same_plan = plan_equal(plan, mips, dirs, sched, kw, compute, ws)
        wk = torch.empty(plan.shape + (plan.nb,), dtype=torch.int32,
                         device=mips[0].device)
        wp = torch.empty_like(wk)
        before = _build.launches()["dense_pack"]
        out_k = OD.dense_march_cuda(mips, plan, wk)
        packs = _build.launches()["dense_pack"] - before
        slots, _ = OD.level_slots(mips, plan)
        want_packs = int(any(s.pack for s in slots))
        packed_bytes = sum(s.view.numel() for s in slots if s.pack) * \
            torch.finfo(plan.compute).bits // 8
        same_pack = all(
            t is None or torch.equal(t, p) for t, p in zip(
                OD.pack_levels_cuda(mips, plan),
                OD.pack_levels_plain(mips, plan)))
        out_p = OD.dense_march_plain(mips, plan, wp)
        e = h.maxerr(out_k, out_p)
        unequal = int((out_k != out_p).sum())
        same_walk = torch.equal(wk, wp)
        # the build marches in the preset's bfloat16
        same_built = None if as_built is None else torch.equal(out_k,
                                                               as_built)
        b, o = OD.march_work(mips, plan, wk)
        bms, by = bound(b, o, FP32_RN_OPS_PER_S)
        ms = elapsed_ms(lambda: OD.dense_march_cuda(mips, plan), DENSE_REPS)
        pack_ms = (statistics.median(elapsed_ms(
            lambda: OD.pack_levels_cuda(mips, plan), DENSE_REPS))
            if want_packs else 0.0)
        plain = "plain not timed"
        if plain_reps:
            pms = elapsed_ms(lambda: OD.dense_march_plain(mips, plan),
                             plain_reps)
            plain = f"plain {statistics.median(pms):.3f} ms"
        steps = plan.nb * int(np.prod(plan.shape)) * len(plan.steps)
        h.say(f"dense march{tag}, {what}, {str(compute)[6:]} over "
              f"{str(mips[0].dtype)[6:]} levels: "
              f"{plan.shape[0]}^3 cells x {plan.nb} directions x "
              f"{len(plan.steps)} steps ({steps} samples, "
              f"{plan.idx.shape[1]} taps a direction), "
              f"{int(wk.sum())} steps taken before the early-outs (the "
              f"kernel's count equal to the plain version's "
              f"{same_walk}); the plan (card-built taps) equal to the host "
              f"build's {same_plan}; max_abs_err {e:.3e}, {unequal} elements not "
              f"bit-equal of {out_k.numel()}; the build's output equal "
              f"{same_built} (None: not the build's march); pack "
              f"launches {packs} (expected {want_packs}), packed bytes "
              f"{packed_bytes}, copy equal to pack_levels_plain's "
              f"{same_pack}; kernel {statistics.median(ms):.4f} ms (median "
              f"over {ms}, the pack's {pack_ms:.4f} ms included), {plain}; "
              f"bound {bms:.4f} ms "
              f"({by}: {b:.4g} B, {o:.4g} ops at {FP32_RN_OPS_PER_S:.4g}/s)")
        if not (unequal == 0 and same_walk and same_built is not False
                and same_pack and packs == want_packs and same_plan):
            fail(f"the dense-march kernel disagrees with its plain "
                 f"version on the {what}{tag} ({compute})")
        return mips, plan, b, o

    row = None
    for compute in (torch.bfloat16, torch.float32):
        runs, nbytes, ops = [], 0, 0
        for what, mips, dirs, sched, kw, out in built:
            as_built = out if compute == torch.bfloat16 else None
            m, plan, b, o = check("", what, mips, dirs, sched, kw, as_built,
                                  compute, PLAIN_REPS)
            runs.append((m, plan))
            nbytes, ops = nbytes + b, ops + o

        def all_kernel(runs=runs):
            for mips, plan in runs:
                OD.dense_march_cuda(mips, plan)

        def all_plain(runs=runs):
            for mips, plan in runs:
                OD.dense_march_plain(mips, plan)

        if compute == torch.bfloat16:
            row = (all_kernel, all_plain, nbytes, ops)
    all_kernel, all_plain, nbytes, ops = row

    def bf16(mips):
        return [m.to(torch.bfloat16) for m in mips]

    for what, mips, dirs, sched, kw, _ in marches(
            bf16(voxels.unlit_mips), bf16(voxels.radiance_mips)):
        check(" (bfloat16 levels)", what, mips, dirs, sched, kw, None,
              torch.bfloat16, 0)
    aniso = OA.build_aniso_mips(voxels.radiance_mips[0], cfg.grid.num_levels)
    for levels, compute in ((aniso, torch.bfloat16), (aniso, torch.float32),
                            (bf16(aniso), torch.bfloat16)):
        for what, mips, dirs, sched, kw, _ in marches(None, levels)[1:]:
            check(" (6-direction pyramid)", what, mips, dirs, sched, kw,
                  None, compute, 0)
    del aniso
    h.kernel_row("dense_march", "vct_tpu_torch/ops/csrc/dense.cu",
                 "vct_tpu/core/dense.py:134", 0.0, 0.0,
                 elapsed_ms(all_kernel, DENSE_REPS),
                 elapsed_ms(all_plain, PLAIN_REPS), nbytes, ops,
                 rate=FP32_RN_OPS_PER_S)
    tap_path(h, cfg, voxels, marches(voxels.unlit_mips,
                                     voxels.radiance_mips))


def plan_equal(plan, mips, dirs, sched, kw, compute, ws) -> bool:
    """A march_plan Plan against the host build of the same march: every
    table from direction_taps and step_table through ops/dense.make_plan,
    on the same device; field for field, bit for bit."""
    from vct_tpu_torch.core import dense as D
    from vct_tpu_torch.ops import dense as OD
    dims = [m.shape[0] for m in mips]
    df = kw["field_dim"]
    lod_plan, groups = D.plan_groups(sched.lods, len(dims))
    idx, w = D.direction_taps(np.asarray(dirs, np.float64), sched, groups,
                              dims, df, ws, compute)
    host = OD.make_plan(
        [(idx[:, :, a], w[:, :, a]) for a in range(3)], D.tap_levels(groups),
        D.step_table(sched, lod_plan, groups,
                     kw.get("occlusion_falloff", 0.03)), dirs, (df,) * 3,
        mips[0].device, compute, sched.step_factor,
        kw.get("max_alpha", 0.95), kw.get("opacity_gain", 1.0),
        kw.get("transmittance_only", False))
    for f in dataclasses.fields(OD.Plan):
        a, b = getattr(plan, f.name), getattr(host, f.name)
        if not (torch.equal(a, b) if isinstance(b, torch.Tensor)
                else a == b):
            return False
    return True


def tap_path(h, cfg, voxels, marches):
    """The march's tap table on the card (csrc/dense.cu dense_kernel_taps,
    core/dense.py march_plan).  The light volume's plan under TAP_SUNS
    suns of the relight traffic's path (vctbench/traffic/relight.json) in
    bfloat16 and float32, each equal to the host build (plan_equal); the
    taps kernel's device time for the build's three marches (a CUDA graph
    of launches) beside the host's direction_taps; march_plan's host time
    a call once its direction-free half is in the memo; then two relight
    steps' marches as build_voxel_state makes them under a new sun: the
    second finds all three halves in the memo (3 hits, 0 misses) and
    launches dense_kernel_taps 3 times, and march_plan syncs with the
    card 0 times (torch's sync debug mode)."""
    from vct_tpu_torch.core import dense as D
    from vct_tpu_torch.ops import dense as OD
    from vct_tpu_torch.profile_stages import count_syncs
    from vct_tpu_torch.render import shading
    from vctbench.inputs import traffic

    ws = cfg.grid.world_size
    mix = json.loads(pathlib.Path("vctbench/traffic/relight.json")
                     .read_text())
    suns = traffic.make_paths(mix, TAP_SUN_SEED, TAP_SUNS).light
    _, unlit, _, light_sched, light_kw, _ = marches[0]
    equal = 0
    for sun in suns:
        d = (np.asarray(sun, np.float64) / np.linalg.norm(sun))[None]
        for compute in (torch.bfloat16, torch.float32):
            plan = D.march_plan(unlit, d, light_sched, ws,
                                compute_dtype=compute, **light_kw)
            equal += plan_equal(plan, unlit, d, light_sched, light_kw,
                                compute, ws)
    h.say(f"dense taps: the light volume's plan under {TAP_SUNS} suns of "
          f"the relight traffic's path (seed {TAP_SUN_SEED}), bfloat16 and "
          f"float32: {equal} of {2 * TAP_SUNS} equal to the host build's, "
          f"tap table bit for bit")
    if equal != 2 * TAP_SUNS:
        fail("the card-built tap table differs from direction_taps under "
             "the relight traffic's suns")

    compute = shading.march_compute_dtype(cfg)
    for what, mips, dirs, sched, kw, _ in marches:
        plan_kw = dict(kw, compute_dtype=compute)
        D.march_plan(mips, dirs, sched, ws, **plan_kw)
        half = D.march_half(mips, sched, ws, **plan_kw)
        ms = graph_ms(lambda: OD.taps_cuda(
            dirs, half.tap_dist, half.tap_dl, kw["field_dim"], ws, compute),
            KERNEL_REPS, KERNEL_BATCH)
        host = []
        for _ in range(20):
            sync()
            t0 = time.perf_counter()
            D.march_plan(mips, dirs, sched, ws, **plan_kw)
            host.append((time.perf_counter() - t0) * 1e3)
        plain = []
        for _ in range(3):
            _, groups = D.plan_groups(sched.lods, len(mips))
            t0 = time.perf_counter()
            D.direction_taps(np.asarray(dirs, np.float64), sched, groups,
                             [m.shape[0] for m in mips], kw["field_dim"],
                             ws, compute)
            plain.append((time.perf_counter() - t0) * 1e3)
        entries = 3 * dirs.shape[0] * len(half.levels) * kw["field_dim"]
        h.say(f"dense taps, {what}: {dirs.shape[0]} directions x "
              f"{len(half.levels)} taps x 3 axes x {kw['field_dim']} cells "
              f"({entries} entries, {8 * 2 * entries} bytes written); "
              f"kernel {statistics.median(ms):.4f} ms (median of a graph "
              f"over {ms}), host direction_taps "
              f"{statistics.median(plain):.3f} ms; march_plan on the host "
              f"{statistics.median(host):.3f} ms a call (median of 20, "
              f"min {min(host):.3f}, max {max(host):.3f})")

    def relight_marches(sun):
        scfg = dataclasses.replace(cfg, light=dataclasses.replace(
            cfg.light, direction=tuple(float(x) for x in sun)))
        shading.build_light_volume(scfg, voxels.unlit_mips)
        shading.build_cone_field(scfg, voxels.radiance_mips,
                                 shading.diffuse_schedule(scfg))
        shading.build_cone_field(scfg, voxels.radiance_mips,
                                 shading.specular_field_schedule(scfg))

    relight_marches(suns[0])
    sync()
    info0, n0 = D.plan_memo_info(), _build.launches()
    relight_marches(suns[1])
    sync()
    info1, n1 = D.plan_memo_info(), _build.launches()
    hits, misses = info1.hits - info0.hits, info1.misses - info0.misses
    taps = n1["dense_taps"] - n0["dense_taps"]
    marched = n1["dense_march"] - n0["dense_march"]

    def plans():
        d = np.asarray(suns[2], np.float64)
        for what, mips, dirs, sched, kw, _ in marches:
            D.march_plan(mips, (d / np.linalg.norm(d))[None]
                         if what == "light volume" else dirs, sched, ws,
                         compute_dtype=compute, **kw)

    syncs = count_syncs(plans)
    h.say(f"dense taps in a relight step's marches (the second of two "
          f"suns): memo hits {hits}, misses {misses} (expected 3, 0), "
          f"dense_taps launches {taps} (expected 3), dense_march {marched}; "
          f"host syncs in the three march_plan calls {syncs} (expected 0); "
          f"memo {D.plan_memo_info()}")
    if (hits, misses, taps, marched, syncs) != (3, 0, 3, 3, 0):
        fail("a relight step's marches built a tap table on the host, "
             "missed the memo or synchronised with the card")


def mip_check(h, chains, what, aniso=()):
    """The mip kernel at this path's shapes, as path 5 holds it: each
    level of the path's own pyramids (mips, alpha mode) through the
    kernel and its plain version, and the path's next level against
    the plain one.  Each anisotropic pyramid of `aniso` the same way
    through the anisotropic pyramid kernel (ops/aniso), bit for bit."""
    from vct_tpu_torch.ops import aniso as OA
    from vct_tpu_torch.ops import mip
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
    equal, n = True, 0
    for mips in aniso:
        for fine, coarse in zip(mips, mips[1:]):
            plain = OA.downsample_aniso_plain(fine)
            equal &= (torch.equal(OA.downsample_aniso_cuda(fine), plain)
                      and torch.equal(coarse, plain))
            n += 1
    if aniso:
        sizes = ", ".join(f"{m[0].shape[0]}^3 x {m[0].shape[-1]}"
                          for m in aniso)
        h.say(f"{what}: anisotropic pyramid kernel on the {n} levels of "
              f"the pyramids ({sizes}) against its plain version: "
              f"bit-equal {equal}")
    if not equal:
        fail(f"{what}: the anisotropic pyramid kernel differs from its "
             f"plain version")


def aniso_pyramid_time(h, grid):
    """The anisotropic pyramid kernel's whole pyramid on `grid` (D^3 x
    C float32), timed against the plain version and against its bound:
    every level but the last read once, every 6-direction level written
    once, 16 float operations a value written."""
    from vct_tpu_torch.core import aniso as A
    from vct_tpu_torch.ops import aniso as OA
    before = _build.launches()["aniso"]
    mips = OA.build_aniso_mips(grid)
    launches = _build.launches()["aniso"] - before
    written = sum(m.numel() for m in mips[1:])
    nbytes = 4 * (sum(m.numel() for m in mips[:-1]) + written)
    least, what = bound(nbytes, 16 * written)
    ms = statistics.median(elapsed_ms(lambda: OA.build_aniso_mips(grid),
                                      10, 10))
    plain_ms = statistics.median(elapsed_ms(
        lambda: A.build_aniso_mips(grid), 3))
    h.say(f"anisotropic pyramid kernel on {tuple(grid.shape)}: {ms:.4f} ms "
          f"({launches} launches), bound {least:.4f} ms ({what}: "
          f"{nbytes} bytes), {100 * least / ms:.1f}% of it; plain "
          f"{plain_ms:.4f} ms")
    return mips, dict(kernel_ms=ms, bound_ms=least, plain_ms=plain_ms,
                      launches=launches)


def map_aniso_path(h, dev):
    """Path 7: 7a preset("reference") unchanged (the shadow map, 4096^2,
    5x5 PCF with the /9 quirk) on the atrium from the bench camera, 7b
    preset("aniso128") unchanged (the anisotropic pyramid) on the Cornell
    box from (0, 0, 140), both through render_camera_pass, which takes
    render_rays; 7c aniso128 with field diffuse and field specular cones
    through the fast path.  Counts set to 0 just before the build and
    again before the frame, read just after each.  h carries chip_smoke's
    helpers (say, expect, maxerr, check_image, sync, raycast_equal,
    small_check)."""
    from vct_tpu_torch.config import preset
    from vct_tpu_torch.core import aniso as A
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.core import dense as D
    from vct_tpu_torch.core import march as M
    from vct_tpu_torch.ops import dense as OD
    from vct_tpu_torch.ops import prepass as PP
    from vct_tpu_torch.ops import raycast as RC
    from vct_tpu_torch.ops import tap as TP
    from vct_tpu_torch.render import fast as F
    from vct_tpu_torch.render import gbuffer as GB
    from vct_tpu_torch.render import renderer as R
    from vct_tpu_torch.render import shading
    from vct_tpu_torch.render import shadowmap as SM
    from vct_tpu_torch.scene.atrium import atrium
    from vct_tpu_torch.scene.cornell import cornell_box

    cpu = torch.device("cpu")
    only_mip = tuple(k for k in _build.launches() if k != "mip")
    result = {}

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
    qa, build_a, frame_a = drive(h, dev, rcfg, atrium(), bench,
                                 "7a reference")
    levels = rcfg.grid.num_levels - 1
    if build_a["mip"] != 2 * levels or frame_a["mip"] != 0:
        fail(f"7a: mip launches {build_a['mip']} in the build (expected "
             f"{2 * levels}: unlit and lit chains) and {frame_a['mip']} in "
             f"the frame (expected 0)")
    h.expect(build_a, (), only_mip, "7a build")
    expect_oracle_frame(h, frame_a, rcfg, "7a frame")
    mip_check(h, ((qa["voxels"].unlit_mips, "max"),
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
    result["7a"] = measure(h, rcfg, qa, "7a reference", chunks=2)
    percone_twin_check(h, rcfg, qa, "7a reference")
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
    qb, build_b, frame_b = drive(h, dev, acfg, cornell_box(size=100.0),
                                 ocam, "7b aniso128")
    levels = acfg.grid.num_levels - 1
    if build_b["mip"] != levels or frame_b["mip"] != 0:
        fail(f"7b: mip launches {build_b['mip']} in the build (expected "
             f"{levels}: the unlit chain) and {frame_b['mip']} in the frame")
    # the light volume, through the dense-march kernel, once
    if build_b["dense_march"] != 1:
        fail(f"7b: dense-march launches {build_b['dense_march']} in the "
             f"build, expected 1 (the light volume)")
    # the radiance pyramid, through the anisotropic pyramid kernel
    if build_b["aniso"] != levels:
        fail(f"7b: anisotropic pyramid launches {build_b['aniso']} in the "
             f"build, expected {levels}")
    h.expect(build_b, (), tuple(k for k in only_mip if k not in (
        "dense_march", "dense_pack", "dense_taps", "aniso")), "7b build")
    expect_oracle_frame(h, frame_b, acfg, "7b frame")
    rad = qb["voxels"].radiance_mips
    if not A.is_aniso_stack(rad):
        fail("7b: the radiance pyramid is not anisotropic")
    ref = A.build_aniso_mips(rad[0].cpu(), acfg.grid.num_levels)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(rad, ref))
    h.say(f"7b anisotropic pyramid {[tuple(m.shape) for m in rad[:2]]}... "
          f"({len(rad)} levels) on the card against the CPU's from the same "
          f"level 0: bit-equal {same}")
    if not same:
        fail("7b: the card's anisotropic pyramid differs from the CPU's")
    del ref
    # and at the operating point's 256^3 x 4, timed
    rng = np.random.default_rng(SEED + 11)
    grid256 = torch.as_tensor(rng.uniform(0, 0.8, (256, 256, 256, 4)).astype(
        np.float32), device=dev)
    mips256, result["aniso_pyramid"] = aniso_pyramid_time(h, grid256)
    mip_check(h, ((qb["voxels"].unlit_mips, "max"),), "7b",
              aniso=(rad, mips256))
    del grid256, mips256
    result["7b"] = measure(h, acfg, qb, "7b aniso128")
    percone_check(h, acfg, qb, frame_b["percone"])
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
    h.say(f"7b dense anisotropic march (32^3, {sched.num_steps} steps, "
          f"the dense-march kernel) against cone_march at the voxel "
          f"centers on the card: max "
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
    qc, build_c, frame_c = drive(h, dev, fcfg, cornell_box(size=100.0),
                                 ocam, "7c aniso128 field", fast=True)
    h.expect(build_c, ("mip", "aniso"), (), "7c build")
    # the light volume and both fields over the anisotropic stack
    if build_c["dense_march"] != 3:
        fail(f"7c: dense-march launches {build_c['dense_march']} in the "
             f"build, expected 3")
    h.expect(frame_c, ("raycast", "prepass", "tap"), (), "7c frame")
    # the dense-march kernel against its plain version on 7c's own
    # anisotropic stack: the build's diffuse field, bit for bit expected
    vc = qc["voxels"]
    aplan = D.march_plan(
        vc.radiance_mips, D.direction_basis(fcfg.cones.field_basis),
        shading.diffuse_schedule(fcfg), fcfg.grid.world_size,
        field_dim=shading.field_dim(fcfg), max_alpha=fcfg.cones.max_alpha,
        occlusion_falloff=fcfg.cones.occlusion_falloff,
        compute_dtype=shading.march_compute_dtype(fcfg))
    ak = OD.dense_march_cuda(vc.radiance_mips, aplan)
    aerr = h.maxerr(ak, OD.dense_march_plain(vc.radiance_mips, aplan))
    h.say(f"7c dense-march kernel on the anisotropic stack "
          f"({[tuple(m.shape) for m in vc.radiance_mips[:2]]}..., "
          f"{aplan.nb} directions, {len(aplan.steps)} steps): max_abs_err "
          f"{aerr:.3e} against its plain version (tolerance 1e-6), the "
          f"build's diffuse field equal {torch.equal(ak, vc.diffuse_field)}")
    if not (aerr <= 1e-6 and torch.equal(ak, vc.diffuse_field)):
        fail("7c: the dense-march kernel disagrees on the anisotropic "
             "stack")
    del ak
    # each kernel of 7c at the path's own shapes: the pyramids of the
    # build and of the frame tables, and the frame's G-buffer, prepass and
    # taps on its own tables (paths 1-4's comparisons)
    vc, tc = qc["voxels"], qc["tables"]
    mip_check(h, ((vc.unlit_mips, "max"),
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


# ---- paths 8 and 9: parallel/ (preset multihost512) and the CLI ---------
# tests/test_brick.py's bounds on a sharded light volume, a radiance grid
# bound for a build whose partial grids sum in another order, and
# tests/test_parallel.py's on a sharded image
LIGHT_TOL = (1e-4, 1e-5)      # (rtol, atol)
RADIANCE_TOL = (1e-5, 1e-6)
IMAGE_TOL = (2e-4, 2e-5)
DIM_8C = 128                  # 8c's grid: eight ranks' builds on one card
DRYRUN_STEPS = 3              # 8c's dryrun_multichip(8) train steps
DRYRUN_LEVELS = 4             # its 16^3 pyramid's downsamples (16 -> 1)
CLI_S = 600                   # a CLI subprocess's time limit


def multihost_cfg(dim, width, height, n_data, n_model):
    """preset("multihost512") with its grid cut to dim^3 (512 unchanged),
    its frame at width x height and its mesh set to n_data x n_model."""
    from vct_tpu_torch.config import preset
    cfg = preset("multihost512")
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=dim),
        render=dataclasses.replace(cfg.render, width=width, height=height),
        sharding=dataclasses.replace(cfg.sharding, data_parallel=n_data,
                                     brick_parallel=n_model))


def within(a: torch.Tensor, b: torch.Tensor, tol) -> dict:
    """Max error of a against b, bit-equality, and whether every element
    lies within atol + rtol * |b|."""
    rtol, atol = tol
    diff = (a.float() - b.float()).abs()
    excess = float((diff - (atol + rtol * b.float().abs())).max())
    return {"max_abs_err": float(diff.max()), "bit_equal": bool(
        torch.equal(a, b)), "within": excess <= 0.0}


def rank_device(dev_type: str) -> torch.device:
    if dev_type != "cuda":
        return torch.device(dev_type)
    _build.library()           # loads the library the parent built
    return torch.device("cuda", torch.cuda.current_device())


def rank_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def rank_8b(dev_type: str, dim: int, width: int, height: int) -> dict:
    """8b, in each of 2 ranks (data 1 x model 2): the sharded build of the
    atrium at dim^3 (samples over 'model', the light volume
    brick-sharded), and on rank 0 the unsharded build beside it."""
    import torch.distributed as dist
    from vct_tpu_torch.parallel import brick, comm
    from vct_tpu_torch.parallel import mesh as ML
    from vct_tpu_torch.render import renderer as R
    from vct_tpu_torch.render import shading
    from vct_tpu_torch.scene.atrium import atrium

    dev = rank_device(dev_type)
    rank = dist.get_rank()
    cfg = multihost_cfg(dim, width, height, 1, 2)
    mesh = ML.make_mesh_for(cfg, dev.type)
    _, mats, samples = R.prepare_scene(cfg, atrium(), device=dev)
    sched = shading.shadow_schedule(cfg)
    light = np.asarray(cfg.light.direction, np.float64)
    halos, sharded = brick.shard_plan(
        (light / np.linalg.norm(light))[None], sched,
        [dim >> i for i in range(cfg.grid.num_levels)], cfg.grid.world_size,
        2)
    rank_sync(dev)
    dist.barrier()
    comm.STAGED_BYTES = 0
    _build.reset_launches()
    t0 = time.perf_counter()
    state = R.build_voxel_state(cfg, samples, mats, mesh=mesh)
    rank_sync(dev)
    n = _build.launches()
    out = dict(rank=rank, backend=str(dist.get_backend()),
               build_ms=(time.perf_counter() - t0) * 1e3,
               staged_bytes=comm.STAGED_BYTES, mip=n["mip"],
               dense=n["dense_march"], taps=n["dense_taps"],
               samples=samples.positions.shape[0],
               halos=halos, sharded=sharded)
    if rank == 0:
        one = dataclasses.replace(cfg, sharding=dataclasses.replace(
            cfg.sharding, brick_parallel=1))
        ref = R.build_voxel_state(one, samples, mats)
        out["light_volume"] = within(state.light_volume, ref.light_volume,
                                     LIGHT_TOL)
        out["radiance"] = within(state.radiance_mips[0],
                                 ref.radiance_mips[0], RADIANCE_TOL)
    return out


def rank_8c(dev_type: str, dim: int, width: int, height: int) -> dict:
    """8c, in each of 8 ranks (the preset's 4 x 2 mesh): the sharded build
    of the atrium at dim^3, the tile-sharded camera pass over 'data' (its
    torch.distributed calls counted), the image gathered on rank 0 and
    held there against one rank's build and render, then
    dryrun_multichip(8) with 3 steps."""
    import torch.distributed as dist
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.core import grid as G
    from vct_tpu_torch.parallel import comm
    from vct_tpu_torch.parallel import mesh as ML
    from vct_tpu_torch.parallel import tile_dp
    from vct_tpu_torch.render import renderer as R
    from vct_tpu_torch.scene.atrium import atrium

    t_path = time.perf_counter()
    dev = rank_device(dev_type)
    rank = dist.get_rank()
    cfg = multihost_cfg(dim, width, height, 4, 2)
    mesh = ML.make_mesh_for(cfg, dev.type)
    ds, mats, samples = R.prepare_scene(cfg, atrium(), device=dev)
    bench = CAM.Camera(**ATRIUM_CAMERA)
    origins, dirs = CAM.primary_rays(bench, width, height, device=dev)
    cam = G.constant(bench.position, dev)
    rank_sync(dev)
    dist.barrier()
    comm.STAGED_BYTES = 0
    _build.reset_launches()
    t0 = time.perf_counter()
    state = tile_dp.sharded_build_fn(cfg, mesh)(samples, mats)
    rank_sync(dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    n = _build.launches()
    staged, mips, marches = comm.STAGED_BYTES, n["mip"], n["dense_march"]
    taps = n["dense_taps"]
    levels = len(state.radiance_mips) - 1
    camera = tile_dp.shardmap_camera_fn(cfg, ds, mesh, chunk_size=CHUNK)
    t0 = time.perf_counter()
    with comm.count_calls() as calls:
        rows = camera(origins, dirs, cam, state, mats)
        rank_sync(dev)
    camera_ms = (time.perf_counter() - t0) * 1e3
    img = tile_dp.gather_rows(rows, mesh)
    out = dict(rank=rank, coord=(mesh.get_local_rank("data"),
                                 mesh.get_local_rank("model")),
               build_ms=build_ms, staged_bytes=staged, mip=mips,
               dense=marches, taps=taps, levels=levels, camera_ms=camera_ms,
               camera_calls=dict(calls),
               rows=tuple(rows.shape))
    del state, rows
    if rank == 0:
        one = multihost_cfg(dim, width, height, 1, 1)
        ref = R.render_rays(one, ds, R.build_voxel_state(one, samples, mats),
                            mats, origins, dirs, cam, chunk_size=CHUNK)
        out["image"] = within(img, ref, IMAGE_TOL)
        out["image"].update(shape=tuple(img.shape), finite=bool(
            torch.isfinite(img).all()), mean=float(img.mean()))
    del img
    rank_sync(dev)
    _build.reset_launches()
    out["dryrun"] = tile_dp.dryrun_multichip(8, steps=DRYRUN_STEPS,
                                             device=dev)
    rank_sync(dev)
    n = _build.launches()
    out["dryrun_mip"] = (n["mip"], n["mip_bwd"])
    out["seconds"] = time.perf_counter() - t_path
    return out


def multihost_path(h, dev, dim_a=512, dim_c=DIM_8C, size=(WIDTH, HEIGHT)):
    """Path 8: preset("multihost512") (512^3 float32, 1920x1080, 6 + 1
    cones, volume shadows, a 4 x 2 ('data', 'model') mesh) on the atrium
    from the bench camera.  8a the preset at full width on one rank (the
    mesh cut to 1 x 1) through prepare_scene -> build_voxel_state ->
    render_camera_pass (render_rays), counts read after the build and the
    frame; 8b its model axis, 2 ranks (1 x 2) on the card, the whole 512^3
    build sharded and held against the unsharded one; 8c its whole 4 x 2
    mesh, 8 ranks on the card, the grid cut to dim_c^3 (eight ranks'
    states and staged reduces on one card), the frame kept, the
    tile-sharded camera pass and dryrun_multichip(8).  The ranks run on
    one card, so the process group is gloo (NCCL refuses two ranks on one
    card): collectives on CUDA tensors stage through the host
    (parallel/comm.py), and the bytes are printed.  h carries
    chip_smoke's helpers."""
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.parallel import mesh as ML
    from vct_tpu_torch.render import renderer as R
    from vct_tpu_torch.scene.atrium import atrium

    t8 = time.perf_counter()
    width, height = size
    only_mip = tuple(k for k in _build.launches() if k != "mip")
    result = {}

    # ---- 8a: the preset at full width on one rank -----------------------
    acfg = multihost_cfg(dim_a, width, height, 1, 1)
    h.say(f"8a multihost512: {acfg.grid.dim}^3 {acfg.grid.dtype}, "
          f"{acfg.render.width}x{acfg.render.height}, "
          f"{acfg.cones.num_diffuse_cones} diffuse cones and specular "
          f"{acfg.cones.trace_specular}, shadow mode {acfg.shadow.mode}; the "
          f"mesh cut from 4 x 2 to 1 x 1")
    bench = CAM.Camera(**ATRIUM_CAMERA)
    scene = atrium()
    qa, build_a, frame_a = drive(h, dev, acfg, scene, bench,
                                 "8a multihost512")
    levels = acfg.grid.num_levels - 1
    if build_a["mip"] != 2 * levels or frame_a["mip"] != 0:
        fail(f"8a: mip launches {build_a['mip']} in the build (expected "
             f"{2 * levels}) and {frame_a['mip']} in the frame (expected 0)")
    if build_a["dense_march"] != 1:
        fail(f"8a: dense-march launches {build_a['dense_march']} in the "
             f"build, expected 1 (the light volume)")
    h.expect(build_a, (), tuple(k for k in only_mip if k not in (
        "dense_march", "dense_pack", "dense_taps")), "8a build")
    expect_oracle_frame(h, frame_a, acfg, "8a frame")
    mip_check(h, ((qa["voxels"].unlit_mips, "max"),
                  (qa["voxels"].radiance_mips, "mean")), "8a")
    prepare_ms = host_ms(lambda: R.prepare_scene(acfg, scene, device=dev))
    h.say(f"8a prepare_scene ms (host clock to a synchronize, one call): "
          f"{prepare_ms:.3f}; {qa['samples'].positions.shape[0]} surface "
          f"samples")
    result["8a"] = measure(h, acfg, qa, "8a multihost512", chunks=2)
    result["8a"].update(prepare_ms=prepare_ms, mip_build=build_a["mip"])
    del qa
    h.sync()
    torch.cuda.empty_cache()

    # ---- 8b: the model axis, 2 ranks, the whole 512^3 build -------------
    t0 = time.perf_counter()
    ranks = ML.spawn(rank_8b, 2, dev.type, dim_a, width, height)
    r0 = ranks[0]
    h.say(f"8b model axis, 2 ranks on the card, backend {r0['backend']}: "
          f"{acfg.grid.dim}^3, {r0['samples']} samples; light volume halo "
          f"rows and shard decision per level {json.dumps(r0['halos'])} "
          f"{json.dumps(r0['sharded'])}; per rank build ms "
          f"{[round(r['build_ms'], 3) for r in ranks]}, bytes staged "
          f"through the host {[r['staged_bytes'] for r in ranks]}, mip "
          f"launches {[r['mip'] for r in ranks]}, dense-march launches "
          f"(the brick-sharded light volume) {[r['dense'] for r in ranks]}, "
          f"dense-taps launches {[r['taps'] for r in ranks]}; path 8b "
          f"{time.perf_counter() - t0:.1f} s")
    h.say("8b sharded against unsharded on rank 0: light volume "
          + json.dumps(r0["light_volume"]) + f" (rtol/atol {LIGHT_TOL}), "
          "radiance_mips[0] " + json.dumps(r0["radiance"])
          + f" (rtol/atol {RADIANCE_TOL})")
    if not (r0["light_volume"]["within"] and r0["radiance"]["within"]):
        fail("8b: the sharded build disagrees with the unsharded one")
    if not r0["sharded"][0]:
        fail("8b: level 0 did not shard")
    if any(r["mip"] != 2 * levels for r in ranks):
        fail("8b: a rank did not launch the mip kernel for both pyramids")
    if any(r["dense"] != 1 for r in ranks):
        fail("8b: a rank did not march its light-volume slab through the "
             "dense-march kernel once")
    if any(r["taps"] != 1 for r in ranks):
        fail("8b: a rank did not write its slab's tap table on the card "
             "(dense_kernel_taps) once")
    result["8b"] = dict(build_ms=[r["build_ms"] for r in ranks],
                        staged_bytes=[r["staged_bytes"] for r in ranks],
                        light=r0["light_volume"], radiance=r0["radiance"])

    # ---- 8c: the whole 4 x 2 mesh, 8 ranks, the grid cut ----------------
    t0 = time.perf_counter()
    ranks = ML.spawn(rank_8c, 8, dev.type, dim_c, width, height)
    r0 = ranks[0]
    h.say(f"8c the preset's 4 x 2 mesh, 8 ranks on the card: "
          f"{dim_c}^3 (cut from {dim_a}^3), {width}x{height}; per rank "
          f"(data, model) {[r['coord'] for r in ranks]}, build ms "
          f"{[round(r['build_ms'], 1) for r in ranks]}, bytes staged "
          f"{[r['staged_bytes'] for r in ranks]}, mip launches "
          f"{[r['mip'] for r in ranks]}, dense-march launches "
          f"{[r['dense'] for r in ranks]}, dense-taps launches "
          f"{[r['taps'] for r in ranks]}, camera pass ms "
          f"{[round(r['camera_ms'], 1) for r in ranks]} for rows "
          f"{ranks[0]['rows']}, torch.distributed calls in the camera pass "
          f"{[r['camera_calls'] for r in ranks]}")
    h.say("8c image gathered on rank 0 against one rank's build and render: "
          + json.dumps(r0["image"]) + f" (rtol/atol {IMAGE_TOL})")
    h.say(f"8c dryrun_multichip(8), {DRYRUN_STEPS} steps: " + json.dumps(
        {k: r0["dryrun"][k] for k in ("mesh", "losses", "image_mean")})
        + f", mip and mip_bwd launches per rank "
        f"{[r['dryrun_mip'] for r in ranks]}; path 8c "
        f"{time.perf_counter() - t0:.1f} s")
    if any(r["camera_calls"] for r in ranks):
        fail("8c: the camera pass made torch.distributed calls")
    if any(r["mip"] != 2 * r["levels"] for r in ranks):
        fail("8c: a rank did not launch the mip kernel once a level for "
             "both pyramids")
    if any(r["dense"] != 1 for r in ranks):
        fail("8c: a rank did not march its light-volume slab through the "
             "dense-march kernel once")
    if any(r["taps"] != 1 for r in ranks):
        fail("8c: a rank did not write its slab's tap table on the card "
             "(dense_kernel_taps) once")
    # each step builds both pyramids and differentiates the radiance
    # one; the field build after the steps builds both again
    dry = (2 * DRYRUN_LEVELS * (DRYRUN_STEPS + 1),
           DRYRUN_LEVELS * DRYRUN_STEPS)
    if any(tuple(r["dryrun_mip"]) != dry for r in ranks):
        fail(f"8c: dryrun_multichip(8)'s mip and mip_bwd launches "
             f"{[r['dryrun_mip'] for r in ranks]}, expected {dry} a rank")
    if r0["image"]["shape"] != (height, width, 3) or not (
            r0["image"]["finite"] and r0["image"]["within"]):
        fail("8c: the gathered image disagrees with one rank's render")
    losses = r0["dryrun"]["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and r0["dryrun"]["image_mean"] is not None):
        fail(f"8c: dryrun_multichip(8) losses {losses}")
    result["8c"] = dict(build_ms=[r["build_ms"] for r in ranks],
                        camera_ms=[r["camera_ms"] for r in ranks],
                        image=r0["image"], losses=losses,
                        seconds=max(r["seconds"] for r in ranks))
    h.say(f"path 8 took {time.perf_counter() - t8:.1f} s")
    return result


CLI_WRAPPER = """
import json, runpy
runpy.run_module("vct_tpu_torch", run_name="__main__", alter_sys=True)
from vct_tpu_torch.ops import _build
print("launches " + json.dumps(_build.launches()))
"""


def cli_path(h, out_dir, extra=()):
    """Path 9: `python -m vct_tpu_torch` as subprocesses (through a wrapper
    that runs the module as __main__ and then prints the launch counts of
    that process): render on the atrium from the bench camera under
    sponza256 at 1920x1080 (the fast path), orbit (2 frames) and debug at
    32^3 / 96x96 under the default preset; their stage reports."""
    from vct_tpu_torch.utils.image import read_png

    t9 = time.perf_counter()
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    root = pathlib.Path(__file__).resolve().parent

    def run(args):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", CLI_WRAPPER, *args,
                              *extra], cwd=root, capture_output=True,
                             text=True, timeout=CLI_S)
        if res.returncode != 0:
            fail(f"the CLI {' '.join(args[:1])} failed:\n{res.stderr[-3000:]}")
        report = [ln for ln in res.stderr.splitlines()
                  if ln.strip() and not ln.startswith("[")]
        h.say(f"python -m vct_tpu_torch {' '.join(args)}: "
              f"{time.perf_counter() - t0:.1f} s; stage report: "
              + " | ".join(" ".join(ln.split()) for ln in report))
        return json.loads(res.stdout.split("launches ", 1)[1])

    png = out_dir / "atrium.png"
    launches = run(["render", "--preset", "sponza256", "--scene", "atrium",
                    "--camera", "48,-10,0", "--yaw", "180", "--out",
                    str(png)])
    h.say("9 render launches: " + json.dumps(launches))
    h.expect(launches, ("mip", "raycast", "raycast_stream", "prepass",
                        "material", "tap", "dense_march"),
             ("binrast", "binning", "specmarch"), "CLI render")
    img = read_png(str(png))
    h.say(f"9 render wrote {png.name} {img.shape}, mean {img.mean():.3f}")
    if img.shape[:2] != (HEIGHT, WIDTH) or not img.mean() > 1.0:
        fail("9: the CLI's render is not a lit 1920x1080 image")
    small = ["--dim", "32", "--width", "96", "--height", "96"]
    run(["orbit", *small, "--frames", "2", "--out-dir",
         str(out_dir / "orbit")])
    run(["debug", *small, "--out-dir", str(out_dir / "debug")])
    wanted = [out_dir / "orbit" / f"frame_{i:03d}.png" for i in range(2)] + [
        out_dir / "debug" / f for f in (
            "voxel_mip0.png", "occupancy.png", "light_volume.png",
            "gbuffer_depth.png", "gbuffer_normal.png")]
    missing = [str(p) for p in wanted if not p.exists()]
    if missing:
        fail(f"9: the CLI did not write {missing}")
    h.say(f"path 9 took {time.perf_counter() - t9:.1f} s")


# ---- path 10: the asset path at full size -------------------------------
# scripts/bench_asset_path.py's scene: the atrium subdivided 4 times as an
# OBJ with 20 textured materials (14 PNG, 6 JPEG pages at 256^2)
ASSET_SUBDIV = 4
ASSET_TRIS = 287_232
ASSET_SAMPLES = 11_283_968     # at 256^3, 2 samples a voxel width
ASSET_REPS = 5                 # timed frames after the warm-up
ASSET_PHASES = ("load", "prepare", "build", "tables", "frame")
ASSET_KERNELS = ("mip", "binrast", "binning", "prepass", "material", "tap",
                 "dense_march")
# the build's stages that march, one dense-march launch each
MARCH_STAGES = ("light_volume", "diffuse_field", "specular_field")


def asset_path(h, dev, cfg, subdiv=ASSET_SUBDIV,
               expect_counts=(ASSET_TRIS, ASSET_SAMPLES)):
    """Path 10: vct_tpu_torch.asset_path.run on `cfg` (sponza256 at
    1920x1080): generate the OBJ, load_obj (native), prepare_scene (native
    samples), build_voxel_state, build_frame_tables and render_frame from
    the bench camera, with the counts read and set to 0 after each phase.
    Then, on the card's host at full size, the native OBJ arrays against
    the Python parser's and the native samples against numpy's (after a
    stable sort by tri_ids), bit for bit; the binning's column tier
    against its budget; the binning kernels against the plain binning
    (binning_check); each kernel of the path against its plain version
    on this scene with paths 2's and 3's tolerances; host syncs in a build
    and a frame and their device ms by stage.  Returns the main path's
    launches (load to the first frame) and the run's result.  h carries
    chip_smoke's helpers and the card's nvidia-smi line."""
    import tempfile

    from vct_tpu_torch import asset_path as AP
    from vct_tpu_torch.ops import binrast, material, mip, prepass, tap
    from vct_tpu_torch.profile_stages import stage_ms, syncs_by_stage
    from vct_tpu_torch.render import fast as F
    from vct_tpu_torch.render import renderer as R
    from vct_tpu_torch.render.voxelize import generate_surface_samples
    from vct_tpu_torch.scene.obj import load_obj

    t10 = time.perf_counter()
    phases = {}

    def on_phase(name):
        phases[name] = _build.launches()
        _build.reset_launches()

    with tempfile.TemporaryDirectory() as tmp:
        _build.reset_launches()
        res, st = AP.run(tmp, subdiv, cfg, device=dev, reps=ASSET_REPS,
                         on_phase=on_phase)
        obj_path = str(pathlib.Path(tmp) / "atrium_hi.obj")
        scene = st["scene"]
        t0 = time.perf_counter()
        py = load_obj(obj_path, backend="python")
        py_s = time.perf_counter() - t0
    h.say(f"10 on {h.card}: asset path result " + json.dumps(res))
    for name in ("load", "prepare", "build", "tables", "frame", "frames"):
        h.say(f"10 launches in {name}: " + json.dumps(phases[name]))
    main_run = {k: sum(phases[p][k] for p in ASSET_PHASES)
                for k in phases["load"]}
    h.say(f"10 on {h.card}: launches in the main path run (load to the "
          f"first frame) " + json.dumps(main_run))
    tris, samples_n = expect_counts
    if (res["tris"], res["materials"], res["textured_materials"],
            res["samples"]) != (tris, 20, 20, samples_n):
        fail(f"10: the asset scene has {res['tris']} triangles, "
             f"{res['materials']} materials ({res['textured_materials']} "
             f"textured) and {res['samples']} samples, not {tris}, 20, 20 "
             f"and {samples_n}")
    h.expect(main_run, ASSET_KERNELS, ("raycast", "specmarch", "mip_bwd"),
             "asset")
    for name in ("load", "prepare"):
        if any(phases[name].values()):
            fail(f"10: the {name} phase launched kernels")
    if not (phases["build"]["mip"] and phases["tables"]["mip"]):
        fail("10: the build or the tables launched no mip")
    if phases["frame"]["binrast"] != 1 or phases["frame"]["tap"] != 1:
        fail("10: the frame must launch binrast and tap once each")
    if phases["frame"]["binning"] != BINNING_LAUNCHES:
        fail(f"10: the frame launched {phases['frame']['binning']} binning "
             f"kernels, not {BINNING_LAUNCHES} (pack 1, bin 8)")
    if phases["build"]["dense_march"] != len(MARCH_STAGES):
        fail(f"10: the build launched the dense march "
             f"{phases['build']['dense_march']} times, not "
             f"{len(MARCH_STAGES)}")
    h.check_image(st["img"], "asset path", (cfg.render.width,
                                            cfg.render.height))
    h.say(f"10 image: finite, mean {res['image_mean']:.6f}")

    # the native routes against the plain ones on this host, full size
    for name in ("positions", "uvs", "normals", "indices", "tri_material"):
        if not np.array_equal(getattr(scene, name), getattr(py, name)):
            fail(f"10: the native OBJ parse differs from the Python one in "
                 f"{name}")
    if [m.name for m in scene.materials] != [m.name for m in py.materials]:
        fail("10: the native and Python parses name other materials")
    del py
    vws = cfg.grid.voxel_world_size
    spw = cfg.voxelize.samples_per_voxel_width
    t0 = time.perf_counter()
    nat = generate_surface_samples(scene, vws, spw)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    npy = generate_surface_samples(scene, vws, spw, backend="python")
    npy_s = time.perf_counter() - t0
    on, op = (np.argsort(s.tri_ids, kind="stable") for s in (nat, npy))
    for name in ("positions", "normals", "uvs", "material_ids", "tri_ids"):
        if not np.array_equal(getattr(nat, name)[on],
                              getattr(npy, name)[op]):
            fail(f"10: the native samples differ from numpy's in {name}")
    if not np.array_equal(st["samples"].positions.cpu().numpy(),
                          nat.positions):
        fail("10: prepare_scene's samples are not the native generator's")
    h.say(f"10 on this host: native OBJ arrays bit-equal to the Python "
          f"parser's ({py_s:.3f} s against the native "
          f"{res['obj_load_split']['geometry_parse_s']:.3f} s); native "
          f"samples ({nat.count}, {nat_s:.3f} s) bit-equal to numpy's "
          f"({npy_s:.3f} s) after a stable sort by tri_ids")
    del nat, npy, on, op

    # the frame's own inputs, as render_frame makes them
    ds, mats, tables = st["ds"], st["mats"], st["tables"]
    width, height = cfg.render.width, cfg.render.height
    hp, wp = -(-height // F.TSY) * F.TSY, -(-width // 64) * 64
    dimg = F._pad_edge(st["dirs"], hp, wp)
    d = F._tile_order(dimg, hp, wp).contiguous()
    origin = st["origins"].reshape(-1, 3)[0].contiguous()
    rows, attrs = binrast.pack_rows(ds, origin, mats.albedo, mats.specular,
                                    mats.shininess)
    scal, table, n_col = binrast.bin_triangles(ds, origin, d, dimg, rows)
    nb_col = binrast._budgets(ds.v0.shape[0])[1]
    h.say(f"10 binning at {ds.v0.shape[0]} triangles: {scal.shape[1]} "
          f"strips, table {table.shape[0]} rows; column tier {int(n_col)} "
          f"of its budget {nb_col}")
    if int(n_col) > nb_col:
        fail("10: the column tier overflowed its budget: geometry was "
             "dropped")
    binning_check(h, dev, cfg, scene, ds, mats, (origin, d, dimg),
                  stable=tris == ASSET_TRIS)

    # binrast: hit, material and the winners' rows exact, t and u, v
    # within 1e-6, every column within 1e-4 (path 3)
    gb_k = binrast.raycast_binned_cuda(d, origin, scal, table, attrs)
    o8_p = binrast.raycast_binned_plain(d, scal, table)
    gb_p = binrast.finish_binned(d, origin, o8_p, attrs)
    hit = o8_p[:, 4] > 0.5
    exact = all(torch.equal(gb_k[:, c], gb_p[:, c])
                for c in (slice(19, 20), slice(17, 18), slice(6, 9),
                          slice(20, 28)))
    t_rel = float(((gb_k[:, 18] - gb_p[:, 18]).abs()
                   / gb_p[:, 18].abs().clamp_min(1.0))[hit].max())
    uv_err = h.maxerr(gb_k[:, 15:17], gb_p[:, 15:17])
    b_err = h.maxerr(gb_k, gb_p)
    h.say(f"10 binrast against its plain version: hit, material, winners' "
          f"rows exact {exact}, t rel {t_rel:.3e}, u/v {uv_err:.3e} "
          f"(tolerance 1e-6), max error {b_err:.3e} (tolerance 1e-4); hit "
          f"fraction {float(hit.float().mean()):.6f}")
    if not (exact and max(t_rel, uv_err) <= 1e-6 and b_err <= 1e-4):
        fail("10: the binned raycast disagrees with its plain version")
    del o8_p, gb_p, table, rows

    # the alpha re-cast: the MTL has no map_d and every page is opaque
    maskable = F._maskable(mats, cfg.render.alpha_threshold)
    n_cand = int(F._candidates(gb_k, maskable).sum())
    h.say(f"10 alpha re-cast: {int(maskable.sum())} maskable materials, "
          f"{n_cand} candidate pixels; streamed-raycast launches in the "
          f"frame {phases['frame']['raycast_stream']}")
    if (n_cand == 0) != (phases["frame"]["raycast_stream"] == 0):
        fail("10: the streamed raycast launched without candidates, or "
             "not with them")
    g = F.alpha_resolve(cfg, ds, mats, gb_k, d, origin)

    # prepass and material on the frame's G-buffer, bit for bit (path 2)
    pages = tables.atlas_pages
    pres = material.pages_resolution(pages)
    pkw = dict(light_dims=tuple(m.shape[0] for m in tables.light_mips),
               field_dims=tuple(m.shape[0] for m in tables.field_mips),
               voxel=vws, world_size=cfg.grid.world_size,
               shadow_offset=cfg.shadow.normal_offset,
               atlas=prepass.AtlasShape(pages.shape[0], pres,
                                        pres.bit_length()))
    outs = prepass.prepass_cuda(g, **pkw)
    plains = prepass.prepass_plain(g, **pkw)
    same = [torch.equal(a, b) for a, b in zip(outs, plains)]
    per_tile = plains[1][:, 0]
    h.say(f"10 prepass ({g.shape[0] // tap.TILE} tiles, {pages.shape[0]} "
          f"atlas pages): scal8, mscal, mlists, mslots bit-equal {same}; "
          f"materials a tile: max {int(per_tile.max())}, "
          f"{int((per_tile > 8).sum())} tiles above 8, "
          f"{int((per_tile == prepass.NSLOT).sum())} at the {prepass.NSLOT}-"
          f"slot limit")
    if not all(same):
        fail("10: the prepass differs from its plain version")
    scal8, mscal, mlists, mslots = outs
    m_err = h.maxerr(material.material_cuda(g, mslots, mscal, mlists, pages,
                                            pres),
                     material.material_plain(g, mslots, mscal, mlists, pages,
                                             pres))
    h.say(f"10 material: max error {m_err:.3e} (expected 0)")
    if m_err != 0.0:
        fail("10: the material kernel is not bit-equal to its plain version")

    # tap at the frame's prepass levels (path 2)
    nb = cfg.cones.field_basis
    tkw = dict(cfield=8 * nb, nb=nb, world_size=cfg.grid.world_size,
               voxel=vws, shadow_offset=cfg.shadow.normal_offset,
               power_diffuse=int(cfg.cones.basis_power_diffuse),
               power_specular=int(cfg.cones.basis_power_specular),
               cones_static=F._cones_static(cfg))
    bumpn = torch.cat([g[:, 3:6], torch.zeros_like(g[:, :1])],
                      dim=1).contiguous()
    targs = (g, scal8, bumpn, st["cam"], tables.light_mips,
             tables.field_mips)
    t_err = h.maxerr(tap.tap_cuda(*targs, **tkw), tap.tap_plain(*targs, **tkw))
    h.say(f"10 tap: max error {t_err:.3e} (tolerance 1e-4)")
    if not t_err <= 1e-4:
        fail("10: the tap kernel disagrees with its plain version")
    del g, gb_k, outs, plains, targs, bumpn

    # mip at each level of the build's own pyramids (path 5)
    voxels = st["voxels"]
    mip_err = 0.0
    for mips, mode in ((voxels.unlit_mips, "max"),
                       (voxels.radiance_mips, "mean")):
        for fine, coarse in zip(mips, mips[1:]):
            plain = mip.downsample2x_plain(fine, mode)
            mip_err = max(mip_err, h.maxerr(mip.downsample2x_cuda(fine, mode),
                                            plain), h.maxerr(coarse, plain))
    h.say(f"10 mip at the build's pyramids ({voxels.radiance_mips[0].shape}"
          f" to 1^3, max and mean): max error {mip_err:.3e} (tolerance "
          f"1e-6)")
    if not mip_err <= 1e-6:
        fail("10: the mip kernel disagrees with its plain version")

    # host syncs in a build and a frame, by stage
    samples = st["samples"]
    syncs = {"build": syncs_by_stage(lambda: R.build_voxel_state(
        cfg, samples, mats)),
             "frame": syncs_by_stage(lambda: F.render_frame(
                 cfg, ds, tables, mats, st["origins"], st["dirs"],
                 st["cam"]))}
    res["syncs"] = {k: sum(v.values()) for k, v in syncs.items()}
    march_syncs = {k: syncs["build"].get(k, 0) for k in MARCH_STAGES}
    h.say(f"10 on {h.card}: host syncs by stage " + json.dumps(syncs)
          + f"; the build's {res['syncs']['build']} in all, its marches' "
          + json.dumps(march_syncs) + " (one tap table a march, copied "
          "through pinned memory)")
    if any(march_syncs.values()):
        fail("10: a dense march synchronized the host")
    # device ms by stage: the build once after a warm-up, the frame's
    # medians of 3
    for what, fn, reps in (
            ("build", lambda: R.build_voxel_state(cfg, samples, mats), 1),
            ("frame", lambda: F.render_frame(cfg, ds, tables, mats,
                                             st["origins"], st["dirs"],
                                             st["cam"]), 3)):
        per, totals = stage_ms(fn, reps)
        res[f"{what}_stages_ms"] = per
        h.say(f"10 on {h.card}: {what} stages, device ms "
              + json.dumps({k: round(v, 4) for k, v in per.items()})
              + f"; total {totals}")
    res["path_s"] = time.perf_counter() - t10
    h.say(f"path 10 took {res['path_s']:.1f} s")
    return main_run, res


# path 10's binning check: three poses of vctbench's walk (walk.json's
# paths under this seed, these steps) beside the bench camera
BIN_WALK_SEED = 2200000022
BIN_WALK_STEPS = (0, 50, 100)


def binning_check(h, dev, cfg, scene, ds, mats, bench_inputs, stable=True):
    """Path 10: csrc/binning.cu (binrast.pack_rows_cuda,
    bin_triangles_cuda) against pack_rows_plain and bin_triangles_plain on
    the same CUDA tensors: isect, attrs, scal, table and n_col_total equal
    bit for bit (torch.equal, dtypes included) on `ds` at the bench camera
    (`bench_inputs`: origin, tile-major rays, padded ray image) and at
    three poses of vctbench's walk (BIN_WALK_SEED, BIN_WALK_STEPS, its
    rays as vctbench makes them), then on `scene` subdivided once more at
    the bench camera and the first walk pose; with `stable`, that scene
    must reach 2**19 triangles, the stable sort's branch, whose unused
    slots carry real triangle ids into the table's padding rows."""
    from vct_tpu_torch.ops import binrast
    from vct_tpu_torch.render import fast as F
    from vct_tpu_torch.render.gbuffer import DeviceScene
    from vct_tpu_torch.scene.mesh import subdivide_scene
    from vctbench.inputs import traffic

    width, height = cfg.render.width, cfg.render.height
    hp, wp = -(-height // F.TSY) * F.TSY, -(-width // 64) * 64
    mix = json.loads((pathlib.Path(__file__).resolve().parent / "vctbench"
                      / "traffic" / "walk.json").read_text())
    maker = traffic.RayMaker(width, height, cfg.render.fov_degrees, dev)
    basis = maker.basis(traffic.make_paths(mix, BIN_WALK_SEED,
                                           max(BIN_WALK_STEPS) + 1))
    poses = [("bench camera", bench_inputs)]
    for step in BIN_WALK_STEPS:
        origins, dirs, _ = maker.rays(basis[step])
        dimg = F._pad_edge(dirs, hp, wp)
        poses.append((f"walk step {step}",
                      (origins.reshape(-1, 3)[0].contiguous(),
                       F._tile_order(dimg, hp, wp).contiguous(), dimg)))
    consts = (mats.albedo, mats.specular, mats.shininess)

    def case(q, what, inputs):
        origin, d, dimg = inputs
        isect, attrs = binrast.pack_rows_plain(q, origin, *consts)
        packed = binrast.pack_rows_cuda(q, origin, *consts)
        plain = binrast.bin_triangles_plain(q, origin, d, dimg, isect)
        kern = binrast.bin_triangles_cuda(q, origin, d, dimg, isect)
        same = {k: a.dtype == b.dtype and torch.equal(a, b)
                for k, a, b in zip(("isect", "attrs", "scal", "table",
                                    "n_col_total"), (*packed, *kern),
                                   (isect, attrs, *plain))}
        h.say(f"10 binning kernels at {q.v0.shape[0]} triangles, {what}: "
              f"bit-equal to the plain versions {json.dumps(same)}; table "
              f"{plain[1].shape[0]} rows, column tier {int(plain[2])}")
        if not all(same.values()):
            fail(f"10: the binning kernels differ from the plain binning at "
                 f"{q.v0.shape[0]} triangles, {what}")

    for what, inputs in poses:
        case(ds, what, inputs)
    big = DeviceScene.from_scene(subdivide_scene(scene, 1), device=dev)
    if stable and big.v0.shape[0] < 1 << 19:
        fail(f"10: {big.v0.shape[0]} triangles do not reach the stable "
             f"sort's 2**19")
    for what, inputs in poses[:2]:
        case(big, what, inputs)


# ---- path 11: the operating point, bench and fidelity gate --------------
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "frame_ms_1080p",
              "fps_1080p", "fast_path", "frame_tris", "raycast_ms",
              "march_achieved_gbps", "peak_gbps", "march_mxu_util",
              "build_ms", "device", "power_limit_w")
FIDELITY_KEYS = ("diffuse_field128_rel_rms",
                 "specular_percone_kernel_rel_rms", "image_field_rel_rms",
                 "image_exact_specular_rel_rms",
                 "specular_field128_rel_rms")
BENCH_TIMES = ("value", "vs_baseline", "frame_ms_1080p", "fps_1080p",
               "raycast_ms", "march_achieved_gbps", "peak_gbps", "build_ms",
               "power_limit_w")


def operating_point_path(h, dev, dim=256, size=(WIDTH, HEIGHT), subdiv=4,
                         reps=5, expect_tris=ASSET_TRIS, fid_cfg=None,
                         fid_size=(480, 272)):
    """Path 11: 11a vct_tpu_torch.bench.run at bench.py's defaults (256^3
    float32, 1920x1080, the atrium subdivided 4 times, 5 reps, and the
    preset's bf16 build), its JSON printed and every bench.py key held
    present (the times finite and positive on the card); 11b
    vct_tpu_torch.fidelity.run at tests/test_fidelity.py's settings
    (fidelity.GATE_SETTINGS: 1,024 pixels, df 128, every stage; preset
    sponza256 on the atrium, 480x272), failing unless every GATE bound
    holds; counts set to 0 before each and read after.  Then, on 11b's
    own inputs, the whole-table raycast's G-buffer against raycast_plain
    (path 2's tolerances) and the specular march of the pass against
    spec_march_plain (path 4's, 1e-5), the pass's own output against the
    kernel's.  Returns (the launches of 11a plus 11b, the results)."""
    from vct_tpu_torch import bench
    from vct_tpu_torch import fidelity as FI
    from vct_tpu_torch.ops import raycast, specmarch
    from vct_tpu_torch.render import fast as F

    t11 = time.perf_counter()
    _build.reset_launches()
    res_a = bench.run(dim=dim, width=size[0], height=size[1],
                      subdiv=subdiv, reps=reps, device=dev)
    launches_a = _build.launches()
    h.say(f"11a on {h.card}: vct_tpu_torch.bench " + json.dumps(res_a))
    h.say("11a launches: " + json.dumps(launches_a))
    missing = [k for k in BENCH_KEYS if k not in res_a]
    if missing:
        fail(f"11a: the bench result lacks {missing}")
    if (res_a["frame_tris"], res_a["fast_path"]) != (expect_tris, True):
        fail(f"11a: the frame has {res_a['frame_tris']} triangles (fast "
             f"path {res_a['fast_path']}), not {expect_tris} on the fast "
             f"path")
    if dev.type == "cuda" and not all(
            isinstance(res_a[k], float) and 0 < res_a[k] < float("inf")
            for k in BENCH_TIMES):
        fail("11a: a bench figure is missing, not finite or not positive")
    h.expect(launches_a, ("mip", "binrast", "binning", "prepass",
                          "material", "raycast_stream", "tap", "dense_march"),
             ("specmarch", "mip_bwd"), "bench")
    # the dense march: 3 launches a sponza256 build (the light volume and
    # both fields) over bench.run's 2 x (1 + reps) builds, and the
    # diffuse march alone 1 + reps times (its timed calls and the call
    # that counts its steps)
    builds = 2 * (1 + reps)
    if launches_a["dense_march"] != 3 * builds + reps + 1:
        fail(f"11a: {launches_a['dense_march']} dense-march launches, not 3 "
             f"a build over {builds} builds and {reps + 1} lone marches")
    h.say(f"11a dense-march launches {launches_a['dense_march']}: 3 a "
          f"sponza256 build over {builds} builds, and {reps + 1} lone "
          f"diffuse marches")
    t11b = time.perf_counter()

    _build.reset_launches()
    rec, st = FI.run(fid_cfg, size=fid_size, device=dev, **FI.GATE_SETTINGS)
    launches_b = _build.launches()
    h.say(f"11b on {h.card}: vct_tpu_torch.fidelity " + json.dumps(rec))
    h.say("11b launches: " + json.dumps(launches_b))
    broken = FI.gate_failures(rec)
    h.say("11b tests/test_fidelity.py's bounds: " + json.dumps(FI.GATE)
          + (" all hold" if not broken else " broken: " + "; ".join(broken)))
    if broken:
        fail("11b: the fidelity gate failed: " + "; ".join(broken))
    h.expect(launches_b, ("mip", "raycast", "prepass", "tap", "specmarch",
                          "dense_march"), ("binrast", "binning", "mip_bwd"),
             "fidelity")

    # 11b's own inputs: its G-buffer and its specular pass
    prim, arrays = st["prim"], st["arrays"]
    g_p = raycast.raycast_plain(prim["d"], prim["origin"], prim["isect"],
                                prim["attrs"])
    rc_err = h.raycast_equal(prim["g"], g_p, "11b fidelity")
    cfg = st["cfg"]
    pages, *pin = arrays["spec_inputs"]
    start4, refl4, step_lv, weights, perm = F.spec_march_inputs(cfg, pages,
                                                                *pin)
    mkw = dict(world_size=cfg.grid.world_size, max_alpha=cfg.cones.max_alpha)
    so_k = specmarch.spec_march_cuda(start4, refl4, step_lv, weights, pages,
                                     **mkw)
    so_p = specmarch.spec_march_plain(start4, refl4, step_lv, weights, pages,
                                      **mkw)
    sm_err = h.maxerr(so_k, so_p)
    same = torch.equal(arrays["spec_pass"][perm], so_k)
    h.say(f"11b specular march on the pass's {so_k.shape[0]} pixels: max "
          f"error against spec_march_plain {sm_err:.3e} (tolerance 1e-5); "
          f"the pass's output is the kernel's {same}")
    if not (sm_err <= 1e-5 and same):
        fail("11b: the specular march disagrees with its plain version")
    launches = {k: launches_a[k] + launches_b[k] for k in launches_a}
    res = dict(bench=res_a, fidelity=rec, raycast_err=rc_err,
               specmarch_err=sm_err, a_s=t11b - t11,
               b_s=time.perf_counter() - t11b,
               path_s=time.perf_counter() - t11)
    h.say(f"11 launches (a + b): {json.dumps(launches)}; path 11 took "
          f"{res['path_s']:.1f} s (11a {res['a_s']:.1f}, 11b "
          f"{res['b_s']:.1f})")
    return launches, res


ENTRY_BOUNDS = (1e-4, 1e-3)   # (mean, p99): test_torch_oracle.py's render_rays


def scaling_path(h, dev, settings=None, counts=None):
    """Path 12: vct_tpu_torch.bench_scaling.run, strong and weak, at
    bench_scaling.py's defaults (64^3 float32, 512x512, the Cornell box
    from (3, 2, 140), counts 1, 2, 4, 8, 3 reps), each count's ranks
    spawned on the card over gloo; then vct_tpu_torch.entry.entry()'s
    forward once on the card and on the CPU.  Fails unless every
    record's rays and cone samples equal bench_scaling.py's formulas
    (:140, :173, written out here), the camera pass makes no
    torch.distributed call, each rank's build launches mip twice a level
    (both pyramids), the dense march is launched 3 times a rank's build
    and once a timed march (bench_scaling's count), no rank launches
    another kernel, at 2 ranks the
    gathered march slabs equal one rank's march bit for bit, and the
    entry image is finite and within test_torch_oracle.py's render_rays
    bounds of its CPU run.  Returns (the launches of the path: the
    ranks' summed over every record, plus entry()'s in this process,
    the results)."""
    from vct_tpu_torch import bench_scaling as BS
    from vct_tpu_torch import entry as E
    from vct_tpu_torch.core import dense as D
    from vct_tpu_torch.ops import dense as OD
    from vct_tpu_torch.render import shading

    t12 = time.perf_counter()
    settings = settings or BS.Settings()
    counts = counts or BS.COUNTS
    cfg = BS.config(settings.dim, settings.width, settings.height)
    steps = shading.diffuse_schedule(cfg).num_steps
    nb = D.direction_basis(cfg.cones.field_basis).shape[0]
    levels = cfg.grid.num_levels - 1
    _build.reset_launches()
    launches = _build.launches()
    records = {}
    for mode in BS.MODES:
        t0 = time.perf_counter()
        recs = BS.run(counts, mode, dev, settings, check=(2,))
        records[mode] = recs
        for rec in recs:
            n = rec["devices"]
            h.say(f"12 {mode} n={n}: " + json.dumps(rec))
            rows = settings.height * n if mode == "weak" else settings.height
            dirs = nb * n if mode == "weak" else nb
            want = (settings.width * rows, dirs * steps * settings.dim ** 3)
            if (rec["rays"], rec["cone_samples"]) != want:
                fail(f"12 {mode} n={n}: work {rec['rays']}, "
                     f"{rec['cone_samples']}, expected {want}")
            if rec["collective_calls"] != 0:
                fail(f"12 {mode} n={n}: the camera pass made "
                     f"{rec['collective_calls']} torch.distributed calls")
            if rec["levels"] != levels or rec["mip_launches"] != [
                    2 * levels] * n:
                fail(f"12 {mode} n={n}: mip launches a rank "
                     f"{rec['mip_launches']}, expected {2 * levels} (2 x "
                     f"{levels} levels)")
            others = {k: v for k, v in rec["launches"].items()
                      if k not in ("mip", "dense_march", "dense_pack",
                                   "dense_taps") and v}
            if others:
                fail(f"12 {mode} n={n}: the ranks launched {others}")
            # the dense march: 3 a rank's build, one a timed march call
            # (1 + reps a rank), one for the 2-rank check on rank 0, and
            # weak mode's one-rank control on rank 0 (1 + reps)
            marches = (n * (3 + 1 + settings.reps) + (n == 2)
                       + (1 + settings.reps) * (mode == "weak" and n > 1))
            if rec["launches"]["dense_march"] != marches:
                fail(f"12 {mode} n={n}: dense-march launches "
                     f"{rec['launches']['dense_march']}, expected {marches}")
            # each march's tap table written on the card, sharded or not:
            # one launch for each of a build's 3 marches, one for each
            # MAX_TAP_DIRECTIONS of the timed and checked marches' dirs
            taps = 3 * n + -(-dirs // OD.MAX_TAP_DIRECTIONS) * (marches
                                                                - 3 * n)
            if rec["launches"]["dense_taps"] != taps:
                fail(f"12 {mode} n={n}: dense-taps launches "
                     f"{rec['launches']['dense_taps']}, expected {taps}")
            if not all(0 < rec[k] < float("inf") for k in (
                    "rays_per_s", "cone_samples_per_s")):
                fail(f"12 {mode} n={n}: a throughput is not finite")
            if n == 2:
                chk = rec["march_check"]
                if not chk["bit_equal"]:
                    fail(f"12 {mode} n=2: the gathered march slabs differ "
                         f"from one rank's march, max_abs_err "
                         f"{chk['max_abs_err']:.3e}")
            for k in launches:
                launches[k] += rec["launches"].get(k, 0)
        h.say(f"12 {mode}: {[r['devices'] for r in recs]} ranks in "
              f"{time.perf_counter() - t0:.1f} s")

    # ---- entry(): the forward step on the card against the CPU ---------
    t0 = time.perf_counter()
    forward, args = E.entry(device=dev)
    img = forward(*args)
    h.sync()
    entry_launches = _build.launches()
    forward_c, args_c = E.entry(device="cpu")
    ref = forward_c(*args_c)
    err = (img.cpu() - ref).abs().flatten()
    mean, p99 = float(err.mean()), float(torch.quantile(err, 0.99))
    h.say(f"12 entry(): image {tuple(img.shape)}, finite "
          f"{bool(torch.isfinite(img).all())}, mean {float(img.mean()):.6f}; "
          f"against its CPU run mean {mean:.3e}, p99 {p99:.3e}, max "
          f"{float(err.max()):.3e} (bounds {ENTRY_BOUNDS}); launches "
          + json.dumps(entry_launches) + f"; {time.perf_counter() - t0:.1f} s")
    entry_levels = E.DIM.bit_length() - 1      # 32 -> 1: 5 downsamples
    entry_cones = 2 * -(-E.WIDTH * E.HEIGHT // E.CHUNK)
    if entry_launches["mip"] != 2 * entry_levels or entry_launches[
            "dense_march"] != 1 or entry_launches["percone"] != entry_cones \
            or any(v for k, v in entry_launches.items()
                   if k not in ("mip", "dense_march", "dense_pack",
                                "dense_taps", "percone")):
        fail(f"12 entry(): launches {entry_launches}, expected mip "
             f"{2 * entry_levels}, dense_march 1 (the light volume), "
             f"percone {entry_cones} (diffuse and specular a chunk) and no "
             f"other kernel")
    if not (img.shape == (E.HEIGHT, E.WIDTH, 3)
            and bool(torch.isfinite(img).all())
            and mean < ENTRY_BOUNDS[0] and p99 < ENTRY_BOUNDS[1]):
        fail("12 entry(): the image is not its CPU run's")
    for k in launches:
        launches[k] += entry_launches[k]
    res = dict(records=records, entry=dict(mean=mean, p99=p99),
               path_s=time.perf_counter() - t12)
    h.say(f"12 launches: {json.dumps(launches)}; path 12 took "
          f"{res['path_s']:.1f} s")
    return launches, res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from vct_tpu_torch.config import preset
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.core import cones as C
    from vct_tpu_torch.core import grid as G
    from vct_tpu_torch.ops import (binrast, material, mip, prepass,
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
    from vct_tpu_torch.utils.profiling import card_line

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
            ("material", "vct_material_occupancy", ()),
            ("dense march, field", "vct_dense_occupancy", (0,)),
            ("dense march, transmittance", "vct_dense_occupancy", (1,)),
            ("per-cone march, 6 cones", "vct_percone_occupancy", (6,)),
            ("per-cone march, 1 cone", "vct_percone_occupancy", (1,))):
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
        _build.reset_launches()
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
        return (_build.launches(), first_s,
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
    expect(launches, ("mip", "raycast", "prepass", "tap", "dense_march"),
           ("material", "raycast_stream", "binrast", "binning", "specmarch"),
           "Cornell")
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
                      "raycast_stream", "dense_march"),
           ("binrast", "binning", "specmarch"), "atrium")
    if launches["dense_march"] != 3:
        fail(f"the sponza256 build launched the dense march "
             f"{launches['dense_march']} times, not 3 (the light volume "
             f"and both fields)")
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

    # the dense march at the operating point's three shapes, on path 2's
    # own pyramids
    dense_path(types.SimpleNamespace(say=say, maxerr=maxerr,
                                     kernel_row=kernel_row), cfg,
               p["voxels"])

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
    expect(launches3, ("mip", "prepass", "tap", "material", "binrast",
                       "binning", "dense_march")
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

    # binning's row: pack_rows and bin_triangles at the bench camera; its
    # bound counts what they must read once (the rays, each triangle's
    # rows) and write once (isect, attrs, scal, the table)
    row_launches["binning"] = launches3["binning"]
    t3 = ds_hi.v0.shape[0]
    mkw = (m3.albedo, m3.specular, m3.shininess)
    ik, ak = binrast.pack_rows_cuda(ds_hi, origin3, *mkw)
    ip, ap = binrast.pack_rows_plain(ds_hi, origin3, *mkw)
    kern = binrast.bin_triangles_cuda(ds_hi, origin3, d3, dimg3, ip)
    plain = binrast.bin_triangles_plain(ds_hi, origin3, d3, dimg3, ip)
    bin_err = max(maxerr(a, b) for a, b in zip((ik, ak, *kern),
                                                (ip, ap, *plain)))
    bin_bytes = (d3.numel() * 4 + t3 * TRI_INPUT_BYTES
                 + t3 * (raycast.NISECT + raycast.NATTR) * 4
                 + scal3.numel() * 4 + table3.numel() * 4)
    kernel_row("binning", "vct_tpu_torch/ops/csrc/binning.cu",
               "none (XLA: vct_tpu/ops/binrast_pallas.py:128-275)", bin_err,
               0.0, elapsed_ms(lambda: binrast.bin_triangles_cuda(
                   ds_hi, origin3, d3, dimg3,
                   binrast.pack_rows_cuda(ds_hi, origin3, *mkw)[0]),
                   KERNEL_REPS, KERNEL_BATCH),
               elapsed_ms(lambda: binrast.bin_triangles_plain(
                   ds_hi, origin3, d3, dimg3,
                   binrast.pack_rows_plain(ds_hi, origin3, *mkw)[0]),
                   PLAIN_REPS),
               bin_bytes, 0)
    del ik, ak, ip, ap, kern, plain
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
                       "raycast_stream", "specmarch", "dense_march"),
           ("binrast", "binning"), "exact-specular")
    if launches4["dense_march"] != 2:
        fail("the exact-specular build must march the light volume and the "
             "diffuse field, one launch each")
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
    # kernel, the frame the per-cone march kernel twice a chunk (its
    # raycast is plain PyTorch, as it is XLA in the JAX package)
    del p4, t4, margs
    ocfg = preset("cornell64_full")
    osize = (ocfg.render.width, ocfg.render.height)
    ocam = CAM.Camera(**ORACLE_CAMERA)
    not_oracle = ("raycast", "raycast_stream", "binrast", "binning",
                  "prepass", "material", "tap", "specmarch")

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
        expect(launches_, ("mip", "dense_march", "percone"), not_oracle,
               what)
        want = percone_launches(run_cfg, run_cfg.render.width
                                * run_cfg.render.height)
        if launches_["percone"] != want:
            fail(f"{what}: per-cone march launches {launches_['percone']}, "
                 f"expected {want}")
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
    say(f"cornell64_full render_camera_pass (render_rays, chunks of {CHUNK}) "
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
                          p5["dirs"], p5["cam"], chunk_size=CHUNK)
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
        say=say, expect=expect, maxerr=maxerr, elapsed_ms=elapsed_ms,
        kernel_row=kernel_row,
        row_launches=row_launches, sync=sync), preset("inverse"), dev)
    say(f"path 6 took {time.perf_counter() - t6:.1f} s")

    # ---- (c7) the shadow map and the anisotropic mips -------------------
    r7 = map_aniso_path(types.SimpleNamespace(
        say=say, expect=expect, maxerr=maxerr, check_image=check_image,
        sync=sync, raycast_equal=raycast_equal, small_check=small_check,
        kernel_row=kernel_row, row_launches=row_launches), dev)

    # ---- (c8) parallel/: preset multihost512 --------------------------
    hp8 = types.SimpleNamespace(
        say=say, expect=expect, maxerr=maxerr, check_image=check_image,
        sync=sync, card=card)
    r8 = multihost_path(hp8, dev)

    # ---- (c9) the CLI -------------------------------------------------
    cli_path(hp8, pathlib.Path(__file__).resolve().parent / "chiprun_out"
             / "cli")

    # ---- (c10) the asset path at full size ------------------------------
    launches10, r10 = asset_path(hp8, dev, cfg)
    for row in report:
        row["launches_path10"] = launches10[row["name"]]
    split10 = {**r10["obj_load_split"], **r10["prepare_scene_split"]}
    say(f"path 10 on {card}: generate {r10['generate_s']:.3f} s, load "
        f"{r10['obj_load_s']:.3f} s, prepare {r10['prepare_scene_s']:.3f} s, "
        f"build {r10['voxel_build_s']:.3f} s, tables "
        f"{r10['frame_tables_s']:.3f} s, frame ms "
        + json.dumps(r10["frame_ms"]) + "; split (s) " + json.dumps(split10)
        + "; peak over held (GiB) " + json.dumps(r10["peak_over_held_gib"])
        + "; host syncs " + json.dumps(r10["syncs"]) + "; launches "
        + json.dumps(launches10) + f"; image mean {r10['image_mean']:.6f}; "
        f"{r10['path_s']:.1f} s")

    # ---- (c11) the operating point: bench and the fidelity gate ---------
    launches11, r11 = operating_point_path(
        types.SimpleNamespace(**vars(hp8), raycast_equal=raycast_equal), dev)
    for row in report:
        row["launches_path11"] = launches11[row["name"]]
    b11, f11 = r11["bench"], r11["fidelity"]
    say(f"path 11 on {card}: {b11['value']:.4e} cone samples/s "
        f"(vs_baseline {b11['vs_baseline']:.4f}), build ms "
        f"{b11['build_ms']:.3f} float32 and "
        f"{b11['build_ms_bf16']['median']:.3f} bf16, frame ms "
        + json.dumps(b11["frame_ms"]) + f", raycast ms "
        f"{b11['raycast_ms']:.4f}, march {b11['march_achieved_gbps']:.1f} "
        f"GB/s; fidelity " + json.dumps(
            {k: round(f11[k], 6) for k in FIDELITY_KEYS}))

    # ---- (c12) the scaling sweep and the forward step -------------------
    launches12, r12 = scaling_path(hp8, dev)
    for row in report:
        row["launches_path12"] = launches12[row["name"]]
    for mode, recs in r12["records"].items():
        say(f"path 12 {mode} on {card}, n ranks of one card over gloo: "
            + json.dumps([{k: r.get(k) for k in (
                "devices", "rays_per_s", "rays_scaling_efficiency",
                "cone_samples_per_s", "samples_scaling_efficiency",
                "rays_weak_overhead_efficiency",
                "samples_weak_overhead_efficiency", "t_camera_ms",
                "t_march_ms", "staged_bytes")} for r in recs]))

    say(f"path 8 on {card}: 8a build ms {r8['8a']['build_ms']:.3f}, frame "
        f"ms {r8['8a']['frame_ms']:.3f}, prepare ms "
        f"{r8['8a']['prepare_ms']:.3f}; 8b build ms per rank "
        f"{[round(x, 3) for x in r8['8b']['build_ms']]}; 8c "
        f"{r8['8c']['seconds']:.1f} s in each rank")
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
