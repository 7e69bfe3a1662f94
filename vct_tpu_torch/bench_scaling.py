"""Scaling sweep: rays/s (tile data parallelism) and cone-samples/s (the
brick-sharded dense march) against the rank count (port of
bench_scaling.py and of the timing half of scripts/scaling_attrib.py).

    python -m vct_tpu_torch.bench_scaling

Environment, as bench_scaling.py reads it: VCT_SCALING_DIM (the grid and
the field, default 64), VCT_SCALING_W and VCT_SCALING_H (the image,
512 x 512), VCT_SCALING_REPS (timed calls, 3), VCT_SCALING_MODE
("strong" or "weak") and VCT_SCALING_RECORD (the JSON file the records
merge into by mode; default chiprun_out/scaling.json, where
bench_scaling.py writes no file without it).  It needs a CUDA card and
exits non-zero without one; there is no CPU fallback.  run() does the
work; the tests call it with device="cpu".

The operating point is bench_scaling.py's (:80-112): preset sponza256
with grid.dim = field_dim = DIM and float32 dense marches, at W x H, on
the Cornell box (size 100) from (3, 2, 140).

Ranks.  Without torchrun's variables, each count n of COUNTS (1, 2, 4, 8:
bench_scaling.py:103's list cut at 8) runs in n fresh processes started
by parallel/mesh.spawn, on a gloo group, every rank on the one card where
the machine has one (then every collective on a CUDA tensor stages
through the host, parallel/comm.py, and `staged_bytes` counts it).  One
spawn serves both halves of a count.  Under torchrun
(parallel/mesh.init_distributed) the sweep spans the world's ranks, one
card each, as bench_scaling.py spans hosts; the counts above the world
size are dropped.

What each rank does, at n:
  * builds the voxel state once, untimed: tile_dp.sharded_build_fn on a
    mesh of n 'data' ranks (data_parallel n, brick_parallel 1, so the
    build is the unsharded build_voxel_state), its mip launches counted;
  * rays/s: tile_dp.sharded_camera_fn (= shardmap_camera_fn, chunk
    16384) over 'data', its torch.distributed calls counted (0 by
    construction).  Weak mode grows the image n-fold by rows;
  * cone-samples/s: the diffuse schedule's march of the field basis
    (direction_basis, tiled n times in weak mode) over the state's
    radiance pyramid: core/dense.directional_march_multi at n = 1,
    parallel/brick.sharded_directional_march_multi over a mesh of n
    'model' ranks above, which returns the rank's x-slab; on the card
    each is one launch of the dense-march kernel (csrc/dense.cu).
Each timed part: one warm-up call, then `reps` calls between two marks,
each a synchronize of the card and a barrier of the n ranks; the time is
the slowest rank's, which is what bench_scaling.py's sync() gives.

Weak mode's controls at n > 1, on rank 0 alone while the others wait at
a barrier (bench_scaling.py:175-200, scaling_attrib.py:112-121, 146):
t_ctl_ms and t_ctl_march_ms, the n-fold camera pass and march on one
rank (a 1 x 1 mesh); t_1x_ms, the 1-fold camera pass on one rank;
t_seq_ms = n * t_1x_ms, the zero-overlap serial bound; and
serialization_gap_ms = t_camera_ms - t_seq_ms.  scaling_attrib.py's
jit+sharding variant, its partitioned-HLO collective count and
reshard_cost_ms have no counterpart: PyTorch has one camera-pass form
(parallel/tile_dp.py), and `collective_calls` counts what it calls.

Records: one JSON line a count on stdout with bench_scaling.py's keys
(mode, devices, rays_per_s, rays_scaling_efficiency, cone_samples_per_s,
samples_scaling_efficiency, and in weak mode at n > 1
rays_weak_overhead_efficiency and samples_weak_overhead_efficiency),
and beside them rays and cone_samples (the work), t_camera_ms,
t_march_ms, the weak controls, collective_calls (summed over the ranks),
staged_bytes and mip_launches (a list, a rank each: each rank's build),
launches (every kernel's launches, summed over the ranks: the builds'
mip and dense-march launches and one dense-march launch a timed march,
each march with the dense-taps launch that writes its tap table; the
camera pass launches none), card (nvidia-smi's name and power
limit) and ranks_share_one_card; then a summary line.
Where the ranks share one card, the efficiencies measure that card's
ranks over gloo, not more cards: weak_overhead_efficiency, t(n-fold work
on one rank) / t(n ranks), is the column that isolates the sharding's
overhead there (bench_scaling.py:17-26).  Diagnostics go to stderr.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from vct_tpu_torch.config import VCTConfig, preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.ops import _build
from vct_tpu_torch.parallel import brick, comm
from vct_tpu_torch.parallel import mesh as ML
from vct_tpu_torch.parallel import tile_dp
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.render import shading
from vct_tpu_torch.scene.cornell import cornell_box

COUNTS = (1, 2, 4, 8)
MODES = ("strong", "weak")
CHUNK = 16384
CAMERA = dict(position=(3.0, 2.0, 140.0))     # bench_scaling.py:94
RECORD = os.path.join("chiprun_out", "scaling.json")
NOTE = ("rays and cone_samples are bench_scaling.py's work counts; "
        "*_scaling_efficiency = throughput / (n x the 1-rank throughput); "
        "*_weak_overhead_efficiency = t(n-fold work, 1 rank) / t(n "
        "ranks). t_seq = n x t(1-fold camera pass, 1 rank), "
        "scaling_attrib.py's zero-overlap serial bound; serialization_gap "
        "= t_camera - t_seq. scaling_attrib.py's jit+sharding variant and "
        "its reshard_cost have no counterpart: PyTorch has one camera-pass "
        "form, and collective_calls counts its torch.distributed calls. "
        "With ranks_share_one_card, the ranks are one card's, over gloo.")



def log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class Settings:
    """The sweep's operating point (bench_scaling.py's environment)."""

    dim: int = 64
    width: int = 512
    height: int = 512
    reps: int = 3


def config(dim: int, width: int, height: int) -> VCTConfig:
    """bench_scaling.py:87-92: sponza256 with grid.dim = field_dim = dim,
    float32 dense marches, at width x height."""
    cfg = preset("sponza256")
    return dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, dim=dim, compute="float32"),
        cones=dataclasses.replace(cfg.cones, field_dim=dim),
        render=dataclasses.replace(cfg.render, width=width, height=height))


def with_mesh(cfg: VCTConfig, n_data: int, n_model: int) -> VCTConfig:
    return dataclasses.replace(cfg, sharding=dataclasses.replace(
        cfg.sharding, data_parallel=n_data, brick_parallel=n_model))


def setup(settings: Settings = Settings(), device="cuda") -> dict:
    """bench_scaling.py:87-97 on `device`: cfg, the Cornell box prepared
    (ds, mats, samples), the camera, its 1-fold rays (origins, dirs) and
    position (cam)."""
    dev = torch.device(device)
    cfg = config(settings.dim, settings.width, settings.height)
    ds, mats, samples = R.prepare_scene(cfg, cornell_box(size=100.0),
                                        device=dev)
    camera = CAM.Camera(**CAMERA)
    origins, dirs = CAM.primary_rays(camera, settings.width,
                                     settings.height, device=dev)
    return dict(cfg=cfg, ds=ds, mats=mats, samples=samples, camera=camera,
                origins=origins, dirs=dirs,
                cam=G.constant(camera.position, dev))


def image_rows(height: int, n: int, mode: str) -> int:
    """Weak mode grows the image n-fold by rows (bench_scaling.py:116)."""
    return height * n if mode == "weak" else height


def march_basis(cfg: VCTConfig, n: int, mode: str) -> np.ndarray:
    """The field basis, tiled n times in weak mode (bench_scaling.py:
    145-147)."""
    basis = D.direction_basis(cfg.cones.field_basis)
    return np.tile(basis, (n, 1)) if mode == "weak" else basis


def work(cfg: VCTConfig, n: int, mode: str) -> tuple:
    """(rays, cone_samples) at n: bench_scaling.py:140 and :173."""
    rays = cfg.render.width * image_rows(cfg.render.height, n, mode)
    samples = (march_basis(cfg, n, mode).shape[0]
               * shading.diffuse_schedule(cfg).num_steps * cfg.grid.dim ** 3)
    return rays, samples


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mark(dev: torch.device, group) -> None:
    _sync(dev)
    if group is not None:
        dist.barrier(group=group)


def _timed(fn, reps: int, dev: torch.device, group=None):
    """(the last call's result, seconds a call): a warm-up call, then
    `reps` calls between two marks (a synchronize, and with a group a
    barrier of its ranks, so every rank leaves with the slowest)."""
    out = fn()
    _mark(dev, group)
    t0 = time.perf_counter()
    for _ in range(reps):
        del out
        out = fn()
    _mark(dev, group)
    return out, (time.perf_counter() - t0) / reps


def sweep_rank(n: int, mode: str, settings: Settings, dev_type: str,
               check: bool = False) -> Optional[dict]:
    """Count n, in each rank of the process group: the first n ranks work
    (see the module docstring), the others only join the meshes' groups
    and return None.  check: the camera pass's rows gathered on rank 0
    (under "image", None on the others), and the march slabs gathered on
    every rank and, on rank 0, held against one rank's march of the same
    basis (under "march_check": max_abs_err, bit_equal, shape)."""
    dev = torch.device(dev_type)
    rank = dist.get_rank()
    # every rank of the world takes part in making each mesh's groups
    cam_mesh = ML.make_mesh(n, 1, device_type=dev.type)
    one_mesh = ML.make_mesh(1, 1, device_type=dev.type)
    march_mesh = ML.make_mesh(1, n, device_type=dev.type) if n > 1 else None
    if rank >= n:
        return None
    group = cam_mesh.get_group("data")
    st = setup(settings, dev)
    cfg0, ds, mats, cam = st["cfg"], st["ds"], st["mats"], st["cam"]
    cfg = with_mesh(cfg0, n, 1)
    comm.STAGED_BYTES = 0
    _build.reset_launches()
    voxels = tile_dp.sharded_build_fn(cfg, cam_mesh)(st["samples"], mats)
    _sync(dev)
    out = dict(rank=rank, levels=len(voxels.radiance_mips) - 1)

    # ---- rays/s: the camera pass over 'data' ---------------------------
    h_n = image_rows(settings.height, n, mode)
    origins, dirs = CAM.primary_rays(st["camera"], settings.width, h_n,
                                     device=dev)
    render = tile_dp.shardmap_camera_fn(cfg, ds, cam_mesh, chunk_size=CHUNK)
    calls = collections.Counter()

    def camera_pass():
        with comm.count_calls() as c:
            img = render(origins, dirs, cam, voxels, mats)
        calls.update(c)
        return img

    rows, out["t_camera_s"] = _timed(camera_pass, settings.reps, dev, group)
    out.update(collective_calls=sum(calls.values()),
               rows=tuple(rows.shape))

    # ---- cone-samples/s: the march, brick-sharded over 'model' ---------
    mips = voxels.radiance_mips
    basis = march_basis(cfg0, n, mode)
    sched = shading.diffuse_schedule(cfg0)
    ws = cfg0.grid.world_size
    kw = dict(field_dim=settings.dim, max_alpha=cfg0.cones.max_alpha,
              occlusion_falloff=cfg0.cones.occlusion_falloff)

    def one_rank_march():
        return D.directional_march_multi(mips, basis, sched, ws, **kw)

    if n > 1:
        def march():
            return brick.sharded_directional_march_multi(
                mips, basis, sched, ws, march_mesh, axis_name="model", **kw)
    else:
        march = one_rank_march
    slab, out["t_march_s"] = _timed(march, settings.reps, dev, group)
    out.update(staged_bytes=comm.STAGED_BYTES, slab=tuple(slab.shape))
    if check:          # after the count: the checks' gathers stage too
        out["image"] = tile_dp.gather_rows(rows, cam_mesh)
        whole = slab if n == 1 else brick.gather_x(slab, march_mesh)
        if rank == 0:
            ref = one_rank_march()
            out["march_check"] = dict(
                max_abs_err=float((whole - ref).abs().max()),
                bit_equal=bool(torch.equal(whole, ref)),
                shape=list(whole.shape))
        del whole
    del slab, rows

    # ---- weak mode's controls: the n-fold work on one rank -------------
    if mode == "weak" and n > 1:
        if rank == 0:
            one = with_mesh(cfg0, 1, 1)
            ctl = tile_dp.shardmap_camera_fn(one, ds, one_mesh,
                                             chunk_size=CHUNK)
            _, out["t_ctl_s"] = _timed(
                lambda: ctl(origins, dirs, cam, voxels, mats),
                settings.reps, dev)
            _, out["t_1x_s"] = _timed(
                lambda: ctl(st["origins"], st["dirs"], cam, voxels, mats),
                settings.reps, dev)
            _, out["t_ctl_march_s"] = _timed(one_rank_march, settings.reps,
                                             dev)
        dist.barrier(group=group)
    # every kernel's launches since the build began (on the card the
    # build's mip and dense-march launches and the timed marches' dense
    # ones: the camera pass launches none)
    out["launches"] = _build.launches()
    return out


def sweep(n: int, mode: str, settings: Settings, device="cuda",
          check: bool = False) -> list:
    """Count n's rank results, in rank order (the first n ranks): in n
    spawned ranks, or across the world's ranks when the process group
    is already up (torchrun), where rank 0 gets the list and the others
    None."""
    dev_type = torch.device(device).type
    args = (n, mode, settings, dev_type, check)
    if not dist.is_initialized():
        return ML.spawn(sweep_rank, n, *args)
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, sweep_rank(*args))
    return got[:n] if dist.get_rank() == 0 else None


def record(mode: str, n: int, rays: int, cone_samples: int,
           t_camera_s: float, t_march_s: float, base: Optional[dict] = None,
           t_ctl_s: Optional[float] = None, t_ctl_march_s: Optional[float]
           = None, t_1x_s: Optional[float] = None) -> dict:
    """One count's record: bench_scaling.py's keys (:205-215), the work,
    the times and the weak controls.  base: the first count's record
    (its throughputs set the efficiencies; None at the first)."""
    rays_per_s = rays / t_camera_s
    samples_per_s = cone_samples / t_march_s
    r1 = base["rays_per_s"] if base else rays_per_s
    s1 = base["cone_samples_per_s"] if base else samples_per_s
    rec = {"mode": mode, "devices": n,
           "rays_per_s": rays_per_s,
           "rays_scaling_efficiency": rays_per_s / (r1 * n),
           "cone_samples_per_s": samples_per_s,
           "samples_scaling_efficiency": samples_per_s / (s1 * n)}
    if t_ctl_s is not None:
        rec["rays_weak_overhead_efficiency"] = t_ctl_s / t_camera_s
        rec["samples_weak_overhead_efficiency"] = t_ctl_march_s / t_march_s
    rec.update(rays=rays, cone_samples=cone_samples,
               t_camera_ms=t_camera_s * 1e3, t_march_ms=t_march_s * 1e3)
    if t_ctl_s is not None:
        rec.update(t_ctl_ms=t_ctl_s * 1e3, t_ctl_march_ms=t_ctl_march_s
                   * 1e3, t_1x_ms=t_1x_s * 1e3, t_seq_ms=n * t_1x_s * 1e3,
                   serialization_gap_ms=(t_camera_s - n * t_1x_s) * 1e3)
    return rec


def card(device) -> str:
    """nvidia-smi's name and power limit of the card; "cpu" on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    from vct_tpu_torch.utils.profiling import card_line
    return card_line()


def run(counts: Sequence[int] = COUNTS, mode: str = "strong",
        device="cuda", settings: Settings = Settings(),
        check: Sequence[int] = ()) -> list:
    """The sweep's records, one a count, in count order (under torchrun
    on rank 0; the other ranks get an empty list).  check: the counts at
    which the gathered march is held against one rank's (sweep_rank's
    "march_check", kept in the record)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dev = torch.device(device)
    if dev.type == "cuda":
        from vct_tpu_torch.ops import _build
        _build.library()        # built once here, loaded by every rank
    world = dist.get_world_size() if dist.is_initialized() else None
    if world is not None:
        counts = [n for n in counts if n <= world]
    shared = dev.type == "cuda" and (
        world is None and torch.cuda.device_count() == 1)
    line = card(dev)
    cfg = config(settings.dim, settings.width, settings.height)
    out = []
    for n in counts:
        t0 = time.perf_counter()
        ranks = sweep(n, mode, settings, dev, check=n in check)
        if ranks is None:
            continue
        rays, cone_samples = work(cfg, n, mode)
        r0 = ranks[0]
        rec = record(mode, n, rays, cone_samples,
                     max(r["t_camera_s"] for r in ranks),
                     max(r["t_march_s"] for r in ranks),
                     base=out[0] if out else None, t_ctl_s=r0.get("t_ctl_s"),
                     t_ctl_march_s=r0.get("t_ctl_march_s"),
                     t_1x_s=r0.get("t_1x_s"))
        rec.update(collective_calls=sum(r["collective_calls"] for r in ranks),
                   staged_bytes=[r["staged_bytes"] for r in ranks],
                   mip_launches=[r["launches"]["mip"] for r in ranks],
                   launches={k: sum(r["launches"][k] for r in ranks)
                             for k in ranks[0]["launches"]},
                   levels=r0["levels"], card=line,
                   ranks_share_one_card=shared,
                   seconds=time.perf_counter() - t0)
        if "march_check" in r0:
            rec["march_check"] = r0["march_check"]
        out.append(rec)
        log(f"n={n} [{mode}]: {rec['rays_per_s']:.4e} rays/s "
            f"({rec['t_camera_ms']:.3f} ms), {rec['cone_samples_per_s']:.4e} "
            f"cone-samples/s ({rec['t_march_ms']:.3f} ms); "
            f"{rec['seconds']:.1f} s")
    return out


def write_record(path: str, mode: str, records: list, device) -> None:
    """Merge the records into `path` under `mode` (bench_scaling.py:
    226-238), with the card beside them."""
    try:
        with open(path) as f:
            prev = json.load(f)
    except FileNotFoundError:
        prev = {}
    prev[mode] = {"records": records, "note": NOTE}
    dev = torch.device(device)
    prev["device_kind"] = (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")
    prev["num_devices"] = (torch.cuda.device_count()
                           if dev.type == "cuda" else 0)
    prev["card"] = records[0]["card"] if records else card(dev)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(prev, f, indent=1)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_scaling: CUDA is not available (no CPU fallback)",
              file=sys.stderr)
        return 1
    env = os.environ.get
    settings = Settings(dim=int(env("VCT_SCALING_DIM", "64")),
                        width=int(env("VCT_SCALING_W", "512")),
                        height=int(env("VCT_SCALING_H", "512")),
                        reps=int(env("VCT_SCALING_REPS", "3")))
    mode = env("VCT_SCALING_MODE", "strong")
    path = env("VCT_SCALING_RECORD", RECORD)
    ML.init_distributed()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, "
        + (f"{dist.get_world_size()} ranks under torchrun"
           if dist.is_initialized() else "ranks spawned on this host"))
    records = run(mode=mode, settings=settings)
    if not records:          # a rank other than 0 under torchrun
        return 0
    for rec in records:
        print(json.dumps(rec))
    last = records[-1]
    summary = {"summary": mode, "devices": [r["devices"] for r in records],
               "rays_scaling_efficiency": last["rays_scaling_efficiency"],
               "samples_scaling_efficiency":
               last["samples_scaling_efficiency"], "card": last["card"],
               "ranks_share_one_card": last["ranks_share_one_card"],
               "record": path}
    for key in ("rays_weak_overhead_efficiency",
                "samples_weak_overhead_efficiency"):
        if key in last:
            summary[key] = last[key]
    print(json.dumps(summary), flush=True)
    write_record(path, mode, records, "cuda")
    log(f"recorded -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
