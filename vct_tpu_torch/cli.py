"""CLI driver — the app layer (C1 in SURVEY.md §2.1, main.cpp:23-149);
the port of vct_tpu/cli.py, with the same subcommands, options and
output files.

The reference's interactive GLFW loop (window + WASD fly camera + per-frame
Render()) maps to offline commands over the same pipeline:

  render   one frame -> PNG                        (Render(), main.cpp:89)
  orbit    N frames around the scene -> PNGs       (the render loop; the
           voxel state builds ONCE, like the reference's init-time
           voxelization, Voxel_Cone_Tracing.h:138-139)
  debug    dump pipeline internals: voxel-mip slice montages
           (DrawVoxelTexture, Voxel_Cone_Tracing.h:213-250), the light
           volume / shadow map (DrawDepthTexture, :192-211), and G-buffer
           depth/normal views

Everything runs on the card; --cpu runs it all on the CPU instead, and
without --cpu a machine with no CUDA device raises.

Usage:
  python -m vct_tpu_torch render --preset cornell64_full --out /tmp/img.png
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _parse_vec3(s: str):
    v = tuple(float(x) for x in s.split(","))
    if len(v) != 3:
        raise argparse.ArgumentTypeError(f"need x,y,z — got {s!r}")
    return v


def _build_cfg(args):
    from vct_tpu_torch.config import preset

    cfg = preset(args.preset)
    if args.dim:
        cfg = dataclasses.replace(
            cfg, grid=dataclasses.replace(cfg.grid, dim=args.dim))
    if args.width or args.height:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, width=args.width or cfg.render.width,
            height=args.height or cfg.render.height))
    if args.bounces:
        cfg = dataclasses.replace(cfg, light=dataclasses.replace(
            cfg.light, gi_bounces=args.bounces))
    if args.shadow_mode:
        cfg = dataclasses.replace(cfg, shadow=dataclasses.replace(
            cfg.shadow, mode=args.shadow_mode))
    if args.anisotropic:
        cfg = dataclasses.replace(
            cfg, grid=dataclasses.replace(cfg.grid, anisotropic=True))
    return cfg


def _load_scene(args):
    if args.scene == "cornell":
        from vct_tpu_torch.scene.cornell import cornell_box
        return cornell_box(size=100.0)
    if args.scene == "atrium":
        from vct_tpu_torch.scene.atrium import atrium
        return atrium()
    if args.scene.endswith(".obj"):
        from vct_tpu_torch.scene.obj import load_obj
        return load_obj(args.scene, scale=args.scene_scale)
    raise SystemExit(f"unknown scene {args.scene!r} "
                     "(cornell | atrium | path/to/model.obj)")


def _camera(args):
    from vct_tpu_torch.core import camera as cameralib
    return cameralib.Camera(position=args.camera, yaw=args.yaw,
                            pitch=args.pitch)


def _add_common(p):
    p.add_argument("--preset", default="cornell64_full")
    p.add_argument("--scene", default="cornell",
                   help="cornell | atrium | path/to/model.obj")
    p.add_argument("--scene-scale", type=float, default=1.0,
                   help="uniform model scale for .obj scenes "
                        "(the reference uses 0.05 for Sponza)")
    p.add_argument("--dim", type=int, default=0, help="voxel grid override")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--bounces", type=int, default=0, help="GI bounces (>=2)")
    p.add_argument("--shadow-mode", choices=["volume", "percone", "map"],
                   default=None)
    p.add_argument("--anisotropic", action="store_true")
    p.add_argument("--camera", type=_parse_vec3, default=(0.0, 0.0, 140.0))
    p.add_argument("--yaw", type=float, default=-90.0)
    p.add_argument("--pitch", type=float, default=0.0)
    p.add_argument("--gamma", type=float, default=2.2)
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler (Perfetto) trace here")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")


def _device(args) -> torch.device:
    """The card, or the CPU under --cpu; no silent fallback."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    return torch.device("cuda")


def _prepare(args, cfg, timer):
    """Scene prep + voxel build (the init-time passes)."""
    from vct_tpu_torch.render import renderer as R

    scene = _load_scene(args)
    with timer.stage("prepare_scene") as box:
        ds, mats, samples = R.prepare_scene(cfg, scene, device=args.device)
        box["result"] = samples.positions
    log(f"scene: {scene.indices.shape[0]} tris, "
        f"{samples.positions.shape[0]} surface samples")
    with timer.stage("build_voxel_state") as box:
        voxels = R.build_voxel_state(cfg, samples, mats)
        box["result"] = voxels.radiance_mips[0]
    tables = None
    if R.use_fast_path(cfg):
        from vct_tpu_torch.render import fast as F
        with timer.stage("frame_tables") as box:
            tables = F.build_frame_tables(cfg, voxels, mats)
            box["result"] = tables.field_mips[0]
        log("camera pass: fast path (render/fast.py)")
    return ds, mats, samples, voxels, tables


def _render_frame(cfg, ds, voxels, mats, camera, timer, device,
                  name="render", tables=None):
    from vct_tpu_torch.core import camera as cameralib
    from vct_tpu_torch.core import grid as G
    from vct_tpu_torch.render import renderer as R

    origins, dirs = cameralib.primary_rays(
        camera, cfg.render.width, cfg.render.height, device=device)
    cam_pos = G.constant(camera.position, device)
    with timer.stage(name) as box:
        img = R.render_camera_pass(cfg, ds, voxels, mats, origins, dirs,
                                   cam_pos, frame_tables=tables)
        box["result"] = img
    return img.cpu().numpy()


def cmd_render(args):
    from vct_tpu_torch.utils import image as I
    from vct_tpu_torch.utils import profiling as P

    args.device = _device(args)
    cfg = _build_cfg(args)
    timer = P.StageTimer(log=log)
    with P.perfetto_trace(args.trace_dir):
        ds, mats, samples, voxels, tables = _prepare(args, cfg, timer)
        img = _render_frame(cfg, ds, voxels, mats, _camera(args), timer,
                            args.device, tables=tables)
    I.write_png(args.out, I.tonemap(img, gamma=args.gamma,
                                    exposure=args.exposure))
    log(timer.report())
    log(f"wrote {args.out}  ({img.shape[1]}x{img.shape[0]}, "
        f"mean={img.mean():.4f})")


def cmd_orbit(args):
    """N frames orbiting the scene center — the interactive loop analogue;
    voxelization runs once, per-frame cost is the camera pass only."""
    from vct_tpu_torch.core import camera as cameralib
    from vct_tpu_torch.utils import image as I
    from vct_tpu_torch.utils import profiling as P

    args.device = _device(args)
    cfg = _build_cfg(args)
    timer = P.StageTimer(log=log)
    ds, mats, samples, voxels, tables = _prepare(args, cfg, timer)
    os.makedirs(args.out_dir, exist_ok=True)
    radius = float(np.linalg.norm(np.asarray(args.camera)))
    for i in range(args.frames):
        ang = 2.0 * math.pi * i / args.frames
        pos = (radius * math.sin(ang), args.camera[1],
               radius * math.cos(ang))
        yaw = math.degrees(math.atan2(-math.cos(ang), -math.sin(ang)))
        cam = cameralib.Camera(position=pos, yaw=yaw, pitch=args.pitch)
        img = _render_frame(cfg, ds, voxels, mats, cam, timer, args.device,
                            name=f"frame{i:03d}", tables=tables)
        path = os.path.join(args.out_dir, f"frame_{i:03d}.png")
        I.write_png(path, I.tonemap(img, gamma=args.gamma,
                                    exposure=args.exposure))
    log(timer.report())
    log(f"wrote {args.frames} frames to {args.out_dir}")


def _montage(vol: np.ndarray, max_slices: int = 16) -> np.ndarray:
    """(D, D, D, C) volume -> tiled 2D montage of z-slices."""
    d = vol.shape[2]
    take = min(max_slices, d)
    idx = np.linspace(0, d - 1, take).astype(int)
    cols = int(math.ceil(math.sqrt(take)))
    rows = int(math.ceil(take / cols))
    c = vol.shape[-1]
    out = np.zeros((rows * vol.shape[0], cols * vol.shape[1], c),
                   vol.dtype)
    for n, k in enumerate(idx):
        r, q = divmod(n, cols)
        out[r * vol.shape[0]:(r + 1) * vol.shape[0],
            q * vol.shape[1]:(q + 1) * vol.shape[1]] = vol[:, :, k]
    return out


def cmd_debug(args):
    """Dump pipeline internals (DrawVoxelTexture / DrawDepthTexture
    equivalents, Voxel_Cone_Tracing.h:192-250) as PNGs."""
    from vct_tpu_torch.core import camera as cameralib
    from vct_tpu_torch.render.gbuffer import raycast
    from vct_tpu_torch.utils import image as I
    from vct_tpu_torch.utils import profiling as P

    args.device = _device(args)
    cfg = _build_cfg(args)
    timer = P.StageTimer(log=log)
    ds, mats, samples, voxels, _tables = _prepare(args, cfg, timer)
    os.makedirs(args.out_dir, exist_ok=True)

    def dump(name, img):
        path = os.path.join(args.out_dir, name)
        I.write_png(path, I.tonemap(np.asarray(img), gamma=args.gamma))
        log(f"wrote {path}")

    # voxel radiance mips (DrawVoxelTexture)
    def host(x):
        return x.cpu().numpy()

    for lvl, m in enumerate(voxels.radiance_mips[:4]):
        m = host(m)
        if m.ndim == 5:       # anisotropic: mean over the 6 directions
            m = m.mean(axis=3)
        dump(f"voxel_mip{lvl}.png", _montage(m[..., :3]))
    # occupancy
    dump("occupancy.png", _montage(host(voxels.unlit_mips[0][..., 3:4])))
    # light transport (DrawDepthTexture analogue)
    if voxels.light_volume is not None:
        dump("light_volume.png", _montage(host(voxels.light_volume)))
    if voxels.shadow_map is not None:
        sm = host(voxels.shadow_map)
        sm = (sm - sm.min()) / max(sm.max() - sm.min(), 1e-6)
        dump("shadow_map.png", sm[..., None])
    # G-buffer views
    camera = _camera(args)
    origins, dirs = cameralib.primary_rays(
        camera, cfg.render.width, cfg.render.height, device=args.device)
    gbuf = raycast(ds, origins, dirs, device=args.device)
    t = host(gbuf.t)
    hit = host(gbuf.hit)
    depth = np.where(hit, t, np.nan)
    dn = (depth - np.nanmin(depth)) / max(
        np.nanmax(depth) - np.nanmin(depth), 1e-6)
    dump("gbuffer_depth.png", np.where(hit, 1.0 - dn, 0.0)[..., None])
    dump("gbuffer_normal.png",
         np.where(hit[..., None], host(gbuf.normal) * 0.5 + 0.5, 0.0))
    log(timer.report())


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="vct_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render one frame to PNG")
    _add_common(p)
    p.add_argument("--out", default="/tmp/vct_render.png")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("orbit", help="render an orbit sequence")
    _add_common(p)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out-dir", default="/tmp/vct_orbit")
    p.set_defaults(fn=cmd_orbit)

    p = sub.add_parser("debug", help="dump pipeline internals as PNGs")
    _add_common(p)
    p.add_argument("--out-dir", default="/tmp/vct_debug")
    p.set_defaults(fn=cmd_debug)

    args = ap.parse_args(argv)
    t0 = time.time()
    args.fn(args)
    log(f"total {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
