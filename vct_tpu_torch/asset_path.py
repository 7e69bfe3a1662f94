"""The asset path at the reference's scale: a Sponza-sized textured OBJ
written to disk, loaded, sampled, built and framed (port of
scripts/bench_asset_path.py).

    python -m vct_tpu_torch.asset_path [--subdiv 4] [--dir D] [--reps 5]
                                       [--cpu]

The reference loads a 262k-triangle Sponza OBJ with dozens of textures
through Assimp and stb_image (Voxel_Cone_Tracing.h:77, Model.h:43,
141-186).  Here:

  1. generate(root, subdiv): the atrium subdivided `subdiv` times
     (287,232 triangles at 4), its materials expanded to 20 textured
     variants (checker, brick and fabric textures at 256^2), written as
     OBJ + MTL + 14 PNG + 6 baseline JPEG files, the files
     scripts/bench_asset_path.py writes.  Nothing here encodes a JPEG:
     the six were encoded once with Pillow at quality 92 from the arrays
     `texture_arrays` makes (as scripts/bench_asset_path.py encodes them)
     and ship in scene/asset_jpeg/; generate copies them.
  2. load_obj (the native geometry parser, MTL and texture decode in
     Python through utils/image.py's readers).
  3. prepare_scene (native surface samples, the texture atlas, the
     copies to the card), build_voxel_state and build_frame_tables under
     preset sponza256 (256^3, bf16 march), and render_frame at 1920x1080
     from the bench camera (48, -10, 0), yaw 180.

Prints one JSON line with scripts/bench_asset_path.py's keys (tris,
materials, textured_materials, generate_s, obj_load_s, prepare_scene_s,
voxel_build_s, frame_ms_1080p, image_mean) and the splits of the load
(native geometry parse, MTL and texture decode, scene_from_arrays: the
tangent frames) and of prepare_scene (geometry, atlas, sampling,
host-to-device copy), each timed apart after the whole call,
the frame tables' seconds and the frame's CUDA-event min, median and max
over --reps frames after a warm-up.  On the card it first prints the
card's name and power limit (nvidia-smi).  --cpu runs everything on the
CPU (the kernels' plain versions), where frame_ms_1080p is null and
`frame_ms` holds host-clock times.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from vct_tpu_torch import native
from vct_tpu_torch.config import VCTConfig, preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import gbuffer as GB
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.render.voxelize import generate_surface_samples
from vct_tpu_torch.scene import obj as OBJ
from vct_tpu_torch.scene.atrium import atrium
from vct_tpu_torch.scene.mesh import scene_from_arrays, subdivide_scene
from vct_tpu_torch.utils.image import write_png
from vct_tpu_torch.utils.profiling import card_line

JPEG_DIR = Path(__file__).resolve().parent / "scene" / "asset_jpeg"
CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0)  # bench_asset_path:150
NUM_MATERIALS = 20
KINDS = ("checker", "brick", "fabric", "checker")
HUES = ((0.8, 0.75, 0.7), (0.7, 0.45, 0.35), (0.35, 0.5, 0.7),
        (0.45, 0.65, 0.4), (0.75, 0.7, 0.5))


def _texture(rng, kind, color):
    """Deterministic 256^2 rgb texture in [0, 1]."""
    r = 256
    yy, xx = np.mgrid[0:r, 0:r] / r
    base = np.asarray(color, np.float32)
    if kind == "checker":
        c = (((yy * 8).astype(int) + (xx * 8).astype(int)) % 2)
        img = base * (0.6 + 0.4 * c[..., None])
    elif kind == "brick":
        row = (yy * 16).astype(int)
        mort = (((xx * 8 + 0.5 * (row % 2)) % 1.0 < 0.06)
                | (yy * 16 % 1.0 < 0.12))
        img = np.where(mort[..., None], base * 0.45, base)
    else:  # noise fabric
        n = rng.uniform(0.75, 1.0, (32, 32, 1)).repeat(8, 0).repeat(8, 1)
        img = base * n
    img = img + rng.uniform(-0.02, 0.02, (r, r, 3))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def texture_file(i: int) -> str:
    """Material i's texture: 6 JPEGs (i % 10 < 3) and 14 PNGs."""
    return f"tex_{i:02d}.{'jpg' if i % 10 < 3 else 'png'}"


def texture_arrays() -> list:
    """The 20 textures, drawn from np.random.RandomState(7) in material
    order, as scripts/bench_asset_path.py draws them."""
    rng = np.random.RandomState(7)
    return [_texture(rng, KINDS[i % 4], HUES[i // 4])
            for i in range(NUM_MATERIALS)]


def generate(root: str, subdiv: int) -> str:
    """Write the scene under root (kept if its OBJ exists); returns the
    OBJ's path."""
    obj_path = os.path.join(root, "atrium_hi.obj")
    if os.path.exists(obj_path):
        return obj_path
    os.makedirs(root, exist_ok=True)
    scene = subdivide_scene(atrium(), subdiv)
    names = [f"mat{i:02d}" for i in range(NUM_MATERIALS)]
    texfiles = [texture_file(i) for i in range(NUM_MATERIALS)]
    for fn, img in zip(texfiles, texture_arrays()):
        if fn.endswith(".png"):
            write_png(os.path.join(root, fn), img)
        else:
            shutil.copyfile(JPEG_DIR / fn, os.path.join(root, fn))

    # MTL: every material textured; a few carry specular maps
    with open(os.path.join(root, "atrium_hi.mtl"), "w") as f:
        for i, name in enumerate(names):
            f.write(f"newmtl {name}\n")
            f.write("Kd 1.0 1.0 1.0\nKs 0.2 0.2 0.2\n")
            f.write(f"Ns {10 + 5 * (i % 5)}\n")
            f.write(f"map_Kd {texfiles[i]}\n")
            if i % 5 == 0:
                f.write(f"map_Ks {texfiles[(i + 1) % NUM_MATERIALS]}\n")
            f.write("\n")

    # triangle materials: base material -> variant by spatial hash
    centro = scene.positions[scene.indices].mean(axis=1)
    h = (np.floor(centro[:, 0] / 15) + 3 * np.floor(centro[:, 2] / 15)
         ).astype(np.int64)
    tri_mat = (scene.tri_material.astype(np.int64) * 5
               + np.abs(h) % 5) % NUM_MATERIALS

    with open(obj_path, "w") as f:
        f.write("mtllib atrium_hi.mtl\n")
        np.savetxt(f, scene.positions, fmt="v %.6f %.6f %.6f")
        np.savetxt(f, scene.uvs, fmt="vt %.6f %.6f")
        np.savetxt(f, scene.normals, fmt="vn %.5f %.5f %.5f")
        order = np.argsort(tri_mat, kind="stable")
        faces = scene.indices[order] + 1
        fmat = tri_mat[order]
        bounds = np.flatnonzero(np.diff(fmat)) + 1
        for blk, m0 in zip(np.split(faces, bounds),
                           fmat[np.concatenate([[0], bounds])]):
            f.write(f"usemtl {names[m0]}\n")
            # v/vt/vn share one index per vertex (parallel arrays)
            np.savetxt(f, np.repeat(blk, 3, axis=1),
                       fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
    return obj_path


def run(root: str, subdiv: int = 4, cfg: VCTConfig = None, device="cuda",
        reps: int = 5, on_phase=None):
    """Generate (or reuse) the scene under root, then load, prepare,
    build and frame it at cfg.render's size (default preset sponza256).
    on_phase(name), where given, is called after each phase ("load",
    "prepare", "build", "tables", "frame": the warm-up frame, "frames":
    the timed ones), its work finished.  Returns (result, state): the
    JSON-able result and the phases' objects (scene, ds, mats, samples,
    voxels, tables, origins, dirs, cam, img)."""
    cfg = preset("sponza256") if cfg is None else cfg
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def finish(name):
        if cuda:
            torch.cuda.synchronize(dev)
        if on_phase is not None:
            on_phase(name)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    def peak_over_held(fn):
        """fn's result, its seconds and its peak device memory over what
        was held before it (GiB; None on the CPU)."""
        if not cuda:
            return (*timed(fn), None)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out, s = timed(fn)
        return out, s, (torch.cuda.max_memory_allocated(dev) - held) / 2**30

    obj_path, gen_s = timed(lambda: generate(root, subdiv))
    scene, load_s = timed(lambda: OBJ.load_obj(obj_path))
    finish("load")
    load_split = {}
    geo, load_split["geometry_parse_s"] = timed(
        lambda: native.parse_obj_geometry(obj_path))
    mtl, load_split["texture_decode_s"] = timed(lambda: OBJ._parse_mtl(
        os.path.join(root, "atrium_hi.mtl")))
    _, load_split["scene_arrays_s"] = timed(lambda: scene_from_arrays(
        geo[0], geo[3], normals=geo[2], uvs=geo[1], tri_material=geo[4],
        materials=[mtl[n] for n in geo[5]]))
    del geo, mtl

    (ds, mats, samples), prep_s, prep_gib = peak_over_held(
        lambda: R.prepare_scene(cfg, scene, device=dev))
    finish("prepare")
    split = {}
    _, split["geometry_s"] = timed(lambda: GB.DeviceScene.from_scene(
        scene, device=dev))
    _, split["atlas_s"] = timed(lambda: R.MaterialTable.from_scene(
        scene, device=dev))
    host, split["sample_s"] = timed(lambda: generate_surface_samples(
        scene, cfg.grid.voxel_world_size,
        cfg.voxelize.samples_per_voxel_width))
    _, split["copy_s"] = timed(lambda: R.SamplesDevice.from_samples(
        host, device=dev))
    del host

    voxels, build_s, build_gib = peak_over_held(
        lambda: R.build_voxel_state(cfg, samples, mats))
    finish("build")
    tables, tables_s = timed(lambda: F.build_frame_tables(cfg, voxels, mats))
    finish("tables")

    w, h = cfg.render.width, cfg.render.height
    camera = CAM.Camera(**CAMERA)
    origins, dirs = CAM.primary_rays(camera, w, h, device=dev)
    cam = torch.as_tensor(camera.position, dtype=torch.float32, device=dev)

    def frame():
        return F.render_frame(cfg, ds, tables, mats, origins, dirs, cam)

    img, warm_s, frame_gib = peak_over_held(frame)
    finish("frame")
    frame_ms = []
    for _ in range(reps):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            frame()
            ev[1].record()
            torch.cuda.synchronize(dev)
            frame_ms.append(ev[0].elapsed_time(ev[1]))
        else:
            frame_ms.append(timed(frame)[1] * 1e3)
    finish("frames")

    med = statistics.median(frame_ms)
    res = {
        "tris": int(scene.indices.shape[0]),
        "materials": len(scene.materials),
        "textured_materials": sum(m.albedo_texture is not None
                                  for m in scene.materials),
        "samples": int(samples.positions.shape[0]),
        "generate_s": gen_s,
        "obj_load_s": load_s,
        "obj_load_split": load_split,
        "prepare_scene_s": prep_s,
        "prepare_scene_split": split,
        "voxel_build_s": build_s,
        "frame_tables_s": tables_s,
        "warmup_frame_s": warm_s,
        "frame_ms_1080p": med if cuda and (w, h) == (1920, 1080) else None,
        "frame_ms": {"min": min(frame_ms), "median": med,
                     "max": max(frame_ms), "reps": reps,
                     "clock": "cuda events" if cuda else "host"},
        "peak_over_held_gib": {"prepare": prep_gib, "build": build_gib,
                               "frame": frame_gib},
        "image_mean": float(img.mean()),
        "size": [w, h],
        "grid": cfg.grid.dim,
        "device": (torch.cuda.get_device_name(dev) if cuda else "cpu"),
    }
    state = dict(scene=scene, ds=ds, mats=mats, samples=samples,
                 voxels=voxels, tables=tables, origins=origins, dirs=dirs,
                 cam=cam, img=img)
    return res, state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subdiv", type=int, default=4)
    ap.add_argument("--dir", default=None,
                    help="where the scene is written (kept); default a "
                         "temporary directory, removed at the end")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if not args.cpu:
        if not torch.cuda.is_available():
            print("asset_path: CUDA is not available (--cpu runs on the "
                  "CPU)", file=sys.stderr)
            return 1
        print(card_line(), flush=True)
    device = "cpu" if args.cpu else "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        res, _ = run(args.dir or tmp, args.subdiv, device=device,
                     reps=args.reps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
