"""Field-mode fidelity at the operating point, and its gate (port of
scripts/fidelity_field.py and of tests/test_fidelity.py's bounds).

    python -m vct_tpu_torch.fidelity [--n 2048] [--df 128,256]
                                     [--stage all] [--out PATH]

Preset sponza256 (256^3 grid, bf16 dense march, 128^3 basis fields) on
the atrium from the bench camera (48, -10, 0), yaw 180.  On a subset of
`n` hit pixels of a 480x272 G-buffer (the whole-table raycast), picked
as the script picks them (np.random.RandomState(0).choice without
replacement over the hit indices), it holds against the exact per-cone
march (the fs:82-107 oracle, shading.indirect_*_percone):
  * diffuse_field{df}_rel_rms: the diffuse basis fields marched at
    df^3 (in bfloat16) and tapped at the pixels with the cones' folded
    basis weights, accumulated over groups of basis directions (13 at
    df <= 128, 4 above: a 256^3 group of 4 is 1 GiB) so that the whole
    field never exists at once;
  * specular_percone_kernel_rel_rms: the exact specular pass of the fast
    path (render/fast.spec_percone_pass: Morton order, levels, the
    csrc/specmarch.cu kernel on the card) over the whole G-buffer, read
    at the subset;
  * image_field_rel_rms, image_exact_specular_rel_rms: render_frame at
    480x272 under the config and under its exact-specular twin (specular
    mode "percone": preset sponza256_exact_specular at full size),
    against render_rays with percone diffuse and specular at the subset's
    rays (chunks of 2048);
  * specular_field{df}_rel_rms: the specular basis fields against the
    mirror cone.
--stage picks "diffuse", "kernelspec", "image" or "specular" ("all":
each).  The record (and n_pixels, grid_dim, basis, the basis powers,
device, size) goes to --out, default chiprun_out/fidelity.json, written
fresh: the script merged into the FIDELITY_r*.json of its working
directory, this never touches one.  It needs a CUDA card and exits
non-zero without one; run() and measure() take a device, and the tests
call them on the CPU.

GATE holds tests/test_fidelity.py's four regression bounds, which hold at
its settings (GATE_SETTINGS: 1,024 pixels, df 128, every stage);
gate_failures names the bounds a record breaks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Sequence

import numpy as np
import torch

from vct_tpu_torch.config import VCTConfig, preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.core import cones as C
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.ops import specmarch as SM
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.render import shading
from vct_tpu_torch.scene.atrium import atrium

Tensor = torch.Tensor

CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0)   # fidelity_field:86
STAGES = ("diffuse", "kernelspec", "image", "specular")
# tests/test_fidelity.py:57-60, at its settings (:36-41)
GATE = {"diffuse_field128_rel_rms": 0.5,
        "specular_percone_kernel_rel_rms": 0.25,
        "image_field_rel_rms": 0.3,
        "image_exact_specular_rel_rms": 0.22}
GATE_SETTINGS = dict(n=1024, dfs=(128,), stages="all")
OUT = os.path.join("chiprun_out", "fidelity.json")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def rel_rms(x, ref) -> float:
    """sqrt(mean((x - ref)^2)) / sqrt(mean(ref^2)), in float64."""
    x = np.asarray(torch.as_tensor(x).cpu(), np.float64)
    ref = np.asarray(torch.as_tensor(ref).cpu(), np.float64)
    return float(np.sqrt(np.mean((x - ref) ** 2))
                 / max(np.sqrt(np.mean(ref ** 2)), 1e-9))


def gate_failures(res: dict) -> list:
    """The GATE bounds `res` breaks (a missing key breaks its bound)."""
    return [f"{k} = {res.get(k)} (bound < {b})" for k, b in GATE.items()
            if not (k in res and res[k] < b)]


def select_pixels(hits: np.ndarray, n: int) -> np.ndarray:
    """The subset: np.random.RandomState(0).choice(hits, min(n, len),
    replace=False), the script's draw."""
    rng = np.random.RandomState(0)
    return rng.choice(hits, size=min(n, len(hits)), replace=False)


def field_taps_grouped(cfg: VCTConfig, mips: Sequence[Tensor],
                       sched, pos: Tensor, nrm: Tensor, weights: Tensor,
                       field_dim: int, group: int = None) -> Tensor:
    """sum_b weights[:, b] * trilinear(G_b, p), the fields G_b marched in
    bfloat16 at field_dim^3 a group of basis directions at a time (13 at
    field_dim <= 128, 4 above), each group's field freed before the next:
    the whole (df^3, B*4) field never exists.  -> (n, 4)."""
    if group is None:
        group = 13 if field_dim <= 128 else 4
    basis = D.direction_basis(cfg.cones.field_basis)
    n = pos.shape[0]
    out = torch.zeros((n, 4), dtype=torch.float32, device=pos.device)
    uvw = G.world_to_uvw(pos + nrm * cfg.grid.voxel_world_size,
                         cfg.grid.world_size)
    for b0 in range(0, basis.shape[0], group):
        sub = basis[b0:b0 + group]
        f = D.directional_march_multi(
            mips, sub, sched, cfg.grid.world_size, field_dim=field_dim,
            max_alpha=cfg.cones.max_alpha,
            occlusion_falloff=cfg.cones.occlusion_falloff,
            compute_dtype=torch.bfloat16)          # (df, df, df, g*4)
        taps = G.trilinear_sample(f, uvw).reshape(n, sub.shape[0], 4)
        del f
        out = out + torch.einsum("ngc,ng->nc", taps,
                                 weights[:, b0:b0 + sub.shape[0]])
    return out


def exact_specular_config(cfg: VCTConfig) -> VCTConfig:
    """cfg with the exact per-pixel specular march in place of the
    specular field: preset sponza256_exact_specular when cfg is
    sponza256."""
    return dataclasses.replace(cfg, cones=dataclasses.replace(
        cfg.cones, specular_mode="percone"))


def primary_gbuffer(ds, mats, camera: CAM.Camera, size=(480, 272)
                    ) -> dict:
    """The script's G-buffer: camera rays at size (w, h), flattened row
    by row, through the whole-table raycast (raycast.pack_tables with the
    materials' albedo and specular, raycast_gbuf24).  Returns
    {g, origins, dirs (H, W, 3), d (N, 3), origin, isect, attrs}."""
    w, h = size
    if (w * h) % SM.TILE:
        raise ValueError(f"the specular pass groups {SM.TILE} pixels: "
                         f"{w}x{h} is not a multiple")
    origins, dirs = CAM.primary_rays(camera, w, h, device=ds.v0.device)
    origin = origins.reshape(-1, 3)[0].contiguous()
    d = dirs.reshape(-1, 3).contiguous()
    isect, attrs = RP.pack_tables(ds, origin, mats.albedo, mats.specular)
    return dict(g=RP.raycast_gbuf24(d, origin, isect, attrs),
                origins=origins, dirs=dirs, d=d, origin=origin,
                isect=isect, attrs=attrs)


def measure(cfg: VCTConfig, ds, mats, voxels, camera: CAM.Camera,
            prim: dict, n: int = 2048, dfs=(128, 256), stages: str = "all"):
    """The record at primary_gbuffer's `prim` on a prepared scene and its
    voxel state, on their device.  Returns (record, arrays): arrays holds
    what each key compares (the subset, the oracles, the field taps, the
    specular pass and its inputs, the images at the subset)."""
    if stages != "all" and stages not in STAGES:
        raise ValueError(f"stages must be 'all' or one of {STAGES}")

    def on(stage):
        return stages in ("all", stage)

    dev = voxels.radiance_mips[0].device
    res, arrays = {}, {}
    g, origins, dirs, d = prim["g"], prim["origins"], prim["dirs"], prim["d"]
    h, w = dirs.shape[:2]
    hits = np.nonzero(g[:, 19].cpu().numpy() > 0.5)[0]
    sel_np = select_pixels(hits, n)
    sel = torch.as_tensor(sel_np, device=dev)
    pos, nrm = g[sel, 0:3], g[sel, 3:6]
    tan, bit = g[sel, 9:12], g[sel, 12:15]
    log(f"pixel subset: {sel.shape[0]} of {len(hits)} hits")
    arrays["sel"] = sel_np

    mips = voxels.radiance_mips
    basis = D.direction_basis(cfg.cones.field_basis)
    cam_pos = G.constant(camera.position, dev)
    eye = pos - cam_pos
    refl = shading.reflect_eye(nrm, -eye / torch.linalg.norm(
        eye, dim=1, keepdim=True))

    if on("diffuse"):
        cone_dirs = shading.pixel_cone_dirs(cfg, nrm, tan, bit)
        t0 = time.perf_counter()
        rgb, occ = shading.indirect_diffuse_percone(cfg, mips, pos, nrm,
                                                    cone_dirs)
        oracle = torch.cat([rgb, occ[:, None]], dim=1)
        log(f"percone diffuse oracle: {time.perf_counter() - t0:.1f}s")
        wb = D.basis_weights(cone_dirs, basis,
                             cfg.cones.basis_power_diffuse)
        cw = G.constant(C.CONE_WEIGHTS[:cfg.cones.num_diffuse_cones], dev)
        w_diff = torch.einsum("k,nkb->nb", cw, wb)
        arrays["diffuse_oracle"] = oracle
        for df in dfs:
            t0 = time.perf_counter()
            out = field_taps_grouped(cfg, mips, shading.diffuse_schedule(cfg),
                                     pos, nrm, w_diff, df)
            key = f"diffuse_field{df}_rel_rms"
            res[key] = rel_rms(out, oracle)
            arrays[key] = out
            log(f"field {df}^3 diffuse: rel RMS {res[key]:.4f} "
                f"({time.perf_counter() - t0:.1f}s)")

    if on("kernelspec") or on("specular"):
        s_rgb, s_occ = shading.indirect_specular_percone(cfg, mips, pos,
                                                         nrm, refl)
        spec_oracle = torch.cat([s_rgb, s_occ[:, None]], dim=1)
        arrays["specular_oracle"] = spec_oracle

    if on("kernelspec"):
        # the fast path's own pass over the whole G-buffer, read at the
        # subset
        posf, nrmf, hitf = g[:, 0:3], g[:, 3:6], g[:, 19] > 0.5
        eyef = C.normalize(cam_pos - posf)
        pages = SM.pack_spec_mips(mips)
        so = F.spec_percone_pass(cfg, pages, posf, nrmf, nrmf, eyef, hitf)
        key = "specular_percone_kernel_rel_rms"
        res[key] = rel_rms(so[sel], spec_oracle)
        arrays.update(spec_inputs=(pages, posf, nrmf, nrmf, eyef, hitf),
                      spec_pass=so)
        log(f"percone specular kernel: rel RMS {res[key]:.4f}")
        del pages

    if on("image"):
        cfg_o = dataclasses.replace(cfg, cones=dataclasses.replace(
            cfg.cones, diffuse_mode="percone", specular_mode="percone"))
        img_oracle = R.render_rays(
            cfg_o, ds, voxels, mats, origins.reshape(-1, 3)[sel], d[sel],
            cam_pos, chunk_size=2048)
        arrays["image_oracle"] = img_oracle
        for key, cfg_f in (("image_field_rel_rms", cfg),
                           ("image_exact_specular_rel_rms",
                            exact_specular_config(cfg))):
            tables = F.build_frame_tables(cfg_f, voxels, mats)
            img = F.render_frame(cfg_f, ds, tables, mats, origins, dirs,
                                 cam_pos).reshape(-1, 3)[sel]
            del tables
            res[key] = rel_rms(img, img_oracle)
            arrays[key] = img
            log(f"{key}: rel RMS {res[key]:.4f}")

    if on("specular"):
        w_spec = D.basis_weights(refl, basis, cfg.cones.basis_power_specular)
        for df in dfs:
            out = field_taps_grouped(cfg, mips, shading.specular_schedule(cfg),
                                     pos, nrm, w_spec, df)
            key = f"specular_field{df}_rel_rms"
            res[key] = rel_rms(out, arrays["specular_oracle"])
            arrays[key] = out
            log(f"field {df}^3 specular (mirror dirs): rel RMS "
                f"{res[key]:.4f}")

    res.update(n_pixels=int(sel.shape[0]), grid_dim=cfg.grid.dim,
               basis=int(cfg.cones.field_basis),
               power_diffuse=float(cfg.cones.basis_power_diffuse),
               power_specular=float(cfg.cones.basis_power_specular),
               device=(torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
               size=[w, h])
    return res, arrays


def run(cfg: VCTConfig = None, scene=None, camera: CAM.Camera = None,
        size=(480, 272), n: int = 2048, dfs=(128, 256), stages: str = "all",
        device="cuda"):
    """prepare_scene + build_voxel_state of `scene` (the atrium) under
    `cfg` (preset sponza256), primary_gbuffer and measure() from `camera`
    (the bench camera).  Returns (record, state): state holds cfg, ds,
    mats, voxels, prim (primary_gbuffer's) and arrays (measure's)."""
    cfg = preset("sponza256") if cfg is None else cfg
    scene = atrium() if scene is None else scene
    camera = CAM.Camera(**CAMERA) if camera is None else camera
    ds, mats, samples = R.prepare_scene(cfg, scene, device=device)
    t0 = time.perf_counter()
    voxels = R.build_voxel_state(cfg, samples, mats)
    log(f"voxel build: {time.perf_counter() - t0:.1f}s")
    prim = primary_gbuffer(ds, mats, camera, size)
    res, arrays = measure(cfg, ds, mats, voxels, camera, prim, n=n,
                          dfs=dfs, stages=stages)
    return res, dict(cfg=cfg, ds=ds, mats=mats, voxels=voxels, prim=prim,
                     arrays=arrays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048,
                    help="pixels in the subset")
    ap.add_argument("--df", default="128,256",
                    help="field resolutions, comma-separated")
    ap.add_argument("--stage", default="all", choices=("all",) + STAGES)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fidelity: CUDA is not available (no CPU fallback)",
              file=sys.stderr)
        return 1
    res, _ = run(n=args.n, dfs=tuple(int(x) for x in args.df.split(",")),
                 stages=args.stage)
    broken = gate_failures(res)
    log(f"tests/test_fidelity.py's bounds (they hold at n 1024, df 128): "
        + ("all hold" if not broken else "broken: " + "; ".join(broken)))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
