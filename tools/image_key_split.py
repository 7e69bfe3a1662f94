"""Where the fidelity record's image keys part between the port and the
JAX package, on the CPU.

scripts/fidelity_field.py's image keys (image_field_rel_rms,
image_exact_specular_rel_rms) at tests/test_torch_fidelity.py's size:
preset sponza256 cut to --dim^3 (float32 build, --dim^3 fields), the
atrium from the bench camera, a 96x64 G-buffer and 128 pixels drawn as
the script draws them.  Everything starts from the JAX package's voxel
state, scene and materials, carried to the port by vct_tpu_torch.interop;
the reference is JAX's per-cone render_rays at the pixels.  For each key
it prints the key and the per-pixel error against JAX's
render_frame(interpret=True) of:
  * JAX's frame (interpret mode);
  * the port's render_frame, on its own G-buffer;
  * the port's shading pass (fast._shade) on JAX's G-buffer (after the
    alpha re-cast), then with JAX's material output swapped in, then
    JAX's tap output, then both.
The JAX intermediates are caught as the jitted frame computes them
(jax.debug.callback around the material and tap kernels).

    python tools/image_key_split.py --dim 64

At 64^3 it takes about a minute on the CPU.
"""

import argparse
import dataclasses
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vct_tpu.config import preset as jpreset  # noqa: E402
from vct_tpu.core import camera as jcam  # noqa: E402
from vct_tpu.ops import material_pallas as JMP  # noqa: E402
from vct_tpu.ops import raycast_pallas as JRP  # noqa: E402
from vct_tpu.ops import tap_pallas as JTP  # noqa: E402
from vct_tpu.render import fast as JF  # noqa: E402
from vct_tpu.render import renderer as JR  # noqa: E402
from vct_tpu.scene.atrium import atrium as jatrium  # noqa: E402
from vct_tpu_torch import interop  # noqa: E402
from vct_tpu_torch.config import preset  # noqa: E402
from vct_tpu_torch.render import fast as PF  # noqa: E402
from vct_tpu_torch.render import renderer as PR  # noqa: E402

W, H, N = 96, 64, 128
CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0)
CPU = torch.device("cpu")
KEYS = {"field": "image_field_rel_rms",
        "percone": "image_exact_specular_rel_rms"}


def cut(make_preset, dim):
    cfg = make_preset("sponza256")
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=dim, compute="float32"),
        cones=dataclasses.replace(cfg.cones, field_dim=dim))


def with_specular(cfg, mode):
    return dataclasses.replace(cfg, cones=dataclasses.replace(
        cfg.cones, specular_mode=mode))


def rel_rms(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((x - ref) ** 2))
                 / max(np.sqrt(np.mean(ref ** 2)), 1e-9))


def errors(a, b) -> str:
    e = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return (f"mean {e.mean():.3e} p99 {np.percentile(e, 99):.3e} "
            f"max {e.max():.3e}")


def caught(name, fn, store):
    """fn, its output also stored under `name` as the jitted frame runs."""
    def call(*a, **k):
        out = fn(*a, **k)
        jax.debug.callback(
            lambda x: store.__setitem__(name, np.asarray(x)), out)
        return out
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=64)
    dim = ap.parse_args().dim
    torch.set_num_threads(4)
    jcfg, pcfg = cut(jpreset, dim), cut(preset, dim)
    ds, mats, samples = JR.prepare_scene(jcfg, jatrium())
    voxels = JR.build_voxel_state_staged(jcfg, samples, mats)
    camera = jcam.Camera(**CAMERA)
    origins, dirs = jcam.primary_rays(camera, W, H)
    origin = origins.reshape(-1, 3)[0]
    isect, attrs, _ = JRP.pack_tables(ds, origin, mats.albedo, mats.specular)
    g0 = np.asarray(JRP.raycast_gbuf24(dirs.reshape(-1, 3), origin, isect,
                                       attrs, interpret=True))
    hits = np.nonzero(g0[:, 19] > 0.5)[0]
    sel = np.random.RandomState(0).choice(hits, size=min(N, len(hits)),
                                          replace=False)
    cam_pos = jnp.asarray(camera.position, jnp.float32)
    cfg_o = dataclasses.replace(jcfg, cones=dataclasses.replace(
        jcfg.cones, diffuse_mode="percone", specular_mode="percone"))
    oracle = np.asarray(JR.render_rays(
        cfg_o, ds, voxels, mats, origins.reshape(-1, 3)[sel],
        dirs.reshape(-1, 3)[sel], cam_pos, chunk_size=2048))

    store = {}
    JMP.material_tiles = caught("material", JMP.material_tiles, store)
    JTP.tap_tiles = caught("taps", JTP.tap_tiles, store)
    host = jax.tree_util.tree_map(np.asarray, (ds, mats, voxels))
    pds = interop.device_scene(host[0], CPU)
    pm = interop.material_table(host[1], CPU)
    pv = interop.voxel_state(host[2], CPU)

    def tor(x):
        return torch.as_tensor(np.array(x))

    porig, pdirs, pcam = tor(origins), tor(dirs), tor(cam_pos)
    h, w = dirs.shape[:2]
    hw = (h, w, -(-h // JF.TSY) * JF.TSY, -(-w // 64) * 64)
    material_tiles, tap_tiles = PF.MT.material_tiles, PF.TP.tap_tiles

    for mode, key in KEYS.items():
        jc, pc = with_specular(jcfg, mode), with_specular(pcfg, mode)
        tables = JF.build_frame_tables(jc, voxels, mats)
        img_j = np.asarray(JF.render_frame(jc, ds, tables, mats, origins,
                                           dirs, cam_pos, interpret=True))
        g, d = JF._raycast_small(ds, mats, dirs, origin, interpret=True)
        g = tor(JF.alpha_resolve(jc, ds, mats, g, d, origin, interpret=True))
        ptables = PF.build_frame_tables(pc, pv, pm)
        light = PR.light_direction(pc, CPU)
        rows = [("JAX, interpret mode", img_j),
                ("port, own G-buffer", PF.render_frame(
                    pc, pds, ptables, pm, porig, pdirs, pcam).numpy())]
        for name, mat, tap in (("port, JAX's G-buffer", False, False),
                               ("  + JAX's material", True, False),
                               ("  + JAX's taps", False, True),
                               ("  + both", True, True)):
            PF.MT.material_tiles = ((lambda *a, **k: tor(store["material"]))
                                    if mat else material_tiles)
            PF.TP.tap_tiles = ((lambda *a, **k: tor(store["taps"]))
                               if tap else tap_tiles)
            rows.append((name, PF._shade(pc, ptables, g, pcam, light,
                                         hw).numpy()))
        PF.MT.material_tiles, PF.TP.tap_tiles = material_tiles, tap_tiles
        print(f"--- {dim}^3, {W}x{H}, {len(sel)} pixels: {key}")
        for name, img in rows:
            sub = img.reshape(-1, 3)[sel]
            print(f"{name:24s} key {rel_rms(sub, oracle):.6f}; against JAX "
                  f"at the pixels {errors(sub, img_j.reshape(-1, 3)[sel])}; "
                  f"whole frame {errors(img, img_j)}", flush=True)


if __name__ == "__main__":
    main()
