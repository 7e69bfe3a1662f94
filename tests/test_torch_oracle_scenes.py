"""The port's per-cone oracle renderer on the textured atrium, the voxel
build's extra bounces and per-sample shadow cones, and the JAX package's
alpha-mask and field-mode cases, on the CPU.  Helpers and bounds are
tests/test_torch_oracle.py's (its docstring states them and what these
fixtures measured).

  * the atrium under preset cornell64_full cut to 32^3 / 96x64 from the
    bench camera: shade_gbuffer (with the bump normal) on the JAX
    G-buffer, render_rays on the carried JAX state and on the port's own
    build, and through the general raycast against the pinhole one
    (tests/test_pinhole.py's bounds, 1e-4); the alpha re-cast from
    EDGE_CAMERA, which sees the banners' masked edge (the bench camera
    sees none);
  * gi_bounces=3 with volume shadows (tests/test_bounce.py's case) and
    shadow mode "percone", at 16^3: the port's build against the JAX
    build at atol 1e-5;
  * tests/test_alpha_mask.py's render_rays cases and
    tests/test_field_mode.py's field-vs-percone bounds, on the port alone.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_oracle import (BENCH_CAMERA, CORNELL_CAMERA, CPU,
                               EDGE_CAMERA, as_torch, carry, cfg_pair, close,
                               cut_config, hold_gbuffer, hold_own_build,
                               hold_render_rays, hold_shade, jax_state)
from vct_tpu.core import camera as jcam
from vct_tpu.render import gbuffer as JGB
from vct_tpu.render import renderer as JR
from vct_tpu.scene.atrium import atrium as jatrium
from vct_tpu.scene.cornell import cornell_box as jcornell_box
from vct_tpu_torch import interop
from vct_tpu_torch.config import GridConfig, preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.render import gbuffer as GB
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.scene.atrium import atrium
from vct_tpu_torch.scene.cornell import cornell_box
from vct_tpu_torch.scene.mesh import Material, scene_from_arrays

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4


@pytest.fixture(scope="module")
def atrium_run():
    jc, pc = cfg_pair(32, 96, 64)
    j = jax_state(jc, jatrium(), BENCH_CAMERA, 96, 64)
    j["img"] = np.asarray(JR.render_rays(jc, j["ds"], j["voxels"], j["mats"],
                                         j["origins"], j["dirs"], j["cam"],
                                         chunk_size=2048))
    j["cfg"] = pc
    p = carry(j, atrium(), BENCH_CAMERA, 96, 64)
    return jc, pc, j, p


def test_shade_gbuffer_on_jax_gbuffer(atrium_run):
    hold_shade(atrium_run)


def test_render_rays_on_carried_state(atrium_run):
    hold_render_rays(atrium_run)


def test_render_camera_pass_on_own_build(atrium_run):
    hold_own_build(atrium_run)


def test_render_rays_general_path_matches_pinhole(atrium_run):
    """tests/test_pinhole.py's render_rays case: the general raycast
    (pinhole=False, no alpha re-cast; the bench camera sees no masked
    texel) renders the pinhole path's image within 1e-4 at every pixel
    whose winner the two raycasts agree on: all but 8 of 6,144, on
    triangle edges."""
    _, pc, j, p = atrium_run
    args = (pc, p["ds"], p["voxels"], p["mats"], p["origins"], p["dirs"],
            p["cam"])
    general = R.render_rays(*args, chunk_size=2048, pinhole=False)
    pinhole = R.render_rays(*args, chunk_size=2048)
    o, d = p["origins"].reshape(-1, 3), p["dirs"].reshape(-1, 3)
    gg = GB.raycast(p["ds"], o, d, device=CPU)
    gp = GB.raycast_chunk_pinhole(p["ds"], GB.pinhole_constants(p["ds"], o[0]),
                                  o[0], d)
    agree = ((gg.tri == gp.tri) & (gg.hit == gp.hit)).reshape(64, 96)
    assert float(agree.float().mean()) >= 0.998
    close(general[agree], pinhole[agree], atol=1e-4, rtol=1e-4)


def test_alpha_recast_on_atrium_edge(atrium_run):
    """The alpha re-cast's G-buffer equals the JAX one from EDGE_CAMERA
    (tests/test_torch_atrium.py), which sees the banners' masked edge;
    the bench camera sees no masked texel."""
    jc, pc, j, p = atrium_run
    origins, dirs = jcam.primary_rays(jcam.Camera(**EDGE_CAMERA), 96, 64)
    o, d = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    jpc = JGB.pinhole_constants(j["ds"], o[0])
    jg0 = JGB.raycast_chunk_pinhole(j["ds"], jpc, o[0], d)
    jg = JR.alpha_mask_recast(jc, j["ds"], jpc, o[0], d, jg0, j["mats"])
    po, pd = as_torch(o), as_torch(d)
    ppc = GB.pinhole_constants(p["ds"], po[0])
    pg0 = interop.gbuffer(jax.tree_util.tree_map(np.asarray, jg0), CPU)
    pg = R.alpha_mask_recast(pc, p["ds"], ppc, po[0], pd, pg0, p["mats"])
    moved = int((pg.tri != pg0.tri).sum())
    assert moved > 0                  # the re-cast found surfaces behind
    hold_gbuffer(pg, jg, "alpha re-cast")


# ---------------------------------------------------------------------------
# the build: extra bounces and per-sample shadow cones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bounces, shadow", [(3, "volume"), (2, "percone")])
def test_build_bounce_and_percone_shadow(bounces, shadow):
    jc, pc = cfg_pair(16, 24, 24)
    jc, pc = (dataclasses.replace(
        c, light=dataclasses.replace(c.light, gi_bounces=bounces),
        shadow=dataclasses.replace(c.shadow, mode=shadow)) for c in (jc, pc))
    _, jm, js = JR.prepare_scene(jc, jcornell_box(size=100.0))
    jv = JR.build_voxel_state_staged(jc, js, jm)
    _, pm, ps = R.prepare_scene(pc, cornell_box(size=100.0), device=CPU)
    pv = R.build_voxel_state(pc, ps, pm)
    for name in ("radiance_mips", "unlit_mips"):
        for a, b in zip(getattr(pv, name), getattr(jv, name)):
            close(a, b)
    assert (pv.light_volume is None) == (shadow == "percone")
    if bounces == 3:     # the bounce adds energy (tests/test_bounce.py)
        two = R.build_voxel_state(dataclasses.replace(pc, light=dataclasses
                                  .replace(pc.light, gi_bounces=2)), ps, pm)
        r2, r3 = two.radiance_mips[0], pv.radiance_mips[0]
        assert float(r3[..., :3].sum()) > float(r2[..., :3].sum()) * 1.001
        assert torch.equal(r2[..., 3], r3[..., 3])



def test_build_light_dir():
    """build_voxel_state(light_dir=) against the JAX build with the same
    direction: the per-sample shadow cones (shadow mode "percone") march
    toward it, at 16^3, atol 1e-5; the default direction builds another
    state."""
    jc, pc = cfg_pair(16, 24, 24)
    jc, pc = (dataclasses.replace(c, shadow=dataclasses.replace(
        c.shadow, mode="percone")) for c in (jc, pc))
    d = np.asarray([0.3, 1.0, -0.2], np.float32)
    d /= np.linalg.norm(d)
    _, jm, js = JR.prepare_scene(jc, jcornell_box(size=100.0))
    jv = JR.build_voxel_state(jc, js, jm, light_dir=jax.numpy.asarray(d))
    _, pm, ps = R.prepare_scene(pc, cornell_box(size=100.0), device=CPU)
    pv = R.build_voxel_state(pc, ps, pm, light_dir=as_torch(d))
    for name in ("radiance_mips", "unlit_mips"):
        for a, b in zip(getattr(pv, name), getattr(jv, name)):
            close(a, b)
    default = R.build_voxel_state(pc, ps, pm)
    assert not torch.equal(default.radiance_mips[0], pv.radiance_mips[0])
    assert torch.equal(default.unlit_mips[0], pv.unlit_mips[0])


# ---------------------------------------------------------------------------
# tests/test_alpha_mask.py's render_rays cases and tests/test_field_mode.py
# ---------------------------------------------------------------------------

WALL_RGB = (0.9, 0.1, 0.1)
BG = (0.0, 0.0, 1.0)


def masked_scene(second_layer: bool = False):
    """tests/test_alpha_mask.py's scene: a red wall at z = -20 behind a
    green quad at z = 0 whose left half (u < 0.5) is alpha-masked;
    second_layer adds a fully masked quad at z = -10."""
    verts, uvs, tris, mats_idx = [], [], [], []

    def add(z, mat):
        base = len(verts)
        verts.extend([(-40.0, -40.0, z), (40.0, -40.0, z), (40.0, 40.0, z),
                      (-40.0, 40.0, z)])
        uvs.extend([(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)])
        tris.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])
        mats_idx.extend([mat, mat])

    add(-20.0, 0)
    add(0.0, 1)
    if second_layer:
        add(-10.0, 2)
    m = np.ones((8, 8), np.float32)
    m[:, :4] = 0.0
    materials = [
        Material(name="wall", albedo=(*WALL_RGB, 1.0),
                 albedo_texture=np.ones((4, 4, 3), np.float32)
                 * np.asarray(WALL_RGB, np.float32)),
        Material(name="masked", albedo=(0.1, 0.9, 0.1, 1.0), mask_texture=m),
        Material(name="gone", albedo=(0.1, 0.1, 0.9, 1.0),
                 mask_texture=np.zeros((4, 4), np.float32)),
    ]
    return scene_from_arrays(
        np.asarray(verts, np.float32), np.asarray(tris, np.int32),
        uvs=np.asarray(uvs, np.float32),
        tri_material=np.asarray(mats_idx, np.int32), materials=materials)


def _mask_cfg(depth=2):
    cfg = preset("sponza256")
    return dataclasses.replace(
        cfg, grid=GridConfig(dim=16, world_size=150.0),
        render=dataclasses.replace(cfg.render, width=64, height=64,
                                   background=BG, alpha_mask_depth=depth))


def _oracle(cfg, scene):
    camera = CAM.Camera(position=(0.0, 0.0, 60.0), yaw=-90.0)
    ds, mats, samples = R.prepare_scene(cfg, scene, device=CPU)
    voxels = R.build_voxel_state(cfg, samples, mats)
    origins, dirs = CAM.primary_rays(camera, 64, 64, device=CPU)
    return R.render_rays(cfg, ds, voxels, mats, origins, dirs,
                         torch.tensor(camera.position, dtype=torch.float32),
                         chunk_size=1024).numpy()


def test_alpha_masked_half_shows_wall():
    img = _oracle(_mask_cfg(), masked_scene())
    lo = img[32, 16]
    masked, kept = (16, 48) if lo[0] > lo[1] else (48, 16)
    assert img[32, masked][0] > img[32, masked][2] + 0.05, img[32, masked]
    assert img[32, kept][1] > img[32, kept][0], img[32, kept]
    assert not np.any(img[8:56, 8:56, 2] > 0.9), "background leaked"


def test_alpha_stacked_masks_need_depth_2():
    scene = masked_scene(second_layer=True)
    img = _oracle(_mask_cfg(), scene)
    reds = [float(px[0] > px[1] and px[0] > px[2])
            for px in (img[32, 16], img[32, 48])]
    assert sum(reds) >= 1.0
    img1 = _oracle(_mask_cfg(depth=1), scene)
    col = 16 if reds[0] else 48
    assert img1[32, col][2] > 0.8, img1[32, col]


def test_alpha_depth_zero_shows_background():
    img = _oracle(_mask_cfg(depth=0), masked_scene())
    assert (img[32, :, 2] > 0.9).sum() > 10


@pytest.mark.parametrize("route", ["fast_path", "render_rays"])
def test_field_close_to_percone(route):
    """tests/test_field_mode.py on the port: field-mode GI against the
    percone oracle at 32^3 / 64x64, through the fast path (the field
    taps) or through render_rays' field providers."""
    camera = CAM.Camera(**CORNELL_CAMERA)
    base = cut_config(preset, GridConfig, 32, 64, 64)
    imgs = {}
    for mode in ("percone", "field"):
        cfg = dataclasses.replace(base, cones=dataclasses.replace(
            base.cones, diffuse_mode=mode, specular_mode=mode))
        if route == "fast_path" or mode == "percone":
            imgs[mode] = R.render_image(cfg, cornell_box(100.0), camera,
                                        device=CPU).numpy()
        else:
            ds, mats, samples = R.prepare_scene(cfg, cornell_box(100.0),
                                                device=CPU)
            voxels = R.build_voxel_state(cfg, samples, mats)
            o, d = CAM.primary_rays(camera, 64, 64, device=CPU)
            imgs[mode] = R.render_rays(cfg, ds, voxels, mats, o, d,
                                       torch.tensor(camera.position),
                                       chunk_size=1024).numpy()
    assert R.use_fast_path(dataclasses.replace(base, cones=dataclasses
                           .replace(base.cones, diffuse_mode="field",
                                    specular_mode="field")))
    d = np.abs(imgs["percone"] - imgs["field"])
    assert d.mean() < 0.02, d.mean()
    assert np.percentile(d, 95) < 0.08
    img = imgs["field"]
    assert np.isfinite(img).all() and img.min() >= 0.0
    assert 0.01 < img.mean() < 1.0
