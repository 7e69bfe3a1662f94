"""The port's textured slice end to end against the JAX package, at
tests/test_fast.py's textured fixture: preset sponza256 cut to a 32^3
grid, float32 dense-march compute, 96x64 pixels, the atrium (1,122
triangles, 8 materials, a 256^2 texture atlas), the bench camera
(48, -10, 0) with yaw 180.  The frame runs the material half of the
prepass, the material fetch and the alpha re-cast through the streamed
raycast.

Bounds, with what this fixture measured on the CPU:
  * VoxelState arrays vs build_voxel_state_staged: atol 1e-5;
  * render_frame on the converted JAX state vs F.render_frame(interpret=
    True): mean < 1e-3 and p99 < 1e-2 (measured mean 1.9e-4, p99 1.9e-3,
    max 1.0e-2; the TPU material kernel rounds its bilinear weights to
    bf16 and its tap kernel its trilinear weights, the port's kernels do
    not); the same bounds for preset sponza256_exact_specular cut the same
    way (the exact per-pixel specular march in place of the specular
    field; the TPU march kernel also rounds its weights to bf16);
  * the port's own build + frame vs R.render_rays, the per-cone oracle
    path: mean < 0.03, tests/test_fast.py's bound (measured mean 0.020,
    p99 0.20; the fast path mip-filters textures by tile footprint,
    render_rays samples level 0).

Also the three fast-path cases of tests/test_alpha_mask.py on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.config import GridConfig as JGridConfig
from vct_tpu.config import preset as jpreset
from vct_tpu.core import camera as jcam
from vct_tpu.render import fast as JF
from vct_tpu.render import renderer as JR
from vct_tpu.scene.atrium import atrium as jatrium
from vct_tpu_torch import interop
from vct_tpu_torch.config import GridConfig, preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.ops import material as MT
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.scene.atrium import atrium
from vct_tpu_torch.scene.mesh import Material, scene_from_arrays

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

CPU = torch.device("cpu")
W, H = 96, 64
CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0)
# above the nave, looking down the hall: sees the banners' scalloped,
# alpha-masked edge, which the bench camera does not (chip_smoke.py's
# input (c))
EDGE_CAMERA = dict(position=(48.0, 20.0, 0.0), yaw=180.0, pitch=-10.0)


def _cfg(make_preset, name="sponza256"):
    cfg = make_preset(name)
    return dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, dim=32, compute="float32"),
        cones=dataclasses.replace(cfg.cones, field_dim=32),
        render=dataclasses.replace(cfg.render, width=W, height=H),
    )


@pytest.fixture(scope="module")
def jax_run():
    cfg = _cfg(jpreset)
    ds, mats, samples = JR.prepare_scene(cfg, jatrium())
    assert mats.atlas is not None
    voxels = JR.build_voxel_state_staged(cfg, samples, mats)
    origins, dirs = jcam.primary_rays(jcam.Camera(**CAMERA), W, H)
    cam = jnp.asarray(CAMERA["position"], jnp.float32)
    tables = JF.build_frame_tables(cfg, voxels, mats)
    fast = np.asarray(JF.render_frame(cfg, ds, tables, mats, origins, dirs,
                                      cam, interpret=True))
    ref = np.asarray(JR.render_rays(cfg, ds, voxels, mats, origins, dirs,
                                    cam, chunk_size=512))
    host = jax.tree_util.tree_map(np.asarray, (voxels, tables, mats))
    return host, fast, ref


@pytest.fixture(scope="module")
def port_run():
    cfg = _cfg(preset)
    ds, mats, samples = R.prepare_scene(cfg, atrium(), device=CPU)
    voxels = R.build_voxel_state(cfg, samples, mats)
    origins, dirs = CAM.primary_rays(CAM.Camera(**CAMERA), W, H, device=CPU)
    cam = torch.tensor(CAMERA["position"], dtype=torch.float32)
    return cfg, ds, mats, voxels, origins, dirs, cam


def _err(a, b):
    e = np.abs(np.asarray(a) - np.asarray(b))
    return e.mean(), np.percentile(e, 99)


@pytest.mark.parametrize("name", ["radiance_mips", "unlit_mips",
                                  "light_volume", "diffuse_field",
                                  "specular_field"])
def test_voxel_state_matches(jax_run, port_run, name):
    jv = jax_run[0][0]
    pv = port_run[3]
    a, b = getattr(pv, name), getattr(jv, name)
    if isinstance(b, tuple):
        assert len(a) == len(b)
    else:
        a, b = (a,), (b,)
    for x, y in zip(a, b):
        assert tuple(x.shape) == y.shape
        np.testing.assert_allclose(x.numpy(), y, atol=1e-5, rtol=0)


def test_atlas_matches(jax_run, port_run):
    """The host-built atlas pages are the JAX package's bit for bit, and so
    are the packed mip pages built from them."""
    jt, jm = jax_run[0][1], jax_run[0][2]
    cfg, _, mats, voxels = port_run[:4]
    for k in ("albedo", "specular", "height"):
        np.testing.assert_array_equal(getattr(mats.atlas, k).numpy(),
                                      getattr(jm.atlas, k))
    pages = F.build_frame_tables(cfg, voxels, mats).atlas_pages
    np.testing.assert_array_equal(pages.view(torch.int16).numpy(),
                                  jt.atlas_pages.view(np.int16))
    assert MT.pages_resolution(pages) == 256


def test_frame_on_converted_state_matches_jax_fast_path(jax_run, port_run):
    (jv, jt, jm), fast, _ = jax_run
    cfg, ds, _, _, origins, dirs, cam = port_run
    mats = interop.material_table(jm, device=CPU)
    tables = interop.frame_tables(jt, cfield=8 * cfg.cones.field_basis,
                                  device=CPU)
    out = F.render_frame(cfg, ds, tables, mats, origins, dirs, cam).numpy()
    assert out.shape == fast.shape and np.isfinite(out).all()
    mean, p99 = _err(out, fast)
    assert mean < 1e-3, mean
    assert p99 < 1e-2, p99


@pytest.fixture(scope="module")
def jax_exact(jax_run):
    """The JAX fast frame under sponza256_exact_specular on jax_run's
    voxel state (the percone config builds no specular field and samples
    none) and its frame tables, as numpy."""
    cfg = _cfg(jpreset, "sponza256_exact_specular")
    ds, mats, _ = JR.prepare_scene(cfg, jatrium())
    voxels = jax.tree_util.tree_map(jnp.asarray, jax_run[0][0])
    origins, dirs = jcam.primary_rays(jcam.Camera(**CAMERA), W, H)
    cam = jnp.asarray(CAMERA["position"], jnp.float32)
    tables = JF.build_frame_tables(cfg, voxels, mats)
    assert tables.spec_mips is not None
    img = np.asarray(JF.render_frame(cfg, ds, tables, mats, origins, dirs,
                                     cam, interpret=True))
    return jax.tree_util.tree_map(np.asarray, tables), img


def test_exact_specular_frame_matches_jax_fast_path(jax_run, jax_exact,
                                                    port_run):
    jt, fast_x = jax_exact
    _, ds, _, _, origins, dirs, cam = port_run
    cfg = _cfg(preset, "sponza256_exact_specular")
    mats = interop.material_table(jax_run[0][2], device=CPU)
    tables = interop.frame_tables(jt, cfield=4 * cfg.cones.field_basis,
                                  device=CPU)
    assert tables.field_mips[0].shape[-1] == 4 * cfg.cones.field_basis
    out = F.render_frame(cfg, ds, tables, mats, origins, dirs, cam).numpy()
    assert out.shape == fast_x.shape and np.isfinite(out).all()
    mean, p99 = _err(out, fast_x)
    assert mean < 1e-3, mean
    assert p99 < 1e-2, p99
    # the exact march is not the field: the two JAX frames differ
    assert np.abs(fast_x - jax_run[1]).max() > 1e-3


def test_own_build_matches_render_rays(jax_run, port_run):
    _, _, ref = jax_run
    cfg, ds, mats, voxels, origins, dirs, cam = port_run
    out = R.render_camera_pass(cfg, ds, voxels, mats, origins, dirs,
                               cam).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    mean, _ = _err(out, ref)
    assert mean < 0.03, mean


def test_alpha_resolve_recasts_banner_hits(port_run):
    """The bench camera sees banner pixels, so the re-cast has candidates;
    every row it rewrote was a masked hit and now lies farther along the
    same ray."""
    cfg, ds, mats, _, origins, dirs, _ = port_run
    hp, wp = -(-H // F.TSY) * F.TSY, -(-W // 64) * 64
    d = F._tile_order(F._pad_edge(dirs, hp, wp), hp, wp).contiguous()
    origin = origins.reshape(-1, 3)[0].contiguous()
    g0 = RP.raycast_gbuf24(d, origin, *RP.pack_tables(
        ds, origin, mats.albedo, mats.specular, mats.shininess))
    g1 = F.alpha_resolve(cfg, ds, mats, g0, d, origin)
    maskable = (mats.atlas.albedo[..., 3] < 0.5).flatten(1).any(dim=1)
    cand = (g0[:, 19] > 0.5) & maskable[g0[:, 17].long()]
    assert int(cand.sum()) > 0
    changed = (g1 != g0).any(dim=1)
    assert bool((changed <= cand).all())
    assert bool(((g1[changed, 18] > g0[changed, 18])
                 | (g1[changed, 19] == 0)).all())


def test_alpha_resolve_recasts_masked_edge(port_run):
    """From EDGE_CAMERA the first pass has masked candidates, and
    alpha_resolve rewrites exactly their rows: each now hits a surface
    farther along the same ray."""
    cfg, ds, mats = port_run[:3]
    origins, dirs = CAM.primary_rays(CAM.Camera(**EDGE_CAMERA), W, H,
                                     device=CPU)
    hp, wp = -(-H // F.TSY) * F.TSY, -(-W // 64) * 64
    d = F._tile_order(F._pad_edge(dirs, hp, wp), hp, wp).contiguous()
    origin = origins.reshape(-1, 3)[0].contiguous()
    g0 = RP.raycast_gbuf24(d, origin, *RP.pack_tables(
        ds, origin, mats.albedo, mats.specular, mats.shininess))
    idx, masked, _, _ = F.recast_inputs(cfg, mats, g0, d)
    n_masked = int(masked.sum())
    assert n_masked > 0
    g1 = F.alpha_resolve(cfg, ds, mats, g0, d, origin)
    changed = (g1 != g0).any(dim=1)
    assert int(changed.sum()) == n_masked
    assert bool(changed[idx[masked]].all())
    assert bool((g1[changed, 19] > 0.5).all())
    assert bool((g1[changed, 18] > g0[changed, 18]).all())
    np.testing.assert_allclose(
        g1[changed, 0:3].numpy(),
        (origin + g1[changed, 18:19] * d[changed]).numpy(), atol=1e-4)


# ---- tests/test_alpha_mask.py's fast-path cases ---------------------------

WALL_RGB = (0.9, 0.1, 0.1)
BG = (0.0, 0.0, 1.0)


def masked_scene(mask_value: float = 0.0, second_layer: bool = False):
    """tests/test_alpha_mask.py's scene: a red wall at z=-20 behind a green
    quad at z=0 whose left half (u < 0.5) is alpha-masked, and with
    second_layer a fully masked quad at z=-10 between them."""
    def quad(z):
        v = [(-40.0, -40.0, z), (40.0, -40.0, z), (40.0, 40.0, z),
             (-40.0, 40.0, z)]
        return v, [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]

    verts, uvs, tris, mats_idx = [], [], [], []

    def add(z, mat):
        v, uv = quad(z)
        base = len(verts)
        verts.extend(v)
        uvs.extend(uv)
        tris.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])
        mats_idx.extend([mat, mat])

    add(-20.0, 0)
    add(0.0, 1)
    if second_layer:
        add(-10.0, 2)
    m = np.ones((8, 8), np.float32)
    m[:, :4] = mask_value
    wall_tex = np.ones((4, 4, 3), np.float32) * np.asarray(WALL_RGB)
    materials = [
        Material(name="wall", albedo=(*WALL_RGB, 1.0),
                 albedo_texture=wall_tex),
        Material(name="masked", albedo=(0.1, 0.9, 0.1, 1.0),
                 mask_texture=m),
        Material(name="gone", albedo=(0.1, 0.1, 0.9, 1.0),
                 mask_texture=np.zeros((4, 4), np.float32)),
    ]
    return scene_from_arrays(
        np.asarray(verts, np.float32), np.asarray(tris, np.int32),
        uvs=np.asarray(uvs, np.float32),
        tri_material=np.asarray(mats_idx, np.int32), materials=materials)


def small_cfg(depth=2):
    cfg = preset("sponza256")
    return dataclasses.replace(
        cfg, grid=GridConfig(dim=16, world_size=150.0),
        render=dataclasses.replace(cfg.render, width=64, height=64,
                                   background=BG, alpha_mask_depth=depth))


def render_fast(cfg, scene):
    camera = CAM.Camera(position=(0.0, 0.0, 60.0), yaw=-90.0)
    ds, mats, samples = R.prepare_scene(cfg, scene, device=CPU)
    voxels = R.build_voxel_state(cfg, samples, mats)
    origins, dirs = CAM.primary_rays(camera, 64, 64, device=CPU)
    cam = torch.tensor(camera.position, dtype=torch.float32)
    return R.render_camera_pass(cfg, ds, voxels, mats, origins, dirs,
                                cam).numpy()


def test_masked_half_shows_wall():
    img = render_fast(small_cfg(), masked_scene())
    left, right = img[32, 16], img[32, 48]
    masked_col, kept_col = (16, 48) if left[0] > left[1] else (48, 16)
    mpx, kpx = img[32, masked_col], img[32, kept_col]
    assert mpx[0] > mpx[2] + 0.05, f"masked px shows background: {mpx}"
    assert kpx[1] > kpx[0], f"kept px lost the front quad: {kpx}"
    assert not np.any(img[8:56, 8:56, 2] > 0.9), "background leaked"


def test_stacked_masks_need_depth_2():
    scene = masked_scene(second_layer=True)
    img = render_fast(small_cfg(), scene)
    reds = [float(px[0] > px[1] and px[0] > px[2])
            for px in (img[32, 16], img[32, 48])]
    assert sum(reds) >= 1.0, (img[32, 16], img[32, 48])
    img1 = render_fast(small_cfg(depth=1), scene)
    col = 16 if reds[0] else 48
    assert img1[32, col][2] > 0.8, img1[32, col]


def test_depth_zero_keeps_background():
    img = render_fast(small_cfg(depth=0), masked_scene())
    assert (img[32, :, 2] > 0.9).sum() > 10


def test_port_config_matches_jax_small_cfg():
    """small_cfg built from the port's config equals the JAX one
    (GridConfig(dim, world_size) resets compute to float32 in both)."""
    j = jpreset("sponza256")
    j = dataclasses.replace(
        j, grid=JGridConfig(dim=16, world_size=150.0),
        render=dataclasses.replace(j.render, width=64, height=64,
                                   background=BG, alpha_mask_depth=2))
    assert dataclasses.asdict(small_cfg()) == dataclasses.asdict(j)
