"""The port's shadow map (vct_tpu_torch/render/shadowmap.py) and camera
matrices against the JAX package's, on the same numpy inputs, on the CPU,
and preset("reference") through build_voxel_state and render_rays.

Bounds, with what these fixtures measured on the CPU:
  * look_at, perspective, ortho, view_matrix and light_matrix: numpy
    float64 in both packages, equal to the bit;
  * project: atol 1e-6 (uv equal; the depth one float32 ulp, 6e-8, on
    some points: XLA's CPU dot fuses its last multiply-add, the port
    rounds each operation alone, ROADMAP Queue 3);
  * the map: atol 1e-6 (those depth ulps, measured 6.0e-8 on 882 of
    65,536 texels of the reference slice), the same texels covered;
  * the bilinear fetch: equal to the bit;
  * the PCF, by counting flips: the compare `current - bias <= closest`
    is a step, so an ulp in the depth flips a tap.  At least 99.9% of
    points must agree and every other one differ by a whole number of
    taps (measured: no flip on any fixture here);
  * preset("reference") at 32^3, 24x24, map 256 on the Cornell box:
    test_torch_oracle.hold_image's bounds, mean < 1e-4 and p99 < 1e-3,
    over the pixels whose PCF did not flip (measured: none flipped; mean
    1.2e-8, max 1.8e-7; radiance mips equal to the bit).
The JAX references run eagerly, as tests/test_shadowmap.py runs them
(render_image(..., jit=False)); jit fuses the shadow math differently.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.config import GridConfig as JGridConfig
from vct_tpu.config import LightConfig as JLightConfig
from vct_tpu.config import ShadowConfig as JShadowConfig
from vct_tpu.config import VCTConfig as JVCTConfig
from vct_tpu.config import preset as jpreset
from vct_tpu.core import camera as jcam
from vct_tpu.render import gbuffer as JGB
from vct_tpu.render import renderer as JR
from vct_tpu.render import shadowmap as JSM
from vct_tpu.scene.cornell import cornell_box as jcornell_box
from vct_tpu_torch import interop
from vct_tpu_torch.config import GridConfig, LightConfig, ShadowConfig
from vct_tpu_torch.config import VCTConfig, preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.render import gbuffer as GB
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.render import shadowmap as SM
from vct_tpu_torch.scene.cornell import cornell_box

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

CPU = torch.device("cpu")
FLIP_SHARE = 1e-3           # at most 0.1% of points may flip
LIGHTS = [(0.0, 1.0, 0.0),                 # along +y: the degenerate up
          (0.3, 1.0, 0.2), (-1.0, 0.5, 0.25), (0.0, -1.0, 0.0)]


def pair(light=None, **shadow):
    """(JAX config, port config) with shadow mode "map" and these
    overrides."""
    out = []
    for vc, sc, lc in ((JVCTConfig, JShadowConfig, JLightConfig),
                       (VCTConfig, ShadowConfig, LightConfig)):
        kw = dict(shadow=sc(mode="map", **shadow))
        if light is not None:
            kw["light"] = lc(direction=light)
        out.append(vc(**kw))
    return tuple(out)


def t(x):
    return torch.from_numpy(np.array(x))


def taps(value, cfg, normalization):
    """PCF values -> whole numbers of lit taps."""
    if normalization == "main" and cfg.shadow.pcf_normalization == "reference":
        return np.asarray(value, np.float64) / 0.111
    return np.asarray(value, np.float64) * (2 * cfg.shadow.pcf_radius + 1) ** 2


def hold_flips(a, b, cfg, normalization):
    """The port's PCF a against the JAX package's b: at least 99.9% of
    points equal, every other one off by a whole number of taps.  Returns
    the mask of flipped points."""
    ta, tb = taps(a, cfg, normalization), taps(b, cfg, normalization)
    np.testing.assert_allclose(ta, np.round(ta), atol=1e-4)
    np.testing.assert_allclose(tb, np.round(tb), atol=1e-4)
    flipped = np.round(ta) != np.round(tb)
    assert flipped.mean() <= FLIP_SHARE, (int(flipped.sum()), flipped.size)
    return flipped


# ---------------------------------------------------------------------------
# matrices
# ---------------------------------------------------------------------------

CAMERAS = [dict(), dict(position=(48.0, -10.0, 0.0), yaw=180.0),
           dict(position=(1.0, 2.0, 3.0), yaw=33.0, pitch=-71.0)]


def _matrix_args(fn, rng):
    if fn == "look_at":
        return (rng.normal(size=3) * 50, rng.normal(size=3),
                np.array([0.0, 1.0, 0.0]))
    if fn == "perspective":
        return (rng.uniform(10, 90), rng.uniform(0.5, 2.5), 0.1,
                rng.uniform(100, 1000))
    lo, hi = rng.uniform(-150, -1, 3), rng.uniform(1, 150, 3)   # ortho
    return (lo[0], hi[0], lo[1], hi[1], lo[2], hi[2])


@pytest.mark.parametrize("fn", ["look_at", "perspective", "ortho"])
def test_camera_matrices_equal(fn):
    rng = np.random.default_rng(0)
    for _ in range(8):
        args = _matrix_args(fn, rng)
        np.testing.assert_array_equal(getattr(CAM, fn)(*args),
                                      getattr(jcam, fn)(*args))


@pytest.mark.parametrize("cam", CAMERAS)
def test_view_matrix_equal(cam):
    np.testing.assert_array_equal(CAM.view_matrix(CAM.Camera(**cam)),
                                  jcam.view_matrix(jcam.Camera(**cam)))


@pytest.mark.parametrize("light", [None] + LIGHTS)
def test_light_matrix_equal(light):
    jc, pc = pair(light, ortho_extent=90.0, ortho_near=-80.0)
    a, b = SM.light_matrix(pc), JSM.light_matrix(jc)
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    jc, pc = pair(light)
    np.testing.assert_array_equal(SM.light_matrix(pc), JSM.light_matrix(jc))


@pytest.mark.parametrize("light", [None] + LIGHTS[:2])
def test_project_matches(light):
    jc, pc = pair(light)
    pts = np.random.default_rng(1).uniform(-200, 200, (4000, 3)).astype(
        np.float32)
    m = JSM.light_matrix(jc)
    uv, depth = SM.project(SM.light_matrix(pc), t(pts))
    juv, jdepth = JSM.project(m, jnp.asarray(pts))
    np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("light", [None, LIGHTS[0]])
def test_build_shadow_map_matches(light):
    """Random points at S=64, a third off the map (|coordinate| past the
    +-120 extent) or off the depth range (+-100)."""
    jc, pc = pair(light, map_size=64)
    pts = np.random.default_rng(2).uniform(-200, 200, (6000, 3)).astype(
        np.float32)
    a = SM.build_shadow_map(pc, t(pts)).numpy()
    b = np.asarray(JSM.build_shadow_map(jc, jnp.asarray(pts)))
    assert a.shape == (64, 64) and a.dtype == np.float32
    np.testing.assert_array_equal(a < 1.0, b < 1.0)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert 0.2 < (a < 1.0).mean() < 1.0           # covered and empty texels
    uv, depth = SM.project(SM.light_matrix(pc), t(pts))
    off = ((uv < 0) | (uv > 1)).any(dim=1) | (depth < 0) | (depth > 1)
    assert 0.2 < float(off.float().mean()) < 0.9


def test_bilinear_depth_edges():
    """Texel centers, the map's edges and corners, and uv well outside
    [0, 1] (CLAMP_TO_EDGE), on a random map."""
    s = 16
    smap = np.random.default_rng(3).random((s, s), np.float32)
    edge = np.array([-3.0, -0.2, 0.0, 0.5 / s, 0.3, 0.5, 1 - 0.5 / s, 1.0,
                     1.2, 4.0], np.float32)
    uv = np.stack(np.meshgrid(edge, edge), -1).reshape(-1, 2)
    uv = np.concatenate([uv, np.random.default_rng(4).uniform(
        -0.5, 1.5, (500, 2)).astype(np.float32)])
    a = SM._bilinear_depth(t(smap), t(uv)).numpy()
    b = np.asarray(JSM._bilinear_depth(jnp.asarray(smap), jnp.asarray(uv)))
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def cornell_samples():
    """The Cornell box's surface samples at 32^3, and the points a few
    units off them."""
    cfg = dataclasses.replace(jpreset("reference"), grid=JGridConfig(
        dim=32, world_size=150.0))
    _, _, samples = JR.prepare_scene(cfg, jcornell_box(size=100.0))
    pos = np.asarray(samples.positions)
    rng = np.random.default_rng(5)
    return np.concatenate([pos, pos[::7] + rng.normal(
        size=pos[::7].shape).astype(np.float32) * 3.0])


@pytest.mark.parametrize("normalization,pcf", [
    ("main", "reference"), ("main", "correct"), ("voxelize", "reference")])
def test_pcf_shadow_matches(cornell_samples, normalization, pcf):
    """On one map (the JAX package's) and on each package's own map."""
    jc, pc = pair(map_size=256, pcf_normalization=pcf)
    pts = cornell_samples
    jmap = JSM.build_shadow_map(jc, jnp.asarray(pts))
    pmap = SM.build_shadow_map(pc, t(pts))
    b = np.asarray(JSM.pcf_shadow(jc, jmap, jnp.asarray(pts), normalization))
    for smap in (t(np.asarray(jmap)), pmap):
        a = SM.pcf_shadow(pc, smap, t(pts), normalization).numpy()
        hold_flips(a, b, pc, normalization)
    lit = taps(b, pc, normalization)
    assert 0.05 < (lit == 0).mean() < 0.95        # shadowed and lit points


# ---------------------------------------------------------------------------
# tests/test_shadowmap.py's behavioural cases on the port
# ---------------------------------------------------------------------------

def map_cfg(**kw):
    return VCTConfig(shadow=ShadowConfig(mode="map", map_size=128, **kw))


def test_projects_origin_to_center():
    uv, d = SM.project(SM.light_matrix(map_cfg()), torch.zeros((1, 3)))
    np.testing.assert_allclose(uv.numpy()[0], [0.5, 0.5], atol=1e-5)
    np.testing.assert_allclose(float(d[0]), 0.5, atol=0.02)


def test_depth_increases_away_from_light():
    cfg = map_cfg()
    l = np.asarray(cfg.light.direction, np.float64)
    l /= np.linalg.norm(l)
    _, d = SM.project(SM.light_matrix(cfg),
                      torch.tensor(np.stack([l * 50.0, -l * 50.0]),
                                   dtype=torch.float32))
    assert float(d[0]) < float(d[1])


def test_ortho_extent_maps_to_unit_uv():
    cfg = map_cfg()
    eye = np.asarray(cfg.light.direction, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    s = np.cross(fwd, [0.0, 1.0, 0.0])
    s /= np.linalg.norm(s)
    uv, _ = SM.project(SM.light_matrix(cfg), torch.tensor(
        s * cfg.shadow.ortho_extent, dtype=torch.float32)[None])
    np.testing.assert_allclose(float(uv[0, 0]), 1.0, atol=1e-4)


def test_occluder_shadows_point_below():
    cfg = VCTConfig(light=LightConfig(direction=(0.0, 1.0, 0.0)),
                    shadow=ShadowConfig(mode="map", map_size=256))
    xs = np.linspace(-20, 20, 80)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    plate = np.stack([gx, np.full_like(gx, 30.0), gz], -1).reshape(-1, 3)
    smap = SM.build_shadow_map(cfg, torch.tensor(plate, dtype=torch.float32))
    queries = torch.tensor([[0.0, -20.0, 0.0], [60.0, -20.0, 0.0],
                            [0.0, 50.0, 0.0]])
    s = SM.pcf_shadow(cfg, smap, queries, "voxelize").numpy()
    assert s[0] < 0.05 and s[1] > 0.95 and s[2] > 0.95


def test_reference_pcf_quirk_brightens():
    cfg_ref = VCTConfig(shadow=ShadowConfig(mode="map", map_size=64,
                                            pcf_normalization="reference"))
    cfg_cor = VCTConfig(shadow=ShadowConfig(mode="map", map_size=64,
                                            pcf_normalization="correct"))
    smap, q = torch.ones((64, 64)), torch.zeros((1, 3))
    np.testing.assert_allclose(
        float(SM.pcf_shadow(cfg_cor, smap, q, "main")[0]), 1.0, atol=1e-6)
    np.testing.assert_allclose(
        float(SM.pcf_shadow(cfg_ref, smap, q, "main")[0]), 25 * 0.111,
        atol=1e-6)
    np.testing.assert_allclose(
        float(SM.pcf_shadow(cfg_ref, smap, q, "voxelize")[0]), 1.0,
        atol=1e-6)


# ---------------------------------------------------------------------------
# preset("reference") through build_voxel_state and render_rays
# ---------------------------------------------------------------------------

CAMERA = dict(position=(0.0, 0.0, 140.0))
SIZE = 24


def cut(make_preset, grid_cls):
    cfg = make_preset("reference")
    return dataclasses.replace(
        cfg, grid=grid_cls(dim=32, world_size=150.0),
        render=dataclasses.replace(cfg.render, width=SIZE, height=SIZE),
        shadow=dataclasses.replace(cfg.shadow, map_size=256))


@pytest.fixture(scope="module")
def reference():
    """The JAX package's eager build and its render_rays image, and the
    port's own build from the same samples."""
    jc, pc = cut(jpreset, JGridConfig), cut(preset, GridConfig)
    ds, mats, samples = JR.prepare_scene(jc, jcornell_box(size=100.0))
    jv = JR.build_voxel_state(jc, samples, mats)
    origins, dirs = jcam.primary_rays(jcam.Camera(**CAMERA), SIZE, SIZE)
    cam = jnp.asarray(CAMERA["position"], jnp.float32)
    img = np.asarray(JR.render_rays(jc, ds, jv, mats, origins, dirs, cam,
                                    chunk_size=1024))
    d = dirs.reshape(-1, 3)
    gbuf = JGB.raycast_chunk_pinhole(ds, JGB.pinhole_constants(ds, origins[
        0, 0]), origins[0, 0], d)
    j = dict(voxels=jv, img=img, samples=samples,
             pcf=np.asarray(JSM.pcf_shadow(jc, jv.shadow_map, gbuf.position,
                                           "main")),
             sample_pcf=np.asarray(JSM.pcf_shadow(
                 jc, jv.shadow_map, samples.positions, "voxelize")))
    pds, pmats, _ = R.prepare_scene(pc, cornell_box(size=100.0), device=CPU)
    psamples = interop.samples(jax.tree_util.tree_map(np.asarray, samples),
                               device=CPU)
    pv = R.build_voxel_state(pc, psamples, pmats)
    po, pd = CAM.primary_rays(CAM.Camera(**CAMERA), SIZE, SIZE, device=CPU)
    p = dict(ds=pds, mats=pmats, samples=psamples, voxels=pv, origins=po,
             dirs=pd, cam=torch.tensor(CAMERA["position"]))
    return jc, pc, j, p


def test_reference_build_matches(reference):
    jc, pc, j, p = reference
    pv, jv = p["voxels"], j["voxels"]
    jmap = np.asarray(jv.shadow_map)
    assert pv.shadow_map.shape == (256, 256)
    np.testing.assert_array_equal(pv.shadow_map.numpy() < 1.0, jmap < 1.0)
    np.testing.assert_allclose(pv.shadow_map.numpy(), jmap, atol=1e-6,
                               rtol=0)
    assert pv.light_volume is None and jv.light_volume is None
    a = SM.pcf_shadow(pc, pv.shadow_map, p["samples"].positions,
                      "voxelize").numpy()
    flipped = hold_flips(a, j["sample_pcf"], pc, "voxelize")
    # a flipped sample changes the radiance it splats: hold the voxels
    # that hold none
    dim = pc.grid.dim
    vox = np.clip(np.floor((p["samples"].positions.numpy() / 75.0 * 0.5
                            + 0.5) * dim), 0, dim - 1).astype(int)
    keep = np.ones((dim,) * 3, bool)
    keep[tuple(vox[flipped].T)] = False
    np.testing.assert_allclose(pv.radiance_mips[0].numpy()[keep],
                               np.asarray(jv.radiance_mips[0])[keep],
                               atol=1e-5, rtol=0)
    if not flipped.any():
        for a_, b_ in zip(pv.radiance_mips + pv.unlit_mips,
                          jv.radiance_mips + jv.unlit_mips):
            np.testing.assert_allclose(a_.numpy(), np.asarray(b_),
                                       atol=1e-5, rtol=0)


def test_reference_render_rays_matches(reference):
    """render_camera_pass takes render_rays; held over the pixels whose
    main-pass PCF did not flip."""
    jc, pc, j, p = reference
    assert not R.use_fast_path(pc)
    out = R.render_camera_pass(pc, p["ds"], p["voxels"], p["mats"],
                               p["origins"], p["dirs"], p["cam"]).numpy()
    d = p["dirs"].reshape(-1, 3)
    o = p["origins"].reshape(-1, 3)[0]
    g = GB.raycast_chunk_pinhole(p["ds"], GB.pinhole_constants(p["ds"], o),
                                 o, d)
    pcf = SM.pcf_shadow(pc, p["voxels"].shadow_map, g.position,
                        "main").numpy()
    flipped = hold_flips(pcf, j["pcf"], pc, "main").reshape(SIZE, SIZE)
    err = np.abs(out - j["img"])[~flipped]
    assert out.shape == j["img"].shape and np.isfinite(out).all()
    assert err.mean() < 1e-4, err.mean()
    assert np.percentile(err, 99) < 1e-3, np.percentile(err, 99)
    assert float(out.mean()) > 0.01
    lit = taps(j["pcf"], pc, "main")[np.asarray(g.hit)]
    assert 0.0 < (np.round(lit) == 0).mean() < 1.0   # shadowed and lit
