"""The PyTorch port's host-side helpers and small device math, held equal
to the JAX package's on the same inputs (tests/conftest.py keeps JAX on
the CPU).  Host code is pure Python/numpy in both packages, so most
checks are exact; float tensor math states its tolerance."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.config import preset as jpreset
from vct_tpu.core import camera as jcam
from vct_tpu.core import cones as jcones
from vct_tpu.core import dense as jdense
from vct_tpu.core import grid as jgrid
from vct_tpu.core import march as jmarch
from vct_tpu.ops import raycast_pallas as JRP
from vct_tpu.render import gbuffer as jgbuf
from vct_tpu.render import shading as jshading
from vct_tpu.render import voxelize as jvox
from vct_tpu.scene.atrium import atrium as jatrium
from vct_tpu.scene.cornell import cornell_box as jcornell_box
from vct_tpu_torch.config import preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.core import cones as C
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.render import gbuffer as GB
from vct_tpu_torch.render import shading as S
from vct_tpu_torch.render import voxelize as V
from vct_tpu_torch.scene.atrium import atrium
from vct_tpu_torch.scene.cornell import cornell_box

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

SCHEDULES = [
    (0.577, 150.0 / 256, 75.0, None, 1.0),     # diffuse at 256^3
    (0.07, 150.0 / 256, 75.0, None, 2.0),      # specular field
    (0.03, 150.0 / 256, 3 ** 0.5 * 150.0, None, 0.5),   # shadow
    (0.07, 150.0 / 32, 75.0, 5, 1.0),          # capped steps
]


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("args", SCHEDULES)
def test_march_schedule_equal(args):
    a = M.march_schedule(*args)
    b = jmarch.march_schedule(*args)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("num_levels", [1, 5, 9])
@pytest.mark.parametrize("args", SCHEDULES[:3])
def test_lod_plan_and_groups_equal(args, num_levels):
    lods = M.march_schedule(*args).lods
    assert M._static_lod_plan(lods, num_levels) == \
        jmarch._static_lod_plan(lods, num_levels)
    assert D.plan_groups(lods, num_levels) == \
        jdense.plan_groups(lods, num_levels)


@pytest.mark.parametrize("df,dl,shift", [(8, 8, 0.3), (8, 16, -2.7),
                                         (16, 4, 5.25), (4, 1, 0.0)])
def test_axis_indices_equal(df, dl, shift):
    for a, b in zip(D._axis_indices(df, dl, shift),
                    jdense._axis_indices(df, dl, shift)):
        np.testing.assert_array_equal(a, b)


def test_cone_constants_equal():
    np.testing.assert_array_equal(C.CONE_DIRECTIONS, jcones.CONE_DIRECTIONS)
    np.testing.assert_array_equal(C.CONE_WEIGHTS, jcones.CONE_WEIGHTS)


@pytest.mark.parametrize("n", [6, 26])
def test_direction_basis_equal(n):
    np.testing.assert_array_equal(D.direction_basis(n),
                                  jdense.direction_basis(n))


@pytest.mark.parametrize("seed", [0, 1])
def test_morton_order_equal(seed):
    c = np.random.default_rng(seed).normal(size=(500, 3)) * 40
    c[::7] = c[3]                        # ties: stable order decides
    np.testing.assert_array_equal(GB._morton_order(c),
                                  jgbuf._morton_order(c))


@pytest.mark.parametrize("cam,w,h", [
    (dict(position=(3.0, 2.0, 40.0)), 64, 48),
    (dict(position=(48.0, -10.0, 0.0), yaw=180.0), 33, 17),
    (dict(position=(1.0, 2.0, 3.0), yaw=-30.0, pitch=20.0, zoom=60.0), 16, 16),
])
def test_primary_rays_equal(cam, w, h):
    o, d = CAM.primary_rays(CAM.Camera(**cam), w, h, device="cpu")
    jo, jd = jcam.primary_rays(jcam.Camera(**cam), w, h)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


SCENES = {"cornell": (lambda: cornell_box(size=100.0),
                      lambda: jcornell_box(size=100.0)),
          "atrium": (atrium, jatrium)}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_device_scene_equal(name):
    make, jmake = SCENES[name]
    ds = GB.DeviceScene.from_scene(make(), device="cpu")
    jds = jgbuf.DeviceScene.from_scene(jmake())
    for f in dataclasses.fields(jds):
        np.testing.assert_array_equal(getattr(ds, f.name).numpy(),
                                      np.asarray(getattr(jds, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_tables_match(name):
    """Triangle rows equal the JAX tables' columns.  Cornell's are exact;
    on the atrium XLA's CPU compiler fuses some cross-product
    multiply-subtracts (one rounding instead of two), so an entry may
    differ by an ulp of its products: 1e-6 of the row's largest entry."""
    make, jmake = SCENES[name]
    scene = make()
    ds = GB.DeviceScene.from_scene(scene, device="cpu")
    jds = jgbuf.DeviceScene.from_scene(jmake())
    rng = np.random.default_rng(1)
    m = len(scene.materials)
    alb, spec = rng.random((m, 4), np.float32), rng.random((m, 3), np.float32)
    shin = rng.random(m).astype(np.float32) * 40
    o = np.array([3.0, 2.0, 40.0], np.float32)
    isect, attrs = RP.pack_tables(ds, t(o), t(alb), t(spec), t(shin))
    ji, ja, n = JRP.pack_tables(jds, jnp.asarray(o), jnp.asarray(alb),
                                jnp.asarray(spec), jnp.asarray(shin))
    assert n == isect.shape[0]
    np.testing.assert_array_equal(attrs.numpy(), np.asarray(ja)[:n])
    ref = np.asarray(ji).T[:n]
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert np.all(np.abs(isect.numpy() - ref) <= 1e-6 * scale)
    if scene.num_triangles == 40:
        np.testing.assert_array_equal(isect.numpy(), ref)


@pytest.mark.parametrize("backend", ["auto", "python"])
def test_surface_samples_equal(backend):
    """The port's numpy generator against the JAX package's numpy path
    (equal as they stand) and its native generator, where that library
    builds: the native one emits triangle by triangle, the numpy one by
    subdivision level, so the two are equal once stably sorted by
    triangle (tests/test_native.py)."""
    a = V.generate_surface_samples(cornell_box(size=100.0), 150.0 / 32, 2.0)
    b = jvox.generate_surface_samples(jcornell_box(size=100.0), 150.0 / 32,
                                      2.0, backend=backend)
    fields = ("positions", "normals", "uvs", "material_ids", "tri_ids")
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if backend == "auto":
            x = x[np.argsort(a.tri_ids, kind="stable")]
            y = y[np.argsort(b.tri_ids, kind="stable")]
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_splat_matches(mode):
    """Deterministic sort + segment reduction vs the JAX scatter-add; the
    sums run in sample order in both, atol 1e-6 covers reassociation."""
    rng = np.random.default_rng(2)
    pos = rng.uniform(-80, 80, (4000, 3)).astype(np.float32)   # some outside
    val = rng.random((4000, 3), np.float32)
    w = (rng.random(4000) > 0.1).astype(np.float32)
    a = V.splat(t(pos), t(val), t(w), 16, 150.0, mode=mode).numpy()
    b = np.asarray(jvox.splat(jnp.asarray(pos), jnp.asarray(val),
                              jnp.asarray(w), 16, 150.0, mode=mode))
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert a[..., 3].sum() > 100


def test_trilinear_sample_matches():
    rng = np.random.default_rng(3)
    grid = rng.random((8, 8, 8, 5), np.float32)
    uvw = rng.uniform(-0.1, 1.1, (300, 3)).astype(np.float32)
    np.testing.assert_allclose(
        G.trilinear_sample(t(grid), t(uvw)).numpy(),
        np.asarray(jgrid.trilinear_sample(jnp.asarray(grid),
                                          jnp.asarray(uvw))),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("compute", [None, "bfloat16"])
@pytest.mark.parametrize("transmittance", [False, True])
def test_directional_march_matches(compute, transmittance):
    """Gather-and-lerp resample vs the JAX interpolation-matrix einsums.
    In bf16 both round the level, the weights and each axis result to bf16
    and accumulate exact bf16 products in f32, so they agree to f32
    rounding; atol 1e-6 on values of order 1."""
    rng = np.random.default_rng(4)
    mips = jgrid.build_mips(jnp.asarray(rng.random((16, 16, 16, 4),
                                                   np.float32)))
    sched = jmarch.march_schedule(0.3, 150.0 / 16, 75.0,
                                  step_factor=2.0 if compute else 1.0)
    basis = jdense.direction_basis(6)
    jdt = jnp.bfloat16 if compute else None
    tdt = torch.bfloat16 if compute else None
    kw = dict(field_dim=8, opacity_gain=4.0 if transmittance else 1.0,
              transmittance_only=transmittance)
    b = np.asarray(jdense.directional_march_multi(
        mips, basis, sched, 150.0, compute_dtype=jdt, **kw))
    b = np.moveaxis(b, 0, -2).reshape(8, 8, 8, -1)
    a = D.directional_march_multi([t(m) for m in mips], basis, sched, 150.0,
                                  compute_dtype=tdt, **kw).numpy()
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_anisotropic_mips_match(compute):
    """A one-level stack of a directional (2, 2, 2, 6, 4) level: it is
    resampled packed to 24 channels and its six directions blended after,
    as the JAX package's _unblend does; atol 1e-6 as above."""
    level = np.random.default_rng(6).random((2, 2, 2, 6, 4), np.float32)
    sched = M.march_schedule(0.3, 1.0, 2.0)
    basis = D.direction_basis(6)
    b = np.asarray(jdense.directional_march_multi(
        [jnp.asarray(level)], basis, sched, 2.0,
        compute_dtype=jnp.bfloat16 if compute else None))
    b = np.moveaxis(b, 0, -2).reshape(2, 2, 2, -1)
    a = D.directional_march_multi(
        [t(level)], basis, sched, 2.0,
        compute_dtype=torch.bfloat16 if compute else None).numpy()
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert np.abs(a).max() > 0


def _dim16(cfg):
    return dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid, dim=16))


def test_light_corner_tap_matches():
    cfg, jcfg = _dim16(preset("sponza256")), _dim16(jpreset("sponza256"))
    rng = np.random.default_rng(5)
    vol = rng.random((16, 16, 16, 1), np.float32)
    pos = rng.uniform(-70, 70, (500, 3)).astype(np.float32)
    nrm = rng.normal(size=(500, 3)).astype(np.float32)
    packed = S.pack_light_corners(t(vol))
    jpacked = jshading.pack_light_corners(jnp.asarray(vol))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_allclose(
        S.shadow_volume_tap_packed(cfg, packed, 16, t(pos), t(nrm)).numpy(),
        np.asarray(jshading.shadow_volume_tap_packed(
            jcfg, jpacked, 16, jnp.asarray(pos), jnp.asarray(nrm))),
        atol=1e-6, rtol=0)


def test_shading_helpers_match():
    cfg = preset("sponza256")
    rng = np.random.default_rng(6)
    n = 300

    def r(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, (n,) + shape).astype(np.float32)

    args = dict(albedo=r(3), spec_color=r(3), normal=r(3, lo=-1),
                eye_dir=np.asarray(jcones.normalize(jnp.asarray(r(3, lo=-1)))),
                shadow=r(), ind_diffuse_rgb=r(3), ind_diffuse_occ=r(),
                ind_spec_rgb=r(3), ind_spec_occ=r(), shininess=r(hi=40))
    light = np.array([0.0, 0.97014, 0.24254], np.float32)
    a = S.combine(cfg, light_dir=t(light), **{k: t(v) for k, v in args.items()})
    b = jshading.combine(jpreset("sponza256"), light_dir=jnp.asarray(light),
                         **{k: jnp.asarray(v) for k, v in args.items()})
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    nrm, eye = r(3, lo=-1), r(3, lo=-1)
    np.testing.assert_allclose(
        S.reflect_eye(t(nrm), t(eye)).numpy(),
        np.asarray(jshading.reflect_eye(jnp.asarray(nrm), jnp.asarray(eye))),
        atol=1e-6)
    spec = r(3)
    spec[::3, 1:] = 0.0
    np.testing.assert_array_equal(
        S.spec_gray_fallback(t(spec)).numpy(),
        np.asarray(jshading.spec_gray_fallback(jnp.asarray(spec))))
    t_, bt = C.orthonormal_frame(C.normalize(t(nrm)))
    jt, jbt = jcones.orthonormal_frame(jcones.normalize(jnp.asarray(nrm)))
    np.testing.assert_allclose(t_.numpy(), np.asarray(jt), atol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(jbt), atol=1e-6)


@pytest.mark.parametrize("fn", ["diffuse_schedule", "specular_schedule",
                                "specular_field_schedule", "shadow_schedule",
                                "field_dim"])
def test_config_derived_equal(fn):
    def plain(x):
        return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x

    for name in ("sponza256", "cornell64_full"):
        assert (plain(getattr(S, fn)(preset(name)))
                == plain(getattr(jshading, fn)(jpreset(name))))
