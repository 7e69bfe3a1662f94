"""The port's per-cone oracle renderer (render_rays and everything it
calls) against the JAX package, on the same numpy inputs, on the CPU.

Fixtures: tests/test_march.py's 32^3 grid of random emissive blobs for
the march; tests/test_renderer.py's Cornell box (preset cornell64_full
cut to a 32^3 grid, 64x64, camera (0, 0, 140)) and tests/test_pinhole.py's
atrium rays (48x32 from the bench camera) for the raycasts; the atrium
under cornell64_full at 32^3 / 96x64 from the bench camera (the alpha
re-cast and the bump normal) end to end.

Bounds, with what these fixtures measured on the CPU:
  * grid, cones, basis weights, march functions, the shadow cone and the
    four indirect providers: atol 1e-5 (measured max 2.0e-6, the
    specular cone; the rest 5.4e-7 or less);
  * raycasts: hit, tri, material and t equal wherever the winners agree,
    and at least 99.9% must agree.  Every winner agrees on the pinhole
    path (Cornell 4,096 rays, atrium 1,536 with and without tmin, its
    fields bit-equal) and on the atrium's general path; on the Cornell
    grid the general paths differ on 23 rays, all on the image's
    diagonals (test_raycast_cornell_grid).  At the hits: atol 1e-5, t and
    position also rtol 1e-5 (measured 1.8e-5 at t = 64-90, two float32
    steps), the general path's uv atol 1e-4 (measured 3.1e-5 on grazing
    rays);
  * shade_gbuffer on one JAX G-buffer and the JAX voxel state carried
    across: mean < 1e-5, max < 1e-4 (measured mean 7.4e-9 and 1.3e-8 in
    field mode, max 4.5e-7; the atrium mean 2.0e-8, max 1.2e-6);
  * render_rays on the carried JAX state: mean < 1e-4, p99 < 1e-3
    (measured Cornell mean 1.2e-8, p99 1.5e-7, max 1.0e-6; atrium mean
    2.3e-7, p99 3.8e-6, max 9.5e-5); on the port's own build the same
    bounds (measured the same to two digits; the builds agree to 6.0e-7);
  * the build with gi_bounces=3 (volume shadows) and with shadow mode
    "percone" at 16^3: atol 1e-5 (measured max 3.4e-7).
The JAX references run under jax.jit, one compile each, except the
shadow cone: under jit XLA fuses its lerps and its 72-step product and
lands up to 1.7e-5 from eager JAX, which rounds every operation as the
port does.
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
from vct_tpu.core import cones as JC
from vct_tpu.core import dense as JD
from vct_tpu.core import grid as JG
from vct_tpu.core import march as JM
from vct_tpu.render import gbuffer as JGB
from vct_tpu.render import renderer as JR
from vct_tpu.render import shading as JS
from vct_tpu.scene.atrium import atrium as jatrium
from vct_tpu.scene.cornell import cornell_box as jcornell_box
from vct_tpu_torch import interop
from vct_tpu_torch.config import GridConfig, preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.core import cones as C
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M
from vct_tpu_torch.render import gbuffer as GB
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.render import shading as S
from vct_tpu_torch.scene.cornell import cornell_box

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

CPU = torch.device("cpu")
ATOL = 1e-5
# the general raycast's barycentrics divide by det: on grazing rays (cos
# 0.01 to the triangle) a rounding difference grows (measured 3.1e-5)
GENERAL_UV_ATOL = 1e-4
CORNELL_CAMERA = dict(position=(0.0, 0.0, 140.0))
BENCH_CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0)
EDGE_CAMERA = dict(position=(48.0, 20.0, 0.0), yaw=180.0, pitch=-10.0)


def jit_ref(fn, *static):
    """The JAX reference under jit: one compile, not one per eager op."""
    return jax.jit(fn, static_argnums=static)


def as_torch(x):
    return torch.from_numpy(np.array(x))


def close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def cut_config(make_preset, grid_cls, dim, w, h, name="cornell64_full", **cones):
    cfg = make_preset(name)
    return dataclasses.replace(
        cfg, grid=grid_cls(dim=dim, world_size=150.0),
        cones=dataclasses.replace(cfg.cones, **cones),
        render=dataclasses.replace(cfg.render, width=w, height=h))


def cfg_pair(dim, w, h, name="cornell64_full", **cones):
    """(JAX config, port config) of one preset cut the same way."""
    return (cut_config(jpreset, JGridConfig, dim, w, h, name, **cones),
            cut_config(preset, GridConfig, dim, w, h, name, **cones))


# ---------------------------------------------------------------------------
# grid, cones, basis weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blob_mips():
    """tests/test_march.py's 32^3 grid of 40 random emissive blobs."""
    rng = np.random.default_rng(42)
    dim = 32
    base = np.zeros((dim, dim, dim, 4), np.float32)
    for _ in range(40):
        i, j, l = rng.integers(4, dim - 4, size=3)
        base[i, j, l] = [*rng.uniform(0.2, 1.0, 3), rng.uniform(0.3, 1.0)]
    jm = JG.build_mips(jnp.asarray(base))
    return jm, tuple(as_torch(m) for m in jm)


@pytest.mark.parametrize("lod", [0.0, 0.5, 1.0, 2.3, 4.0, 7.5])
def test_sample_lod_and_voxels(blob_mips, lod):
    jm, pm = blob_mips
    rng = np.random.default_rng(1)
    uvw = rng.uniform(-0.1, 1.1, (50, 3)).astype(np.float32)
    close(G.sample_lod(pm, as_torch(uvw), lod), JG.sample_lod(jm, uvw, lod))
    p = rng.uniform(-80, 80, (50, 3)).astype(np.float32)
    close(G.sample_voxels(pm, as_torch(p), lod, 150.0),
           JG.sample_voxels(jm, jnp.asarray(p), lod, 150.0))


def test_tbn_and_rotate_cones():
    rng = np.random.default_rng(2)
    n = rng.normal(size=(64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t, bt = (np.array(x) for x in JC.orthonormal_frame(jnp.asarray(n)))
    # half the frames orthonormal, half sheared (imported tangents)
    t[32:] += 0.3 * rng.normal(size=(32, 3)).astype(np.float32)
    jt = JC.tbn_matrix(jnp.asarray(t), jnp.asarray(bt), jnp.asarray(n))
    pt = C.tbn_matrix(as_torch(t), as_torch(bt), as_torch(n))
    close(pt, jt)
    dirs = JC.CONE_DIRECTIONS
    close(C.rotate_cones(pt, as_torch(dirs)), JC.rotate_cones(jt, dirs))
    # a singular frame gives non-finite entries and raises nothing
    z = torch.zeros(1, 3)
    assert not bool(torch.isfinite(C.tbn_matrix(z, z, z)).all())


@pytest.mark.parametrize("nb", [6, 26])
@pytest.mark.parametrize("power", [8.0, 32.0, 3.0])
def test_basis_weights(nb, power):
    rng = np.random.default_rng(3)
    d = rng.normal(size=(40, 6, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    basis = JD.direction_basis(nb)
    close(D.basis_weights(as_torch(d), D.direction_basis(nb), power),
           JD.basis_weights(jnp.asarray(d), basis, power))


# ---------------------------------------------------------------------------
# the march (tests/test_march.py's fixtures)
# ---------------------------------------------------------------------------

def _composite_both(colors, alphas, diams, **kw):
    a = M.composite(as_torch(colors), as_torch(alphas), tuple(diams), **kw)
    b = JM.composite(jnp.asarray(colors), jnp.asarray(alphas), tuple(diams),
                     **kw)
    for x, y in zip(a, b):
        close(x, y)
    return a


@pytest.mark.parametrize("step_factor", [1.0, 2.0])
def test_composite_random(step_factor):
    rng = np.random.default_rng(0)
    k = 12
    _composite_both(rng.uniform(size=(5, k, 3)).astype(np.float32),
                    rng.uniform(0, 0.4, size=(5, k)).astype(np.float32),
                    rng.uniform(0.5, 5.0, size=(k,)).astype(np.float32),
                    step_factor=step_factor)


def test_composite_early_out_and_opaque_first_step():
    color, _, alpha = _composite_both(np.ones((5, 3), np.float32),
                                      np.full(5, 0.9, np.float32), (1.0,) * 5)
    close(color, [1.1, 1.1, 1.1], atol=1e-6)
    close(alpha, 0.99, atol=1e-6)
    colors = np.random.default_rng(1).uniform(size=(4, 3)).astype(np.float32)
    color, occ, alpha = _composite_both(
        colors, np.asarray([1.0, 0.5, 0.5, 0.5], np.float32), (2.0,) * 4)
    close(color, colors[0], atol=1e-6)
    close(occ, 1.0 / 1.06, atol=1e-6)


def test_sample_schedule(blob_mips):
    jm, pm = blob_mips
    sched = JM.march_schedule(0.07, 150.0 / 32, 75.0)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-60, 60, (6, sched.num_steps, 3)).astype(np.float32)
    close(M.sample_schedule(pm, as_torch(pts), sched.lods, 150.0),
           jit_ref(JM.sample_schedule, 2, 3)(jm, jnp.asarray(pts), sched.lods,
                                          150.0))


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-40, 40, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    return starts, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


@pytest.mark.parametrize("tan_half", [0.577, 0.07])
def test_cone_march(blob_mips, tan_half):
    jm, pm = blob_mips
    sched = M.march_schedule(tan_half, 150.0 / 32, 75.0)
    starts, dirs = _rays(7, 6)
    a = M.cone_march(pm, as_torch(starts), as_torch(dirs), sched, 150.0)
    b = jit_ref(JM.cone_march, 3, 4)(
        jm, jnp.asarray(starts), jnp.asarray(dirs),
        JM.march_schedule(tan_half, 150.0 / 32, 75.0), 150.0)
    for x, y in zip(a, b):
        close(x, y)
    assert float(a[2].max()) > 0          # the cones see the blobs


def test_cone_march_empty_grid_and_no_steps():
    mips = G.build_mips(torch.zeros(16, 16, 16, 4))
    sched = M.march_schedule(0.577, 150.0 / 16, 75.0)
    color, _, alpha = M.cone_march(
        mips, torch.zeros(2, 3), torch.tensor([[0, 0, 1.0], [1.0, 0, 0]]),
        sched, 150.0)
    assert float(color.abs().max()) == 0.0 and float(alpha.max()) == 0.0
    none = M.march_schedule(0.577, 150.0 / 16, 1.0)
    assert none.num_steps == 0
    out = M.cone_march(mips, torch.zeros(2, 3), torch.ones(2, 3), none, 150.0)
    assert [tuple(x.shape) for x in out] == [(2, 3), (2,), (2,)]


def test_cone_march_multi(blob_mips):
    jm, pm = blob_mips
    start = np.random.default_rng(3).uniform(-30, 30, (4, 3)).astype(
        np.float32)
    n = np.tile(np.asarray([0.0, 1.0, 0.0], np.float32), (4, 1))
    t, bt = JC.orthonormal_frame(jnp.asarray(n))
    jdirs = JC.rotate_cones(JC.tbn_matrix(t, bt, jnp.asarray(n)),
                            jnp.asarray(JC.CONE_DIRECTIONS))
    sched = M.march_schedule(0.577, 150.0 / 32, 75.0)
    a = M.cone_march_multi(pm, as_torch(start), as_torch(jdirs),
                           tuple(C.CONE_WEIGHTS), sched, 150.0)
    b = jit_ref(JM.cone_march_multi, 3, 4, 5)(
        jm, jnp.asarray(start), jdirs, tuple(float(w) for w in JC.CONE_WEIGHTS),
        JM.march_schedule(0.577, 150.0 / 32, 75.0), 150.0)
    for x, y in zip(a, b):
        close(x, y)


def test_anisotropic_stack_sample_schedule():
    """A (4^3 x 4, 2^3 x 6 x 4) anisotropic stack: the directional level
    blends by the travel direction, which it then requires."""
    rng = np.random.default_rng(8)
    jm = (jnp.asarray(rng.random((4, 4, 4, 4), np.float32)),
          jnp.asarray(rng.random((2, 2, 2, 6, 4), np.float32)))
    pm = tuple(as_torch(m) for m in jm)
    pts = rng.uniform(-80, 80, (5, 3, 3)).astype(np.float32)
    d = rng.normal(size=(5, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lods = (0.0, 0.5, 1.0)
    close(M.sample_schedule(pm, as_torch(pts), lods, 150.0,
                            direction=as_torch(d)),
          jit_ref(JM.sample_schedule, 2, 3)(jm, jnp.asarray(pts), lods,
                                            150.0, jnp.asarray(d)))
    with pytest.raises(ValueError, match="march direction"):
        M.sample_schedule(pm, torch.zeros(1, 1, 3), (0.5,), 150.0)


# ---------------------------------------------------------------------------
# raycasts
# ---------------------------------------------------------------------------

def hold_gbuffer(pg, jg, what, uv_atol=ATOL, may_differ=None):
    """hit, tri, material and t equal where the winners agree (>= 99.9% of
    rays, or, where `may_differ` is given, every ray outside that mask);
    at the hits among them every other field within atol 1e-5 (t and
    position also rtol 1e-5: float32 spacing is 7.6e-6 at 64-128), uv
    within `uv_atol`.  A miss's other fields are whatever triangle 0
    gives, in both packages, and nothing reads them.  Returns the mask of
    rays whose winners differ."""
    jg = jax.tree_util.tree_map(np.asarray, jg)
    agree = ((pg.tri.numpy() == jg.tri) & (pg.hit.numpy() == jg.hit))
    if may_differ is None:
        assert agree.mean() >= 0.999, (what, agree.mean())
    else:
        assert not (~agree & ~may_differ).any(), what
    assert np.array_equal(pg.material.numpy()[agree], jg.material[agree])
    assert pg.tri.dtype == torch.int32 and pg.material.dtype == torch.int32
    hit = agree & jg.hit
    for f in ("t", "position", "normal", "geo_normal", "tangent",
              "bitangent", "uv"):
        rtol = 1e-5 if f in ("t", "position") else 0.0
        close(getattr(pg, f).numpy()[hit], getattr(jg, f)[hit], rtol=rtol,
               atol=uv_atol if f == "uv" else ATOL)
    assert np.array_equal(pg.t.numpy()[agree & ~jg.hit], jg.t[agree & ~jg.hit])
    return ~agree


@pytest.fixture(scope="module")
def cornell_scenes():
    jds = JGB.DeviceScene.from_scene(jcornell_box(size=100.0))
    return jds, interop.device_scene(jax.tree_util.tree_map(np.asarray, jds),
                                     device=CPU)


@pytest.mark.parametrize("o, d, check", [
    ([[0.0, 0.0, 140.0]], [[0.0, 0.0, -1.0]], "back_wall"),
    ([[0.0, 0.0, 140.0]], [[0.0, 0.0, 1.0]], "miss"),
    ([[0.0, 30.0, 0.0]], [[-1.0, 0.0, 0.0]], "red_wall"),
], ids=["back_wall", "miss", "red_wall"])
def test_raycast_rays(cornell_scenes, o, d, check):
    jds, pds = cornell_scenes
    pg = GB.raycast(pds, np.array(o, np.float32), np.array(d, np.float32),
                    device=CPU)
    hold_gbuffer(pg, JGB.raycast(jds, jnp.asarray(o), jnp.asarray(d)), check,
                  uv_atol=GENERAL_UV_ATOL)
    if check == "back_wall":
        assert bool(pg.hit[0])
        close(pg.position[0], [0, 0, -50], atol=1e-3)
    elif check == "miss":
        assert not bool(pg.hit[0])
    else:
        assert int(pg.material[0]) == 1


def test_raycast_cornell_grid(cornell_scenes):
    """The Cornell camera grid through the general raycast, in its batch
    shape.  The camera is on the box's axis, so the grid's diagonal rays
    pass exactly through shared triangle edges, where a rounding
    difference decides the winner or a miss: the JAX general path and the
    port's disagree there (23 of 4,096 rays, all on the diagonals; the
    JAX general path misses 8 rays both pinhole paths hit and differs
    from its own pinhole path on 22 winners), and agree on every other
    ray.  Both pinhole paths agree on every ray, and the port's general
    path hits every ray they hit."""
    jds, pds = cornell_scenes
    o, d = jcam.primary_rays(jcam.Camera(**CORNELL_CAMERA), 64, 64)
    pg = GB.raycast(pds, np.array(o), np.array(d), chunk_size=1000,
                    device=CPU)
    assert tuple(pg.hit.shape) == (64, 64)
    assert tuple(pg.uv.shape) == (64, 64, 2)
    i, j = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    differ = hold_gbuffer(pg, JGB.raycast(jds, o, d), "cornell grid",
                          uv_atol=GENERAL_UV_ATOL,
                          may_differ=(i == j) | (i + j == 63))
    assert differ.sum() <= 23, differ.sum()
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    jp = JGB.raycast_chunk_pinhole(jds, JGB.pinhole_constants(jds, o[0]),
                                   o[0], d)
    pp = GB.raycast_chunk_pinhole(pds, GB.pinhole_constants(pds, as_torch(o[0])),
                                  as_torch(o[0]), as_torch(d))
    assert not hold_gbuffer(pp, jp, "cornell grid, pinhole").any()
    assert not bool((pp.hit & ~pg.hit.reshape(-1)).any())
    assert float(pg.hit.float().mean()) > 0.9


@pytest.mark.parametrize("batch", [(1536,), (32, 48)])
def test_raycast_atrium_rays(atrium_rays, batch):
    """tests/test_pinhole.py's rays through the general raycast, in any
    batch shape."""
    jds, pds, o, d = atrium_rays[:4]
    pg = GB.raycast(pds, np.array(o).reshape(batch + (3,)),
                    np.array(d).reshape(batch + (3,)), chunk_size=700,
                    device=CPU)
    assert tuple(pg.normal.shape) == batch + (3,)
    flat = GB.map_gbuffer(lambda x: x.reshape((-1,) + x.shape[len(batch):]),
                          pg)
    assert not hold_gbuffer(flat, JGB.raycast(jds, o, d), "atrium general",
                            uv_atol=GENERAL_UV_ATOL).any()


@pytest.fixture(scope="module")
def atrium_rays():
    """tests/test_pinhole.py's rays: the atrium at 48x32, bench camera."""
    jds = JGB.DeviceScene.from_scene(jatrium())
    pds = interop.device_scene(jax.tree_util.tree_map(np.asarray, jds),
                               device=CPU)
    o, d = jcam.primary_rays(jcam.Camera(**BENCH_CAMERA), 48, 32)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    jpc = JGB.pinhole_constants(jds, o[0])
    pg0 = JGB.raycast_chunk_pinhole(jds, jpc, o[0], d)
    return jds, pds, o, d, jpc, pg0


@pytest.mark.parametrize("with_tmin", [False, True])
def test_raycast_chunk_pinhole(atrium_rays, with_tmin):
    jds, pds, o, d, jpc, jg0 = atrium_rays
    tmin = None
    if with_tmin:
        # every other hit re-cast past its first surface (the alpha
        # re-cast's tmin), the rest from -1
        hit = np.asarray(jg0.hit) & (np.arange(d.shape[0]) % 2 == 0)
        tmin = np.where(hit, np.asarray(jg0.t) * (1.0 + 1e-5) + 1e-4,
                        -1.0).astype(np.float32)
    jpc_h = jax.tree_util.tree_map(np.asarray, jpc)
    ppc = GB.pinhole_constants(pds, as_torch(o[0]))
    for f in ("a", "b", "c", "k"):
        close(getattr(ppc, f), getattr(jpc_h, f), rtol=1e-6)
    pg = GB.raycast_chunk_pinhole(pds, ppc, as_torch(o[0]), as_torch(d),
                                  tmin=None if tmin is None else as_torch(tmin))
    jg = JGB.raycast_chunk_pinhole(
        jds, jpc, o[0], d, tmin=None if tmin is None else jnp.asarray(tmin))
    hold_gbuffer(pg, jg, f"pinhole tmin={with_tmin}")
    assert int(pg.hit.sum()) > 100
    if with_tmin:       # re-cast rays hit farther or miss
        assert bool((pg.t[as_torch(hit)] > as_torch(np.asarray(jg0.t))[as_torch(hit)]).all()
                    | ~pg.hit[as_torch(hit)].all())
    # the pinhole path equals the port's general one (test_pinhole.py)
    ref = GB.raycast_chunk(pds, as_torch(o), as_torch(d))
    if tmin is None:
        assert torch.equal(ref.hit, pg.hit)
        assert torch.equal(ref.tri[ref.hit], pg.tri[pg.hit])


# ---------------------------------------------------------------------------
# shading on the JAX state and G-buffer carried across
# ---------------------------------------------------------------------------

def jax_state(cfg, scene, camera, w, h):
    ds, mats, samples = JR.prepare_scene(cfg, scene)
    voxels = JR.build_voxel_state_staged(cfg, samples, mats)
    origins, dirs = jcam.primary_rays(jcam.Camera(**camera), w, h)
    o, d = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    gbuf = JGB.raycast_chunk_pinhole(ds, JGB.pinhole_constants(ds, o[0]),
                                     o[0], d)
    cam = jnp.asarray(camera["position"], jnp.float32)
    return dict(ds=ds, mats=mats, samples=samples, voxels=voxels,
                origins=origins, dirs=dirs, gbuf=gbuf, cam=cam)


def carry(j, scene, camera, w, h):
    """The port's side: the JAX state, G-buffer and materials carried
    across, and the port's own scene prep and rays."""
    host = jax.tree_util.tree_map(np.asarray, (j["voxels"], j["gbuf"],
                                               j["mats"]))
    ds, mats, samples = R.prepare_scene(j["cfg"], scene, device=CPU)
    origins, dirs = CAM.primary_rays(CAM.Camera(**camera), w, h, device=CPU)
    return dict(ds=ds, mats=mats, samples=samples,
                voxels=interop.voxel_state(host[0], device=CPU),
                gbuf=interop.gbuffer(host[1], device=CPU),
                jmats=interop.material_table(host[2], device=CPU),
                origins=origins, dirs=dirs,
                cam=torch.tensor(camera["position"], dtype=torch.float32))


@pytest.fixture(scope="module")
def cornell():
    jc, pc = cfg_pair(32, 64, 64)
    j = jax_state(jc, jcornell_box(size=100.0), CORNELL_CAMERA, 64, 64)
    j["img"] = np.asarray(JR.render_rays(jc, j["ds"], j["voxels"], j["mats"],
                                         j["origins"], j["dirs"], j["cam"],
                                         chunk_size=1024))
    j["cfg"] = pc
    p = carry(j, cornell_box(size=100.0), CORNELL_CAMERA, 64, 64)
    return jc, pc, j, p


def test_shadow_cone_value(cornell):
    jc, pc, j, p = cornell
    jg, pg = j["gbuf"], p["gbuf"]
    a = S.shadow_cone_value(p["voxels"].unlit_mips, pg.position,
                            pg.geo_normal, R.light_direction(pc, CPU),
                            S.shadow_schedule(pc), pc)
    # eager, as the port rounds: under jit XLA fuses the opacity gain and
    # the transmittance product and lands up to 1.7e-5 away
    b = JS.shadow_cone_value(j["voxels"].unlit_mips, jg.position,
                             jg.geo_normal, JR.light_direction(jc),
                             JS.shadow_schedule(jc), jc)
    close(a, b)
    assert 0.05 < float(a[pg.hit].mean()) < 0.95    # lit and shadowed
    close(S.shadow_volume_tap(pc, p["voxels"].light_volume, pg.position,
                               pg.geo_normal),
           JS.shadow_volume_tap(jc, j["voxels"].light_volume, jg.position,
                                jg.geo_normal))


def _random_fields(cfg, seed=5, df=16):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 0.5, (df, df, df, 4 * cfg.cones.field_basis))
            .astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("provider", ["diffuse_percone", "specular_percone",
                                      "diffuse_field", "specular_field"])
def test_indirect_providers(cornell, provider):
    jc, pc, j, p = cornell
    jg, pg = j["gbuf"], p["gbuf"]
    kind, mode = provider.split("_")
    if kind == "diffuse":
        jdirs = JS.pixel_cone_dirs(jc, jg.normal, jg.tangent, jg.bitangent)
        pdirs = S.pixel_cone_dirs(pc, pg.normal, pg.tangent, pg.bitangent)
        close(pdirs, jdirs)
    else:
        jdirs = JS.reflect_eye(jg.normal, JC.normalize(j["cam"] - jg.position))
        pdirs = S.reflect_eye(pg.normal, C.normalize(p["cam"] - pg.position))
        close(pdirs, jdirs)
    if mode == "percone":
        src_j, src_p = j["voxels"].radiance_mips, p["voxels"].radiance_mips
    else:
        field = _random_fields(pc)[kind == "specular"]
        src_j, src_p = jnp.asarray(field), as_torch(field)
    a = getattr(S, f"indirect_{provider}")(pc, src_p, pg.position, pg.normal,
                                          pdirs)
    b = jit_ref(getattr(JS, f"indirect_{provider}"), 0)(
        jc, src_j, jg.position, jg.normal, jdirs)
    for x, y in zip(a, b):
        close(x, y)
    assert float(a[0].abs().max()) > 0


def _variant(cfg, variant):
    if variant == "field":
        return dataclasses.replace(cfg, cones=dataclasses.replace(
            cfg.cones, diffuse_mode="field", specular_mode="field"))
    return cfg


def hold_shade(run, variant="base"):
    """shade_gbuffer on the carried JAX G-buffer and state against the
    JAX one: mean < 1e-5, max < 1e-4."""
    jc, pc, j, p = run
    jc, pc = _variant(jc, variant), _variant(pc, variant)
    jv, pv = j["voxels"], p["voxels"]
    if variant == "field":
        fd, fs = _random_fields(pc)
        jv = dataclasses.replace(jv, diffuse_field=jnp.asarray(fd),
                                 specular_field=jnp.asarray(fs))
        pv = dataclasses.replace(pv, diffuse_field=as_torch(fd),
                                 specular_field=as_torch(fs))
    a = R.shade_gbuffer(pc, pv, p["gbuf"], p["jmats"], p["cam"]).numpy()
    b = np.asarray(jit_ref(JR.shade_gbuffer, 0)(jc, jv, j["gbuf"], j["mats"],
                                             j["cam"]))
    err = np.abs(a - b)
    assert np.isfinite(a).all() and a.shape == b.shape
    assert err.mean() < 1e-5, err.mean()
    assert err.max() < 1e-4, err.max()


@pytest.mark.parametrize("variant", ["base", "field"])
def test_shade_gbuffer_on_jax_gbuffer(cornell, variant):
    hold_shade(cornell, variant)


def hold_image(out, ref):
    err = np.abs(np.asarray(out) - ref)
    assert out.shape == ref.shape and np.isfinite(np.asarray(out)).all()
    assert err.mean() < 1e-4, err.mean()
    assert np.percentile(err, 99) < 1e-3, np.percentile(err, 99)


def hold_render_rays(run):
    _, pc, j, p = run
    out = R.render_rays(pc, p["ds"], p["voxels"], p["mats"], p["origins"],
                        p["dirs"], p["cam"], chunk_size=1000).numpy()
    hold_image(out, j["img"])
    assert float(out.mean()) > 0.01


def hold_own_build(run):
    """The port's own build; render_camera_pass takes render_rays for the
    percone modes."""
    _, pc, j, p = run
    assert not R.use_fast_path(pc)
    voxels = R.build_voxel_state(pc, p["samples"], p["mats"])
    for name in ("radiance_mips", "unlit_mips"):
        for a, b in zip(getattr(voxels, name), getattr(p["voxels"], name)):
            close(a, b)
    out = R.render_camera_pass(pc, p["ds"], voxels, p["mats"], p["origins"],
                               p["dirs"], p["cam"])
    hold_image(out.numpy(), j["img"])


def _mode(cfg, mode):
    if mode == "map":      # the rasterized shadow map, at 256^2
        return dataclasses.replace(cfg, shadow=dataclasses.replace(
            cfg.shadow, mode="map", map_size=256))
    return dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, anisotropic=True))


@pytest.mark.parametrize("mode", ["map", "aniso"])
def test_map_and_aniso_builds_match(cornell, mode):
    """Shadow mode "map" and anisotropic mips on this fixture's samples:
    the port's build against the JAX package's (eager for the map, whose
    PCF is a step: tests/test_torch_shadowmap.py), atol 1e-5; the shadow
    map atol 1e-6 (one float32 ulp of depth on some texels)."""
    jc, pc, j, p = cornell
    jc, pc = _mode(jc, mode), _mode(pc, mode)
    build = JR.build_voxel_state if mode == "map" else \
        JR.build_voxel_state_staged
    jv = build(jc, j["samples"], j["mats"])
    pv = R.build_voxel_state(pc, interop.samples(jax.tree_util.tree_map(
        np.asarray, j["samples"]), device=CPU), p["mats"])
    if mode == "map":
        close(pv.shadow_map, jv.shadow_map, atol=1e-6)
        assert pv.light_volume is None
    else:
        assert pv.radiance_mips[1].dim() == 5
        close(pv.light_volume, jv.light_volume)
    for a, b in zip(pv.radiance_mips + pv.unlit_mips,
                    jv.radiance_mips + jv.unlit_mips):
        close(a, b)


@pytest.mark.parametrize("name", ["cornell64", "cornell64_full", "inverse",
                                  "reference", "aniso128"])
def test_presets_route_to_render_rays(name):
    assert not R.use_fast_path(preset(name))


def test_render_rays_on_carried_state(cornell):
    hold_render_rays(cornell)


def test_render_camera_pass_on_own_build(cornell):
    hold_own_build(cornell)
