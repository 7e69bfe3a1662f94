"""Kernel 8 (the exact specular march): the port's static plan, pyramid,
level selection, step table and plain march against the JAX package's
ops/specmarch_pallas.py on the same numpy inputs, and the port's percone
pass against render/fast.py spec_percone_pass.

Fixtures: tests/test_specmarch_pallas.py's coherent ray bundles on a
random 32^3 radiance grid, 4 groups of 256 pixels; the same rays on an
opaque grid (the early-out), and a miss-only case.

Bounds:
  * plan, levels, permutation: equal; pyramid: bit for bit; the per-step
    constants against the row table's columns 4-6: 1e-6;
  * spec_march_plain vs spec_march_ref: atol 1e-5 (same samples and
    composite; the port multiplies by the row table's attenuation where
    the oracle divides by 1 + falloff * diameter, one rounding apart);
  * vs spec_march_tiles(interpret=True): test_specmarch_pallas.py's
    bounds, atol 4e-2, and 5e-2 / rtol 4e-2 at the early-out (the TPU
    kernel rounds its two-hot weights to bf16 and clamps points outside
    its brick to the brick's edge; the port samples spec_march_ref's way).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.config import GridConfig as JGridConfig
from vct_tpu.config import preset as jpreset
from vct_tpu.core import grid as JG
from vct_tpu.core import march as JM
from vct_tpu.ops import specmarch_pallas as SP
from vct_tpu.render import fast as JF
from vct_tpu.render import shading as JS
from vct_tpu_torch import interop
from vct_tpu_torch.config import GridConfig, preset
from vct_tpu_torch.ops import specmarch as SM
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import shading

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

TILE = SM.TILE
WS = 150.0
DIM = 32
NT = 4
MAX_ALPHA = 0.95
FALLOFF = 0.03

CASES = {"coherent": (dict(seed=0), dict(seed=1)),
         "opaque": (dict(seed=0, opaque=True), dict(seed=7)),
         "misses": (dict(seed=0), dict(seed=1, miss_frac=1.0))}


def _mips(seed, opaque=False):
    rng = np.random.default_rng(seed)
    vol = rng.uniform(0, 1, (DIM, DIM, DIM, 4)).astype(np.float32)
    vol[..., 3] *= 0.9 if opaque else 0.25
    return JG.build_mips(jnp.asarray(vol))


def _rays(seed, spread=0.02, miss_frac=0.0):
    """Coherent per-group ray bundles (one surface patch per group)."""
    rng = np.random.default_rng(seed)
    n = NT * TILE
    base_p = rng.uniform(-40, 40, (NT, 1, 3))
    base_d = rng.normal(size=(NT, 1, 3))
    pos = base_p + rng.uniform(-1, 1, (NT, TILE, 3))
    d = base_d + spread * rng.normal(size=(NT, TILE, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    hit = (rng.uniform(size=(NT, TILE)) >= miss_frac).astype(np.float32)
    start4 = np.concatenate([pos, hit[..., None]], -1).reshape(n, 4)
    refl4 = np.concatenate([d, np.zeros((NT, TILE, 1))], -1).reshape(n, 4)
    return start4.astype(np.float32), refl4.astype(np.float32)


def _groups(dims):
    return SP.plan_groups(JM.march_schedule(0.07, WS / DIM, 75.0), len(dims))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    mip_kw, ray_kw = CASES[request.param]
    jmips = _mips(**mip_kw)
    start4, refl4 = _rays(**ray_kw)
    pages = SP.pack_spec_mips(jmips)
    dims = SP.pages_dims(pages)
    groups = _groups(dims)
    valid = start4[:, 3] > 0.5
    lists, rowtab = SP.select_spec_bricks(
        jnp.asarray(start4[:, :3].reshape(NT, TILE, 3)),
        jnp.asarray(refl4[:, :3].reshape(NT, TILE, 3)),
        jnp.asarray(valid.reshape(NT, TILE)), groups, dims, WS,
        occlusion_falloff=FALLOFF)
    kw = dict(groups=groups, dims=dims, world_size=WS, max_alpha=MAX_ALPHA,
              occlusion_falloff=FALLOFF, tile=TILE)
    jargs = (jnp.asarray(start4), jnp.asarray(refl4), lists, rowtab, pages)
    ker = np.asarray(SP.spec_march_tiles(*jargs, interpret=True, **kw))
    ref = np.asarray(SP.spec_march_ref(
        jnp.asarray(start4), jnp.asarray(refl4), lists, pages, groups, dims,
        WS, MAX_ALPHA, FALLOFF, tile=TILE))

    # the port, on the same float32 mips
    pyramid = SM.pack_spec_mips([torch.as_tensor(np.array(m))
                                 for m in jmips])
    t_start4, t_refl4 = torch.as_tensor(start4), torch.as_tensor(refl4)
    levels = SM.select_spec_levels(
        t_start4[:, :3].reshape(NT, TILE, 3),
        t_refl4[:, :3].reshape(NT, TILE, 3),
        torch.as_tensor(valid).reshape(NT, TILE), groups, dims, WS)
    step_lv, weights = SM.step_table(groups, levels, FALLOFF)
    out = SM.spec_march_tiles(t_start4, t_refl4, step_lv, weights, pyramid,
                              world_size=WS, max_alpha=MAX_ALPHA).numpy()
    return dict(name=request.param, jmips=jmips, pages=np.asarray(pages),
                dims=dims, groups=groups, lists=np.asarray(lists),
                rowtab=np.asarray(rowtab), ker=ker, ref=ref, pyramid=pyramid,
                levels=levels.numpy(), step_lv=step_lv.numpy(),
                weights=weights.numpy(), out=out)


@pytest.mark.parametrize("dim", [32, 256])
def test_plan_matches_jax(dim):
    cfg = dataclasses.replace(preset("sponza256_exact_specular"),
                              grid=GridConfig(dim=dim, world_size=WS))
    jcfg = dataclasses.replace(jpreset("sponza256_exact_specular"),
                               grid=JGridConfig(dim=dim, world_size=WS))
    dims = SM._level_dims(dim)
    assert dims == SP._level_dims(dim)
    groups = SM.plan_groups(shading.specular_schedule(cfg), len(dims))
    jgroups = SP.plan_groups(JS.specular_schedule(jcfg), len(dims))
    assert groups == jgroups
    plan = SM.plan_entries(groups, len(dims))
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        SP.plan_entries(jgroups, len(dims)))
    if dim == 256:
        # sponza256_exact_specular's fixed plan
        assert dims == (256, 128, 64, 32, 16, 8)
        assert plan.nsteps == 29 and plan.g_mip == 1 and plan.rows == 54
        assert tuple(l0 for l0, _ in groups) == (0, 0, 0, 0, 1, 1, 2, 2, 3,
                                                 3, 4)
        assert len(plan.entries) == 21


def test_pyramid_matches_pages(case):
    """pack_spec_mips equals copy (0, 0) of the JAX pages bit for bit, and
    interop cuts the same levels out of the pages."""
    pages, dims = case["pages"], case["dims"]
    assert SM.pyramid_dims(case["pyramid"]) == dims
    conv = interop.spec_pyramid(pages, device="cpu")
    d0 = dims[0]
    for li, (a, b) in enumerate(zip(case["pyramid"], conv)):
        d = dims[li]
        xb = 2 * d0 - 2 * (d0 >> li)
        jl = pages[0, 0, xb:xb + d, :d, :d * 4].reshape(d, d, d, 4)
        assert a.dtype == b.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      jl.view(np.int16))
        np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                      jl.view(np.int16))


def test_levels_match_lists(case):
    ng = len(case["groups"])
    np.testing.assert_array_equal(
        case["levels"], case["lists"][:NT, 0:SP.GWORDS * ng:SP.GWORDS])
    if case["name"] == "misses":
        assert (case["levels"] == len(case["dims"]) - 1).all()
    else:      # the bundles keep some groups at their schedule level
        l0s = np.array([l0 for l0, _ in case["groups"]])
        assert (case["levels"] == l0s).mean() > 0.5


def test_step_table_matches_rowtab(case):
    """Per (tile, step): the level is the step's group's, and distance,
    mip weight and attenuation are the row table's columns 4-6 (a primary
    row weighs 1 - w, a mip row w)."""
    groups = case["groups"]
    plan = SP.plan_entries(groups, len(case["dims"]))
    rt = case["rowtab"][:NT].reshape(NT, SP.RTPAD, SP.RTCOLS)
    first = np.cumsum([0] + [len(s) for _, s in groups])
    w = case["weights"]
    for e, (role, g, _) in enumerate(plan.entries):
        for j in range(len(groups[g][1])):
            k = first[g] + j
            row = rt[:, plan.block_off[e] + j]
            np.testing.assert_array_equal(case["step_lv"][:, k],
                                          case["levels"][:, g])
            np.testing.assert_allclose(w[:, k, 0], row[:, 4], atol=1e-6,
                                       rtol=0)
            wgt = 1.0 - w[:, k, 1] if role == "prim" else w[:, k, 1]
            np.testing.assert_allclose(wgt, row[:, 5], atol=1e-6, rtol=0)
            np.testing.assert_allclose(w[:, k, 2], row[:, 6], atol=1e-6,
                                       rtol=0)


def test_plain_matches_ref(case):
    out = case["out"]
    assert out.shape == (NT * TILE, 4) and np.isfinite(out).all()
    np.testing.assert_allclose(out, case["ref"], atol=1e-5, rtol=0)
    if case["name"] != "misses":
        assert np.abs(out).max() > 0.05


def test_plain_within_pallas_bounds(case):
    if case["name"] == "opaque":
        np.testing.assert_allclose(case["out"], case["ker"], atol=5e-2,
                                   rtol=4e-2)
    else:
        np.testing.assert_allclose(case["out"], case["ker"], atol=4e-2)


def test_misses_are_zero(case):
    if case["name"] == "misses":
        assert np.abs(case["out"]).max() == 0.0
    else:       # hits only: every pixel marched something
        assert (np.abs(case["out"]).max(axis=1) > 0).all()


# ---- the percone pass: sort, select, march, unsort ------------------------

@pytest.fixture(scope="module")
def percone():
    """A G-buffer's worth of surface points in 4 clusters with a quarter
    misses, bump normals off the geometric ones, a camera outside."""
    rng = np.random.default_rng(3)
    n = NT * TILE
    pos = (rng.uniform(-40, 40, (NT, 3))[rng.integers(0, NT, n)]
           + rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    bump = (nrm + 0.2 * rng.normal(size=(n, 3))).astype(np.float32)
    cam = np.array([5.0, -3.0, 120.0], np.float32)
    eye = cam - pos
    eye = (eye / np.linalg.norm(eye, axis=1, keepdims=True)).astype(
        np.float32)
    hit = rng.uniform(size=n) >= 0.25
    jcfg = dataclasses.replace(jpreset("sponza256_exact_specular"),
                               grid=JGridConfig(dim=DIM, world_size=WS))
    cfg = dataclasses.replace(preset("sponza256_exact_specular"),
                              grid=GridConfig(dim=DIM, world_size=WS))
    jmips = _mips(seed=5)
    pages = SP.pack_spec_mips(jmips)
    jin = [jnp.asarray(x) for x in (pos, nrm, bump, eye, hit)]
    ker = np.asarray(JF.spec_percone_pass(jcfg, pages, *jin, interpret=True))

    # JAX's order and its jnp oracle over it, unsorted
    refl = JS.reflect_eye(jin[2], jin[3])
    start = jin[0] + jin[1] * jcfg.grid.voxel_world_size
    cell = jnp.clip((start + WS * 0.5) * (2.0 / WS) * 64.0, 0.0,
                    127.0).astype(jnp.int32)
    octant = ((refl[:, 0] > 0).astype(jnp.int32)
              + 2 * (refl[:, 1] > 0).astype(jnp.int32)
              + 4 * (refl[:, 2] > 0).astype(jnp.int32))
    key = jnp.where(jin[4], (JF._morton3(cell) << 3) | octant,
                    jnp.int32(2 ** 30))
    perm = np.asarray(jnp.argsort(key))
    dims = SP.pages_dims(pages)
    groups = _groups(dims)
    start4 = jnp.concatenate([start[perm], jin[4][perm, None].astype(
        jnp.float32)], axis=1)
    refl4 = jnp.concatenate([refl[perm], jnp.zeros((n, 1))], axis=1)
    lists, _ = SP.select_spec_bricks(
        start4[:, :3].reshape(NT, TILE, 3), refl4[:, :3].reshape(NT, TILE, 3),
        jin[4][perm].reshape(NT, TILE), groups, dims, WS,
        occlusion_falloff=FALLOFF)
    ref = np.empty((n, 4), np.float32)
    ref[perm] = np.asarray(SP.spec_march_ref(
        start4, refl4, lists, pages, groups, dims, WS, MAX_ALPHA, FALLOFF,
        tile=TILE))

    tin = [torch.as_tensor(x) for x in (pos, nrm, bump, eye, hit)]
    pyramid = interop.spec_pyramid(np.asarray(pages), device="cpu")
    out = F.spec_percone_pass(cfg, pyramid, *tin).numpy()
    _, _, tperm = F.percone_order(cfg, *tin)
    return dict(out=out, ker=ker, ref=ref, perm=perm, tperm=tperm.numpy(),
                hit=hit)


def test_percone_order_matches_jax(percone):
    np.testing.assert_array_equal(percone["tperm"], percone["perm"])


def test_percone_pass_matches_jax(percone):
    out = percone["out"]
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, percone["ref"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, percone["ker"], atol=4e-2)
    assert np.abs(out[~percone["hit"]]).max() == 0.0
    assert np.abs(out[percone["hit"]]).max() > 0.05


def test_pyramid_cell_limit_refuses():
    """The march kernel counts pyramid cells in 32 bits: check_cells, which
    its wrapper calls before every launch, passes the pyramids below 2**31
    cells and refuses the rest."""
    SM.check_cells(SM._level_dims(256))           # 19.2 M cells
    SM.check_cells(SM._level_dims(1024))
    SM.check_cells([1290])                        # 2,146,689,000 cells
    for dims in ([1291], SM._level_dims(2048)):
        with pytest.raises(ValueError, match="32 bits"):
            SM.check_cells(dims)
