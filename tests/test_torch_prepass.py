"""Kernel 3 (prepass): the port's per-tile light/field level selection
and its material half must EQUAL the JAX package's Pallas prepass
(interpret mode, has_atlas False and True) and its XLA oracles
select_light_bricks / select_field_bricks / select_material_bricks, as
tests/test_prepass_pallas.py requires."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.core import grid as jgrid
from vct_tpu.ops import material_pallas as JMP
from vct_tpu.ops import prepass_pallas as JPP
from vct_tpu.ops import tap_pallas as JTP
from vct_tpu_torch.ops import prepass as PP
from vct_tpu_torch.ops import tap as TP

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

TILE = 256
WS = 150.0
VOXEL = WS / 64
OFFSET = 2.0
LIGHT_DIMS = (64, 32, 16)
FIELD_DIMS = (64, 32, 16, 8)
KW = dict(light_dims=LIGHT_DIMS, field_dims=FIELD_DIMS, voxel=VOXEL,
          world_size=WS, shadow_offset=OFFSET)


def _gbuf(ntiles, seed=0, miss_frac=0.1, spread=2.0):
    """Tile-coherent random G-buffer (tests/test_prepass_pallas.py)."""
    rng = np.random.default_rng(seed)
    n = ntiles * TILE
    g = np.zeros((n, 32), np.float32)
    base = rng.uniform(-60, 60, (ntiles, 1, 3))
    g[:, 0:3] = (base + rng.uniform(-spread, spread, (ntiles, TILE, 3))
                 ).reshape(n, 3)
    nrm = rng.normal(size=(n, 3))
    g[:, 3:6] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    geo = rng.normal(size=(n, 3))
    g[:, 6:9] = geo / np.linalg.norm(geo, axis=1, keepdims=True)
    g[:, 19] = (rng.uniform(size=n) >= miss_frac).astype(np.float32)
    return g


CASES = [(0, 0.1, 2.0), (1, 0.0, 0.5), (2, 0.5, 8.0), (3, 0.1, 30.0)]


@pytest.mark.parametrize("seed,miss,spread", CASES)
def test_matches_pallas_prepass(seed, miss, spread):
    g = _gbuf(6, seed, miss, spread)
    ref, _, _, _ = JPP.prepass_tiles(
        jnp.asarray(g), num_materials=1, resolution=16, atlas_levels=1,
        has_atlas=False, interpret=True, tile=TILE, **KW)
    out = PP.prepass_tiles(torch.as_tensor(g), **KW)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed,miss,spread", CASES)
def test_matches_select_oracles(seed, miss, spread):
    g = _gbuf(5, seed + 10, miss, spread)
    pos, nrm, geo = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    hit = (g[:, 19] > 0.5).reshape(5, TILE)
    uvw_l = jgrid.world_to_uvw(jnp.asarray(pos + geo * (VOXEL * OFFSET)), WS)
    uvw_f = jgrid.world_to_uvw(jnp.asarray(pos + nrm * VOXEL), WS)
    llev, lorg = JTP.select_light_bricks(uvw_l.reshape(5, TILE, 3),
                                         jnp.asarray(hit), LIGHT_DIMS)
    flev, forg = JTP.select_field_bricks(uvw_f.reshape(5, TILE, 3),
                                         jnp.asarray(hit), FIELD_DIMS)
    ref = np.concatenate([np.asarray(llev)[:, None], np.asarray(lorg),
                          np.asarray(flev)[:, None], np.asarray(forg)], 1)
    np.testing.assert_array_equal(
        PP.prepass_tiles(torch.as_tensor(g), **KW).numpy(), ref)


@pytest.mark.parametrize("which", ["light", "field"])
def test_select_helpers_equal(which):
    """The port's plain selection helpers against the JAX ones on raw uvw
    (including the z-straddle case of tests/test_tap_pallas.py)."""
    rng = np.random.default_rng(7)
    uvw = (rng.uniform(0.2, 0.8, (8, 1, 3))
           + rng.uniform(0, 0.05, (8, TILE, 3))).astype(np.float32)
    uvw[0, :, 2] = (np.linspace(15.2, 30.8, TILE) + 0.5) / 64
    valid = rng.uniform(size=(8, TILE)) > 0.2
    valid[1] = False
    dims = LIGHT_DIMS if which == "light" else FIELD_DIMS
    fa = getattr(TP, f"select_{which}_bricks")
    fb = getattr(JTP, f"select_{which}_bricks")
    la, oa = fa(torch.as_tensor(uvw), torch.as_tensor(valid), dims)
    lb, ob = fb(jnp.asarray(uvw), jnp.asarray(valid), dims)
    np.testing.assert_array_equal(la.numpy(), np.asarray(lb))
    np.testing.assert_array_equal(oa.numpy(), np.asarray(ob))


def test_all_miss_tiles_take_coarsest():
    out = PP.prepass_tiles(torch.as_tensor(_gbuf(2, miss_frac=1.0)), **KW)
    np.testing.assert_array_equal(
        out.numpy(), [[len(LIGHT_DIMS) - 1, 0, 0, 0,
                       len(FIELD_DIMS) - 1, 0, 0, 0]] * 2)


def test_atlas_half_refused():
    """The material half needs the atlas's shape: a material count, a
    power-of-two resolution and its level count."""
    with pytest.raises(TypeError):
        PP.prepass_tiles(torch.as_tensor(_gbuf(1)), atlas=(3, 64), **KW)


def _atlas_gbuf(ntiles, seed=0, miss_frac=0.1, mm=5):
    """tests/test_prepass_pallas.py's _gbuf: tile-coherent positions, uv
    boxes of 0.3 around per-tile bases in [-2, 2], materials 0..mm-1."""
    rng = np.random.default_rng(seed)
    n = ntiles * TILE
    g = np.zeros((n, 32), np.float32)
    base = rng.uniform(-60, 60, (ntiles, 1, 3))
    g[:, 0:3] = (base + rng.uniform(-2, 2, (ntiles, TILE, 3))).reshape(n, 3)
    nrm = rng.normal(size=(n, 3))
    g[:, 3:6] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    geo = rng.normal(size=(n, 3))
    g[:, 6:9] = geo / np.linalg.norm(geo, axis=1, keepdims=True)
    ub = rng.uniform(-2, 2, (ntiles, 1, 2))
    g[:, 15:17] = (ub + rng.uniform(0, 0.3, (ntiles, TILE, 2))).reshape(n, 2)
    g[:, 17] = rng.integers(0, mm, n)
    g[:, 19] = (rng.uniform(size=n) >= miss_frac).astype(np.float32)
    return g


ATLAS_CASES = [(0, 0.1, 5, 64), (1, 0.0, 8, 256), (2, 0.5, 30, 16),
               (3, 1.0, 3, 64)]


@pytest.mark.parametrize("seed,miss,mm,res", ATLAS_CASES)
def test_atlas_matches_pallas_prepass(seed, miss, mm, res):
    """All four outputs equal the Pallas kernel's; the last case is all
    miss, the third has more materials than slots can hold per tile."""
    g = _atlas_gbuf(6, seed, miss, mm)
    nlev = res.bit_length()
    ref = JPP.prepass_tiles(
        jnp.asarray(g), num_materials=mm, resolution=res, atlas_levels=nlev,
        has_atlas=True, interpret=True, tile=TILE, **KW)
    out = PP.prepass_tiles(torch.as_tensor(g), atlas=(mm, res, nlev), **KW)
    assert len(out) == 4
    for a, b in zip(out, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:a.shape[0]])
    if miss == 1.0:
        assert out[1].abs().max() == 0 and out[3].abs().max() == 0


def test_atlas_matches_select_material_bricks():
    g = _atlas_gbuf(5, seed=7)
    tiled = g.reshape(5, TILE, -1)
    scal, lists, slots = JMP.select_material_bricks(
        jnp.asarray(tiled[..., 17].astype(np.int32)),
        jnp.asarray(tiled[..., 15:17]), jnp.asarray(tiled[..., 19] > 0.5),
        num_materials=5, resolution=64, num_levels=7)
    _, mscal, mlists, mslots = PP.prepass_tiles(torch.as_tensor(g),
                                                atlas=(5, 64, 7), **KW)
    np.testing.assert_array_equal(mscal.numpy(), np.asarray(scal))
    np.testing.assert_array_equal(mlists.numpy(), np.asarray(lists)[:5])
    np.testing.assert_array_equal(mslots.numpy().reshape(5, TILE),
                                  np.asarray(slots))


STRESS_RES = 64
STRESS_ATLAS = (PP.MAX_MATERIALS, STRESS_RES, STRESS_RES.bit_length())


@pytest.mark.parametrize("kind", range(len(PP.STRESS_KINDS)),
                         ids=PP.STRESS_KINDS)
def test_stress_matches_pallas_prepass(kind):
    """prepass.stress_gbuffer's tiles (all miss, one hit, all 64 materials
    so the slots clamp, uv up to 1e7 so the texel bases clip, |tu| near
    2^24, wrap corners), a kind at a time: all four outputs equal the
    Pallas kernel's."""
    reps = 2
    g = PP.stress_gbuffer(kind, world_size=WS, resolution=STRESS_RES,
                          reps=reps)
    rows = slice(kind * reps * TILE, (kind + 1) * reps * TILE)
    g = np.ascontiguousarray(g[rows])
    ref = JPP.prepass_tiles(
        jnp.asarray(g), num_materials=STRESS_ATLAS[0],
        resolution=STRESS_RES, atlas_levels=STRESS_ATLAS[2],
        has_atlas=True, interpret=True, tile=TILE, **KW)
    out = PP.prepass_tiles(torch.as_tensor(g), atlas=STRESS_ATLAS, **KW)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:a.shape[0]])
    mscal, mlists = out[1].numpy(), out[2].numpy()
    if PP.STRESS_KINDS[kind].startswith("every material"):
        assert (mscal[:, 0] == PP.NSLOT).all()          # slots clamp
    if kind == PP.STRESS_KINDS.index("every material, huge uv"):
        assert np.abs(mlists[:, :4 * (PP.NSLOT - 1)].reshape(
            reps, -1, 4)[..., 2:]).max() == PP.BCLIP    # bases clip
    if kind == PP.STRESS_KINDS.index("all miss"):
        assert mscal.max() == 0 and out[3].abs().max() == 0
