"""Kernel 3 (prepass): the port's per-tile light/field level selection
must EQUAL the JAX package's Pallas prepass (interpret mode,
has_atlas=False) and its XLA oracles select_light_bricks /
select_field_bricks, as tests/test_prepass_pallas.py requires."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.core import grid as jgrid
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
    with pytest.raises(NotImplementedError):
        PP.prepass_tiles(torch.as_tensor(_gbuf(1)), has_atlas=True, **KW)
