"""Kernel 5 (material fetch): the port's plain version against the JAX
package's jnp reference material_tiles_ref (atol 1e-5: the same float32
weights on the same bf16 texels) and its Pallas kernel in interpret mode
(atol 2e-2, the bound tests/test_material_pallas.py holds that kernel to:
it rounds its bilinear weights to bf16), on the same entries and pages.
Also the port's atlas, mip pages and the whole chain prepass -> material
against the JAX one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.ops import material_pallas as JMP
from vct_tpu.scene import textures as JTX
from vct_tpu.scene.mesh import Material as JMaterial
from vct_tpu_torch.ops import material as MT
from vct_tpu_torch.ops import prepass as PP
from vct_tpu_torch.scene import textures as TX
from vct_tpu_torch.scene.mesh import Material

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

TILE = 256
RES = 32
CPU = torch.device("cpu")


def _textures(res=RES, m=3, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(name=f"m{k}", albedo=(0.2 + 0.2 * k, 0.5, 0.3, 1.0),
                 albedo_texture=rng.uniform(0, 1, (res, res, 4)).astype(
                     np.float32),
                 specular_texture=rng.uniform(0, 1, (res, res, 3)).astype(
                     np.float32),
                 height_texture=rng.uniform(0, 1, (res, res)).astype(
                     np.float32))
            for k in range(m)]


def _case(name):
    """(uv, mat, hit) of tests/test_material_pallas.py's cases."""
    if name == "level0":                 # per-tile 2-texel uv boxes
        rng = np.random.default_rng(2)
        base = rng.uniform(0.1, 0.8, (4, 1, 2))
        uv = (base + rng.uniform(0, 2.0 / RES, (4, TILE, 2))).reshape(-1, 2)
        return (uv.astype(np.float32), np.repeat(rng.integers(0, 3, 4), TILE),
                np.ones(4 * TILE, np.float32))
    if name == "random":                 # any level, three materials
        rng = np.random.default_rng(1)
        n = 4 * TILE
        return (rng.uniform(-1.0, 2.0, (n, 2)).astype(np.float32),
                rng.integers(0, 3, n), np.ones(n, np.float32))
    if name == "wide":                   # many repeats: the 1x1 level
        rng = np.random.default_rng(3)
        return (rng.uniform(-20.0, 20.0, (TILE, 2)).astype(np.float32),
                np.zeros(TILE, np.int64), np.ones(TILE, np.float32))
    if name == "multi":                  # 2+ materials in every tile
        rng = np.random.default_rng(4)
        n = 2 * TILE
        return ((0.3 + rng.uniform(0, 0.1, (n, 2))).astype(np.float32),
                rng.integers(0, 3, n), np.ones(n, np.float32))
    assert name == "empty"               # no hit pixel
    return (np.zeros((TILE, 2), np.float32), np.zeros(TILE, np.int64),
            np.zeros(TILE, np.float32))


CASES = ["level0", "random", "wide", "multi", "empty"]


@pytest.fixture(scope="module")
def atlases():
    jatlas = JTX.TextureAtlas.from_materials(
        [JMaterial(**t) for t in _textures()], resolution=RES)
    atlas = TX.TextureAtlas.from_materials(
        [Material(**t) for t in _textures()], resolution=RES, device=CPU)
    jpages = JMP.atlas_mip_pages(jatlas.albedo, jatlas.specular,
                                 jatlas.height)
    return jatlas, atlas, jpages


def _jax(jpages, uv, mat, hit):
    ntiles = uv.shape[0] // TILE
    scal, lists, slots = JMP.select_material_bricks(
        jnp.asarray(mat).reshape(ntiles, TILE).astype(jnp.int32),
        jnp.asarray(uv).reshape(ntiles, TILE, 2),
        jnp.asarray(hit).reshape(ntiles, TILE).astype(bool),
        num_materials=3, resolution=RES, num_levels=RES.bit_length())
    g = np.zeros((uv.shape[0], 32), np.float32)
    g[:, 15:17], g[:, 17], g[:, 19] = uv, mat, hit
    args = (jnp.asarray(g), slots.reshape(-1, 1), scal, lists, jpages)
    ref = np.asarray(JMP.material_tiles_ref(*args, RES, tile=TILE))
    kern = np.asarray(JMP.material_tiles(*args, resolution=RES,
                                         interpret=True, tile=TILE))
    host = [np.array(a) for a in args]
    return host, ref, kern


def _port(g, slots, scal, lists, pages):
    return MT.material_tiles(
        torch.as_tensor(g), torch.as_tensor(slots), torch.as_tensor(scal),
        torch.as_tensor(lists[:scal.shape[0]]),
        torch.as_tensor(pages.view(np.int16)).view(torch.bfloat16),
        resolution=RES).numpy()


@pytest.mark.parametrize("case", CASES)
def test_matches_material_ref(atlases, case):
    (g, slots, scal, lists, pages), ref, _ = _jax(atlases[2], *_case(case))
    out = _port(g, slots, scal, lists, pages)
    assert out.shape == ref.shape == (g.shape[0], MT.NOUT)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    if case == "empty":
        assert out.max() == 0.0
    if case == "level0":
        assert (scal[:, 2] == 0).all()
    if case == "wide":
        assert scal[0, 2] == RES.bit_length() - 1


@pytest.mark.parametrize("case", CASES)
def test_matches_pallas_interpret(atlases, case):
    (g, slots, scal, lists, pages), _, kern = _jax(atlases[2], *_case(case))
    np.testing.assert_allclose(_port(g, slots, scal, lists, pages), kern,
                               atol=2e-2, rtol=0)


def test_atlas_and_pages_equal(atlases):
    """The port's host-built atlas and its packed mip pages are the JAX
    package's bit for bit (same numpy resize, same float32 box filter,
    same round-to-nearest bf16)."""
    jatlas, atlas, jpages = atlases
    for k in ("albedo", "specular", "height"):
        np.testing.assert_array_equal(getattr(atlas, k).numpy(),
                                      np.asarray(getattr(jatlas, k)))
    pages = MT.atlas_mip_pages(atlas.albedo, atlas.specular, atlas.height)
    assert pages.dtype == torch.bfloat16
    np.testing.assert_array_equal(pages.view(torch.int16).numpy(),
                                  np.asarray(jpages).view(np.int16))
    assert MT.pages_resolution(pages) == RES
    with pytest.raises(ValueError):
        MT.pages_resolution(pages[:, :-1])


@pytest.mark.parametrize("case", ["random", "multi"])
def test_own_prepass_and_material_chain(atlases, case):
    """The port's own atlas prepass feeding its own material fetch, against
    the JAX reference on the JAX entries: the same rows to 1e-5."""
    (g, slots, scal, lists, pages), ref, _ = _jax(atlases[2], *_case(case))
    gt = torch.as_tensor(g)
    scal8, mscal, mlists, mslots = PP.prepass_tiles(
        gt, light_dims=(64, 32, 16), field_dims=(64, 32, 16, 8),
        voxel=150.0 / 64, world_size=150.0, shadow_offset=2.0,
        atlas=PP.AtlasShape(3, RES, RES.bit_length()))
    np.testing.assert_array_equal(mscal.numpy(), scal)
    np.testing.assert_array_equal(mslots.numpy(), slots)
    own_pages = MT.atlas_mip_pages(atlases[1].albedo, atlases[1].specular,
                                   atlases[1].height)
    out = MT.material_tiles(gt, mslots, mscal, mlists, own_pages,
                            resolution=RES).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_sample_atlas_matches():
    """The plain atlas gather (voxel build albedo, alpha re-cast test)."""
    jatlas = JTX.TextureAtlas.from_materials(
        [JMaterial(**t) for t in _textures()], resolution=RES)
    rng = np.random.default_rng(9)
    uv = rng.uniform(-3, 3, (500, 2)).astype(np.float32)
    mat = rng.integers(0, 3, 500).astype(np.int32)
    for k in ("albedo", "specular", "height"):
        pages = np.array(getattr(jatlas, k))
        np.testing.assert_allclose(
            TX.sample_atlas(torch.as_tensor(pages), torch.as_tensor(mat),
                            torch.as_tensor(uv)).numpy(),
            np.asarray(JTX.sample_atlas(jnp.asarray(pages), jnp.asarray(mat),
                                        jnp.asarray(uv))),
            atol=1e-6, rtol=0)


def test_bump_normal_matches():
    rng = np.random.default_rng(10)

    def r(*shape):
        return rng.normal(size=(300,) + shape).astype(np.float32)

    args = [r() * 0.1, r() * 0.1, r() * 0.1, r(3), r(3), r(3)]
    np.testing.assert_allclose(
        TX.bump_normal_from_heights(*map(torch.as_tensor, args)).numpy(),
        np.asarray(JTX.bump_normal_from_heights(*map(jnp.asarray, args))),
        atol=1e-6, rtol=0)


NM_STRESS = PP.MAX_MATERIALS
REPS = 2


@pytest.fixture(scope="module")
def stress():
    """prepass.stress_gbuffer at the test atlas's resolution, pages of 64
    random materials in both packages (bit-equal, as above), and the port
    prepass's entries and slots for it (equal to the Pallas prepass's:
    tests/test_torch_prepass.py; the XLA oracle select_material_bricks
    does not clip the texel bases at +-BCLIP, so it differs where uv is
    huge)."""
    rng = np.random.default_rng(11)
    tex = [rng.uniform(0, 1, (NM_STRESS, RES, RES, c)).astype(np.float32)
           for c in (4, 3, 1)]
    jpages = JMP.atlas_mip_pages(*map(jnp.asarray, tex))
    pages = MT.atlas_mip_pages(*map(torch.as_tensor, tex))
    np.testing.assert_array_equal(pages.view(torch.int16).numpy(),
                                  np.asarray(jpages).view(np.int16))
    g = PP.stress_gbuffer(3, world_size=150.0, resolution=RES,
                          num_materials=NM_STRESS, reps=REPS)
    _, mscal, mlists, mslots = PP.prepass_tiles(
        torch.as_tensor(g), light_dims=(64, 32, 16),
        field_dims=(64, 32, 16, 8), voxel=150.0 / 64, world_size=150.0,
        shadow_offset=2.0, atlas=(NM_STRESS, RES, RES.bit_length()))
    return (g, mslots.numpy(), mscal.numpy(), mlists.numpy(), jpages, pages)


def _kind(stress, kind):
    """The stress fixture's rows of one tile kind: (g, slots, mscal,
    mlists padded to 8 rows, as the JAX functions take them)."""
    g, slots, scal, lists = stress[:4]
    rows = slice(kind * REPS * TILE, (kind + 1) * REPS * TILE)
    tiles = slice(kind * REPS, (kind + 1) * REPS)
    padded = np.zeros((-(-REPS // 8) * 8, lists.shape[1]), np.int32)
    padded[:REPS] = lists[tiles]
    return np.ascontiguousarray(g[rows]), slots[rows], scal[tiles], padded


@pytest.mark.parametrize("kind", range(len(PP.STRESS_KINDS)),
                         ids=PP.STRESS_KINDS)
def test_stress_matches_material_ref(stress, kind):
    """The stress tiles a kind at a time (64 materials, slots clamped, uv
    up to 1e7, |tu| near 2^24, wrap corners): on the same entries the
    port's material fetch equals material_tiles_ref to 1e-5."""
    args = _kind(stress, kind)
    ref = np.asarray(JMP.material_tiles_ref(*map(jnp.asarray, args),
                                            stress[4], RES, tile=TILE))
    out = MT.material_tiles(*map(torch.as_tensor, args[:3]),
                            torch.as_tensor(args[3][:REPS]), stress[5],
                            resolution=RES).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    if kind == PP.STRESS_KINDS.index("all miss"):
        assert out.max() == 0.0


@pytest.mark.parametrize("kind", ["wrap corner, level 0",
                                  "wrap corner, R_l = 4"])
def test_wrap_corner_matches_pallas_interpret(stress, kind):
    """Pixels on a level's wrap corner (i0 = R_l - 1, j0 = 0: the +u tap
    crosses the wrap column, the -v tap the wrap row) at level 0 (d = 1)
    and at the level of R_l = 4: the entries equal the XLA oracle's, and
    the port is within 2e-2 of the Pallas kernel in interpret mode (its
    bf16 weights)."""
    g, slots, scal, lists = _kind(stress, PP.STRESS_KINDS.index(kind))
    tiled = g.reshape(REPS, TILE, -1)
    jscal, jlists, jslots = JMP.select_material_bricks(
        jnp.asarray(tiled[..., 17].astype(np.int32)),
        jnp.asarray(tiled[..., 15:17]), jnp.asarray(tiled[..., 19] > 0.5),
        num_materials=NM_STRESS, resolution=RES, num_levels=RES.bit_length())
    np.testing.assert_array_equal(scal, np.asarray(jscal))
    np.testing.assert_array_equal(lists, np.asarray(jlists))
    np.testing.assert_array_equal(slots.reshape(REPS, TILE),
                                  np.asarray(jslots))
    rl = np.repeat(RES >> scal[:, 2], TILE)
    assert (rl == (RES if kind.endswith("level 0") else 4)).all()
    tu = g[:, 15] * rl - 0.5
    tv = (1 - g[:, 16]) * rl - 0.5
    edge = (np.floor(tu) == rl - 1) & (np.floor(tv) == 0)
    assert edge.mean() > 0.9
    kern = np.asarray(JMP.material_tiles(
        *map(jnp.asarray, (g, slots, scal, lists)), stress[4],
        resolution=RES, interpret=True, tile=TILE))
    out = MT.material_tiles(*map(torch.as_tensor, (g, slots, scal)),
                            torch.as_tensor(lists[:REPS]), stress[5],
                            resolution=RES).numpy()
    np.testing.assert_allclose(out, kern, atol=2e-2, rtol=0)


def _texel_fixtures(atlases, stress):
    for case in CASES:
        (g, slots, scal, lists, _), _, _ = _jax(atlases[2], *_case(case))
        yield case, g, slots, scal, lists
    for k, kind in enumerate(PP.STRESS_KINDS):
        yield (kind,) + _kind(stress, k)


def test_corner_texels_at_most_8(atlases, stress):
    """On every fixture, a pixel whose |tu|, |tv| stay below 2^24 reads at
    most 8 distinct texels and csrc/material.cu loads at most 4 heights
    beside its main tap; the |tu| near 2^24 tiles go past that, which is
    why the kernel compares texels at run time."""
    beyond = {}
    for name, g, slots, scal, lists in _texel_fixtures(atlases, stress):
        gt, st = torch.as_tensor(np.array(g)), torch.as_tensor(slots)
        sc, li = torch.as_tensor(scal), torch.as_tensor(lists[:len(scal)])
        distinct, loads = MT.corner_texels(gt, st, sc, li, RES)
        _, lvl, _ = MT._entries(sc, li, st, TILE)
        rl = (RES >> lvl.clamp(0, RES.bit_length() - 1)).float()
        near = ((gt[:, 15] * rl).abs() < 2 ** 23) \
            & (((1 - gt[:, 16]) * rl).abs() < 2 ** 23)
        assert int(torch.where(near, distinct, 0).max()) <= 8, name
        assert int(torch.where(near, loads, 0).max()) <= 4, name
        assert bool(((loads > 0) <= (distinct > 4)).all()), name
        beyond[name] = int(distinct.max())
    assert beyond["|tu| near 2^24"] > 8
