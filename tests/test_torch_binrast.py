"""Kernel 7 (binned raycast): the port's binning, its plain walk, the
whole pipeline and the frame above 2048 triangles against the JAX
package's vct_tpu.ops.binrast_pallas (kernel in interpret mode) and
vct_tpu.render.fast, at tests/test_binrast.py's fixtures: 128x64 rays
(8 strips of 16x64 pixels), its three cameras, the atrium (1,122
triangles) and the atrium subdivided once (4,488).  Both packages get the
same numpy inputs.

Bounds, with what these fixtures measured on the CPU:
  * bin_triangles: scal, n_col_total and the table's triangle ids equal
    the JAX package's (measured equal on all six scene/camera pairs, the
    gnomonic frame's float sums included);
  * raycast_binned_plain on the JAX bin tables: equal, every column, to
    an exact-float32 numpy walk (every multiply and add rounded on its
    own, as the TPU kernel's VPU arithmetic); against the Pallas kernel
    in interpret mode, hit equal everywhere, and the winner equal on
    all but <= 0.1% of rays (measured 2 of 8,192 at camera 0), each of
    which the port's exact arithmetic puts on a triangle edge
    (min(u, v, 1-u-v) < 1e-5) no farther than the JAX winner: XLA's CPU
    compiler fuses the kernel's multiply-adds (an FMA reproduces its
    winner), so an exact tie on a shared edge or a ray through the edge
    can go the other way.  Where the winners agree, t within rtol 1e-6
    (measured 2.2e-7) and u, v within 1e-4 (measured 2.1e-5: u*det and
    v*det cancel, so one fused rounding moves them);
  * walk_cull_plain (the kernel's per-tile cull of its strip's walk): no
    dropped (ray, row) pair passes the hit test, and each tile cast against
    its kept rows alone gives the plain walk's rows bit for bit;
  * raycast_pinhole_binned: hit and t (rtol/atol 1e-6) equal to the port's
    whole-table raycast_plain, rows within 1e-4 on > 99% (exact-t ties
    go by walk order, not triangle order), and against the JAX pipeline
    hit equal and rows within 1e-4 on > 99%;
  * render_frame on the subdivided atrium at 32^3 / 128x64 on the JAX
    voxel state vs F.render_frame(interpret=True): mean < 1e-3 and the
    max over channels > 0.02 on < 1% of pixels, tests/test_binrast.py's
    bound between two raycasts of the same frame.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.config import preset as jpreset
from vct_tpu.core import camera as jcam
from vct_tpu.ops import binrast_pallas as JBR
from vct_tpu.render import fast as JF
from vct_tpu.render import gbuffer as jgbuf
from vct_tpu.render import renderer as JR
from vct_tpu.scene.atrium import atrium as jatrium
from vct_tpu.scene.mesh import subdivide_scene as jsubdivide
from vct_tpu_torch import interop
from vct_tpu_torch.config import preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.ops import binrast as BR
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import gbuffer as GB
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.scene.atrium import atrium
from vct_tpu_torch.scene.mesh import subdivide_scene

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

CPU = torch.device("cpu")
W, H = 128, 64          # wp = 128 -> 2 strip columns, hp = 64 -> 4 rows
CAMERAS = [
    dict(position=(48.0, -10.0, 0.0), yaw=180.0),
    dict(position=(0.0, 0.0, 0.0), yaw=45.0, pitch=-20.0),
    dict(position=(-30.0, 5.0, 10.0), yaw=10.0, pitch=30.0),
]
CASES = [(s, c) for s in (0, 1) for c in range(len(CAMERAS))]
IDS = [f"subdiv{s}-cam{c}" for s, c in CASES]


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def scenes():
    """Per subdivision level: the JAX and the port DeviceScene, and
    per-material constants made with numpy."""
    out = {}
    rng = np.random.default_rng(0)
    for level in (0, 1):
        jds = jgbuf.DeviceScene.from_scene(jsubdivide(jatrium(), level))
        pds = GB.DeviceScene.from_scene(subdivide_scene(atrium(), level),
                                        device=CPU)
        m = len(atrium().materials)
        mats = (rng.random((m, 4), np.float32),
                rng.random((m, 3), np.float32),
                rng.random(m).astype(np.float32) * 40)
        out[level] = (jds, pds, mats)
    return out


def _rays(cam):
    """Origin, tile-major rays and the padded ray image, as numpy."""
    origins, dirs = jcam.primary_rays(jcam.Camera(**cam), W, H)
    dflat = JF._tile_order(dirs, H, W)            # 64 x 128: no padding
    return (np.array(origins).reshape(-1, 3)[0], np.array(dflat),
            np.array(dirs))


def _jax_bins(jds, o, dflat, dimg, mats=None):
    mats = () if mats is None else tuple(map(jnp.asarray, mats))
    rows, _ = JBR.pack_rows(jds, jnp.asarray(o), *mats)
    scal, isect_p, n_col = JBR.bin_triangles(
        jds, jnp.asarray(o), jnp.asarray(dflat), jnp.asarray(dimg), rows)
    return np.asarray(scal), np.asarray(isect_p), int(n_col)


def cast_ref(d, rows):
    """Rays d (m, 3) against table rows (L, 16), L >= 1, in order, in numpy
    float32 with each multiply and add rounded on its own: (m, 8) rows
    [t, id, u, v, hit, 0, 0, 0], the first minimum of t."""
    f32 = np.float32
    tb = rows[None]
    dd = d[:, None, :]

    def dot3(c):
        return (dd[..., 0] * tb[..., c] + dd[..., 1] * tb[..., c + 1]
                + dd[..., 2] * tb[..., c + 2])

    det, ud, vd = dot3(0), dot3(3), dot3(6)
    kk = tb[..., 9]
    sgn = np.sign(det)
    ad = np.abs(det)
    sinv = sgn * (f32(1) / np.maximum(ad, f32(RP.EPS)))
    valid = ((ad > f32(RP.EPS)) & (sgn * ud >= 0) & (sgn * vd >= 0)
             & (sgn * (ud + vd) <= ad)
             & (sgn * kk > f32(RP.TMIN_EPS) * ad))
    tc = np.where(valid, kk * sinv, f32(RP.BIG))
    j = np.argmin(tc, axis=1)
    r = np.arange(tc.shape[0])
    best = tc[r, j]
    hit = best < f32(RP.BIG)
    out = np.zeros((d.shape[0], 8), f32)
    out[:, 0] = best
    out[:, 1] = np.where(hit, tb[0, j, 10], 0)
    out[:, 2] = np.where(hit, (ud * sinv)[r, j], 0)
    out[:, 3] = np.where(hit, (vd * sinv)[r, j], 0)
    out[:, 4] = hit
    return out


def walk_ref(d, scal, table):
    """The walk in numpy float32, each multiply and add rounded on its own:
    (n, 8) rows [t, id, u, v, hit, 0, 0, 0]."""
    out = np.zeros((d.shape[0], 8), np.float32)
    out[:, 0] = np.float32(RP.BIG)
    for s in range(scal.shape[1]):
        off, gseg, coff, gcol = (int(x) for x in scal[:, s])
        rows = np.concatenate([off + np.arange(gseg * BR.GANGW),
                               coff + np.arange(gcol * BR.GANGW)])
        if rows.size:
            sl = slice(s * BR.STRIPE, (s + 1) * BR.STRIPE)
            out[sl] = cast_ref(d[sl], table[rows])
    return out


@pytest.mark.parametrize("level,cam", CASES, ids=IDS)
def test_bin_triangles_match_jax(scenes, level, cam):
    jds, pds, _ = scenes[level]
    o, dflat, dimg = _rays(CAMERAS[cam])
    scal, isect_p, n_col = _jax_bins(jds, o, dflat, dimg)
    isect, _ = BR.pack_rows(pds, t(o))
    ps, table, pn = BR.bin_triangles(pds, t(o), t(dflat), t(dimg), isect)
    np.testing.assert_array_equal(ps.numpy(), scal)
    assert int(pn) == n_col
    assert table.shape == isect_p.T.shape
    np.testing.assert_array_equal(table[:, 10].numpy(), isect_p[10])


@pytest.mark.parametrize("level,cam", CASES, ids=IDS)
def test_walk_matches_jax(scenes, level, cam):
    jds, _, _ = scenes[level]
    o, dflat, dimg = _rays(CAMERAS[cam])
    scal, isect_p, _ = _jax_bins(jds, o, dflat, dimg)
    table = np.ascontiguousarray(isect_p.T)
    out = BR.raycast_binned_plain(t(dflat), t(scal), t(table)).numpy()
    np.testing.assert_array_equal(out, walk_ref(dflat, scal, table))

    ref = np.asarray(JBR.raycast_binned(jnp.asarray(dflat),
                                        jnp.asarray(scal),
                                        jnp.asarray(isect_p),
                                        interpret=True))
    np.testing.assert_array_equal(out[:, 4], ref[:, 4])
    same = out[:, 1] == ref[:, 1]
    assert (~same).mean() <= 1e-3, int((~same).sum())
    u, v = out[~same, 2], out[~same, 3]
    assert (np.minimum(np.minimum(u, v), 1 - u - v) < 1e-5).all()
    assert (out[~same, 0] <= ref[~same, 0] * (1 + 1e-6)).all()
    np.testing.assert_allclose(out[same, 0], ref[same, 0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(out[same, 2:4], ref[same, 2:4], atol=1e-4)


@pytest.mark.parametrize("level,cam", CASES, ids=IDS)
def test_pipeline_matches(scenes, level, cam):
    jds, pds, mats = scenes[level]
    o, dflat, dimg = _rays(CAMERAS[cam])
    out = BR.raycast_pinhole_binned(pds, t(o), t(dflat), t(dimg),
                                    *map(t, mats)).numpy()
    whole = RP.raycast_plain(t(dflat), t(o), *RP.pack_tables(
        pds, t(o), *map(t, mats))).numpy()
    np.testing.assert_array_equal(out[:, 19], whole[:, 19])
    np.testing.assert_allclose(out[:, 18], whole[:, 18], rtol=1e-6,
                               atol=1e-6)
    assert np.isclose(out, whole, rtol=1e-4, atol=1e-4).all(1).mean() > 0.99

    ref = np.asarray(JBR.raycast_pinhole_binned(
        jds, jnp.asarray(o), jnp.asarray(dflat), jnp.asarray(dimg),
        *map(jnp.asarray, mats), interpret=True))
    np.testing.assert_array_equal(out[:, 19], ref[:, 19])
    assert np.isclose(out, ref, rtol=1e-4, atol=1e-4).all(1).mean() > 0.99


# ---------------------------------------------------------------------------
# the binned kernel's per-tile cull of its strip's walk (walk_cull_plain)
# ---------------------------------------------------------------------------

TPS = BR.STRIPE // RP.TILE      # 256-ray tiles a strip


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def walk_case(request, scenes):
    """The port's own binning of one fixture, and walk_cull_plain on it."""
    level, cam = request.param
    _, pds, _ = scenes[level]
    o, dflat, dimg = _rays(CAMERAS[cam])
    isect, _ = BR.pack_rows(pds, t(o))
    scal, table, _ = BR.bin_triangles(pds, t(o), t(dflat), t(dimg), isect)
    return dflat, scal, table, BR.walk_cull_plain(t(dflat), scal, table)


def _tile_walk(scal, tile, length):
    rows, live = BR._walk(scal, torch.tensor([tile // TPS]), length)
    return rows[0], live[0]


def test_walk_cull_drops_no_hit(walk_case):
    """Every (ray, walk row) pair the tile's cull drops fails the hit test;
    the cull keeps only positions on the walk, is tile_cull_plain's verdict
    on the same rows (one predicate, two batchings), and drops most of the
    walk."""
    dflat, scal, table, keep = walk_case
    d = t(dflat)
    whole = RP.tile_cull_plain(d, table)
    assert keep.shape[0] == d.shape[0] // RP.TILE
    walked = 0
    for tile in range(keep.shape[0]):
        rows, live = _tile_walk(scal, tile, keep.shape[1])
        assert not (keep[tile] & ~live).any()
        kt, rows = keep[tile][live], rows[live]
        np.testing.assert_array_equal(kt.numpy(), whole[tile, rows].numpy())
        valid = RP.hit_tests(d[tile * RP.TILE:(tile + 1) * RP.TILE],
                             table[rows])[0]
        assert not (valid & ~kt[None, :]).any()
        walked += rows.numel()
    assert 0 < int(keep.sum()) < 0.5 * walked


def test_walk_culled_cast_is_exact(walk_case):
    """Each tile cast against only its kept walk rows, in walk order (plus
    one all-zero row, which never hits, so that no table is empty), gives
    raycast_binned_plain's rows bit for bit: dropped rows never win and the
    kept ones keep their order."""
    dflat, scal, table, keep = walk_case
    out = BR.raycast_binned_plain(t(dflat), scal, table).numpy()
    parts = []
    for tile in range(keep.shape[0]):
        rows, _ = _tile_walk(scal, tile, keep.shape[1])
        tb = table[rows[keep[tile]]].numpy()
        parts.append(cast_ref(dflat[tile * RP.TILE:(tile + 1) * RP.TILE],
                              np.concatenate([tb, np.zeros((1, RP.NISECT),
                                                           np.float32)])))
    np.testing.assert_array_equal(np.concatenate(parts), out)
    assert out[:, 4].any()


def test_stable_order_branch():
    """At >= 2**19 triangles the slots sort stably by bin alone: the
    port's order equals jax.lax.sort(num_keys=1, is_stable=True) on the
    same emission arrays, and below it the packed-word sort equals a
    lexicographic (bin, triangle) sort."""
    rng = np.random.default_rng(1)
    nbins = 40
    bins = rng.integers(0, nbins + 1, 5000).astype(np.int32)  # nbins: unused
    tris = rng.integers(0, 1 << 19, 5000).astype(np.int32)
    sb, st = BR._sort_slots(t(bins), t(tris), 1 << 19, nbins)
    jb, jt = jax.lax.sort((jnp.asarray(bins), jnp.asarray(tris)),
                          dimension=0, num_keys=1, is_stable=True)
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jt))

    small = tris % 1000
    sb, st = BR._sort_slots(t(bins), t(small), 1000, nbins)
    used = bins < nbins
    order = np.lexsort((small[used], bins[used]))
    n = int(used.sum())
    np.testing.assert_array_equal(sb.numpy()[:n], bins[used][order])
    np.testing.assert_array_equal(st.numpy()[:n], small[used][order])
    assert (sb.numpy()[n:] == nbins).all() and (st.numpy()[n:] == 0).all()


def test_column_tier_within_budget(scenes):
    """Camera 1 stands inside the scene, where near-plane straddlers would
    fill the column tier: it must fit its budget (overflow drops
    geometry)."""
    _, pds, _ = scenes[1]
    o, dflat, dimg = _rays(CAMERAS[1])
    isect, _ = BR.pack_rows(pds, t(o))
    _, _, n_col = BR.bin_triangles(pds, t(o), t(dflat), t(dimg), isect)
    assert int(n_col) <= BR._budgets(pds.v0.shape[0])[1]
    for tris in (1122, 4488, 287232, 1 << 20):
        assert BR._budgets(tris) == JBR._budgets(tris)
    assert BR._budgets(287232) == (23936, 8976)


def _small_cfg(make_preset):
    cfg = make_preset("sponza256")
    return dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, dim=32, compute="float32"),
        cones=dataclasses.replace(cfg.cones, field_dim=32),
        render=dataclasses.replace(cfg.render, width=W, height=H))


def test_frame_matches_jax():
    """The subdivided atrium (4,488 triangles) goes through the binned
    raycast in both packages: the port's frame on the JAX voxel state
    (built from the unsubdivided atrium's samples, as bench.py does)."""
    jcfg = _small_cfg(jpreset)
    _, jmats, jsamples = JR.prepare_scene(jcfg, jatrium())
    jds, _, _ = JR.prepare_scene(jcfg, jsubdivide(jatrium(), 1),
                                 samples=jsamples)
    voxels = JR.build_voxel_state_staged(jcfg, jsamples, jmats)
    jtables = JF.build_frame_tables(jcfg, voxels, jmats)
    cam = CAMERAS[0]
    origins, dirs = jcam.primary_rays(jcam.Camera(**cam), W, H)
    pos = jnp.asarray(cam["position"], jnp.float32)
    ref = np.asarray(JF.render_frame(jcfg, jds, jtables, jmats, origins,
                                     dirs, pos, interpret=True))
    jt, jm = jax.tree_util.tree_map(np.asarray, (jtables, jmats))

    cfg = _small_cfg(preset)
    ds = GB.DeviceScene.from_scene(subdivide_scene(atrium(), 1), device=CPU)
    assert ds.v0.shape[0] > RP.MAX_TRIANGLES
    tables = interop.frame_tables(jt, cfield=8 * cfg.cones.field_basis,
                                  device=CPU)
    mats = interop.material_table(jm, device=CPU)
    po, pd = CAM.primary_rays(CAM.Camera(**cam), W, H, device=CPU)
    launches = BR.LAUNCHES
    out = F.render_frame(cfg, ds, tables, mats, po, pd,
                         torch.tensor(cam["position"])).numpy()
    assert BR.LAUNCHES == launches          # CPU tensors: the plain walk
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    assert err.mean() < 1e-3, err.mean()
    assert (err.max(axis=-1) > 0.02).mean() < 0.01


def test_prepare_scene_reuses_samples():
    cfg = _small_cfg(preset)
    _, _, samples = R.prepare_scene(cfg, atrium(), device=CPU)
    ds, mats, again = R.prepare_scene(cfg, subdivide_scene(atrium(), 1),
                                      samples=samples, device=CPU)
    assert again is samples
    assert ds.v0.shape[0] == 4 * 1122 and mats.atlas is not None


def _huge_scene(t):
    """A DeviceScene of t triangles that holds one (stride-0 rows)."""
    def rows(*shape):
        return torch.zeros((1,) + shape).expand((t,) + shape)
    return GB.DeviceScene(v0=rows(3), e1=rows(3), e2=rows(3), vn=rows(3, 3),
                          vt=rows(3, 3), vb=rows(3, 3), vuv=rows(3, 2),
                          face_normal=rows(3),
                          material=torch.zeros(1, dtype=torch.int32)
                          .expand(t))


def test_id_limits_refuse():
    """Scenes whose ids would not fit raise instead of picking wrong
    triangles: float32 ids in the binned table, 16-bit chunk ids in the
    streamed raycast's list words."""
    o = torch.zeros(3)
    big = _huge_scene(BR.MAX_IDS + 1)
    with pytest.raises(ValueError, match="float32"):
        BR.pack_rows(big, o)
    dimg = torch.zeros((16, 64, 3))
    with pytest.raises(ValueError, match="float32"):
        BR.bin_triangles(big, o, dimg.reshape(-1, 3), dimg,
                         torch.zeros((1, RP.NISECT)))
    with pytest.raises(ValueError, match="chunk ids"):
        RP.pack_tables_stream(_huge_scene(RP.MAX_CHUNKS * RP.CHUNK + 1), o)
    with pytest.raises(ValueError, match="chunk ids"):
        RP.select_chunks(torch.zeros((1, RP.TILE, 3)),
                         torch.zeros((RP.MAX_CHUNKS + 1, 4)))
    # at the limit every chunk id reads back from its word
    dirs = torch.zeros((1, RP.TILE, 3))
    dirs[..., 2] = 1.0
    spheres = torch.zeros((RP.MAX_CHUNKS, 4))
    spheres[:, 2] = 5.0
    spheres[:, 3] = 1.0
    lists, counts = RP.select_chunks(dirs, spheres)
    assert int(counts[0]) == RP.MAX_CHUNKS
    assert torch.equal(torch.sort(lists[0] & 0xFFFF).values,
                       torch.arange(RP.MAX_CHUNKS, dtype=torch.int32))
