"""Kernel 6 (streamed raycast): the port's plain version against the JAX
package's Pallas raycast_stream in interpret mode, on the atrium at
tests/test_raycast_stream.py's rays (64x32, the bench camera) and the
same tables and chunk lists, with and without a per-ray tmin as the
alpha re-cast sets it: hit and material columns equal, t and position
atol 1e-5 (rtol 1e-5 for t up to ~100), the interpolated columns atol
1e-4, the bound tests/test_torch_raycast.py holds the whole-table port to
against that Pallas kernel (measured: 2.6e-5 on a uv, where the kernel
under XLA's CPU compiler itself differs from the jnp oracle raycast_ref
by the same 2.6e-5).  Against raycast_ref, the oracle, the port is held
to atol 1e-5 (measured 1.2e-7).  Without tmin it equals the port's
whole-table raycast.  Also the port's own stream tables and chunk lists
against the JAX ones.

And the kernel's work, stated in plain PyTorch (csrc/raycast_stream.cu
runs only on the card): on the atrium fixture and on the atrium
subdivided once (4,488 triangles, tests/test_torch_binrast.py's second
scene, its own tables) at the same rays, with no tmin, with the re-cast's
tmin and with live and dead rays mixed in each tile, and at rays in tight
clusters (even warps two, 5 degrees apart, odd warps one), stream_parts
splits a warp only at its widest neighbour angle above 1 degree,
stream_cull_plain keeps every row that wins in raycast_stream_plain, and
stream_walk_plain (each warp part's cast over its kept rows alone, with
the front-to-back stop) equals raycast_stream_plain bit for bit; a warp
with no live ray keeps nothing and gives raycast_stream_plain's miss
rows.  may_keep_rows, the kernel's square-root-free test before its
cull, keeps every row cull_rows keeps, on both scenes and on random rows
from 1e-30 to 1e30."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.core import camera as jcam
from vct_tpu.ops import raycast_pallas as JRP
from vct_tpu.render import gbuffer as jgbuf
from vct_tpu.scene.atrium import atrium as jatrium
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.render import gbuffer as GB
from vct_tpu_torch.scene.atrium import atrium
from vct_tpu_torch.scene.mesh import subdivide_scene

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

W, H = 64, 32
CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def setup():
    _, d = jcam.primary_rays(jcam.Camera(**CAMERA), W, H)
    d = np.array(d).reshape(-1, 3)
    o = np.asarray(CAMERA["position"], np.float32)
    jds = jgbuf.DeviceScene.from_scene(jatrium())
    m = int(np.asarray(jds.material).max()) + 1
    rng = np.random.default_rng(0)
    mats = (rng.random((m, 4), np.float32), rng.random((m, 3), np.float32),
            rng.random(m).astype(np.float32) * 40)
    isect, attrsT, spheres, n = JRP.pack_tables_stream(
        jds, jnp.asarray(o), *map(jnp.asarray, mats))
    lists, counts = JRP.select_chunks(
        jnp.asarray(d).reshape(-1, RP.TILE, 3), spheres)
    tables = tuple(np.asarray(x) for x in (isect, attrsT, spheres, lists,
                                           counts))
    return d, o, mats, tables, n


def _jax(d, o, tables, tmin=None):
    isect, attrsT, spheres, lists, counts = map(jnp.asarray, tables)
    return np.asarray(JRP.raycast_stream(
        jnp.asarray(d), jnp.asarray(o), isect, attrsT, lists, counts,
        spheres, interpret=True,
        tmin=None if tmin is None else jnp.asarray(tmin)[:, None]))


def _port(d, o, tables, tmin=None):
    isect, attrsT, spheres, lists, counts = tables
    return RP.raycast_stream(
        t(d), t(o), t(isect.T), t(attrsT.T), t(lists), t(counts),
        t(spheres), tmin=None if tmin is None else t(tmin)).numpy()


def _check(out, ref):
    np.testing.assert_array_equal(out[:, 19], ref[:, 19])
    np.testing.assert_array_equal(out[:, 17], ref[:, 17])
    np.testing.assert_allclose(out[:, 18], ref[:, 18], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[:, 0:3], ref[:, 0:3], atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def _recast_tmin(d, o, tables):
    """tmin just past each ray's first hit, as alpha_resolve sets it;
    rays that missed get 3e38 (nothing can be hit)."""
    g = _jax(d, o, tables)
    return np.where(g[:, 19] > 0.5, g[:, 18] * (1.0 + 1e-5) + 1e-4,
                    3.0e38).astype(np.float32), g


def test_matches_pallas_stream(setup):
    d, o, _, tables, _ = setup
    ref = _jax(d, o, tables)
    assert (ref[:, 19] > 0.5).any()
    _check(_port(d, o, tables), ref)


def test_matches_raycast_ref(setup):
    """No tmin: the JAX jnp oracle on the whole table, atol 1e-5."""
    d, o, mats, tables, _ = setup
    jds = jgbuf.DeviceScene.from_scene(jatrium())
    isect, attrs, _ = JRP.pack_tables(jds, jnp.asarray(o),
                                      *map(jnp.asarray, mats))
    ref = np.asarray(JRP.raycast_ref(jnp.asarray(d), jnp.asarray(o), isect,
                                     attrs))
    out = _port(d, o, tables)
    np.testing.assert_array_equal(out[:, 19], ref[:, 19])
    np.testing.assert_array_equal(out[:, 17], ref[:, 17])
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_matches_pallas_stream_with_tmin(setup):
    d, o, _, tables, _ = setup
    tmin, first = _recast_tmin(d, o, tables)
    ref = _jax(d, o, tables, tmin)
    out = _port(d, o, tables, tmin)
    _check(out, ref)
    behind = out[:, 19] > 0.5
    assert behind.any()                    # surfaces behind the first hits
    assert (out[behind, 18] > first[behind, 18]).all()


def test_matches_whole_table_without_tmin(setup):
    """Culling is conservative: the streamed winner is the whole-table
    one (the port's own tables, no ties on this fixture)."""
    d, o, mats, _, _ = setup
    ds = GB.DeviceScene.from_scene(atrium(), device="cpu")
    own = RP.pack_tables_stream(ds, t(o), *map(t, mats))
    isect, attrs, spheres = own
    lists, counts = RP.select_chunks(t(d).reshape(-1, RP.TILE, 3), spheres)
    out = RP.raycast_stream(t(d), t(o), isect, attrs, lists, counts,
                            spheres).numpy()
    whole = RP.raycast_gbuf24(t(d), t(o), *RP.pack_tables(
        ds, t(o), *map(t, mats))).numpy()
    np.testing.assert_array_equal(out, whole)


def test_own_tables_match(setup):
    """The port's pack_tables_stream and select_chunks against the JAX
    ones: the same padded rows and spheres, and the same chunk lists."""
    d, o, mats, tables, n = setup
    isect, attrsT, spheres, lists, counts = tables
    ds = GB.DeviceScene.from_scene(atrium(), device="cpu")
    pi, pa, ps = RP.pack_tables_stream(ds, t(o), *map(t, mats))
    assert pi.shape == (isect.shape[1], RP.NISECT)
    np.testing.assert_array_equal(pa.numpy(), attrsT.T)
    np.testing.assert_allclose(pi.numpy(), isect.T, rtol=0,
                               atol=1e-6 * np.abs(isect).max())
    np.testing.assert_allclose(ps.numpy(), spheres, rtol=1e-6, atol=1e-4)
    pl, pc = RP.select_chunks(t(d).reshape(-1, RP.TILE, 3), t(spheres))
    np.testing.assert_array_equal(pc.numpy(), counts)
    nchunk = spheres.shape[0]
    np.testing.assert_array_equal(pl.numpy(), lists[:pc.shape[0], :nchunk])


def test_sky_rays_miss():
    """Rays that leave the scene box: miss rows (position = origin, the
    rest zero), from the miss sentinel rather than BIG."""
    ds = GB.DeviceScene.from_scene(atrium(), device="cpu")
    o = torch.tensor([0.0, 500.0, 0.0])
    d = torch.zeros((RP.TILE, 3))
    d[:, 1] = 1.0                               # straight up, away
    isect, attrs, spheres = RP.pack_tables_stream(ds, o)
    lists, counts = RP.select_chunks(d.reshape(1, RP.TILE, 3), spheres)
    out = RP.raycast_stream(d, o, isect, attrs, lists, counts,
                            spheres).numpy()
    np.testing.assert_array_equal(out[:, 0:3], np.tile(o.numpy(), (RP.TILE, 1)))
    np.testing.assert_array_equal(out[:, 3:], 0.0)


# ---- the kernel's cull and walk (stream_cull_plain, stream_walk_plain) ----

SCENES = ("atrium", "atrium-x1")
KINDS = ("none", "recast", "mixed", "clusters")


@pytest.fixture(scope="module")
def stream_args(setup):
    """Per scene, the streamed raycast's tables and lists at the fixture's
    rays: (d, o, isect, attrs, lists, counts, spheres) as torch tensors."""
    d, o, mats, tables, _ = setup
    isect, attrsT, spheres, lists, counts = tables
    d, o = t(d), t(o)
    out = {"atrium": (d, o, t(isect.T).contiguous(),
                      t(attrsT.T).contiguous(),
                      t(lists)[:counts.shape[0]].contiguous(), t(counts),
                      t(spheres))}
    ds = GB.DeviceScene.from_scene(subdivide_scene(atrium(), 1), device="cpu")
    isect1, attrs1, spheres1 = RP.pack_tables_stream(ds, o, *map(t, mats))
    lists1, counts1 = RP.select_chunks(d.reshape(-1, RP.TILE, 3), spheres1)
    out["atrium-x1"] = (d, o, isect1, attrs1, lists1, counts1, spheres1)
    return out


def _cluster_rays(d):
    """Each warp's rays jittered by ~0.01 degrees around its first ray, and
    in even warps lanes 20-31 around that ray turned 5 degrees about y."""
    ng = d.shape[0] // RP.GROUP
    base = np.repeat(d.numpy().reshape(ng, RP.GROUP, 3)[:, :1], RP.GROUP,
                     axis=1).astype(np.float64)
    c, s = np.cos(np.radians(5.0)), np.sin(np.radians(5.0))
    turned = base @ np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
    far = (np.arange(ng)[:, None] % 2 == 0) & (np.arange(RP.GROUP) >= 20)
    x = np.where(far[..., None], turned, base)
    x = x + np.random.default_rng(2).normal(0.0, 2e-4, x.shape)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return torch.as_tensor(x.reshape(-1, 3).astype(np.float32))


_CACHE = {}


def _case(stream_args, scene, kind):
    """The walk's inputs and results for one scene and kind: the
    streamed raycast's arguments, stream_cull_plain's keep,
    raycast_stream_plain's G-buffer and stream_walk_plain's G-buffer and
    kept counts (cached per case)."""
    if (scene, kind) in _CACHE:
        return _CACHE[scene, kind]
    d, o, isect, attrs, lists, counts, spheres = stream_args[scene]
    n = d.shape[0]
    tmin = torch.full((n,), -1.0)
    if kind == "clusters":
        d = _cluster_rays(d)
        lists, counts = RP.select_chunks(d.reshape(-1, RP.TILE, 3), spheres)
    elif kind != "none":
        first = RP.raycast_stream(d, o, isect, attrs, lists, counts, spheres)
        tmin = torch.where(first[:, 19] > 0.5,
                           first[:, 18] * (1.0 + 1e-5) + 1e-4, 3.0e38)
        if kind in ("mixed", "dead"):
            # half the rays at random, and every third warp whole, cannot
            # hit (tmin at or past the miss sentinel); "dead": all of them
            rng = np.random.default_rng(1)
            dead = torch.as_tensor(rng.random(n) < 0.5) | (kind == "dead")
            dead.reshape(-1, RP.GROUP)[::3] = True
            tmin = torch.where(dead, 3.0e38, tmin)
    miss = RP.miss_distance(d, spheres)
    args = (d, o, isect, attrs, lists, counts, tmin, miss)
    keep = RP.stream_cull_plain(d, isect, lists, counts, tmin, miss)
    plain = RP.raycast_stream_plain(*args)
    walk, kept = RP.stream_walk_plain(*args, keep)
    _CACHE[scene, kind] = (args, keep, plain, walk, kept)
    return _CACHE[scene, kind]


def _winners(d, isect, lists, counts, tmin, miss):
    """Each ray's winner as raycast_stream_plain picks it: the least t > tmin
    over its tile's listed rows, ties to the earliest (list position, row);
    returns hit (N,) and the winner's position and row (N,)."""
    nrt, width = counts.shape[0], lists.shape[1]
    listed = torch.arange(width)[None, :] < counts[:, None].long()
    chunk = (lists & 0xFFFF).long()
    pos = torch.full((nrt, isect.shape[0] // RP.CHUNK), width)
    for tile in range(nrt):
        ids = chunk[tile, listed[tile]]
        pos[tile, ids] = torch.arange(ids.numel())
    tri = torch.arange(isect.shape[0])
    key = pos[:, tri // RP.CHUNK] * RP.CHUNK + tri % RP.CHUNK   # (nrt, T)
    key = key[torch.arange(d.shape[0]) // RP.TILE]
    valid, _, _, kk, sinv = RP.hit_tests(d, isect)
    tval = kk * sinv
    ok = valid & (tval > tmin[:, None]) & (key < width * RP.CHUNK)
    tc = torch.where(ok, tval, RP.BIG)
    tb = tc.amin(dim=1, keepdim=True)
    first = torch.where(tc == tb, key, width * RP.CHUNK).amin(dim=1)
    return tb[:, 0] < miss, first // RP.CHUNK, first % RP.CHUNK


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scene", SCENES)
def test_stream_cull_keeps_winners(stream_args, scene, kind):
    """No row that wins in raycast_stream_plain is culled by its ray's warp
    part, and the cull drops rows (else it would prove nothing).  The
    clustered warps split exactly between their clusters."""
    args, keep, plain, _, _ = _case(stream_args, scene, kind)
    d, _, isect, _, lists, counts, tmin, miss = args
    hit, pos, row = _winners(d, isect, lists, counts, tmin, miss)
    np.testing.assert_array_equal(hit.numpy(), plain[:, 19].numpy() > 0.5)
    assert bool(hit.any())
    parts = RP.stream_parts(d, tmin, miss)
    lane = torch.arange(d.shape[0]) % RP.GROUP
    group = torch.arange(d.shape[0]) // RP.GROUP
    part = parts[group, 1, lane].long()
    assert bool(keep[group[hit], part[hit], pos[hit], row[hit]].all())
    tile = torch.arange(keep.shape[0]) // (RP.TILE // RP.GROUP)
    assert int(keep.any(dim=1).sum()) < int(counts[tile].sum()) * RP.CHUNK
    if kind == "clusters":
        even = torch.arange(parts.shape[0]) % 2 == 0
        np.testing.assert_array_equal(parts[:, 1].any(dim=1).numpy(),
                                      even.numpy())
        assert bool((parts[even, 1] == (torch.arange(RP.GROUP) >= 20)).all())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scene", SCENES)
def test_stream_walk_over_kept_rows_is_exact(stream_args, scene, kind):
    """Each warp part's cast over its kept rows alone, with the stop, gives
    raycast_stream_plain's G-buffer bit for bit; a warp counts only rows
    it kept, and at most those of its listed chunks."""
    _, keep, plain, walk, kept = _case(stream_args, scene, kind)
    assert torch.equal(walk, plain)
    assert bool((kept <= keep.flatten(1).sum(dim=1)).all())
    assert int(kept.sum()) > 0


@pytest.mark.parametrize("kind", ("mixed", "dead"))
@pytest.mark.parametrize("scene", SCENES)
def test_stream_dead_groups_miss(stream_args, scene, kind):
    """A warp whose rays all have tmin at or past their miss sentinel keeps
    no row and tests nothing, and its rows are raycast_stream_plain's miss
    rows (position the origin, every other column 0); "dead" is the
    frame's own re-cast input at the bench camera, where no candidate is
    masked."""
    args, keep, plain, walk, kept = _case(stream_args, scene, kind)
    d, o, _, _, _, _, tmin, miss = args
    dead = ~RP.stream_live(d, tmin, miss).reshape(-1, RP.GROUP).any(dim=1)
    assert bool(dead.any())
    assert not bool(keep[dead].any())
    assert not bool(kept[dead].any())
    rows = dead.repeat_interleave(RP.GROUP)
    assert torch.equal(walk[rows], plain[rows])
    np.testing.assert_array_equal(plain[rows, 0:3].numpy(),
                                  np.broadcast_to(o.numpy(),
                                                  (int(rows.sum()), 3)))
    np.testing.assert_array_equal(plain[rows, 3:].numpy(), 0.0)


def _random_rows(kind):
    """4,096 table rows (a3 b3 c3 k) with random directions: "unit" at
    sizes 0.1-10, "huge" at 1e17-1e30 (keep_row's squared norms overflow),
    "tiny" at 1e-30-1e-17 (they are subnormal or 0), "mixed" with each of
    a, b and c at its own size in 1e-30-1e30; k of either sign, or 0."""
    rng = np.random.default_rng(3)
    lo, hi = {"unit": (-1, 1), "huge": (17, 30), "tiny": (-30, -17),
              "mixed": (-30, 30)}[kind]
    abc = rng.normal(size=(4096, 3, 3)) * 10.0 ** rng.uniform(
        lo, hi, (4096, 3, 1))
    rows = np.zeros((4096, RP.NISECT), np.float32)
    rows[:, :9] = abc.reshape(4096, 9)
    rows[:, 9] = rng.choice([-1.0, 0.0, 1.0], 4096, p=[0.45, 0.1, 0.45])
    return torch.as_tensor(rows)


@pytest.mark.parametrize("kind", SCENES + ("unit", "huge", "tiny", "mixed"))
def test_may_keep_rows_keeps_every_culled_row(stream_args, kind):
    """may_keep_rows (csrc/raycast_common.cuh may_keep_row, which the
    streamed kernel asks before keep_row) keeps every row cull_rows keeps:
    on each scene's table against the fixture's warp cones, and on random
    rows of every size against random cones (sines 0-0.5), where rows whose
    norms overflow or underflow are left to cull_rows.  On the scenes it
    also drops rows, else it would save nothing."""
    if kind in SCENES:
        d, _, isect, _, _, _, _ = stream_args[kind]
        axis, sin_a, wide = RP.tile_cones(d, RP.GROUP)
        rows = isect
    else:
        rows = _random_rows(kind)
        rng = np.random.default_rng(4)
        a = rng.normal(size=(64, 3))
        axis = torch.as_tensor(
            (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32))
        sin_a = torch.as_tensor(rng.uniform(0.0, 0.5, 64).astype(np.float32))
        sin_a[:4] = torch.tensor([0.0, 1e-30, 1e-7, 1e-3])
        wide = torch.zeros(64, dtype=torch.bool)
    cone = (axis[:, None], sin_a[:, None], wide[:, None], rows[None])
    keep, may = RP.cull_rows(*cone), RP.may_keep_rows(*cone)
    assert bool(keep.any())
    assert not bool((keep & ~may).any())
    if kind in SCENES:
        assert int(may.sum()) < int((rows[:, 9] != 0).sum()) * keep.shape[0]
