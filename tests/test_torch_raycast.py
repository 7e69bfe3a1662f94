"""Kernel 2 (raycast + G-buffer): the port's plain version against the
JAX package's jnp oracle raycast_ref and its Pallas kernel (interpret
mode), on the same packed tables.  Hit and material ids exact; columns
1e-5 against the oracle, and against the Pallas kernel the bounds
tests/test_raycast_pallas.py holds that kernel to (t 1e-5, the
interpolated columns 1e-4: its one-hot attribute fetch rounds apart
from the oracle's).

Then the CUDA kernel's per-block cull in plain PyTorch
(`tile_cull_plain`): on frames in tile order, the subdivided atrium and
random blocks, no dropped (ray, row) pair passes the hit test, and
casting each block against its kept rows alone is bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.core import camera as jcam
from vct_tpu.ops import raycast_pallas as JRP
from vct_tpu.render import gbuffer as jgbuf
from vct_tpu.scene.atrium import atrium as jatrium
from vct_tpu.scene.cornell import cornell_box as jcornell_box
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import gbuffer as GB
from vct_tpu_torch.scene.atrium import atrium
from vct_tpu_torch.scene.cornell import cornell_box
from vct_tpu_torch.scene.mesh import subdivide_scene

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

SCENES = {
    "cornell": (lambda: cornell_box(size=100.0),
                lambda: jcornell_box(size=100.0),
                dict(position=(3.0, 2.0, 40.0)), 32, 16),
    "atrium": (atrium, jatrium,
               dict(position=(48.0, -10.0, 0.0), yaw=180.0), 64, 32),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def setup(request):
    make, jmake, cam, w, h = SCENES[request.param]
    scene = make()
    jds = jgbuf.DeviceScene.from_scene(jmake())
    _, d = jcam.primary_rays(jcam.Camera(**cam), w, h)
    d = np.array(d).reshape(-1, 3)
    o = np.asarray(cam["position"], np.float32)
    rng = np.random.default_rng(0)
    m = len(scene.materials)
    mats = (rng.random((m, 4), np.float32), rng.random((m, 3), np.float32),
            rng.random(m).astype(np.float32) * 40)
    isect, attrs, t = JRP.pack_tables(jds, jnp.asarray(o),
                                      *map(jnp.asarray, mats))
    return scene, d, o, mats, np.asarray(isect), np.asarray(attrs), t


def _port(d, o, isect, attrs, t):
    """Port raycast on the JAX tables, converted to the port's row layout."""
    return RP.raycast_gbuf24(torch.as_tensor(d), torch.as_tensor(o),
                             torch.as_tensor(isect.T[:t].copy()),
                             torch.as_tensor(attrs[:t].copy())).numpy()


def _check(out, ref, tol=1e-5):
    hit = ref[:, 19] > 0.5
    np.testing.assert_array_equal(out[:, 19], ref[:, 19])
    np.testing.assert_array_equal(out[hit, 17], ref[hit, 17])
    assert hit.any()
    np.testing.assert_allclose(out[:, 18], ref[:, 18], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


def test_matches_raycast_ref(setup):
    _, d, o, _, isect, attrs, t = setup
    ref = np.asarray(JRP.raycast_ref(jnp.asarray(d), jnp.asarray(o),
                                     jnp.asarray(isect), jnp.asarray(attrs)))
    _check(_port(d, o, isect, attrs, t), ref)


def test_matches_pallas_interpret(setup):
    _, d, o, _, isect, attrs, t = setup
    ref = np.asarray(JRP.raycast_gbuf24(jnp.asarray(d), jnp.asarray(o),
                                        jnp.asarray(isect),
                                        jnp.asarray(attrs), interpret=True))
    _check(_port(d, o, isect, attrs, t), ref, tol=1e-4)


def test_own_tables_match(setup):
    """The port's own pack_tables + raycast against the JAX pipeline.
    Cornell's tables are bit-equal; the atrium's differ by an ulp in some
    entries (tests/test_torch_host.py), which may flip a grazing hit: at
    most 0.5% of rays, and agreeing rays stay within 1e-4."""
    scene, d, o, mats, isect, attrs, t = setup
    ds = GB.DeviceScene.from_scene(scene, device="cpu")
    pi, pa = RP.pack_tables(ds, torch.as_tensor(o),
                            *(torch.as_tensor(m) for m in mats))
    out = RP.raycast_gbuf24(torch.as_tensor(d), torch.as_tensor(o),
                            pi, pa).numpy()
    ref = np.asarray(JRP.raycast_ref(jnp.asarray(d), jnp.asarray(o),
                                     jnp.asarray(isect), jnp.asarray(attrs)))
    same = (out[:, 19] == ref[:, 19]) & (out[:, 17] == ref[:, 17])
    assert same.mean() >= 0.995
    np.testing.assert_allclose(out[same], ref[same], atol=1e-4, rtol=1e-4)
    if scene.num_triangles == 40:
        _check(out, ref)


def test_miss_rows():
    """Rays that hit nothing: position = origin, everything else zero."""
    ds = GB.DeviceScene.from_scene(cornell_box(size=100.0), device="cpu")
    o = torch.tensor([0.0, 0.0, 500.0])          # outside, looking away
    d = torch.tensor([[0.0, 0.0, 1.0], [0.6, 0.0, 0.8]])
    out = RP.raycast_gbuf24(d, o, *RP.pack_tables(ds, o)).numpy()
    np.testing.assert_array_equal(out[:, 0:3], np.tile(o.numpy(), (2, 1)))
    np.testing.assert_array_equal(out[:, 3:], 0.0)


def test_chunking_is_exact(setup):
    _, d, o, _, isect, attrs, t = setup
    args = (torch.as_tensor(d), torch.as_tensor(o),
            torch.as_tensor(isect.T[:t].copy()),
            torch.as_tensor(attrs[:t].copy()))
    np.testing.assert_array_equal(RP.raycast_plain(*args, chunk=100).numpy(),
                                  RP.raycast_plain(*args).numpy())


# ---------------------------------------------------------------------------
# the whole-table kernel's per-block cull (tile_cull_plain)
# ---------------------------------------------------------------------------

def _frame_rays(scene, cam, w, h):
    """Primary rays in tile order (256-ray blocks are 16x16 tiles), as
    render_frame hands them to the raycast, with the port's own tables."""
    o, d = CAM.primary_rays(CAM.Camera(**cam), w, h, device="cpu")
    hp, wp = -(-h // F.TSY) * F.TSY, -(-w // 64) * 64
    d = F._tile_order(F._pad_edge(d, hp, wp), hp, wp).contiguous()
    origin = o.reshape(-1, 3)[0].contiguous()
    ds = GB.DeviceScene.from_scene(scene, device="cpu")
    return d, origin, ds


def _random_rays(kind, seed):
    """numpy-seeded 256-ray blocks from a point inside the atrium, a ragged
    last block, lengths 0.5-2 (the cull normalises): `coherent` blocks
    spread ~2 degrees about a random axis; `wide` blocks are uniform over
    the sphere (no bounding cone) or spread ~40 degrees."""
    rng = np.random.default_rng(seed)
    nt = 24
    axis = rng.normal(size=(nt, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    spread = np.full((nt, 1), 0.03) if kind == "coherent" else \
        np.where(np.arange(nt)[:, None] % 2 == 0, 1e3, 0.25)
    d = np.repeat(axis, RP.TILE, 0) + rng.normal(size=(nt * RP.TILE, 3)) \
        * np.repeat(spread, RP.TILE, 0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d *= rng.uniform(0.5, 2.0, size=(nt * RP.TILE, 1))
    d = torch.as_tensor(d[:nt * RP.TILE - 77].astype(np.float32))
    ds = GB.DeviceScene.from_scene(atrium(), device="cpu")
    return d, torch.tensor([10.0, 5.0, -3.0]), ds


CULL_CASES = {
    "cornell": lambda: _frame_rays(cornell_box(size=100.0),
                                   SCENES["cornell"][2], 96, 64),
    "atrium": lambda: _frame_rays(atrium(), SCENES["atrium"][2], 96, 64),
    "atrium_x1": lambda: _frame_rays(subdivide_scene(atrium(), 1),
                                     SCENES["atrium"][2], 96, 64),
    "random_coherent": lambda: _random_rays("coherent", 3),
    "random_wide": lambda: _random_rays("wide", 4),
}


@pytest.fixture(scope="module", params=sorted(CULL_CASES))
def cull_case(request):
    d, origin, ds = CULL_CASES[request.param]()
    rng = np.random.default_rng(5)
    m = int(ds.material.max()) + 1
    isect, attrs = RP.pack_tables(
        ds, origin, torch.as_tensor(rng.random((m, 4), np.float32)),
        torch.as_tensor(rng.random((m, 3), np.float32)),
        torch.as_tensor(rng.random(m).astype(np.float32) * 40))
    return request.param, d, origin, isect, attrs, RP.tile_cull_plain(d, isect)


def test_cull_drops_no_hit(cull_case):
    """Every (ray, row) pair the block's cull drops fails raycast_plain's
    hit test; wide blocks keep every row, and coherent ones drop most."""
    name, d, _, isect, _, keep = cull_case
    assert keep.shape == (-(-d.shape[0] // RP.TILE), isect.shape[0])
    step = 4 * RP.TILE
    for s in range(0, d.shape[0], step):
        valid = RP.hit_tests(d[s:s + step], isect)[0]
        kept = keep[s // RP.TILE:(s + step) // RP.TILE].repeat_interleave(
            RP.TILE, dim=0)[:valid.shape[0]]
        assert not (valid & ~kept).any()
    wide = RP.tile_cones(d)[2]
    assert keep[wide].all()
    if name == "random_wide":
        assert wide.any() and not wide.all()
    else:
        assert not wide.any()
        assert keep.float().mean() < 0.3


def test_culled_cast_is_exact(cull_case):
    """Each block cast against only the rows it keeps (plus one all-zero
    row, which never hits, so that no table is empty) gives raycast_plain's
    G-buffer on the whole table bit for bit: dropped rows never win and
    the kept ones stay in order."""
    _, d, origin, isect, attrs, keep = cull_case
    whole = RP.raycast_plain(d, origin, isect, attrs).numpy()
    parts = []
    for i in range(keep.shape[0]):
        rows = torch.nonzero(keep[i])[:, 0]
        parts.append(RP.raycast_plain(
            d[i * RP.TILE:(i + 1) * RP.TILE], origin,
            torch.cat([isect[rows], isect.new_zeros((1, RP.NISECT))]),
            torch.cat([attrs[rows], attrs.new_zeros((1, RP.NATTR))])))
    np.testing.assert_array_equal(torch.cat(parts).numpy(), whole)
    assert whole[:, 19].any()
