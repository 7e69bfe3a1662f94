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
against the JAX ones."""

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
