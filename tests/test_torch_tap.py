"""Kernel 4 (taps): the port's plain tap against the JAX package's oracle
tap_tiles_ref on the same bf16 tables (carried over by interop), and
against its Pallas kernel in interpret mode.

Against the oracle: 1e-5 (same math on the same bf16 values in f32).
Against the Pallas kernel: its own bounds from tests/test_tap_pallas.py,
5e-3 for the shadow and 2e-2 for rgba (the TPU kernel rounds trilinear
weights to bf16 for its matmuls)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.config import preset
from vct_tpu.core import cones as jcones
from vct_tpu.core import dense as jdense
from vct_tpu.core import grid as jgrid
from vct_tpu.ops import tap_pallas as JTP
from vct_tpu_torch import interop
from vct_tpu_torch.config import preset as port_preset
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.ops import prepass as PP
from vct_tpu_torch.ops import tap as TP

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

WS = 150.0
LDIM = 32
FDIM = 16
NB = 26
VOXEL = WS / LDIM
OFFSET = preset("sponza256").shadow.normal_offset
CAMPOS = np.array([5.0, -3.0, 190.0], np.float32)
CONES = (tuple(map(tuple, np.asarray(jcones.CONE_DIRECTIONS[:6], np.float32))),
         tuple(float(w) for w in jcones.CONE_WEIGHTS[:6]),
         tuple(map(tuple, jdense.direction_basis(NB))))


def _gbuf(ntiles, rng):
    """Tile-coherent G-buffer; tile 1 spans most of the grid (coarse
    levels), the rest cluster in a small ball (level 0)."""
    n = ntiles * TP.TILE
    centers = (rng.random((ntiles, 3)) * 0.5 + 0.25) * WS - WS / 2
    pos = np.repeat(centers, TP.TILE, axis=0) + rng.normal(size=(n, 3)) * 1.5
    pos[TP.TILE:2 * TP.TILE] = (rng.random((TP.TILE, 3)) - 0.5) * WS * 0.8
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tan = np.cross(nrm, [0.1, 0.9, 0.3])
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    g = np.zeros((n, 32), np.float32)
    g[:, 0:3], g[:, 3:6], g[:, 6:9] = pos, nrm, nrm
    g[:, 9:12], g[:, 12:15] = tan, np.cross(nrm, tan)
    g[:, 19] = 1.0
    bump = nrm + rng.normal(size=(n, 3)) * 0.2     # bump normal != normal
    return g, np.concatenate([bump, np.zeros((n, 1))], 1).astype(np.float32)


@pytest.fixture(scope="module", params=[2, 1], ids=["spec", "nospec"])
def setup(request):
    groups = request.param
    cfield = 4 * NB * groups
    rng = np.random.default_rng(0)
    light = jnp.asarray(rng.random((LDIM, LDIM, LDIM, 1), np.float32))
    jlight = JTP.pack_light_mips(
        [m[..., 0] for m in jgrid.build_mips(light, num_levels=2)])
    field = jnp.asarray(rng.random((FDIM, FDIM, FDIM, cfield), np.float32))
    jfield = JTP.pack_field_mips(jgrid.build_mips(field, num_levels=2))
    g, bumpn = _gbuf(4, rng)
    tables = interop.frame_tables(
        dataclasses.make_dataclass(
            "T", ["light_mips", "field_mips", "atlas_pages", "spec_mips"])(
            [np.asarray(m) for m in jlight], [np.asarray(m) for m in jfield],
            None, None),
        cfield, device="cpu")
    scal = PP.prepass_tiles(
        torch.as_tensor(g), light_dims=(LDIM, LDIM // 2),
        field_dims=(FDIM, FDIM // 2), voxel=VOXEL, world_size=WS,
        shadow_offset=OFFSET)
    assert scal[1, 0] > 0 and scal[0, 0] == 0     # both level kinds occur
    kw = dict(cfield=cfield, nb=NB, world_size=WS, voxel=VOXEL,
              shadow_offset=OFFSET, power_diffuse=8, power_specular=32,
              cones_static=CONES)
    out = TP.tap_tiles(torch.as_tensor(g), scal, torch.as_tensor(bumpn),
                       torch.as_tensor(CAMPOS), tables.light_mips,
                       tables.field_mips, **kw).numpy()
    jargs = (jnp.asarray(g), jnp.asarray(scal.numpy()), jnp.asarray(bumpn),
             jnp.asarray(CAMPOS), jlight, jfield)
    return out, jargs, kw, (light, field, tables)


def test_matches_tap_ref(setup):
    out, jargs, kw, _ = setup
    ref = np.asarray(JTP.tap_tiles_ref(*jargs, **kw))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_matches_pallas_interpret(setup):
    out, jargs, kw, _ = setup
    ker = np.asarray(JTP.tap_tiles(*jargs, interpret=True, **kw))
    np.testing.assert_allclose(out[:, 0], ker[:, 0], atol=5e-3, rtol=5e-3)
    np.testing.assert_allclose(out[:, 1:9], ker[:, 1:9], atol=2e-2,
                               rtol=2e-2)
    assert np.abs(out[:, 1:5]).max() > 0.1


def test_tables_layout(setup):
    """interop's un-padded JAX tables equal the port's own packing of the
    same float32 levels, level views sit back to back."""
    _, _, kw, (light, field, tables) = setup
    own_l = TP.pack_mips(
        [m[..., 0] for m in G.build_mips(torch.as_tensor(np.array(light)),
                                         num_levels=2)])
    own_f = TP.pack_mips(G.build_mips(
        torch.as_tensor(np.array(field)), num_levels=2))
    for a, b in zip(own_l + own_f, tables.light_mips + tables.field_mips):
        assert a.dtype == b.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    assert TP._chain(tables.field_mips, "field") == (FDIM, kw["cfield"])
    assert TP._chain(own_l, "light") == (LDIM, 1)


def test_output_layout(setup):
    out, _, kw, _ = setup
    assert out.shape == (4 * TP.TILE, TP.NOUT)
    np.testing.assert_array_equal(out[:, 9:], 0.0)
    if kw["cfield"] == 4 * NB:
        np.testing.assert_array_equal(out[:, 5:9], 0.0)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("name", ["cornell64", "cornell64_full", "aniso128",
                                  "sponza256", "sponza256_exact_specular",
                                  "inverse", "multihost512", "reference"])
def test_presets_fit_the_kernel(name):
    """csrc/tap.cu is built for basis sizes 6 and 26 and for the sharpening
    powers of KERNEL_POWERS as template constants (the wrapper refuses
    others): every preset of the port's config is one it runs."""
    cones = port_preset(name).cones
    assert (int(cones.basis_power_diffuse),
            int(cones.basis_power_specular)) == TP.KERNEL_POWERS
    assert cones.field_basis in (6, 26)
