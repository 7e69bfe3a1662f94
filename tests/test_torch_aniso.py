"""The port's anisotropic mips (vct_tpu_torch/core/aniso.py), and the
cone march, the dense march and the voxel build on anisotropic stacks,
against the JAX package's on the same numpy inputs, on the CPU.

Bounds, with what these fixtures measured on the CPU:
  * the pyramid, the blends and sample_aniso_level: atol 1e-6 (the same
    operations in the same order; measured 1.9e-9 at most);
  * the traced weights: equal to the bit; the static ones are numpy;
  * cone_march and its gradient on an anisotropic stack: atol 1e-5, as
    test_torch_oracle holds the isotropic march;
  * directional_march_multi: test_torch_host's dense tolerance, atol
    1e-6, in float32 and in bfloat16 (both round each axis of the packed
    level to bfloat16 and blend the six directions in float32 after it);
    the dense march against the per-point march at voxel centers at
    tests/test_aniso.py's bounds, rtol 1e-4 and atol 1e-5;
  * preset("aniso128") at 32^3, 24x24 through render_rays:
    test_torch_oracle.hold_image's bounds, mean < 1e-4 and p99 < 1e-3
    (measured mean 1.8e-8, max 3.3e-7);
  * an anisotropic field config at 16^3: its light volume and both
    fields atol 1e-5.
The JAX references run under jax.jit except the pyramid and the weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.config import GridConfig as JGridConfig
from vct_tpu.config import preset as jpreset
from vct_tpu.core import aniso as JA
from vct_tpu.core import camera as jcam
from vct_tpu.core import dense as JD
from vct_tpu.core import march as JM
from vct_tpu.render import renderer as JR
from vct_tpu.scene.cornell import cornell_box as jcornell_box
from vct_tpu_torch import interop
from vct_tpu_torch.config import GridConfig, preset
from vct_tpu_torch.core import aniso as A
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.core import dense as D
from vct_tpu_torch.core import march as M
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.scene.cornell import cornell_box

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

CPU = torch.device("cpu")
WS = 150.0


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def random_grid(dim=16, seed=0):
    """tests/test_aniso.py's random_mips input."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 0.5, size=(dim, dim, dim, 4)).astype(np.float32)


def both_mips(dim=16, seed=0):
    g = random_grid(dim, seed)
    return (JA.build_aniso_mips(jnp.asarray(g)),
            A.build_aniso_mips(t(g)))


def unit_dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d = np.concatenate([d, np.eye(3), -np.eye(3), [[0.0, 0.6, -0.8]]])
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# the pyramid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_levels", [None, 3])
def test_build_aniso_mips_matches(num_levels):
    g = random_grid(16, 1)
    a = A.build_aniso_mips(t(g), num_levels)
    b = JA.build_aniso_mips(jnp.asarray(g), num_levels)
    assert [tuple(x.shape) for x in a] == [x.shape for x in b]
    assert a[1].shape == (8, 8, 8, 6, 4)
    for x, y in zip(a, b):
        close(x, y)
    assert A.is_aniso_stack(a) and not A.is_aniso_stack(a[:1])
    assert A.is_aniso_level(a[1]) and not A.is_aniso_level(a[0])


def test_thin_wall_and_occlusion_order():
    """tests/test_aniso.py's semantics on the port: a 1-voxel wall stays
    opaque face-on at level 1 (0.5 edge-on); a red wall in front of a
    green one keeps red along +z and green along -z."""
    g = np.zeros((16, 16, 16, 4), np.float32)
    g[:, :, 6] = 1.0
    lvl1 = A.build_aniso_mips(t(g))[1].numpy()
    close(lvl1[:, :, 3, 4, 3], 1.0)
    close(lvl1[:, :, 3, 5, 3], 1.0)
    close(lvl1[:, :, 3, 0, 3], 0.5)
    g = np.zeros((8, 8, 8, 4), np.float32)
    g[:, :, 2] = [1.0, 0.0, 0.0, 1.0]
    g[:, :, 3] = [0.0, 1.0, 0.0, 1.0]
    lvl1 = A.build_aniso_mips(t(g))[1].numpy()[:, :, 1]
    close(lvl1[..., 4, :3], np.broadcast_to([1.0, 0, 0], (4, 4, 3)))
    close(lvl1[..., 5, :3], np.broadcast_to([0, 1.0, 0], (4, 4, 3)))


# ---------------------------------------------------------------------------
# weights and sampling
# ---------------------------------------------------------------------------

def test_weights_match():
    d = unit_dirs(64, 2)
    w = A.aniso_weights(t(d)).numpy()
    np.testing.assert_array_equal(w, np.asarray(JA.aniso_weights(
        jnp.asarray(d))))
    close(w.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(A.ANISO_DIRS, JA.ANISO_DIRS)
    for x in d:
        np.testing.assert_array_equal(A.aniso_weights_static(x),
                                      JA.aniso_weights_static(x))


def test_blend_level_static_matches():
    jm, pm = both_mips(16, 3)
    for x in unit_dirs(4, 3):
        w6 = A.aniso_weights_static(x)
        for lvl in (1, 2):
            close(A.blend_level_static(pm[lvl], w6),
                  JA.blend_level_static(jm[lvl], w6))


def test_sample_aniso_level_matches():
    jm, pm = both_mips(16, 4)
    rng = np.random.default_rng(4)
    uvw = rng.uniform(-0.1, 1.1, (300, 3)).astype(np.float32)
    d = unit_dirs(300 - 7, 5)
    for lvl in (1, 2, 3):
        a = A.sample_aniso_level(pm[lvl], t(uvw), t(d))
        b = JA.sample_aniso_level(jm[lvl], jnp.asarray(uvw), jnp.asarray(d))
        close(a, b)


# ---------------------------------------------------------------------------
# the cone march
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tan_half", [0.577, 0.07])
def test_cone_march_matches(tan_half):
    jm, pm = both_mips(16, 6)
    sched = M.march_schedule(tan_half, WS / 16, 75.0)
    rng = np.random.default_rng(7)
    starts = rng.uniform(-40, 40, (40, 3)).astype(np.float32)
    d = unit_dirs(33, 8)
    a = M.cone_march(pm, t(starts), t(d), sched, WS)
    b = jax.jit(JM.cone_march, static_argnums=(3, 4))(
        jm, jnp.asarray(starts), jnp.asarray(d),
        JM.march_schedule(tan_half, WS / 16, 75.0), WS)
    for x, y in zip(a, b):
        close(x, y, atol=1e-5)
    assert float(a[2].max()) > 0


def test_march_gradient_matches():
    """tests/test_aniso.py's test_march_runs_and_differentiates: the
    gradient of the summed color with respect to level 0."""
    jm, pm = both_mips(16, 3)
    sched = M.march_schedule(0.577, WS / 16, 75.0)
    start = np.array([[0.0, 0.0, -40.0], [10.0, 5.0, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]], np.float32)
    jsched = JM.march_schedule(0.577, WS / 16, 75.0)

    def jloss(lvl0):
        c, _, _ = JM.cone_march((lvl0,) + tuple(jm[1:]), jnp.asarray(start),
                                jnp.asarray(d), jsched, WS)
        return jnp.sum(c)

    lvl0 = pm[0].clone().requires_grad_()
    c, _, _ = M.cone_march((lvl0,) + pm[1:], t(start), t(d), sched, WS)
    (g,) = torch.autograd.grad(c.sum(), lvl0)
    jg = np.asarray(jax.jit(jax.grad(jloss))(jm[0]))
    close(g, jg, atol=1e-5)
    assert float(g.abs().max()) > 0


# ---------------------------------------------------------------------------
# the dense march
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", [None, "bfloat16"])
@pytest.mark.parametrize("transmittance", [False, True])
def test_directional_march_matches(compute, transmittance):
    jm, pm = both_mips(16, 9)
    sched = JM.march_schedule(0.3, WS / 16, 75.0,
                              step_factor=2.0 if compute else 1.0)
    basis = JD.direction_basis(6)
    basis = np.concatenate([basis, unit_dirs(2, 10)])
    kw = dict(field_dim=8, opacity_gain=4.0 if transmittance else 1.0,
              transmittance_only=transmittance)
    b = np.asarray(JD.directional_march_multi(
        jm, basis, sched, WS, compute_dtype=jnp.bfloat16 if compute else None,
        **kw))
    b = np.moveaxis(b, 0, -2).reshape(8, 8, 8, -1)
    a = D.directional_march_multi(
        pm, basis, sched, WS,
        compute_dtype=torch.bfloat16 if compute else None, **kw).numpy()
    close(a, b)


def test_dense_matches_percone():
    """tests/test_aniso.py's TestDenseAniso on the port: the dense march
    equals the per-point march at voxel centers."""
    _, pm = both_mips(16, 5)
    sched = M.march_schedule(0.577, WS / 16, 75.0)
    dirv = np.array([0.6, -0.64, 0.48])
    dirv /= np.linalg.norm(dirv)
    field = D.directional_march(pm, dirv, sched, WS)
    idx = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1)
    centers = t(((idx + 0.5) / 16 * WS - WS / 2).astype(np.float32))
    d = torch.as_tensor(dirv, dtype=torch.float32).expand(centers.shape)
    color, occ, _ = M.cone_march(pm, centers, d, sched, WS)
    close(field[..., :3], color, atol=1e-5, rtol=1e-4)
    close(field[..., 3], occ, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# preset("aniso128") through the build and render_rays
# ---------------------------------------------------------------------------

CAMERA = dict(position=(0.0, 0.0, 140.0))
SIZE = 24


def cut(make_preset, grid_cls, dim, **cones):
    cfg = make_preset("aniso128")
    return dataclasses.replace(
        cfg, grid=grid_cls(dim=dim, world_size=WS, anisotropic=True),
        cones=dataclasses.replace(cfg.cones, **cones),
        render=dataclasses.replace(cfg.render, width=SIZE, height=SIZE))


def carried_samples(samples):
    return interop.samples(jax.tree_util.tree_map(np.asarray, samples),
                           device=CPU)


@pytest.fixture(scope="module")
def aniso128():
    jc, pc = cut(jpreset, JGridConfig, 32), cut(preset, GridConfig, 32)
    ds, mats, samples = JR.prepare_scene(jc, jcornell_box(size=100.0))
    jv = JR.build_voxel_state_staged(jc, samples, mats)
    origins, dirs = jcam.primary_rays(jcam.Camera(**CAMERA), SIZE, SIZE)
    img = np.asarray(JR.render_rays(
        jc, ds, jv, mats, origins, dirs,
        jnp.asarray(CAMERA["position"], jnp.float32), chunk_size=1024))
    pds, pmats, _ = R.prepare_scene(pc, cornell_box(size=100.0), device=CPU)
    pv = R.build_voxel_state(pc, carried_samples(samples), pmats)
    po, pd = CAM.primary_rays(CAM.Camera(**CAMERA), SIZE, SIZE, device=CPU)
    return jc, pc, jv, img, dict(ds=pds, mats=pmats, voxels=pv, origins=po,
                                 dirs=pd, cam=torch.tensor(
                                     CAMERA["position"]))


def test_aniso128_build_matches(aniso128):
    _, _, jv, _, p = aniso128
    pv = p["voxels"]
    assert pv.radiance_mips[1].shape == (16, 16, 16, 6, 4)
    assert all(m.dim() == 4 for m in pv.unlit_mips)
    for a, b in zip(pv.radiance_mips + pv.unlit_mips,
                    jv.radiance_mips + jv.unlit_mips):
        close(a, b, atol=1e-5)
    close(pv.light_volume, jv.light_volume, atol=1e-5)


def test_aniso128_render_rays_matches(aniso128):
    _, pc, _, img, p = aniso128
    assert not R.use_fast_path(pc)
    out = R.render_camera_pass(pc, p["ds"], p["voxels"], p["mats"],
                               p["origins"], p["dirs"], p["cam"]).numpy()
    err = np.abs(out - img)
    assert out.shape == img.shape and np.isfinite(out).all()
    assert err.mean() < 1e-4, err.mean()
    assert np.percentile(err, 99) < 1e-3, np.percentile(err, 99)
    assert float(out.mean()) > 0.01


def test_aniso_field_config_build_matches():
    """An anisotropic config with field diffuse and field specular takes
    the fast path, as in the JAX package; its light volume and fields,
    which are all its frame tables read, against the JAX build's."""
    kw = dict(diffuse_mode="field", specular_mode="field")
    jc, pc = cut(jpreset, JGridConfig, 16, **kw), cut(preset, GridConfig, 16,
                                                      **kw)
    assert R.use_fast_path(pc)
    _, mats, samples = JR.prepare_scene(jc, jcornell_box(size=100.0))
    jv = JR.build_voxel_state_staged(jc, samples, mats)
    _, pmats, _ = R.prepare_scene(pc, cornell_box(size=100.0), device=CPU)
    pv = R.build_voxel_state(pc, carried_samples(samples), pmats)
    assert A.is_aniso_stack(pv.radiance_mips)
    for name in ("light_volume", "diffuse_field", "specular_field"):
        close(getattr(pv, name), getattr(jv, name), atol=1e-5)
    assert float(pv.diffuse_field.abs().max()) > 0
