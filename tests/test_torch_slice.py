"""The port's slice end to end against the JAX package, at the
tests/test_fast.py fixture: preset sponza256 cut to a 32^3 grid, float32
dense-march compute, 64x48 pixels, the Cornell box, camera (3, 2, 40).

Bounds, with what this fixture measured on the CPU:
  * VoxelState arrays vs build_voxel_state_staged: atol 1e-5 (measured
    max 6e-7: the same sums in another order);
  * render_frame on the converted JAX state vs F.render_frame(interpret=
    True): mean < 2e-4 and p99 < 2e-3 (measured mean 3.2e-5, p99 2.1e-4,
    max 3.4e-4; the TPU tap kernel rounds its trilinear weights to bf16,
    the port's taps do not);
  * the port's own build + frame vs R.render_rays, the per-cone oracle
    path, at tests/test_fast.py's bounds mean < 0.01, p99 < 0.06
    (measured mean 4.3e-4, p99 7.9e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.config import preset as jpreset
from vct_tpu.core import camera as jcam
from vct_tpu.render import fast as JF
from vct_tpu.render import renderer as JR
from vct_tpu.scene.cornell import cornell_box as jcornell_box
from vct_tpu_torch import interop
from vct_tpu_torch.config import preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.ops import binrast as BR
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.scene.cornell import cornell_box

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4


CPU = torch.device("cpu")


def _cfg(dim, w, h, spec=True, make_preset=preset):
    cfg = make_preset("sponza256")
    return dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, dim=dim, compute="float32"),
        cones=dataclasses.replace(cfg.cones, trace_specular=spec,
                                  field_dim=dim),
        render=dataclasses.replace(cfg.render, width=w, height=h),
    )


CAMERA = dict(position=(3.0, 2.0, 40.0))


@pytest.fixture(scope="module")
def jax_run():
    cfg = _cfg(32, 64, 48, make_preset=jpreset)
    ds, mats, samples = JR.prepare_scene(cfg, jcornell_box(size=100.0))
    voxels = JR.build_voxel_state_staged(cfg, samples, mats)
    origins, dirs = jcam.primary_rays(jcam.Camera(**CAMERA), 64, 48)
    cam = jnp.asarray(CAMERA["position"], jnp.float32)
    tables = JF.build_frame_tables(cfg, voxels, mats)
    fast = np.asarray(JF.render_frame(cfg, ds, tables, mats, origins, dirs,
                                      cam, interpret=True))
    ref = np.asarray(JR.render_rays(cfg, ds, voxels, mats, origins, dirs,
                                    cam, chunk_size=1024))
    host = jax.tree_util.tree_map(np.asarray, (voxels, tables, mats))
    return _cfg(32, 64, 48), None, host, fast, ref


@pytest.fixture(scope="module")
def port_run(jax_run):
    cfg = jax_run[0]
    ds, mats, samples = R.prepare_scene(cfg, cornell_box(size=100.0),
                                        device=CPU)
    voxels = R.build_voxel_state(cfg, samples, mats)
    origins, dirs = CAM.primary_rays(CAM.Camera(**CAMERA), 64, 48,
                                     device=CPU)
    cam = torch.tensor(CAMERA["position"], dtype=torch.float32)
    return ds, mats, samples, voxels, origins, dirs, cam


def _err(a, b):
    e = np.abs(np.asarray(a) - np.asarray(b))
    return e.mean(), np.percentile(e, 99)


@pytest.mark.parametrize("name", ["radiance_mips", "unlit_mips",
                                  "light_volume", "diffuse_field",
                                  "specular_field"])
def test_voxel_state_matches(jax_run, port_run, name):
    jv = jax_run[2][0]
    pv = port_run[3]
    a, b = getattr(pv, name), getattr(jv, name)
    if isinstance(b, tuple):
        assert len(a) == len(b)
    else:
        a, b = (a,), (b,)
    for x, y in zip(a, b):
        assert tuple(x.shape) == y.shape
        np.testing.assert_allclose(x.numpy(), y, atol=1e-5, rtol=0)


def test_frame_on_converted_state_matches_jax_fast_path(jax_run, port_run):
    cfg, _, (jv, _, _), fast, _ = jax_run
    ds, mats, _, _, origins, dirs, cam = port_run
    voxels = interop.voxel_state(jv, device=CPU)
    out = F.render_frame(cfg, ds, F.build_frame_tables(cfg, voxels, mats),
                         mats, origins, dirs, cam).numpy()
    assert out.shape == fast.shape and np.isfinite(out).all()
    mean, p99 = _err(out, fast)
    assert mean < 2e-4, mean
    assert p99 < 2e-3, p99


def test_interop_tables_match_own_tables(jax_run, port_run):
    """The JAX package's packed tables, un-padded by interop, against the
    port's own tables from the converted state: the same float32 mips
    rounded to bf16, so within one bf16 rounding step (2^-8 relative)."""
    cfg, _, (jv, jt, _), _, _ = jax_run
    mats = port_run[1]
    own = F.build_frame_tables(cfg, interop.voxel_state(jv, device=CPU),
                               mats)
    conv = interop.frame_tables(jt, cfield=8 * cfg.cones.field_basis,
                                device=CPU)
    for a, b in zip(own.light_mips + own.field_mips,
                    conv.light_mips + conv.field_mips):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2 ** -8, atol=1e-6)
    out = F.render_frame(cfg, *port_run[:1], conv, mats, *port_run[4:])
    assert np.isfinite(out.numpy()).all()


def test_own_build_matches_render_rays(jax_run, port_run):
    cfg, _, _, _, ref = jax_run
    ds, mats, _, voxels, origins, dirs, cam = port_run
    out = R.render_camera_pass(cfg, ds, voxels, mats, origins, dirs,
                               cam).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    mean, p99 = _err(out, ref)
    assert mean < 0.01, mean
    assert p99 < 0.06, p99


def test_build_is_deterministic(jax_run, port_run):
    cfg = jax_run[0]
    _, mats, samples, voxels = port_run[:4]
    again = R.build_voxel_state(cfg, samples, mats)
    for name in ("radiance_mips", "unlit_mips"):
        assert torch.equal(getattr(again, name)[0],
                           getattr(voxels, name)[0])
    assert torch.equal(again.diffuse_field, voxels.diffuse_field)


def test_no_specular_config(jax_run, port_run):
    """trace_specular=False: diffuse-only fields, zero specular taps."""
    cfg = _cfg(32, 64, 48, spec=False)
    ds, mats, samples, _, origins, dirs, cam = port_run
    voxels = R.build_voxel_state(cfg, samples, mats)
    assert voxels.specular_field is None
    tables = F.build_frame_tables(cfg, voxels, mats)
    assert tables.field_mips[0].shape[-1] == 4 * cfg.cones.field_basis
    out = F.render_frame(cfg, ds, tables, mats, origins, dirs, cam).numpy()
    with_spec = R.render_camera_pass(jax_run[0], ds, port_run[3], mats,
                                     origins, dirs, cam).numpy()
    assert np.isfinite(out).all()
    assert np.abs(out - with_spec).max() > 0        # specular was dropped


def test_off_slice_inputs_raise(jax_run, port_run, monkeypatch):
    cfg = jax_run[0]
    ds, mats, _, voxels, origins, dirs, cam = port_run
    tables = F.build_frame_tables(cfg, voxels, mats)
    # above MAX_TRIANGLES the frame takes the binned raycast: every
    # triangle 52 times over renders the box's image
    big = dataclasses.replace(
        ds, **{f.name: getattr(ds, f.name).repeat_interleave(52, dim=0)
               for f in dataclasses.fields(ds)})
    assert big.v0.shape[0] > RP.MAX_TRIANGLES
    binned = []
    walk = BR.raycast_binned
    monkeypatch.setattr(BR, "raycast_binned",
                        lambda *a: binned.append(1) or walk(*a))
    img = F.render_frame(cfg, big, tables, mats, origins, dirs, cam).numpy()
    assert binned == [1]
    ref = F.render_frame(cfg, ds, tables, mats, origins, dirs, cam).numpy()
    err = np.abs(img - ref)
    assert err.mean() < 1e-3 and (err.max(axis=-1) > 0.02).mean() < 0.01
    # a textured material table against frame tables built without its
    # atlas pages (textured scenes themselves render: test_torch_atrium.py)
    textured = dataclasses.replace(mats, atlas=object())
    with pytest.raises(ValueError, match="atlas"):
        F.render_frame(cfg, ds, tables, textured, origins, dirs, cam)
    # percone specular renders (the exact march replaces the specular
    # field's taps) and differs from the field frame only in the specular
    # term: with both specular terms off the two frames are equal
    percone = dataclasses.replace(cfg, cones=dataclasses.replace(
        cfg.cones, specular_mode="percone"))
    with pytest.raises(ValueError, match="percone"):
        F.render_frame(percone, ds, tables, mats, origins, dirs, cam)
    p_tables = F.build_frame_tables(percone, voxels, mats)
    assert p_tables.field_mips[0].shape[-1] == 4 * cfg.cones.field_basis
    img_p = F.render_frame(percone, ds, p_tables, mats, origins, dirs, cam)
    assert bool(torch.isfinite(img_p).all())
    assert np.abs(img_p.numpy() - ref).max() > 1e-3
    no_spec = dict(show_specular=False, show_indirect_specular=False)
    frames = []
    for c, t in ((cfg, tables), (percone, p_tables)):
        c = dataclasses.replace(c, render=dataclasses.replace(c.render,
                                                               **no_spec))
        frames.append(F.render_frame(c, ds, t, mats, origins, dirs, cam))
    assert torch.equal(frames[0], frames[1])
    # percone diffuse is off the fast path: the camera pass is the per-cone
    # oracle, render_rays
    oracle = dataclasses.replace(cfg, cones=dataclasses.replace(
        cfg.cones, diffuse_mode="percone"))
    assert not R.use_fast_path(oracle)
    img_o = R.render_camera_pass(oracle, ds, voxels, mats, origins, dirs, cam,
                                 chunk_size=4096)
    assert torch.equal(img_o, R.render_rays(oracle, ds, voxels, mats, origins,
                                            dirs, cam, chunk_size=4096))
    assert img_o.shape == (48, 64, 3) and np.abs(img_o.numpy() - ref).max() > 0
