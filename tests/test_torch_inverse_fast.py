"""Inverse rendering through the port's fast camera pass (render/fast.py:
the raycast, prepass and tap kernels' routes, the mip's backward, on the
CPU through their plain versions), against the JAX package's.

tests/test_inverse_fast.py's setup cut to 32^3 and 32x32: preset inverse
with field diffuse and specular cones, volume shadows, a 6-direction
basis, 2 diffuse cones and field_dim 32; the Cornell box from (3, 2, 140);
the target the camera_pass="xla" render of the true scene, times 0.7 plus
0.05, so that the gradients are not zero.

  * "radiance" and "light": loss and gradient against jax.value_and_grad
    of the JAX package's loss under camera_pass="fast" (its kernels in
    interpret mode): loss within 1e-3 relative, gradient cosine >= 0.999
    and norm within 2% (the JAX forward runs interpret-mode kernels,
    whose float rounding the port's plain versions do not repeat);
  * "albedo": the JAX package cannot differentiate it under "fast"
    (jax.grad raises "Linearization failed": the albedo rides the raycast
    rows into the prepass, which has no VJP), so the port's fast gradient
    is held to its own camera_pass="xla" gradient at test_inverse_fast.py's
    bounds: cosine > 0.9, norm ratio in (0.85, 1.15);
  * a few Adam steps under "fast" from a black radiance grid descend.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.config import preset as jpreset
from vct_tpu.core import camera as jcam
from vct_tpu.diff import inverse as JI
from vct_tpu.render import renderer as JR
from vct_tpu.scene.cornell import cornell_box as jcornell_box
from vct_tpu_torch import interop
from vct_tpu_torch.config import preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.diff import inverse as I
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.scene.cornell import cornell_box

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

CPU = torch.device("cpu")
DIM = 32
SIZE = 32
CAMERA = dict(position=(3.0, 2.0, 140.0))
LOSS_REL = 1e-3             # fast loss against JAX's interpret-mode one
COS_MIN = 0.999             # gradient direction against JAX's
NORM_TOL = 0.02             # gradient norm against JAX's


def fast_cfg(make, dim=DIM, size=SIZE):
    """tests/test_inverse_fast.py's _cfg at dim^3 and size x size."""
    cfg = make("inverse")
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=dim, world_size=150.0),
        cones=dataclasses.replace(
            cfg.cones, diffuse_mode="field", specular_mode="field",
            field_dim=dim, field_basis=6, num_diffuse_cones=2),
        shadow=dataclasses.replace(cfg.shadow, mode="volume"),
        render=dataclasses.replace(cfg.render, width=size, height=size))


def setups(jcfg, cfg, jscene, scene, camera):
    """Both packages' scene state, and the shared target (JAX's "xla"
    render of the true scene, times 0.7 plus 0.05)."""
    jds, jmats, jsamples = JR.prepare_scene(jcfg, jscene)
    w, h = jcfg.render.width, jcfg.render.height
    jo, jd = jcam.primary_rays(jcam.Camera(**camera), w, h)
    jc = jnp.asarray(camera["position"], jnp.float32)
    jvox = JR.build_voxel_state(jcfg, jsamples, jmats)
    target = np.asarray(JR.render_rays(jcfg, jds, jvox, jmats, jo, jd,
                                       jc)) * 0.7 + 0.05
    ds, mats, samples = R.prepare_scene(cfg, scene, device=CPU)
    o, d = CAM.primary_rays(CAM.Camera(**camera), w, h, device=CPU)
    cam = torch.tensor(camera["position"])
    return dict(jax=(jcfg, jds, jmats, jsamples, jo, jd, jc, jvox),
                port=(cfg, ds, mats, samples, o, d, cam), target=target)


def jax_grad_params(s, target):
    jcfg, _, jmats, _, _, _, _, jvox = s["jax"]
    return JI.init_params(JI.InverseConfig(optimize=(target,)), jcfg, jmats,
                          jvox)


def jax_grad(s, target, camera_pass):
    jcfg, jds, jmats, jsamples, jo, jd, jc, jvox = s["jax"]
    inv = JI.InverseConfig(optimize=(target,), camera_pass=camera_pass)
    params = JI.init_params(inv, jcfg, jmats, jvox)
    loss, g = jax.value_and_grad(JI.make_loss_fn(inv, jcfg, jds, jc))(
        params, jsamples, jmats, jo, jd, jnp.asarray(s["target"]))
    return float(loss), np.asarray(g[target]), params


def port_grad(s, target, camera_pass, jparams):
    cfg, ds, mats, samples, o, d, cam = s["port"]
    inv = I.InverseConfig(optimize=(target,), camera_pass=camera_pass)
    params = interop.inverse_params(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU)
    loss = I.make_loss_fn(inv, cfg, ds, cam)(params, samples, mats, o, d,
                                             torch.as_tensor(s["target"]))
    (g,) = torch.autograd.grad(loss, params[target])
    return float(loss.detach()), g.numpy()


def cos_ratio(a, b):
    """(cosine, norm ratio) of gradient a against gradient b."""
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return float(a @ b / (na * nb)), float(na / nb)


def assert_like_jax(s, target, loss_rel=LOSS_REL):
    """The port's "fast" loss and gradient against the JAX package's."""
    jl, jg, jparams = jax_grad(s, target, "fast")
    pl, pg = port_grad(s, target, "fast", jparams)
    assert np.isfinite(pg).all() and np.abs(pg).max() > 0
    assert abs(pl - jl) <= loss_rel * jl, (pl, jl)
    cos, ratio = cos_ratio(pg, jg)
    assert cos >= COS_MIN, cos
    assert abs(ratio - 1.0) <= NORM_TOL, ratio


@pytest.fixture(scope="module")
def cornell():
    return setups(fast_cfg(jpreset), fast_cfg(preset),
                  jcornell_box(size=100.0), cornell_box(size=100.0), CAMERA)


@pytest.mark.parametrize("target", ["radiance", "light"])
def test_fast_loss_and_grad_match_jax(cornell, target):
    assert_like_jax(cornell, target)


def test_fast_albedo_against_own_xla(cornell):
    jparams = jax_grad_params(cornell, "albedo")
    lx, gx = port_grad(cornell, "albedo", "xla", jparams)
    lf, gf = port_grad(cornell, "albedo", "fast", jparams)
    assert np.isfinite(gf).all() and np.abs(gf).max() > 0
    assert abs(lf - lx) < 5e-3 + 0.05 * abs(lx)     # test_inverse_fast.py's
    cos, ratio = cos_ratio(gf, gx)
    assert cos > 0.9, cos
    assert 0.85 < ratio < 1.15, ratio


def test_fast_steps_descend(cornell):
    """tests/test_inverse_fast.py test_fast_pass_inverse_step_descends,
    cut to 4 steps: Adam from a black radiance grid toward the lit
    target."""
    cfg, ds, mats, samples, o, d, cam = cornell["port"]
    inv = I.InverseConfig(optimize=("radiance",), camera_pass="fast",
                          learning_rate=0.01)
    with torch.no_grad():
        target = R.render_rays(cfg, ds, R.build_voxel_state(cfg, samples,
                                                            mats), mats, o,
                               d, cam)
        voxels = R.build_voxel_state(cfg, samples, mats)
    params = I.init_params(inv, cfg, mats, voxels)
    with torch.no_grad():
        params["radiance"].zero_()
    step, opt = I.make_step_fn(inv, cfg, ds, cam)
    opt_state = opt(params)
    losses = []
    for _ in range(4):
        params, opt_state, loss = step(params, opt_state, samples, mats, o,
                                       d, target)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses
