"""Inverse rendering in the port (vct_tpu_torch/diff) against the JAX
package's (vct_tpu/diff), on the CPU.

  * make_loss_fn with camera_pass="xla" (render_rays) for "albedo",
    "light" and "radiance": the loss within 1e-5 relative and the
    gradient within 1e-4 relative L2 of jax.value_and_grad's, at
    tests/test_inverse.py's tiny_cfg (preset inverse at 16^3, 16x16);
  * Adam: three steps of the port's optimizer from the same start and the
    same gradients follow Adam's bias-corrected update (numpy, float64)
    within 1e-6 relative, and optax.adam's within 1e-5 relative: optax
    divides its second moment, made with 1 - 0.999 in float64, by the
    bias correction 1 - 0.999**t in float32, so each of its updates is
    6.4e-6 short (0.04999965 for a step of 0.05); a JAX OptimState
    carried over by interop.optim_state takes the same next step, within
    that bound;
  * checkpoints: TestCheckpoint of tests/test_inverse.py, and a run
    resumed from a step-3 checkpoint ends where an unbroken run ends.

The fast camera pass: test_torch_inverse_fast.py (Cornell box) and
test_torch_inverse_atrium.py (textured atrium).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vct_tpu.config import GridConfig as JGridConfig
from vct_tpu.config import RenderConfig as JRenderConfig
from vct_tpu.config import preset as jpreset
from vct_tpu.core import camera as jcam
from vct_tpu.diff import inverse as JI
from vct_tpu.render import renderer as JR
from vct_tpu.scene import cornell_box as jcornell_box
from vct_tpu_torch import interop
from vct_tpu_torch.config import GridConfig, RenderConfig, preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.diff import checkpoint as ckpt
from vct_tpu_torch.diff import inverse as I
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.scene.cornell import cornell_box

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

CPU = torch.device("cpu")
SIZE = 16
LOSS_REL = 1e-5             # relative error of the loss (float32 sums)
GRAD_REL = 1e-4             # relative L2 error of the gradient
ADAM_REL = 1e-6             # Adam's parameters against the float64 update
OPTAX_REL = 1e-5            # ... against optax's (6.4e-6 short a step)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def tiny_cfg(make=preset, grid=GridConfig, render=RenderConfig):
    """tests/test_inverse.py's tiny_cfg, in either package."""
    return dataclasses.replace(
        make("inverse"), grid=grid(dim=SIZE, world_size=150.0),
        render=render(width=SIZE, height=SIZE))


@pytest.fixture(scope="module")
def jax_setup():
    cfg = tiny_cfg(jpreset, JGridConfig, JRenderConfig)
    ds, mats, samples = JR.prepare_scene(
        cfg, jcornell_box(size=100.0, with_blocks=False))
    origins, dirs = jcam.primary_rays(jcam.Camera(), SIZE, SIZE)
    cam = jnp.asarray(jcam.Camera().position, jnp.float32)
    voxels = JR.build_voxel_state(cfg, samples, mats)
    target = np.asarray(JR.render_rays(cfg, ds, voxels, mats, origins, dirs,
                                       cam))
    return cfg, ds, mats, samples, origins, dirs, cam, voxels, target


@pytest.fixture(scope="module")
def port_setup():
    cfg = tiny_cfg()
    scene = cornell_box(size=100.0, with_blocks=False)
    ds, mats, samples = R.prepare_scene(cfg, scene, device=CPU)
    origins, dirs = CAM.primary_rays(CAM.Camera(), SIZE, SIZE, device=CPU)
    cam = torch.tensor(CAM.Camera().position)
    return cfg, scene, ds, mats, samples, origins, dirs, cam


@pytest.mark.parametrize("target", ["albedo", "light", "radiance"])
def test_loss_and_grad_match_jax(jax_setup, port_setup, target):
    jcfg, jds, jmats, jsamples, jo, jd, jc, jvox, jtarget = jax_setup
    cfg, _, ds, mats, samples, origins, dirs, cam = port_setup
    goal = jtarget * 0.7 + 0.05           # off the truth: nonzero gradients
    jinv = JI.InverseConfig(optimize=(target,), chunk_size=256)
    jparams = JI.init_params(jinv, jcfg, jmats, jvox)
    jloss, jgrad = jax.value_and_grad(JI.make_loss_fn(jinv, jcfg, jds, jc))(
        jparams, jsamples, jmats, jo, jd, jnp.asarray(goal))
    inv = I.InverseConfig(optimize=(target,), chunk_size=256)
    params = interop.inverse_params(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU)
    loss = I.make_loss_fn(inv, cfg, ds, cam)(params, samples, mats, origins,
                                             dirs, torch.as_tensor(goal))
    (grad,) = torch.autograd.grad(loss, params[target])
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_REL * float(jloss)
    assert rel_err(grad.numpy(), jgrad[target]) <= GRAD_REL


def test_init_params_are_leaves(port_setup):
    cfg, _, _, mats, samples, _, _, _ = port_setup
    inv = I.InverseConfig(optimize=("albedo", "light", "radiance"))
    with torch.no_grad():
        voxels = R.build_voxel_state(cfg, samples, mats)
    params = I.init_params(inv, cfg, mats, voxels)
    assert list(params) == ["albedo", "light", "radiance"]
    for p in params.values():
        assert p.is_leaf and p.requires_grad and p.device == CPU
    assert params["radiance"].shape == (SIZE,) * 3 + (4,)
    np.testing.assert_array_equal(params["light"].detach().numpy(),
                                  np.float32(cfg.light.color))
    with pytest.raises(ValueError, match="needs a texture atlas"):
        I.init_params(I.InverseConfig(optimize=("textures",)), cfg, mats)


# ---------------------------------------------------------------------------
# Adam against optax.adam
# ---------------------------------------------------------------------------

def _quadratic(seed=0):
    """A loss whose gradients both frameworks compute alike: weighted
    squares of (p - goal), the start and goal from numpy."""
    rng = np.random.default_rng(seed)
    start = {"albedo": rng.random((8, 4), np.float32),
             "light": rng.random(3).astype(np.float32)}
    goal = {k: rng.random(v.shape).astype(np.float32)
            for k, v in start.items()}
    w = {k: (rng.random(v.shape) * 3).astype(np.float32)
         for k, v in start.items()}

    def jloss(p):
        return sum(jnp.sum(w[k] * (p[k] - goal[k]) ** 2) for k in p)

    def tloss(p):
        return sum(torch.sum(torch.as_tensor(w[k])
                             * (p[k] - torch.as_tensor(goal[k])) ** 2)
                   for k in p)

    return start, jloss, tloss


def _optax_steps(start, jloss, lr, n, state=None):
    opt = optax.adam(lr)
    p = {k: jnp.asarray(v) for k, v in start.items()}
    s = opt.init(p) if state is None else state
    path = []
    for _ in range(n):
        u, s = opt.update(jax.grad(jloss)(p), s, p)
        p = optax.apply_updates(p, u)
        path.append({k: np.asarray(v) for k, v in p.items()})
    return path, s


def _port_steps(params, opt, tloss, n):
    path = []
    for _ in range(n):
        opt.zero_grad()
        tloss(params).backward()
        opt.step()
        path.append({k: v.detach().numpy().copy() for k, v in params.items()})
    return path


def _adam_f64(start, grad, lr, n, b1=0.9, b2=0.999, eps=1e-8):
    """Adam's bias-corrected update in float64 numpy."""
    p = {k: v.astype(np.float64) for k, v in start.items()}
    m = {k: np.zeros_like(v) for k, v in p.items()}
    v2 = {k: np.zeros_like(v) for k, v in p.items()}
    path = []
    for t in range(1, n + 1):
        g = grad({k: np.float32(x) for k, x in p.items()})
        for k in p:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1 - b2) * g[k] ** 2
            p[k] = p[k] - lr * (m[k] / (1 - b1 ** t)) / (
                np.sqrt(v2[k] / (1 - b2 ** t)) + eps)
        path.append(dict(p))
    return path


def test_adam_follows_optax():
    start, jloss, tloss = _quadratic()
    lr = 5e-2
    want, _ = _optax_steps(start, jloss, lr, 3)
    exact = _adam_f64(start, lambda p: {
        k: np.asarray(v, np.float64) for k, v in jax.grad(jloss)(
            {k: jnp.asarray(x) for k, x in p.items()}).items()}, lr, 3)
    params = interop.inverse_params(start, CPU)
    got = _port_steps(params, I.adam(lr)(params), tloss, 3)
    for g, w, e in zip(got, want, exact):
        for k in w:
            assert rel_err(g[k], e[k]) <= ADAM_REL
            assert rel_err(g[k], w[k]) <= OPTAX_REL
    assert not np.allclose(got[-1]["albedo"], start["albedo"])


def test_optim_state_carries_adam_over():
    """Two optax steps, then the state crosses over: one more step in each
    package lands in the same place."""
    start, jloss, tloss = _quadratic(seed=1)
    lr = 1e-1
    path, s = _optax_steps(start, jloss, lr, 2)
    jstate = JI.OptimState(params=path[-1], opt_state=s, step=2)
    want, _ = _optax_steps(path[-1], jloss, lr, 1, state=s)
    state = interop.optim_state(jstate, CPU, learning_rate=lr)
    assert state.step == 2
    for k, p in state.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), path[-1][k])
        adam = state.opt_state.state[p]
        assert float(adam["step"]) == 2.0
        np.testing.assert_array_equal(adam["exp_avg"].numpy(), s[0].mu[k])
        np.testing.assert_array_equal(adam["exp_avg_sq"].numpy(),
                                      s[0].nu[k])
    got = _port_steps(state.params, state.opt_state, tloss, 1)
    for k in want[0]:
        assert rel_err(got[0][k], want[0][k]) <= OPTAX_REL


# ---------------------------------------------------------------------------
# checkpoints (tests/test_inverse.py TestCheckpoint)
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path, port_setup):
    cfg, _, _, mats, _, _, _, _ = port_setup
    inv = I.InverseConfig(optimize=("albedo",))
    params = I.init_params(inv, cfg, mats)
    opt = I.adam(1e-2)(params)
    params["albedo"].sum().backward()
    opt.step()                            # an Adam state worth keeping
    state = I.OptimState(params=params, opt_state=opt, step=7)
    ckpt.save(str(tmp_path), state)
    assert ckpt.available_steps(str(tmp_path)) == [7]
    zeros = {k: torch.zeros_like(v).requires_grad_()
             for k, v in params.items()}
    zero = I.OptimState(params=zeros, opt_state=I.adam(1e-2)(zeros), step=0)
    back = ckpt.restore_latest(str(tmp_path), zero)
    assert back.step == 7
    np.testing.assert_array_equal(back.params["albedo"].detach().numpy(),
                                  params["albedo"].detach().numpy())
    saved = opt.state_dict()["state"][0]
    loaded = back.opt_state.state_dict()["state"][0]
    for key in ("step", "exp_avg", "exp_avg_sq"):
        np.testing.assert_array_equal(loaded[key].numpy(),
                                      saved[key].numpy())
    assert back.opt_state.state[back.params["albedo"]]   # bound to them


def test_optimize_resumes_from_checkpoint(tmp_path, port_setup):
    cfg, scene, ds, mats, samples, origins, dirs, cam = port_setup
    with torch.no_grad():
        target = R.render_rays(cfg, ds, R.build_voxel_state(cfg, samples,
                                                            mats), mats,
                               origins, dirs, cam)
    wrong = torch.full_like(mats.albedo, 0.4)
    wrong[:, 3] = 1.0
    inv = I.InverseConfig(optimize=("albedo",), learning_rate=5e-2,
                          num_steps=6, chunk_size=256)
    # run 1: all 6 steps, checkpointing every 3
    s1, h1 = I.optimize(inv, cfg, scene, target, CAM.Camera(),
                        init={"albedo": wrong},
                        checkpoint_dir=str(tmp_path / "a"),
                        checkpoint_every=3)
    assert s1.step == 6 and len(h1) == 6
    assert h1[-1] < h1[0], h1
    steps = ckpt.available_steps(str(tmp_path / "a"))
    assert 3 in steps and 6 in steps
    # run 2: the same directory resumes at 6 and takes no step
    s2, h2 = I.optimize(inv, cfg, scene, target, CAM.Camera(),
                        init={"albedo": wrong},
                        checkpoint_dir=str(tmp_path / "a"))
    assert s2.step == 6 and h2 == []
    # run 3: 3 steps, then resumed to 6, ends where run 1 ended
    I.optimize(dataclasses.replace(inv, num_steps=3), cfg, scene, target,
               CAM.Camera(), init={"albedo": wrong},
               checkpoint_dir=str(tmp_path / "b"))
    s3, h3 = I.optimize(inv, cfg, scene, target, CAM.Camera(),
                        init={"albedo": wrong},
                        checkpoint_dir=str(tmp_path / "b"))
    assert s3.step == 6 and len(h3) == 3
    np.testing.assert_allclose(h3, h1[3:], rtol=1e-6)
    np.testing.assert_allclose(s3.params["albedo"].detach().numpy(),
                               s1.params["albedo"].detach().numpy(),
                               rtol=1e-6, atol=1e-7)
