"""Inverse rendering: optimize scene parameters against a target image
(port of vct_tpu/diff/inverse.py).

The whole pipeline (voxelization, shadow, mip build, cone march, shading
combine) runs under autograd, so one backward reaches material albedos,
texture pages, the light color and the voxel radiance grid itself.  On
the card the kernels on the path carry gradients through their autograd
Functions: the mip's backward is a kernel of its own (ops/mip.py), and
the raycast, material, tap and specular march replay their plain
versions, as the JAX package's custom VJPs replay its jnp references.
The binned and streamed raycasts have no backward and refuse inputs that
need one.

Optimizable parameter sets (InverseConfig.optimize):
  "albedo"       material albedo table (M, 4)
  "textures"     albedo atlas pages (M, R, R, 4), when the scene has them
  "light"        light color (3,); it reaches the voxel build only: the
                 camera pass's direct light keeps cfg.light.color, as in
                 the JAX package
  "radiance"     the level-0 radiance grid directly (D, D, D, 4), re-mipped
                 (and re-fielded) every step

Parameters are leaf tensors on an explicit device; the optimizer is
torch.optim.Adam (optax.adam's defaults and bias-corrected update).
Checkpoint/resume: diff/checkpoint.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from vct_tpu_torch.config import VCTConfig
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.ops import mip
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.render import shading
from vct_tpu_torch.render.voxelize import splat
from vct_tpu_torch.stages import span

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class InverseConfig:
    """What to optimize and how."""

    optimize: Tuple[str, ...] = ("albedo",)
    learning_rate: float = 5e-2
    num_steps: int = 200
    loss: str = "l2"                  # "l2" | "l1"
    chunk_size: int = 4096
    # camera pass inside the loss: "xla" = render_rays (any config; the
    # JAX package's name for it); "fast" = render/fast.py's kernels, for a
    # fast-supported config (volume shadows + field cones) of at most
    # raycast.MAX_TRIANGLES triangles
    camera_pass: str = "xla"          # "xla" | "fast"


@dataclasses.dataclass
class OptimState:
    """Optimization state: the parameters, the optimizer bound to them
    (its state_dict is what a checkpoint keeps) and the step."""

    params: Params
    opt_state: torch.optim.Optimizer
    step: int = 0


def adam(learning_rate: float) -> Callable[[Params], torch.optim.Optimizer]:
    """optax.adam(learning_rate)'s counterpart: params -> torch.optim.Adam
    over their leaf tensors, in the dict's order (b1 0.9, b2 0.999, eps
    1e-8, bias-corrected)."""
    def init(params: Params) -> torch.optim.Optimizer:
        return torch.optim.Adam(list(params.values()), lr=learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)
    return init


def _leaf(x: Tensor) -> Tensor:
    return x.detach().clone().to(torch.float32).requires_grad_()


def init_params(inv: InverseConfig, cfg: VCTConfig, mats: R.MaterialTable,
                voxels: Optional[R.VoxelState] = None) -> Params:
    """Initial parameters from the current scene state: leaf tensors on
    the material table's device."""
    params: Params = {}
    for name in inv.optimize:
        if name == "albedo":
            params["albedo"] = _leaf(mats.albedo)
        elif name == "textures":
            if mats.atlas is None:
                raise ValueError("optimize='textures' needs a texture atlas")
            params["textures"] = _leaf(mats.atlas.albedo)
        elif name == "light":
            params["light"] = _leaf(G.constant(cfg.light.color,
                                               mats.albedo.device))
        elif name == "radiance":
            if voxels is None:
                raise ValueError("optimize='radiance' needs a VoxelState")
            params["radiance"] = _leaf(voxels.radiance_mips[0])
        else:
            raise ValueError(f"unknown optimize target {name!r}")
    return params


def _apply_params(inv: InverseConfig, cfg: VCTConfig, params: Params,
                  samples: R.SamplesDevice, mats: R.MaterialTable,
                  mesh=None):
    """Rebuild (mats, voxels) from the parameters, under autograd, so
    gradients flow through voxelization and the mip build (radiance mode
    re-mips the grid).  mesh: build_voxel_state's, for the sharded build
    (parallel/tile_dp.py); radiance mode has no sharded build."""
    if "albedo" in params:
        mats = dataclasses.replace(mats, albedo=params["albedo"])
    if "textures" in params:
        mats = dataclasses.replace(
            mats, atlas=dataclasses.replace(mats.atlas,
                                            albedo=params["textures"]))
    light_color = params.get("light")
    if "radiance" in params:
        if mesh is not None:
            raise ValueError("optimize='radiance' has no sharded build")
        voxels = voxel_state_from_radiance(
            cfg, params["radiance"], samples, mats, light_color=light_color)
    else:
        voxels = R.build_voxel_state(cfg, samples, mats,
                                     light_color=light_color, mesh=mesh)
    return mats, voxels


def voxel_state_from_radiance(
    cfg: VCTConfig,
    radiance: Tensor,                   # (D, D, D, 4) level-0 grid
    samples: R.SamplesDevice,
    mats: R.MaterialTable,
    light_color: Optional[Tensor] = None,
) -> R.VoxelState:
    """VoxelState with the radiance grid INJECTED instead of splatted: the
    radiance-field path, whose mips, fields and shadow derive from the
    given grid, so gradients reach every voxel.  light_color is unused:
    the occupancy and the light volume do not depend on it."""
    del light_color
    albedo = mats.sample_albedo(samples.material_ids, samples.uvs)
    weights = torch.ones(samples.positions.shape[0], dtype=albedo.dtype,
                         device=albedo.device)
    unlit = splat(samples.positions, albedo[:, :3], weights, cfg.grid.dim,
                  cfg.grid.world_size, mode=cfg.voxelize.mode)
    unlit_mips = mip.build_mips(unlit, cfg.grid.num_levels, alpha_mode="max")
    radiance_mips = R._radiance_mips(cfg, radiance)
    light_volume = (shading.build_light_volume(cfg, unlit_mips)
                    if cfg.shadow.mode == "volume" else None)
    diffuse_field = (shading.build_cone_field(
        cfg, radiance_mips, shading.diffuse_schedule(cfg))
        if cfg.cones.diffuse_mode == "field" else None)
    specular_field = (shading.build_cone_field(
        cfg, radiance_mips, shading.specular_field_schedule(cfg))
        if cfg.cones.trace_specular and cfg.cones.specular_mode == "field"
        else None)
    return R.VoxelState(
        radiance_mips=radiance_mips, unlit_mips=unlit_mips,
        light_volume=light_volume, diffuse_field=diffuse_field,
        specular_field=specular_field)


def make_loss_fn(inv: InverseConfig, cfg: VCTConfig, ds,
                 camera_position: Tensor, mesh=None) -> Callable:
    """loss(params, samples, mats, origins, dirs, target) -> 0-d tensor.
    With a mesh the voxel build is build_voxel_state's sharded one."""

    from vct_tpu_torch.render import fast as F
    if inv.camera_pass == "fast":
        if not F.supported(cfg):
            raise ValueError(
                "camera_pass='fast' needs volume shadows + field cones")
        # above MAX_TRIANGLES render_frame takes the binned raycast, which
        # has no backward
        if ds.v0.shape[0] > RP.MAX_TRIANGLES:
            raise ValueError(
                f"camera_pass='fast' is differentiable only up to "
                f"{RP.MAX_TRIANGLES} triangles (the whole-table raycast "
                f"kernel); this scene has {ds.v0.shape[0]} — use "
                f"camera_pass='xla'")

    def loss_fn(params, samples, mats, origins, dirs, target):
        mats2, voxels = _apply_params(inv, cfg, params, samples, mats,
                                      mesh)
        if inv.camera_pass == "fast":
            tables = F.build_frame_tables(cfg, voxels, mats2)
            img = F.render_frame(cfg, ds, tables, mats2, origins, dirs,
                                 camera_position)
        else:
            img = R.render_rays(cfg, ds, voxels, mats2, origins, dirs,
                                camera_position, chunk_size=inv.chunk_size)
        err = img - target
        if inv.loss == "l1":
            return torch.mean(torch.abs(err))
        return torch.mean(err * err)

    return loss_fn


def make_step_fn(inv: InverseConfig, cfg: VCTConfig, ds,
                 camera_position: Tensor,
                 optimizer: Optional[Callable] = None):
    """(step, optimizer): step(params, opt_state, samples, mats, origins,
    dirs, target) -> (params, opt_state, loss), one forward, backward and
    optimizer update, the parameters updated in place and the loss a 0-d
    tensor on the device (nothing is read back); optimizer(params) makes
    the opt_state (default: adam(inv.learning_rate)).  The step marks
    "loss", "backward" and "optimizer" (vct_tpu_torch/stages.py) after
    each part's work."""
    if optimizer is None:
        optimizer = adam(inv.learning_rate)
    loss_fn = make_loss_fn(inv, cfg, ds, camera_position)

    def step(params, opt_state, samples, mats, origins, dirs, target):
        with span("loss"):
            opt_state.zero_grad(set_to_none=True)
            loss = loss_fn(params, samples, mats, origins, dirs, target)
        with span("backward"):
            loss.backward()
        with span("optimizer"):
            opt_state.step()
        return params, opt_state, loss.detach()

    return step, optimizer


def optimize(
    inv: InverseConfig,
    cfg: VCTConfig,
    scene,
    target,                             # (H, W, 3) target image
    camera: Optional[CAM.Camera] = None,
    init: Optional[Params] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    log_every: int = 0,
    device=None,
) -> Tuple[OptimState, List[float]]:
    """Run the inverse optimization; returns final state + loss history.

    Runs on `device`; None takes the target's device when it is a tensor,
    else the card.  So a target made on the CPU (torch.zeros, an image
    loaded with torch) runs the whole loop on the CPU: pass device="cuda"
    or move the target to the card to optimize there.  With log_every set,
    the first line names the device.  With checkpoint_dir set, resumes from the latest
    checkpoint there and saves every checkpoint_every steps
    (diff/checkpoint.py)."""
    if device is None:
        device = target.device if isinstance(target, Tensor) else "cuda"
    if log_every:
        print(f"optimizing on {device}")
    if camera is None:
        camera = CAM.Camera()
    ds, mats, samples = R.prepare_scene(cfg, scene, device=device)
    origins, dirs = CAM.primary_rays(camera, target.shape[1],
                                     target.shape[0], device=device)
    cam_pos = G.constant(camera.position, device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)

    step_fn, optimizer = make_step_fn(inv, cfg, ds, cam_pos)
    if init is None:
        voxels = None
        if "radiance" in inv.optimize:
            with torch.no_grad():
                voxels = R.build_voxel_state(cfg, samples, mats)
        init = init_params(inv, cfg, mats, voxels)
    else:
        init = {k: _leaf(torch.as_tensor(v).to(device))
                for k, v in init.items()}
    state = OptimState(params=init, opt_state=optimizer(init), step=0)

    if checkpoint_dir is not None:
        from vct_tpu_torch.diff import checkpoint as ckpt
        restored = ckpt.restore_latest(checkpoint_dir, state)
        if restored is not None:
            state = restored

    history: List[float] = []
    while state.step < inv.num_steps:
        params, opt_state, loss = step_fn(
            state.params, state.opt_state, samples, mats, origins, dirs,
            target)
        state = OptimState(params=params, opt_state=opt_state,
                           step=state.step + 1)
        history.append(float(loss))
        if log_every and state.step % log_every == 0:
            print(f"step {state.step}: loss {history[-1]:.6f}")
        if (checkpoint_dir is not None and checkpoint_every
                and state.step % checkpoint_every == 0):
            from vct_tpu_torch.diff import checkpoint as ckpt
            ckpt.save(checkpoint_dir, state)
    if checkpoint_dir is not None:
        from vct_tpu_torch.diff import checkpoint as ckpt
        ckpt.save(checkpoint_dir, state)
    return state, history
