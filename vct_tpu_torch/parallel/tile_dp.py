"""Tile data parallelism and the sharded build, render and train steps
(port of vct_tpu/parallel/tile_dp.py).

Once the voxel state is built, the camera pass is independent per pixel,
so each rank renders its own block of image rows over 'data' with the
whole voxel state, making no collective call (the JAX package's
shard_map camera pass).  The voxel build shards its surface samples over
'model' and reduces the splat's partial grids there (render/renderer.
build_voxel_state with a mesh), where XLA inserts that reduce in JAX.

The train step: every rank renders its rows, and the ranks of one model
group hold the same rows and so the same loss.  Each rank's loss is its
share of the global mean((img - target)^2) divided by n_model; the
collectives' backwards sum over the axes they replicate over
(parallel/comm.py), and the parameter gradients are summed over the
whole mesh before the optimizer's step, so every rank takes the same
step as one rank with the whole image would.

The step functions take whole tensors (rays, targets, samples) on every
rank and cut out the rank's block themselves (parallel/mesh.local_rows,
local_samples); images come back as the rank's rows, and gather_rows
brings them together on the data axis's first rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vct_tpu_torch.config import VCTConfig
from vct_tpu_torch.diff import inverse as I
from vct_tpu_torch.parallel import comm
from vct_tpu_torch.parallel import mesh as meshlib
from vct_tpu_torch.render import renderer as R

Tensor = torch.Tensor

# the optimization state of the train step: parameters and the
# torch.optim optimizer bound to them (diff/inverse.py)
TrainState = I.OptimState


def sharded_build_fn(cfg: VCTConfig, mesh):
    """(samples, mats) -> the whole VoxelState on every rank, the surface
    samples sharded over 'model' and the dense marches brick-sharded
    (with cfg.sharding.brick_parallel > 1)."""
    def fn(samples, mats):
        return R.build_voxel_state(cfg, samples, mats, mesh=mesh)
    return fn


def sharded_camera_fn(cfg: VCTConfig, ds, mesh, chunk_size: int = 4096):
    """The camera pass over 'data': (origins, dirs, cam_pos, voxels,
    mats) -> this rank's rows of the image, rendered with render_rays on
    the whole voxel state, with no collective call.  The rows must
    divide the data axis.  The ranks of one model group render the same
    rows."""
    data = cfg.sharding.data_axis

    def fn(origins, dirs, cam_pos, voxels, mats):
        return R.render_rays(cfg, ds, voxels, mats,
                             meshlib.local_rows(origins, mesh, data),
                             meshlib.local_rows(dirs, mesh, data), cam_pos,
                             chunk_size=chunk_size)
    return fn


# JAX's explicit shard_map form of the camera pass; per rank, PyTorch has
# only this one form
shardmap_camera_fn = sharded_camera_fn


def gather_rows(img_rows: Tensor, mesh, axis_name: str = "data"):
    """The ranks' image rows -> the whole image on the first rank of each
    line along `axis_name` (so on rank 0); None on the others."""
    return comm.gather_to_first(img_rows, comm.axis(mesh, axis_name))


def sharded_render_fn(cfg: VCTConfig, ds, mesh, chunk_size: int = 4096):
    """(origins, dirs, cam_pos, samples, mats) -> this rank's image rows:
    the sharded build, then the camera pass over 'data'."""
    build = sharded_build_fn(cfg, mesh)
    camera = sharded_camera_fn(cfg, ds, mesh, chunk_size)

    def fn(origins, dirs, cam_pos, samples, mats):
        return camera(origins, dirs, cam_pos, build(samples, mats), mats)
    return fn


def pad_samples(samples: R.SamplesDevice, multiple: int) -> R.SamplesDevice:
    """Pad the surface samples to a multiple of `multiple`.  Pad samples
    sit far outside the grid (1e6), so splat drops them: a no-op on the
    results.  (The port's shards may differ in length, so the sharded
    build needs no padding; this serves callers that want equal shards.)"""
    n = samples.positions.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return samples

    def cat(x, fill):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=x.device)])

    return R.SamplesDevice(positions=cat(samples.positions, 1e6),
                           normals=cat(samples.normals, 0),
                           uvs=cat(samples.uvs, 0),
                           material_ids=cat(samples.material_ids, 0))


def sharded_train_step_fn(cfg: VCTConfig, ds, mesh, chunk_size: int = 4096):
    """One inverse-rendering step over the mesh: step(params, opt_state,
    origins, dirs, cam_pos, samples, mats, target) -> (params, opt_state,
    loss).  params {"albedo" (M, 4), "light" (3,)} are leaf tensors,
    the same on every rank, and opt_state a torch.optim optimizer over
    them (diff/inverse.adam); rays, target and samples are whole.  The
    loss is diff/inverse.make_loss_fn's mean((img - target)^2) over the
    whole image, the same on every rank, and every rank's parameters
    take the same step."""
    everyone = comm.whole(mesh)
    inv = I.InverseConfig(optimize=("albedo", "light"),
                          chunk_size=chunk_size)
    rows = cfg.sharding.data_axis

    def total(x):
        return comm.all_reduce(x, everyone)

    def step(params, opt_state, origins, dirs, cam_pos, samples, mats,
             target):
        loss_fn = I.make_loss_fn(inv, cfg, ds, cam_pos, mesh=mesh)
        opt_state.zero_grad(set_to_none=True)
        # this rank's rows are 1/n_data of the image, and its loss is
        # held by all n_model ranks of its model group
        local = loss_fn(params, samples, mats,
                        meshlib.local_rows(origins, mesh, rows),
                        meshlib.local_rows(dirs, mesh, rows),
                        meshlib.local_rows(target, mesh, rows))
        loss = local / everyone.size
        loss.backward()
        for p in params.values():
            p.grad = total(p.grad)
        opt_state.step()
        return params, opt_state, total(loss.detach())

    return step


def _tiny_setup(width: int, height: int, dim: int, device):
    """__graft_entry__._tiny_setup: preset cornell64_full at dim^3 on the
    Cornell box from (0, 0, 140)."""
    from vct_tpu_torch.config import GridConfig, preset
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.core import grid as G
    from vct_tpu_torch.scene.cornell import cornell_box

    cfg = preset("cornell64_full")
    cfg = dataclasses.replace(
        cfg, grid=GridConfig(dim=dim, world_size=150.0),
        render=dataclasses.replace(cfg.render, width=width, height=height))
    camera = CAM.Camera(position=(0.0, 0.0, 140.0))
    ds, mats, samples = R.prepare_scene(cfg, cornell_box(size=100.0),
                                        device=device)
    origins, dirs = CAM.primary_rays(camera, width, height, device=device)
    return (cfg, ds, mats, samples, origins, dirs,
            G.constant(camera.position, device))


def dryrun_multichip(n: int, steps: int = 1, device="cuda") -> dict:
    """__graft_entry__.dryrun_multichip inside each of n ranks: an
    (n/2 x 2) mesh for even n >= 4, else (n x 1); `steps` train steps on
    the Cornell box at 16^3 and 32 x 4*n_data (samples sharded over
    'model'), then, with a model axis, the brick-sharded build of the
    field-cone config and its render.  Returns {"mesh", "losses",
    "image_mean"} (the image mean on rank 0 only, else None)."""
    device = torch.device(device)
    n_model = 2 if n >= 4 and n % 2 == 0 else 1
    n_data = n // n_model
    mesh = meshlib.make_mesh(n_data, n_model, device_type=device.type)
    height = 4 * n_data
    cfg, ds, mats, samples, origins, dirs, cam_pos = _tiny_setup(
        32, height, 16, device)
    cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
        cfg.sharding, data_parallel=n_data, brick_parallel=n_model))

    step = sharded_train_step_fn(cfg, ds, mesh, chunk_size=128)
    params = {"albedo": I._leaf(mats.albedo),
              "light": I._leaf(torch.ones(3, device=device))}
    opt_state = I.adam(1e-2)(params)
    target = torch.zeros((height, 32, 3), device=device)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, origins, dirs,
                                       cam_pos, samples, mats, target)
        losses.append(float(loss))
    if not np.isfinite(losses).all():
        raise FloatingPointError(f"non-finite loss {losses}")

    image_mean = None
    if n_model > 1:
        fcfg = dataclasses.replace(cfg, cones=dataclasses.replace(
            cfg.cones, diffuse_mode="field", specular_mode="field",
            field_basis=6, field_dim=16))
        render = sharded_render_fn(fcfg, ds, mesh, chunk_size=128)
        img = gather_rows(render(origins, dirs, cam_pos, samples, mats),
                          mesh)
        if img is not None and torch.distributed.get_rank() == 0:
            image_mean = float(img.mean())
            if not np.isfinite(image_mean):
                raise FloatingPointError(f"non-finite image mean "
                                         f"{image_mean}")
    return {"mesh": (n_data, n_model), "losses": losses,
            "image_mean": image_mean}
