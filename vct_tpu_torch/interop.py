"""Carry scene data and voxel state from the JAX package into the port.

Each function takes the JAX package's dataclass with numpy leaves (for
example `jax.tree_util.tree_map(np.asarray, x)`) and returns the port's
dataclass on `device`, so both packages can shade the same voxel state.
This module imports no jax: it reads attributes and numpy arrays only.
"""

from __future__ import annotations

import numpy as np
import torch

from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.render.gbuffer import DeviceScene, GBuffer
from vct_tpu_torch.ops import specmarch as SM
from vct_tpu_torch.ops import tap as TP
from vct_tpu_torch.scene.textures import TextureAtlas


def tensor(x, device="cuda") -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> torch, dtype kept."""
    a = np.array(x, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def device_scene(ds, device="cuda") -> DeviceScene:
    return DeviceScene(**{f: tensor(getattr(ds, f), device)
                          for f in DeviceScene.__dataclass_fields__})


def gbuffer(g, device="cuda") -> GBuffer:
    """The JAX package's GBuffer -> the port's, dtypes kept (hit bool,
    material and tri int32)."""
    return GBuffer(**{f: tensor(getattr(g, f), device)
                      for f in GBuffer.__dataclass_fields__})


def material_table(m, device="cuda") -> R.MaterialTable:
    atlas = None
    if m.atlas is not None:
        atlas = TextureAtlas(**{k: tensor(getattr(m.atlas, k), device)
                                for k in ("albedo", "specular", "height")})
    return R.MaterialTable(albedo=tensor(m.albedo, device),
                           specular=tensor(m.specular, device),
                           emissive=tensor(m.emissive, device),
                           shininess=tensor(m.shininess, device),
                           atlas=atlas)


def samples(s, device="cuda") -> R.SamplesDevice:
    return R.SamplesDevice(positions=tensor(s.positions, device),
                           normals=tensor(s.normals, device),
                           uvs=tensor(s.uvs, device),
                           material_ids=tensor(s.material_ids, device))


def voxel_state(v, device="cuda") -> R.VoxelState:
    def opt(x):
        return None if x is None else tensor(x, device)

    return R.VoxelState(
        radiance_mips=tuple(tensor(m, device) for m in v.radiance_mips),
        unlit_mips=tuple(tensor(m, device) for m in v.unlit_mips),
        light_volume=opt(v.light_volume),
        diffuse_field=opt(v.diffuse_field),
        specular_field=opt(v.specular_field),
        shadow_map=opt(v.shadow_map))


def inverse_params(np_params, device="cuda") -> dict:
    """The JAX package's inverse-rendering parameter dict -> leaf float32
    tensors on `device` that require grad (diff/inverse.py Params)."""
    return {k: tensor(v, device).to(torch.float32).requires_grad_()
            for k, v in np_params.items()}


def optim_state(np_state, device="cuda", learning_rate: float = 5e-2):
    """The JAX package's OptimState (params, optax.adam's state, step) ->
    the port's: the parameters as inverse_params, and a torch.optim.Adam at
    `learning_rate` over them whose per-parameter state is optax's
    ScaleByAdamState(count, mu, nu) as (step, exp_avg, exp_avg_sq), so the
    next step of each package lands in the same place."""
    from vct_tpu_torch.diff import inverse as I
    params = inverse_params(np_state.params, device)
    opt = I.adam(learning_rate)(params)
    adam = next(s for s in np_state.opt_state if hasattr(s, "mu"))
    count = float(np.asarray(adam.count))
    saved = opt.state_dict()
    saved["state"] = {
        i: {"step": torch.tensor(count),
            "exp_avg": tensor(adam.mu[k], device).to(torch.float32),
            "exp_avg_sq": tensor(adam.nu[k], device).to(torch.float32)}
        for i, k in enumerate(params)}
    opt.load_state_dict(saved)
    return I.OptimState(params=params, opt_state=opt,
                        step=int(np_state.step))


SPEC_PAGE_ROWS = 24   # specmarch_pallas BY: y rows padded past each level


def spec_pyramid(pages, device="cuda"):
    """specmarch_pallas.pack_spec_mips' (2, 4, XTP, Y0, ZC) pages -> the
    port's pyramid (ops/specmarch.pack_spec_mips layout).  The pages hold
    2 y-shifted x 4 z-shifted copies with the levels stacked along x
    (level l from row 2*D0 - 2*(D0 >> l)), y padded to D0 + 24 rows and z
    fused with the 4 channels; copy (0, 0), the one spec_march_ref reads,
    is cut level by level."""
    d0 = pages.shape[3] - SPEC_PAGE_ROWS
    levels = []
    for li, d in enumerate(SM._level_dims(d0)):
        xb = 2 * d0 - 2 * (d0 >> li)
        levels.append(tensor(pages[0, 0, xb:xb + d, :d, :d * SM.NC],
                             device).reshape(d, d, d, SM.NC))
    return SM.pack_spec_mips(levels)


def frame_tables(t, cfield: int, device="cuda") -> F.FrameTables:
    """The JAX package's packed FrameTables -> the port's layout.

    tap_pallas.pack_light_mips pads each (D, D, D) light level to
    (D, max(D, 32), pad128(D)) and pack_field_mips each (D, D, D, C) field
    level to (D, D, max(D, 32), pad128(C)); this cuts the padding off and
    re-packs the levels back to back.  cfield is the logical channel
    count: 4 * basis, doubled when the config samples the specular field
    (not with percone specular).  The atlas mip pages share the port's
    layout and carry over as they are; the specular march's pages become
    the port's pyramid (spec_pyramid)."""
    light = [tensor(m, device)[:, :m.shape[0], :m.shape[0]]
             for m in t.light_mips]
    field = [tensor(m, device)[:, :, :m.shape[0], :cfield]
             for m in t.field_mips]
    pages = None if t.atlas_pages is None else tensor(t.atlas_pages, device)
    spec = None if t.spec_mips is None else spec_pyramid(t.spec_mips, device)
    return F.FrameTables(light_mips=TP.pack_mips(light),
                         field_mips=TP.pack_mips(field), atlas_pages=pages,
                         spec_mips=spec)
