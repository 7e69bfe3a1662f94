"""The reference's voxel build with the anisotropic radiance pyramid: the
frozen vctbench/reference/render/renderer.py build_voxel_state, with its
radiance mips replaced by the 6-direction pyramid (aniso.py) and nothing
else changed.  The diffuse and specular fields then march the 6-direction
levels through the frozen ops/dense plain march, which blends each level's
taps by the direction's weights, and its march_work counts those taps."""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from vctbench.reference.config import VCTConfig
from vctbench.reference.core import dense as D
from vctbench.reference.core import grid as G
from vctbench.reference.ops import mip
from vctbench.reference.render import renderer as R
from vctbench.reference.render import shading
from vctbench.reference.render.voxelize import splat
from vctbench.reference_aniso import aniso as A

Tensor = torch.Tensor

# the radiance grid's channels: rgb and alpha
RADIANCE_CHANNELS = 4


def build_voxel_state(cfg: VCTConfig, samples: R.SamplesDevice,
                      mats: R.MaterialTable,
                      q: Optional[Callable[[Tensor, str], Tensor]] = None,
                      works: Optional[List[Tuple[int, int]]] = None
                      ) -> R.VoxelState:
    """The frozen build (volume shadows, two bounces, no sharding) with
    the anisotropic radiance pyramid; q and works as there."""
    if not cfg.grid.anisotropic:
        raise ValueError("this reference builds the anisotropic pyramid: "
                         "the configuration's grid.anisotropic is false")
    if q is None:
        def q(x, _):
            return x
    dim, ws = cfg.grid.dim, cfg.grid.world_size
    dev = samples.positions.device
    light_color = G.constant(cfg.light.color, dev)
    albedo = mats.sample_albedo(samples.material_ids, samples.uvs)
    emissive = mats.emissive[samples.material_ids.long()]
    weights = torch.ones(samples.positions.shape[0], dtype=albedo.dtype,
                         device=dev)

    unlit = q(splat(samples.positions, albedo[:, :3], weights, dim, ws,
                    mode=cfg.voxelize.mode), "float32")
    # the occupancy pyramid stays isotropic, with max alpha
    unlit_mips = tuple(q(m, "float32") for m in mip.build_mips(
        unlit, cfg.grid.num_levels, alpha_mode="max"))

    d = np.asarray(cfg.light.direction, np.float64)
    light_volume = q(R._march(
        cfg, unlit_mips, (d / np.linalg.norm(d))[None],
        shading.shadow_schedule(cfg), works, field_dim=dim,
        opacity_gain=cfg.shadow.opacity_gain, transmittance_only=True),
        "bfloat16")
    shadow = shading.shadow_volume_tap_packed(
        cfg, shading.pack_light_corners(light_volume), dim,
        samples.positions, samples.normals)
    radiance = albedo[:, :3] * light_color * shadow[:, None] + emissive
    lit = q(splat(samples.positions, radiance, weights, dim, ws,
                  mode=cfg.voxelize.mode), "float32")
    radiance_mips = tuple(q(m, "float32") for m in A.build_aniso_mips(
        lit, cfg.grid.num_levels))

    def field(schedule):
        return q(R._march(cfg, radiance_mips,
                          D.direction_basis(cfg.cones.field_basis), schedule,
                          works, field_dim=shading.field_dim(cfg),
                          max_alpha=cfg.cones.max_alpha,
                          occlusion_falloff=cfg.cones.occlusion_falloff),
                 "bfloat16")

    diffuse_field = field(shading.diffuse_schedule(cfg))
    specular_field = None
    if cfg.cones.trace_specular and cfg.cones.specular_mode == "field":
        specular_field = field(shading.specular_field_schedule(cfg))
    return R.VoxelState(radiance_mips=radiance_mips, unlit_mips=unlit_mips,
                        light_volume=light_volume,
                        diffuse_field=diffuse_field,
                        specular_field=specular_field)
