"""The voxel build of the reference (a trimmed copy of the port's
render/renderer.py: the volume-shadow, field-cone path that the fast
frame needs), with the control's rounding and the dense marches' work.

`build_voxel_state`: splat albedo -> max-alpha occupancy mips -> the
dense light-transmittance volume and one tap of it per sample -> splat
radiance -> radiance mips -> the diffuse and (specular_mode "field")
specular basis fields.  Every dense march goes through ops/dense's plain
version.

q, where given, rounds what each stage hands on (the lower-precision
control, vctbench/reference/pipeline.py): q(x, "float32") for what the
configuration computes in float32, q(x, "bfloat16") for the marches it
computes in bfloat16.  works, where given, receives each march's (bytes,
float operations) by ops/dense.march_work from the steps its cells take.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from vctbench.inputs.scene import Scene
from vctbench.reference.config import VCTConfig
from vctbench.reference.core import dense as D
from vctbench.reference.core import grid as G
from vctbench.reference.ops import dense as OD
from vctbench.reference.ops import mip
from vctbench.reference.render import shading
from vctbench.reference.render.gbuffer import DeviceScene
from vctbench.reference.render.voxelize import (SurfaceSamples,
                                                generate_surface_samples,
                                                splat)
from vctbench.reference.scene import textures as TX

Tensor = torch.Tensor


@dataclasses.dataclass
class MaterialTable:
    """Per-material constants on the device, plus the texture atlas
    (scene/textures.py) when any material carries textures.  With an
    atlas, albedo and specular fetches sample it per uv (DiffuseTexture /
    SpecularTexture units, Mesh.h:89-111)."""

    albedo: Tensor      # (M, 4)
    specular: Tensor    # (M, 3)
    emissive: Tensor    # (M, 3)
    shininess: Tensor   # (M,) Phong exponent
    atlas: Optional[TX.TextureAtlas] = None

    @staticmethod
    def from_scene(scene: Scene, device="cuda",
                   texture_resolution: int = 256) -> "MaterialTable":
        atlas = None
        if TX.has_textures(scene.materials):
            atlas = TX.TextureAtlas.from_materials(
                scene.materials, texture_resolution, device=device)

        def col(name):
            return torch.as_tensor(
                np.asarray([getattr(m, name) for m in scene.materials],
                           np.float64), dtype=torch.float32, device=device)

        return MaterialTable(albedo=col("albedo"), specular=col("specular"),
                             emissive=col("emissive"),
                             shininess=col("shininess"), atlas=atlas)

    def sample_albedo(self, material_id: Tensor, uv: Tensor) -> Tensor:
        """(..., 4) rgba at the given uv — texture(DiffuseTexture, tex)."""
        if self.atlas is not None:
            return TX.sample_atlas(self.atlas.albedo, material_id, uv)
        return self.albedo[material_id.long()]

    def sample_specular(self, material_id: Tensor, uv: Tensor) -> Tensor:
        if self.atlas is not None:
            return TX.sample_atlas(self.atlas.specular, material_id, uv)
        return self.specular[material_id.long()]


@dataclasses.dataclass
class SamplesDevice:
    """Surface samples on the device (static per scene)."""

    positions: Tensor     # (S, 3)
    normals: Tensor       # (S, 3)
    uvs: Tensor           # (S, 2)
    material_ids: Tensor  # (S,) int32

    @staticmethod
    def from_samples(s: SurfaceSamples, device="cuda") -> "SamplesDevice":
        def put(x, dt=torch.float32):
            return torch.as_tensor(x, dtype=dt, device=device)

        return SamplesDevice(positions=put(s.positions),
                             normals=put(s.normals), uvs=put(s.uvs),
                             material_ids=put(s.material_ids, torch.int32))


@dataclasses.dataclass
class VoxelState:
    """Radiance and unlit/occupancy pyramids, the light volume, the basis
    fields (the fields the fast path needs, in the JAX layout) and the
    shadow map."""

    radiance_mips: Tuple[Tensor, ...]
    unlit_mips: Tuple[Tensor, ...]
    light_volume: Optional[Tensor] = None      # (D, D, D, 1)
    diffuse_field: Optional[Tensor] = None     # (df, df, df, B*4)
    specular_field: Optional[Tensor] = None    # (df, df, df, B*4)
    shadow_map: Optional[Tensor] = None        # (S, S) depth, mode "map"


def prepare_scene(cfg: VCTConfig, scene: Scene,
                  samples: Optional[SamplesDevice] = None, device="cuda"):
    """Host-side prep: device geometry, material table, surface samples,
    all on `device`.

    Pass `samples` to reuse an existing SamplesDevice, for example for a
    subdivided copy of the same surfaces, whose voxelization is the same
    by construction."""
    ds = DeviceScene.from_scene(scene, device=device)
    mats = MaterialTable.from_scene(scene, device=device)
    if samples is None:
        host = generate_surface_samples(scene, cfg.grid.voxel_world_size,
                                        cfg.voxelize.samples_per_voxel_width)
        samples = SamplesDevice.from_samples(host, device=device)
    return ds, mats, samples


def light_direction(cfg: VCTConfig, device="cuda") -> Tensor:
    """L = normalize(LightDirection) — fs:181."""
    l = G.constant(cfg.light.direction, device)
    return l / torch.sqrt(torch.sum(l * l))


def _march(cfg: VCTConfig, mips, dirs, schedule, works, **kw) -> Tensor:
    """One dense march (core/dense.directional_march_multi's), its work
    appended to `works` where that is a list."""
    plan = D.march_plan(mips, np.asarray(dirs, np.float64), schedule,
                        cfg.grid.world_size,
                        compute_dtype=shading.march_compute_dtype(cfg), **kw)
    walked = None
    if works is not None:
        walked = torch.empty(plan.shape + (plan.nb,), dtype=torch.int32,
                             device=mips[0].device)
    out = OD.dense_march(mips, plan, walked)
    if works is not None:
        works.append(OD.march_work(mips, plan, walked))
    return out


def build_voxel_state(cfg: VCTConfig, samples: SamplesDevice,
                      mats: MaterialTable,
                      q: Optional[Callable[[Tensor, str], Tensor]] = None,
                      works: Optional[List[Tuple[int, int]]] = None
                      ) -> VoxelState:
    """Voxelization + radiance injection + mip build + fields under
    cfg.light (volume shadows, two bounces, no sharding)."""
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
    # conservative (max-alpha) mips: shadow cones must not leak through
    # thin occluders diluted by mean reduction
    unlit_mips = tuple(q(m, "float32") for m in mip.build_mips(
        unlit, cfg.grid.num_levels, alpha_mode="max"))

    d = np.asarray(cfg.light.direction, np.float64)
    light_volume = q(_march(
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
    radiance_mips = tuple(q(m, "float32")
                          for m in mip.build_mips(lit, cfg.grid.num_levels))

    def field(schedule):
        return q(_march(cfg, radiance_mips,
                        D.direction_basis(cfg.cones.field_basis), schedule,
                        works, field_dim=shading.field_dim(cfg),
                        max_alpha=cfg.cones.max_alpha,
                        occlusion_falloff=cfg.cones.occlusion_falloff),
                 "bfloat16")

    diffuse_field = field(shading.diffuse_schedule(cfg))
    specular_field = None
    if cfg.cones.trace_specular and cfg.cones.specular_mode == "field":
        specular_field = field(shading.specular_field_schedule(cfg))
    return VoxelState(radiance_mips=radiance_mips, unlit_mips=unlit_mips,
                      light_volume=light_volume, diffuse_field=diffuse_field,
                      specular_field=specular_field)
