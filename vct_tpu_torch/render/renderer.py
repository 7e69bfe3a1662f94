"""Scene prep, the voxel build and the camera pass (port of
vct_tpu/render/renderer.py:48-299, 577-612).

One `build_voxel_state`: splat albedo -> max-alpha occupancy mips ->
dense light-transmittance volume -> per-sample shadow -> splat radiance
-> radiance mips -> diffuse and specular basis fields.  PyTorch runs
eagerly, so the JAX package's staged-jit split has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from vct_tpu_torch.config import VCTConfig
from vct_tpu_torch.scene.mesh import Scene
from vct_tpu_torch.ops import mip
from vct_tpu_torch.render import shading
from vct_tpu_torch.render.gbuffer import DeviceScene
from vct_tpu_torch.render.voxelize import (SurfaceSamples,
                                           generate_surface_samples, splat)
from vct_tpu_torch.scene import textures as TX
from vct_tpu_torch.stages import mark

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
    """Radiance and unlit/occupancy pyramids, the light volume and the
    basis fields (the fields the fast path needs, in the JAX layout)."""

    radiance_mips: Tuple[Tensor, ...]
    unlit_mips: Tuple[Tensor, ...]
    light_volume: Optional[Tensor] = None      # (D, D, D, 1)
    diffuse_field: Optional[Tensor] = None     # (df, df, df, B*4)
    specular_field: Optional[Tensor] = None    # (df, df, df, B*4)


def prepare_scene(cfg: VCTConfig, scene: Scene,
                  samples: Optional[SamplesDevice] = None, device="cuda"):
    """Host-side prep: device geometry, material table, surface samples,
    all on `device`.

    Pass `samples` to reuse an existing SamplesDevice, for example for a
    subdivided copy of the same surfaces (scene/mesh.subdivide_scene),
    whose voxelization is the same by construction."""
    ds = DeviceScene.from_scene(scene, device=device)
    mats = MaterialTable.from_scene(scene, device=device)
    if samples is None:
        host = generate_surface_samples(scene, cfg.grid.voxel_world_size,
                                        cfg.voxelize.samples_per_voxel_width)
        samples = SamplesDevice.from_samples(host, device=device)
    return ds, mats, samples


def light_direction(cfg: VCTConfig, device="cuda") -> Tensor:
    """L = normalize(LightDirection) — fs:181."""
    l = torch.as_tensor(cfg.light.direction, dtype=torch.float32,
                        device=device)
    return l / torch.sqrt(torch.sum(l * l))


def build_voxel_state(cfg: VCTConfig, samples: SamplesDevice,
                      mats: MaterialTable) -> VoxelState:
    """Voxelization + radiance injection + mip build + fields.

    Supports what the fast path needs: volume shadows, isotropic mips,
    two-bounce GI (the reference's), field-mode cones."""
    if cfg.shadow.mode != "volume":
        raise NotImplementedError(
            f"shadow mode {cfg.shadow.mode!r} is not ported: ROADMAP Queue "
            "1 item 8 (shadow map, per-cone oracle renderer)")
    if cfg.grid.anisotropic:
        raise NotImplementedError(
            "anisotropic mips are not ported: ROADMAP Queue 1 item 8 "
            "(core/aniso.py)")
    if cfg.light.gi_bounces > 2:
        raise NotImplementedError(
            "extra GI bounces need the per-sample cone gather: ROADMAP "
            "Queue 1 item 8 (per-cone oracle renderer)")
    dim, ws = cfg.grid.dim, cfg.grid.world_size
    albedo = mats.sample_albedo(samples.material_ids, samples.uvs)
    emissive = mats.emissive[samples.material_ids.long()]
    weights = torch.ones(samples.positions.shape[0], dtype=albedo.dtype,
                         device=albedo.device)
    light_color = torch.as_tensor(cfg.light.color, dtype=torch.float32,
                                  device=albedo.device)

    unlit = splat(samples.positions, albedo[:, :3], weights, dim, ws,
                  mode=cfg.voxelize.mode)
    mark("albedo_splat")
    # conservative (max-alpha) mips: shadow cones must not leak through
    # thin occluders diluted by mean reduction
    unlit_mips = mip.build_mips(unlit, cfg.grid.num_levels, alpha_mode="max")
    mark("occupancy_mips")

    light_volume = shading.build_light_volume(cfg, unlit_mips)
    mark("light_volume")
    shadow = shading.shadow_volume_tap_packed(
        cfg, shading.pack_light_corners(light_volume), dim,
        samples.positions, samples.normals)
    radiance = albedo[:, :3] * light_color * shadow[:, None] + emissive
    lit = splat(samples.positions, radiance, weights, dim, ws,
                mode=cfg.voxelize.mode)
    mark("shadow_and_radiance_splat")
    radiance_mips = mip.build_mips(lit, cfg.grid.num_levels)
    mark("radiance_mips")

    diffuse_field = specular_field = None
    if cfg.cones.diffuse_mode == "field":
        diffuse_field = shading.build_cone_field(
            cfg, radiance_mips, shading.diffuse_schedule(cfg))
        mark("diffuse_field")
    if cfg.cones.trace_specular and cfg.cones.specular_mode == "field":
        specular_field = shading.build_cone_field(
            cfg, radiance_mips, shading.specular_field_schedule(cfg))
        mark("specular_field")
    return VoxelState(radiance_mips=radiance_mips, unlit_mips=unlit_mips,
                      light_volume=light_volume, diffuse_field=diffuse_field,
                      specular_field=specular_field)


def use_fast_path(cfg: VCTConfig) -> bool:
    """Does the camera pass route through render/fast.py?  On this port
    the fast path is the only camera pass; it runs its kernels on CUDA
    tensors and their plain versions on CPU tensors."""
    from vct_tpu_torch.render import fast as F
    return cfg.use_pallas and F.supported(cfg)


def render_camera_pass(
    cfg: VCTConfig,
    ds: DeviceScene,
    voxels: VoxelState,
    mats: MaterialTable,
    origins: Tensor,
    dirs: Tensor,
    camera_position: Tensor,
    light_dir: Optional[Tensor] = None,
    frame_tables=None,
) -> Tensor:
    """The per-frame camera pass -> (H, W, 3) linear RGB.

    frame_tables: pass fast.build_frame_tables(cfg, voxels, mats) to
    amortize the table build across frames; None builds them inline."""
    if not use_fast_path(cfg):
        raise NotImplementedError(
            "this config needs the per-cone oracle renderer (render_rays), "
            "which is not ported: ROADMAP Queue 1 item 8")
    from vct_tpu_torch.render import fast as F
    if frame_tables is None:
        frame_tables = F.build_frame_tables(cfg, voxels, mats)
    return F.render_frame(cfg, ds, frame_tables, mats, origins, dirs,
                          camera_position, light_dir)
