"""Scene prep, the voxel build, the per-cone oracle renderer and the
camera pass (port of vct_tpu/render/renderer.py).

One `build_voxel_state`: splat albedo -> max-alpha occupancy mips ->
per-sample shadow (dense light-transmittance volume, a shadow cone per
sample, or the rasterized shadow map and its PCF) -> splat radiance ->
radiance mips (isotropic, or the anisotropic 6-direction pyramid) ->
extra GI bounces -> diffuse and specular basis fields where the cone
modes need them.
PyTorch runs eagerly, so the JAX package's staged-jit split has no
counterpart.

The camera pass takes the fast path (render/fast.py, the hand-written
kernels) where `use_fast_path` allows, and otherwise the per-cone oracle
`render_rays`: raycast, alpha-mask re-cast and shading per chunk of
rays, all in plain PyTorch on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from vct_tpu_torch.config import VCTConfig
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.core import cones as C
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.scene.mesh import Scene
from vct_tpu_torch.ops import aniso as OA
from vct_tpu_torch.ops import mip
from vct_tpu_torch.render import shading
from vct_tpu_torch.render import shadowmap as SM
from vct_tpu_torch.render.gbuffer import (DeviceScene, GBuffer, map_gbuffer,
                                          pinhole_constants, raycast_chunk,
                                          raycast_chunk_pinhole)
from vct_tpu_torch.render.voxelize import (SurfaceSamples,
                                           generate_surface_samples, splat)
from vct_tpu_torch.scene import textures as TX
from vct_tpu_torch.stages import span

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
    l = G.constant(cfg.light.direction, device)
    return l / torch.sqrt(torch.sum(l * l))


def sample_indirect_diffuse(cfg: VCTConfig, radiance_mips,
                            positions: Tensor, normals: Tensor, mesh=None
                            ) -> Tuple[Tensor, Tensor]:
    """The K-cone indirect-diffuse gather at surface points through the
    current radiance pyramid, for bounces past the reference's two
    (README.md:14).  Cone frames come from a stable ONB around the face
    normal.  Returns (rgb (S, 3), occlusion (S,))."""
    t, bt = C.orthonormal_frame(normals)
    cone_dirs = shading.pixel_cone_dirs(cfg, normals, t, bt)
    if cfg.cones.diffuse_mode == "field":
        field = shading.build_cone_field(cfg, radiance_mips,
                                         shading.diffuse_schedule(cfg),
                                         mesh=mesh)
        return shading.indirect_diffuse_field(cfg, field, positions,
                                              normals, cone_dirs)
    return shading.indirect_diffuse_percone(cfg, radiance_mips, positions,
                                            normals, cone_dirs)


def _inject_bounce(cfg: VCTConfig, samples: SamplesDevice,
                   albedo_rgb: Tensor, direct_radiance: Tensor,
                   weights: Tensor, radiance_mips, mesh=None,
                   reduce=None) -> Tuple[Tensor, ...]:
    """One extra GI bounce: gather indirect at every surface sample, add
    the Lambertian re-emission albedo * occlusion * indirect (fs:205 at
    the voxel sample), re-splat and rebuild the mips.  reduce: the
    sharded build's partial-grid reduce (voxelize.splat)."""
    ind_rgb, ind_occ = sample_indirect_diffuse(
        cfg, radiance_mips, samples.positions, samples.normals, mesh=mesh)
    bounce = albedo_rgb * (1.0 - ind_occ)[:, None] * ind_rgb
    lit = splat(samples.positions, direct_radiance + bounce, weights,
                cfg.grid.dim, cfg.grid.world_size, mode=cfg.voxelize.mode,
                reduce=reduce)
    return _radiance_mips(cfg, lit)


def _radiance_mips(cfg: VCTConfig, lit: Tensor) -> Tuple[Tensor, ...]:
    """The radiance pyramid: the anisotropic 6-direction pre-integrations
    when cfg.grid.anisotropic (core/aniso.py; ops/aniso.py's kernel on
    the card, inside the unmarked span `aniso_mips`), else isotropic box
    mips (glGenerateMipmap, Voxel_Cone_Tracing.h:248).  The unlit pyramid
    stays isotropic with max alpha either way: shadow cones need
    occupancy, not view-dependent radiance."""
    if cfg.grid.anisotropic:
        with span("aniso_mips", mark=False):
            return OA.build_aniso_mips(lit, cfg.grid.num_levels)
    return mip.build_mips(lit, cfg.grid.num_levels)


def build_voxel_state(cfg: VCTConfig, samples: SamplesDevice,
                      mats: MaterialTable,
                      light_dir: Optional[Tensor] = None,
                      light_color: Optional[Tensor] = None,
                      mesh=None) -> VoxelState:
    """Voxelization + radiance injection + mip build + fields.

    Shadows come from the dense light volume (shadow mode "volume"), a
    shadow cone per sample ("percone"), toward the config's light, or the
    rasterized shadow map and its PCF ("map", divided by 25 as the
    reference's voxelize pass does, Voxelization.fs:46).  light_dir (3,),
    normalized toward the light, replaces cfg.light.direction in the
    per-sample shadow cones (shadow mode "percone"; the light volume and
    the map take the config's, as in the JAX package).  light_color (3,)
    replaces cfg.light.color in the radiance injection (the inverse loop's
    "light" parameter).  light.gi_bounces > 2 re-gathers and re-injects
    once per extra bounce.

    With cfg.sharding.brick_parallel > 1 pass the ('data', 'model') mesh
    (parallel/mesh.py), on every rank with the whole sample set: each
    rank splats its share of the samples over 'model' and the partial
    grids (and the shadow map) are reduced over it before the finish,
    and the dense marches run brick-sharded along x; every rank returns
    the whole state."""
    with span("build", mark=False):
        return _build_voxel_state(cfg, samples, mats, light_dir, light_color,
                                  mesh)


def _build_voxel_state(cfg, samples, mats, light_dir, light_color, mesh):
    dim, ws = cfg.grid.dim, cfg.grid.world_size
    with span("albedo_splat"):
        reduce = None
        if shading._use_brick_sharding(cfg, mesh):
            from vct_tpu_torch.parallel import comm
            from vct_tpu_torch.parallel.mesh import local_samples
            samples = local_samples(samples, mesh, cfg.sharding.model_axis)
            reduce = comm.reducer(comm.axis(mesh, cfg.sharding.model_axis))
        dev = samples.positions.device
        if light_dir is None:
            light_dir = light_direction(cfg, dev)
        if light_color is None:
            light_color = G.constant(cfg.light.color, dev)
        albedo = mats.sample_albedo(samples.material_ids, samples.uvs)
        emissive = mats.emissive[samples.material_ids.long()]
        weights = torch.ones(samples.positions.shape[0], dtype=albedo.dtype,
                             device=dev)
        unlit = splat(samples.positions, albedo[:, :3], weights, dim, ws,
                      mode=cfg.voxelize.mode, reduce=reduce)
    # conservative (max-alpha) mips: shadow cones must not leak through
    # thin occluders diluted by mean reduction
    with span("occupancy_mips"):
        unlit_mips = mip.build_mips(unlit, cfg.grid.num_levels,
                                    alpha_mode="max")

    light_volume = shadow_map = None
    mode = cfg.shadow.mode
    if mode == "volume":
        with span("light_volume"):
            light_volume = shading.build_light_volume(cfg, unlit_mips,
                                                      mesh=mesh)
    elif mode == "map":
        with span("shadow_map"):
            shadow_map = SM.build_shadow_map(cfg, samples.positions)
            if reduce is not None:     # a min is exact in any order
                shadow_map = reduce(shadow_map, "min")
    else:
        with span("shadow_cones"):
            shadow = shading.shadow_cone_value(
                unlit_mips, samples.positions, samples.normals, light_dir,
                shading.shadow_schedule(cfg), cfg)
    with span("shadow_and_radiance_splat"):
        if mode == "volume":
            shadow = shading.shadow_volume_tap_packed(
                cfg, shading.pack_light_corners(light_volume), dim,
                samples.positions, samples.normals)
        elif mode == "map":
            shadow = SM.pcf_shadow(cfg, shadow_map, samples.positions,
                                   normalization="voxelize")
        radiance = albedo[:, :3] * light_color * shadow[:, None] + emissive
        lit = splat(samples.positions, radiance, weights, dim, ws,
                    mode=cfg.voxelize.mode, reduce=reduce)
    with span("radiance_mips"):
        radiance_mips = _radiance_mips(cfg, lit)
    for _ in range(max(0, cfg.light.gi_bounces - 2)):
        with span("bounce"):
            radiance_mips = _inject_bounce(cfg, samples, albedo[:, :3],
                                           radiance, weights, radiance_mips,
                                           mesh=mesh, reduce=reduce)

    diffuse_field = specular_field = None
    if cfg.cones.diffuse_mode == "field":
        with span("diffuse_field"):
            diffuse_field = shading.build_cone_field(
                cfg, radiance_mips, shading.diffuse_schedule(cfg), mesh=mesh)
    if cfg.cones.trace_specular and cfg.cones.specular_mode == "field":
        with span("specular_field"):
            specular_field = shading.build_cone_field(
                cfg, radiance_mips, shading.specular_field_schedule(cfg),
                mesh=mesh)
    return VoxelState(radiance_mips=radiance_mips, unlit_mips=unlit_mips,
                      light_volume=light_volume, diffuse_field=diffuse_field,
                      specular_field=specular_field, shadow_map=shadow_map)


def shade_gbuffer(cfg: VCTConfig, voxels: VoxelState, gbuf: GBuffer,
                  mats: MaterialTable, camera_position: Tensor,
                  light_dir: Optional[Tensor] = None) -> Tensor:
    """The fragment stage: G-buffer -> linear RGB (..., 3).

    Marked spans split it: `oracle_surface` (material, bump normal, shadow
    and eye), then, each only where its cone mode is "percone",
    `percone_diffuse` and `percone_specular` (the cone marches; the stage
    between two marks also holds the cone axes); the caller's span closes
    with the combine."""
    if light_dir is None:
        light_dir = light_direction(cfg, gbuf.position.device)
    with span("oracle_surface"):
        albedo4 = mats.sample_albedo(gbuf.material, gbuf.uv)
        spec = shading.spec_gray_fallback(
            mats.sample_specular(gbuf.material, gbuf.uv))
        # shading normal: bump-mapped when a texture atlas is present
        # (N = CalcBumpNormal(TBN), fs:177); cone TBN keeps the vertex frame
        if mats.atlas is not None:
            shade_normal = TX.bump_normal(mats.atlas, gbuf.material, gbuf.uv,
                                          gbuf.tangent, gbuf.bitangent,
                                          gbuf.normal)
        else:
            shade_normal = gbuf.normal

        if cfg.shadow.mode == "volume":
            shadow = shading.shadow_volume_tap(cfg, voxels.light_volume,
                                               gbuf.position, gbuf.geo_normal)
        elif cfg.shadow.mode == "map":
            # the main pass's PCF: the /9 quirk under "reference" (fs:158)
            shadow = SM.pcf_shadow(cfg, voxels.shadow_map, gbuf.position,
                                   normalization="main")
        else:
            shadow = shading.shadow_cone_value(
                voxels.unlit_mips, gbuf.position, gbuf.geo_normal, light_dir,
                shading.shadow_schedule(cfg), cfg)
        eye = C.normalize(camera_position - gbuf.position)      # fs:183

    cone_dirs = shading.pixel_cone_dirs(cfg, gbuf.normal, gbuf.tangent,
                                        gbuf.bitangent)
    if cfg.cones.diffuse_mode == "field":
        ind_d_rgb, ind_d_occ = shading.indirect_diffuse_field(
            cfg, voxels.diffuse_field, gbuf.position, gbuf.normal, cone_dirs)
    else:
        with span("percone_diffuse"):
            ind_d_rgb, ind_d_occ = shading.indirect_diffuse_percone(
                cfg, voxels.radiance_mips, gbuf.position, gbuf.normal,
                cone_dirs)

    if cfg.cones.trace_specular:
        refl = shading.reflect_eye(shade_normal, eye)   # reflect(-E, N)
        if cfg.cones.specular_mode == "field":
            ind_s_rgb, ind_s_occ = shading.indirect_specular_field(
                cfg, voxels.specular_field, gbuf.position, gbuf.normal, refl)
        else:
            with span("percone_specular"):
                ind_s_rgb, ind_s_occ = shading.indirect_specular_percone(
                    cfg, voxels.radiance_mips, gbuf.position, gbuf.normal,
                    refl)
    else:
        ind_s_rgb = torch.zeros_like(ind_d_rgb)
        ind_s_occ = torch.zeros_like(ind_d_occ)

    rgb = shading.combine(
        cfg, albedo=albedo4[..., :3], spec_color=spec, normal=shade_normal,
        light_dir=light_dir, eye_dir=eye, shadow=shadow,
        ind_diffuse_rgb=ind_d_rgb, ind_diffuse_occ=ind_d_occ,
        ind_spec_rgb=ind_s_rgb, ind_spec_occ=ind_s_occ,
        shininess=mats.shininess[gbuf.material.long()])
    # alpha-mask discard (fs:169-172) + miss -> background
    bg = G.constant(cfg.render.background, rgb.device, rgb.dtype)
    visible = gbuf.hit & (albedo4[..., 3] >= cfg.render.alpha_threshold)
    return torch.where(visible[..., None], rgb, bg)


def alpha_mask_recast(cfg: VCTConfig, ds: DeviceScene, pc, origin0: Tensor,
                      dc: Tensor, gbuf: GBuffer,
                      mats: MaterialTable) -> GBuffer:
    """Alpha-mask see-through (fs:169-172): a discarded fragment shows the
    surface behind it, so rays whose hit's albedo alpha is below the
    threshold are re-cast with a per-ray tmin just past the hit, a fixed
    cfg.render.alpha_mask_depth times (deeper masked stacks fall back to
    the background).  Only with a texture atlas: the reference reads
    alpha from DiffuseTexture (fs:167)."""
    depth = cfg.render.alpha_mask_depth
    if depth <= 0 or mats.atlas is None:
        return gbuf
    thresh = cfg.render.alpha_threshold
    for _ in range(depth):
        alpha = mats.sample_albedo(gbuf.material, gbuf.uv)[..., 3]
        masked = gbuf.hit & (alpha < thresh)
        # epsilon relative and absolute, so that the same surface (t
        # within float rounding) cannot win again
        tmin = torch.where(masked, gbuf.t * (1.0 + 1e-5) + 1e-4, -1.0)
        g2 = raycast_chunk_pinhole(ds, pc, origin0, dc, tmin=tmin)

        def pick(a, b):
            m = masked.reshape(masked.shape + (1,) * (a.dim() - 1))
            return torch.where(m, b, a)

        gbuf = map_gbuffer(pick, gbuf, g2)
    return gbuf


def render_rays(cfg: VCTConfig, ds: DeviceScene, voxels: VoxelState,
                mats: MaterialTable, origins: Tensor, dirs: Tensor,
                camera_position: Tensor, light_dir: Optional[Tensor] = None,
                chunk_size: int = 4096, pinhole: bool = True) -> Tensor:
    """The per-cone oracle: raycast + alpha re-cast + shade per chunk of
    `chunk_size` rays, so that the G-buffer and the cone samples stay
    chunk-sized.  Rays pad to whole chunks (origins 0, directions 1), as
    the JAX package's lax.map does.  pinhole=True (camera rays, all from
    origins[0]) takes the matmul raycast; False the general one, without
    the alpha re-cast.  No step reads a value back to the host.
    Returns origins.shape[:-1] + (3,) linear RGB."""
    shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    n = o.shape[0]
    pad = (-n) % chunk_size
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, d.new_ones((pad, 3))])
    if light_dir is None:
        light_dir = light_direction(cfg, d.device)
    if pinhole:
        origin0 = o[0]
        pc = pinhole_constants(ds, origin0)
    out = []
    for s in range(0, n + pad, chunk_size):
        dc = d[s:s + chunk_size]
        with span("raycast"):
            if pinhole:
                gbuf = raycast_chunk_pinhole(ds, pc, origin0, dc)
            else:
                gbuf = raycast_chunk(ds, o[s:s + chunk_size], dc)
        if pinhole:
            with span("alpha_recast"):
                gbuf = alpha_mask_recast(cfg, ds, pc, origin0, dc, gbuf,
                                         mats)
        with span("shade"):
            out.append(shade_gbuffer(cfg, voxels, gbuf, mats,
                                     camera_position, light_dir))
    return torch.cat(out)[:n].reshape(shape + (3,))


def use_fast_path(cfg: VCTConfig) -> bool:
    """Does the camera pass route through render/fast.py?  The same rule
    on every device: the fast path runs its kernels on CUDA tensors and
    their plain versions on CPU tensors."""
    from vct_tpu_torch.render import fast as F
    return cfg.use_pallas and F.supported(cfg)


# camera rays a render_rays chunk: a chunk's work is a few thousand
# kernel launches whatever its size, so the per-cone frame at 512x512
# (262,144 rays) is host-bound in chunks of 16,384 (66-75% of the device
# idle on an H100) and its time follows the host's load; in chunks of
# 65,536 the device has more work than the host has launches
CAMERA_CHUNK = 65536


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
    chunk_size: int = CAMERA_CHUNK,
) -> Tensor:
    """The per-frame camera pass -> (H, W, 3) linear RGB: the fast path
    where use_fast_path allows, else render_rays in chunks of chunk_size
    rays, or of the frame's rays where it has fewer.

    frame_tables: pass fast.build_frame_tables(cfg, voxels, mats) to
    amortize the table build across frames; None builds them inline."""
    if not use_fast_path(cfg):
        n = origins[..., 0].numel()
        return render_rays(cfg, ds, voxels, mats, origins, dirs,
                           camera_position, light_dir,
                           chunk_size=min(chunk_size, n))
    from vct_tpu_torch.render import fast as F
    if frame_tables is None:
        frame_tables = F.build_frame_tables(cfg, voxels, mats)
    return F.render_frame(cfg, ds, frame_tables, mats, origins, dirs,
                          camera_position, light_dir)


def render_image(cfg: VCTConfig, scene: Scene,
                 camera: Optional[CAM.Camera] = None,
                 device="cuda") -> Tensor:
    """One shot: prepare, voxelize, render -> (H, W, 3) on `device`."""
    if camera is None:
        camera = CAM.Camera()
    ds, mats, samples = prepare_scene(cfg, scene, device=device)
    origins, dirs = CAM.primary_rays(camera, cfg.render.width,
                                     cfg.render.height, device=device)
    voxels = build_voxel_state(cfg, samples, mats)
    return render_camera_pass(cfg, ds, voxels, mats, origins, dirs,
                              G.constant(camera.position, device))
