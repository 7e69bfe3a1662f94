"""The system under test: vct_tpu_torch, driven through its public entry
points.  This is the only module of the benchmark that imports the
program, and it imports nothing else of it than the configuration and
scene types, `render/renderer`, `render/fast.build_frame_tables` and the
stage hook (`stages.MARK`).

A step of the program under a light is `build_voxel_state`, then, where
the configuration takes the fast path (`renderer.use_fast_path`),
`build_frame_tables`; a frame is `render_camera_pass` with those tables,
on rays the benchmark made.  Off the fast path (anisotropic mips with
per-cone specular, per-cone diffuse, the shadow map or shadow cones)
there are no tables, and `render_camera_pass` routes to the per-cone
oracle (`render_rays`), as the port does on its own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from vct_tpu_torch import stages
from vct_tpu_torch import config as PC
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.scene import mesh as PM


def port_config(tree: dict) -> PC.VCTConfig:
    """The port's VCTConfig from a configuration file's `config` tree
    (every field of every group; lists become tuples)."""
    def group(cls, d):
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items()})

    kinds = {"grid": PC.GridConfig, "cones": PC.ConeSetConfig,
             "light": PC.LightConfig, "shadow": PC.ShadowConfig,
             "render": PC.RenderConfig, "voxelize": PC.VoxelizeConfig,
             "sharding": PC.ShardingConfig}
    return PC.VCTConfig(**{k: group(kinds[k], v) if k in kinds else v
                           for k, v in tree.items()})


def port_scene(scene) -> PM.Scene:
    """The port's Scene (and Material) holding the benchmark's arrays."""
    mats = [PM.Material(**dataclasses.asdict(m)) for m in scene.materials]
    return PM.Scene(positions=scene.positions, normals=scene.normals,
                    uvs=scene.uvs, tangents=scene.tangents,
                    bitangents=scene.bitangents, indices=scene.indices,
                    tri_material=scene.tri_material, materials=mats)


class State(NamedTuple):
    """What a build under one light leaves for the frames."""

    cfg: PC.VCTConfig
    voxels: R.VoxelState
    tables: Optional[F.FrameTables]      # None off the fast path


class Program:
    """The port prepared for one configuration: the voxel build's scene
    (surface samples and materials) and the frame's geometry."""

    def __init__(self, config: dict, scene_base, scene_frame, device):
        self.cfg = port_config(config)
        dev = torch.device(device)
        _, self.mats, self.samples = R.prepare_scene(
            self.cfg, port_scene(scene_base), device=dev)
        # the same surfaces in more triangles: the base scene's samples
        self.ds, _, _ = R.prepare_scene(self.cfg, port_scene(scene_frame),
                                        samples=self.samples, device=dev)
        self.mark: Callable[[str], None] = lambda name: None

    def set_marks(self, record: Optional[Callable[[str], None]]) -> None:
        """Record `record(name)` at every stage mark of the program and at
        the benchmark's own ("frame_tables", on the fast path); None turns
        them off."""
        stages.MARK = record
        self.mark = record or (lambda name: None)

    def build(self, light=None) -> State:
        """The voxel state, and on the fast path the frame tables, under
        `light` (toward the light, (3,)), or the configuration's own
        light."""
        cfg = self.cfg
        if light is not None:
            cfg = dataclasses.replace(cfg, light=dataclasses.replace(
                cfg.light, direction=tuple(float(x) for x in light)))
        voxels = R.build_voxel_state(cfg, self.samples, self.mats)
        tables = None
        if R.use_fast_path(cfg):
            tables = F.build_frame_tables(cfg, voxels, self.mats)
            self.mark("frame_tables")
        return State(cfg, voxels, tables)

    def frame(self, state: State, origins, dirs, position) -> torch.Tensor:
        """One camera pass -> (H, W, 3) linear RGB: the fast frame with the
        state's tables, or without them the per-cone oracle."""
        return R.render_camera_pass(state.cfg, self.ds, state.voxels,
                                    self.mats, origins, dirs, position,
                                    frame_tables=state.tables)
