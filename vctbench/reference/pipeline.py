"""The plain reference the benchmark holds the program to, and its
lower-precision control.

Everything under vctbench/reference is a frozen copy of the port's plain
PyTorch versions (its ops' `*_plain` paths, the eager build, the fast
frame's glue), with imports of the benchmark only: no kernel, nothing of
vct_tpu_torch, vct_tpu or jax.  Each module copies the port's module of
the same path, cut to what the plain path uses: the kernel routes, the
backward passes and the oracle are taken out, and where a docstring
still speaks of a kernel, the entry point now calls the plain version,
on the card as on the CPU.  The reference works out again everything the
program derives from the benchmark's inputs: the surface samples, the
voxel state, the frame tables, the G-buffer and the image.

The control (`lower=True`) is the same reference with what each stage
hands on rounded one precision down from what the configuration states:
what it computes in float32 through bfloat16 (the splats, the pyramids,
the G-buffer after the raycast and after the alpha re-cast, the image),
and the dense marches it computes in bfloat16 through float8 e4m3.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch

from vctbench.reference import config as RC
from vctbench.reference.render import fast as F
from vctbench.reference.render import renderer as R

LOWER = {"float32": torch.bfloat16, "bfloat16": torch.float8_e4m3fn}


def config_from_tree(tree: dict) -> RC.VCTConfig:
    """The reference's VCTConfig from a configuration file's `config`
    tree (lists become tuples)."""
    def group(cls, d):
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items()})

    kinds = {"grid": RC.GridConfig, "cones": RC.ConeSetConfig,
             "light": RC.LightConfig, "shadow": RC.ShadowConfig,
             "render": RC.RenderConfig, "voxelize": RC.VoxelizeConfig,
             "sharding": RC.ShardingConfig}
    return RC.VCTConfig(**{k: group(kinds[k], v) if k in kinds else v
                           for k, v in tree.items()})


def lower(x: torch.Tensor, stated: str) -> torch.Tensor:
    """x rounded to the precision below `stated` and back."""
    if not x.is_floating_point():
        return x
    return x.to(LOWER[stated]).to(x.dtype)


class Built(NamedTuple):
    cfg: RC.VCTConfig
    voxels: R.VoxelState
    tables: F.FrameTables


class Reference:
    """The reference prepared for one configuration, on `device`."""

    def __init__(self, config: dict, scene_base, scene_frame, device,
                 lower_precision: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = config_from_tree(config)
        self.q = lower if lower_precision else None
        dev = torch.device(device)
        with torch.no_grad():
            _, self.mats, self.samples = R.prepare_scene(
                self.cfg, scene_base, device=dev)
            self.ds, _, _ = R.prepare_scene(self.cfg, scene_frame,
                                            samples=self.samples, device=dev)

    def _cfg(self, light) -> RC.VCTConfig:
        if light is None:
            return self.cfg
        return dataclasses.replace(self.cfg, light=dataclasses.replace(
            self.cfg.light, direction=tuple(float(x) for x in light)))

    def build(self, light=None,
              works: Optional[List[Tuple[int, int]]] = None) -> Built:
        """The voxel state and frame tables under `light`, or the
        configuration's own."""
        cfg = self._cfg(light)
        with torch.no_grad():
            voxels = R.build_voxel_state(cfg, self.samples, self.mats,
                                         q=self.q, works=works)
            tables = F.build_frame_tables(cfg, voxels, self.mats)
        return Built(cfg, voxels, tables)

    def frame(self, built: Built, origins, dirs, position) -> torch.Tensor:
        with torch.no_grad():
            return F.render_frame(built.cfg, self.ds, built.tables,
                                  self.mats, origins, dirs, position,
                                  q=self.q)

    def march_work(self, light) -> List[Tuple[int, int]]:
        """(bytes, float operations) of each dense march of a build under
        `light`, counted from the steps its cells take."""
        works: List[Tuple[int, int]] = []
        self.build(light, works=works)
        return works

