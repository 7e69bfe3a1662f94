"""The plain reference of an anisotropic configuration (grid.anisotropic
true) and its lower-precision control, through vctbench/spec.py's
interface.

It is the frozen reference (vctbench/reference/pipeline.py) with the
build's radiance pyramid replaced by the 6-direction pyramid of Crassin,
Neyret, Sainz, Green and Eisemann, "Interactive Indirect Illumination
Using Voxel Cone Tracing" (Pacific Graphics 2011), as the port builds it;
everything else (splats, the occupancy pyramid, the light volume, the
dense marches, the frame tables and the frame) is the frozen modules'.
Plain torch in float32, TF32 off; it loads nothing of vct_tpu_torch,
vct_tpu or jax.

The control (lower_precision=True) rounds every level of the 6-direction
pyramid to bfloat16 and back, as it rounds every other stage.
`march_work` counts the dense marches' 6-direction taps (the frozen
ops/dense.march_work on the 5-D levels); `pyramid_work` gives the
pyramid's (bytes, float operations) from its level shapes.

Where it departs from Crassin et al. 2011, as the port does:
  * a cone blends the six directional values by the squared components
    of its direction (d_i^2 on the side it travels toward, a partition of
    unity), where the paper interpolates the three directions that face
    the cone linearly by its direction;
  * only the radiance pyramid is anisotropic: the occupancy pyramid the
    light volume marches stays isotropic with the max of the children's
    alphas (shadow cones need conservative occupancy, not view-dependent
    radiance), where the paper's voxels are anisotropic throughout.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from vctbench.reference import pipeline as P
from vctbench.reference.render import fast as F
from vctbench.reference_aniso import aniso as A
from vctbench.reference_aniso import renderer as RA


class Reference(P.Reference):
    """The reference prepared for one anisotropic configuration."""

    def build(self, light=None,
              works: Optional[List[Tuple[int, int]]] = None) -> P.Built:
        """The voxel state, with the 6-direction radiance pyramid, and the
        frame tables under `light`, or the configuration's own."""
        cfg = self._cfg(light)
        with torch.no_grad():
            voxels = RA.build_voxel_state(cfg, self.samples, self.mats,
                                          q=self.q, works=works)
            tables = F.build_frame_tables(cfg, voxels, self.mats)
        return P.Built(cfg, voxels, tables)

    def pyramid_work(self) -> Tuple[int, int]:
        """(bytes, float operations) of one build's radiance pyramid,
        float32, counted from the shapes of its levels."""
        g = self.cfg.grid
        return A.pyramid_work(A.pyramid_shapes(
            g.dim, RA.RADIANCE_CHANNELS, g.num_levels))
