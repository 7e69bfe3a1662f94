"""The forward render step and the multi-rank dry run (port of
__graft_entry__.py).

entry(device) returns (forward, example_args): forward(origins, dirs,
cam_pos, samples, mats) is the whole forward pipeline (voxelize, shadow
volume, inject, mips, fields, then render_rays: raycast and the 6 + 1
cone march, combine) of __graft_entry__.entry on its tiny setup: preset
cornell64_full with a 32^3 grid (world 150), 64 x 64 rays from (0, 0,
140) on the Cornell box, render_rays in chunks of 1024.  JAX jits the
function; here it runs eagerly, and on the card the build launches the
mip kernel.  The example arguments lie on `device` (the card unless
the caller asks for the CPU).

dryrun_multichip(n) is parallel/tile_dp.dryrun_multichip, run inside
each of n ranks.
"""

from __future__ import annotations

import torch

from vct_tpu_torch.parallel.tile_dp import _tiny_setup, dryrun_multichip
from vct_tpu_torch.render import renderer as R

__all__ = ["entry", "dryrun_multichip"]

WIDTH, HEIGHT, DIM = 64, 64, 32     # __graft_entry__._tiny_setup's defaults
CHUNK = 1024                        # __graft_entry__.py:49


def entry(device="cuda"):
    """(forward, example_args) on `device`: __graft_entry__.entry's
    forward step and its arguments (origins, dirs, cam_pos, samples,
    mats)."""
    cfg, ds, mats, samples, origins, dirs, cam_pos = _tiny_setup(
        WIDTH, HEIGHT, DIM, torch.device(device))

    def forward(origins, dirs, cam_pos, samples, mats):
        voxels = R.build_voxel_state(cfg, samples, mats)
        return R.render_rays(cfg, ds, voxels, mats, origins, dirs, cam_pos,
                             chunk_size=CHUNK)

    return forward, (origins, dirs, cam_pos, samples, mats)
