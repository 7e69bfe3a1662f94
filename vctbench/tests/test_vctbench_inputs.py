"""The frozen inputs against today's program: the atrium's arrays,
materials and textures, and its subdivision, bit for bit against
vct_tpu_torch.scene; the rays against the port's primary_rays."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.scene.atrium import atrium as port_atrium
from vct_tpu_torch.scene.mesh import subdivide_scene as port_subdivide
from vctbench.inputs import scene as S
from vctbench.inputs import traffic as T

ARRAYS = ("positions", "normals", "uvs", "tangents", "bitangents",
          "indices", "tri_material")


def _same_scene(a, b):
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert len(a.materials) == len(b.materials)
    for ma, mb in zip(a.materials, b.materials):
        for f in dataclasses.fields(ma):
            x, y = getattr(ma, f.name), getattr(mb, f.name)
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                assert np.array_equal(x, y), (ma.name, f.name)
            else:
                assert x == y, (ma.name, f.name)


@pytest.mark.parametrize("levels", [0, 1, 2])
def test_atrium_and_subdivision_equal_the_ports(levels):
    ours = S.subdivide_scene(S.atrium(), levels)
    theirs = port_subdivide(port_atrium(), levels)
    _same_scene(ours, theirs)
    assert ours.num_triangles == 1122 * 4 ** levels


def test_frame_scene_is_287k_triangles():
    assert S.subdivide_scene(S.atrium(), 4).num_triangles == 287_232


@pytest.mark.parametrize("pose", [((48.0, -10.0, 0.0), 180.0, 0.0),
                                  ((-20.0, -10.0, 12.0), 37.5, 17.0),
                                  ((5.0, -10.0, -9.0), 301.0, -19.5)])
def test_rays_match_the_ports_primary_rays(pose):
    pos, yaw, pitch = pose
    paths = T.Paths(position=np.array([pos]), yaw=np.array([yaw]),
                    pitch=np.array([pitch]), light=None, rebuild_every=0)
    rm = T.RayMaker(96, 64, 45.0, "cpu")
    o, d, p = rm.rays(rm.basis(paths)[0])
    po, pd = CAM.primary_rays(CAM.Camera(position=pos, yaw=yaw, pitch=pitch),
                              96, 64, device="cpu")
    assert torch.equal(o, po) and torch.equal(p, po[0, 0])
    assert float((d - pd).abs().max()) <= 1e-7
