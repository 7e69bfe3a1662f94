"""Procedural Cornell box — the config-1 test scene (BASELINE.json).

The reference ships no small scene (it hard-codes a Sponza path,
Voxel_Cone_Tracing.h:77); the Cornell box is the standard stand-in for
unit/integration tests: colored side walls make bounce bleeding visible.

A copy of vct_tpu/scene/cornell.py: the port keeps its own host modules and
imports nothing of the JAX package; tests/test_torch_scene.py pins its
arrays bit for bit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from vct_tpu_torch.scene.mesh import Material, Scene, scene_from_arrays


def _quad(a, b, c, d):
    """Two triangles for quad corners given counter-clockwise (outward)."""
    return [(a, b, c), (a, c, d)]


def cornell_box(size: float = 100.0, with_blocks: bool = True,
                ceiling_hole: float = 0.4) -> Scene:
    """Cornell box centered at the origin, open toward +z (camera side).

    Interior extent [-s/2, s/2]^3. Normals face inward. Materials:
    0 white, 1 red (left/-x), 2 green (right/+x).

    ceiling_hole > 0 leaves a central square opening (that fraction of the
    side) in the ceiling so the directional light (default (0,1,0.25), i.e.
    from above) enters the box — the light-path analogue of the reference's
    sun-through-the-atrium Sponza setup.
    """
    h = size / 2.0
    v: List[Tuple[float, float, float]] = []
    tris: List[Tuple[int, int, int]] = []
    mats: List[int] = []

    def add_quad(corners, mat):
        base = len(v)
        v.extend(corners)
        for t in _quad(base, base + 1, base + 2, base + 3):
            tris.append(t)
            mats.append(mat)

    # floor (y=-h, normal +y)
    add_quad([(-h, -h, -h), (-h, -h, h), (h, -h, h), (h, -h, -h)], 0)
    # ceiling (y=+h, normal -y) — 4 strips around an optional central hole
    if ceiling_hole > 0.0:
        g = ceiling_hole * h
        add_quad([(-h, h, -h), (h, h, -h), (h, h, -g), (-h, h, -g)], 0)
        add_quad([(-h, h, g), (h, h, g), (h, h, h), (-h, h, h)], 0)
        add_quad([(-h, h, -g), (-g, h, -g), (-g, h, g), (-h, h, g)], 0)
        add_quad([(g, h, -g), (h, h, -g), (h, h, g), (g, h, g)], 0)
    else:
        add_quad([(-h, h, -h), (h, h, -h), (h, h, h), (-h, h, h)], 0)
    # back wall (z=-h, normal +z)
    add_quad([(-h, -h, -h), (h, -h, -h), (h, h, -h), (-h, h, -h)], 0)
    # left wall (x=-h, normal +x) — red
    add_quad([(-h, -h, h), (-h, -h, -h), (-h, h, -h), (-h, h, h)], 1)
    # right wall (x=+h, normal -x) — green
    add_quad([(h, -h, -h), (h, -h, h), (h, h, h), (h, h, -h)], 2)

    if with_blocks:
        def add_box(center, dims, mat):
            cx, cy, cz = center
            dx, dy, dz = dims[0] / 2, dims[1] / 2, dims[2] / 2
            # 6 faces, outward normals
            x0, x1 = cx - dx, cx + dx
            y0, y1 = cy - dy, cy + dy
            z0, z1 = cz - dz, cz + dz
            add_quad([(x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)], mat)  # +z
            add_quad([(x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0)], mat)  # -z
            add_quad([(x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1)], mat)  # +x
            add_quad([(x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)], mat)  # -x
            add_quad([(x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0)], mat)  # +y
            add_quad([(x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)], mat)  # -y

        add_box((-0.18 * size, -h + 0.3 * size, -0.15 * size),
                (0.3 * size, 0.6 * size, 0.3 * size), 0)   # tall block
        add_box((0.2 * size, -h + 0.15 * size, 0.15 * size),
                (0.3 * size, 0.3 * size, 0.3 * size), 0)   # short block

    materials = [
        Material(name="white", albedo=(0.73, 0.73, 0.73, 1.0),
                 specular=(0.2, 0.2, 0.2)),
        Material(name="red", albedo=(0.65, 0.05, 0.05, 1.0)),
        Material(name="green", albedo=(0.12, 0.45, 0.15, 1.0)),
    ]
    positions = np.asarray(v, np.float32)
    indices = np.asarray(tris, np.int32)
    # flat-shaded: duplicate-vertex quads already give per-face normals
    scene = scene_from_arrays(positions, indices, tri_material=np.asarray(mats),
                              materials=materials)
    return scene
