"""The port's own copies of the JAX package's host modules: every config
preset and the Cornell box and atrium scenes must equal the JAX ones
(presets as dicts, scene arrays bit for bit: raycast winners are the
first minimum by triangle index, so even the triangle order counts)."""

import dataclasses

import numpy as np
import pytest

from vct_tpu import config as jconfig
from vct_tpu.scene.atrium import atrium as jatrium
from vct_tpu.scene.cornell import cornell_box as jcornell_box
from vct_tpu.scene.mesh import subdivide_scene as jsubdivide_scene
from vct_tpu_torch import config
from vct_tpu_torch.scene.atrium import atrium
from vct_tpu_torch.scene.cornell import cornell_box
from vct_tpu_torch.scene.mesh import subdivide_scene

PRESETS = ["cornell64", "cornell64_full", "aniso128", "sponza256",
           "sponza256_exact_specular", "inverse", "multihost512", "reference"]


def test_unknown_preset_refused():
    with pytest.raises(ValueError, match="unknown preset"):
        config.preset("no such preset")


@pytest.mark.parametrize("name", PRESETS)
def test_preset_equal(name):
    assert dataclasses.asdict(config.preset(name)) == \
        dataclasses.asdict(jconfig.preset(name))


def test_default_config_equal():
    assert dataclasses.asdict(config.VCTConfig()) == \
        dataclasses.asdict(jconfig.VCTConfig())
    # GridConfig(dim, world_size) resets compute to its float32 default,
    # as bench.py's replacement of the grid does in the JAX package
    assert config.GridConfig(dim=256, world_size=150.0).compute == \
        jconfig.GridConfig(dim=256, world_size=150.0).compute == "float32"


SCENES = {
    "cornell": (lambda: cornell_box(size=100.0),
                lambda: jcornell_box(size=100.0)),
    "atrium": (atrium, jatrium),
    "atrium_subdivided": (lambda: subdivide_scene(atrium(), 2),
                          lambda: jsubdivide_scene(jatrium(), 2)),
}
ARRAYS = ("positions", "normals", "uvs", "tangents", "bitangents",
          "indices", "tri_material")
TEXTURES = ("albedo_texture", "specular_texture", "height_texture",
            "mask_texture")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_arrays_equal(name):
    mine, theirs = (make() for make in SCENES[name])
    for f in ARRAYS:
        a, b = getattr(mine, f), getattr(theirs, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(mine.triangle_vertices(),
                                  theirs.triangle_vertices())
    np.testing.assert_array_equal(mine.face_normals(), theirs.face_normals())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_materials_equal(name):
    mine, theirs = (make() for make in SCENES[name])
    assert len(mine.materials) == len(theirs.materials)
    for a, b in zip(mine.materials, theirs.materials):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name in TEXTURES:
                assert (x is None) == (y is None), f.name
                if x is not None:
                    np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


def test_atrium_shape():
    """The slice's scene: 1,122 triangles and 8 materials, some masked."""
    scene = atrium()
    assert scene.num_triangles == 1122
    assert len(scene.materials) == 8
    assert any(m.mask_texture is not None for m in scene.materials)
