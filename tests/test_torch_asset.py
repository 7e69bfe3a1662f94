"""The asset path (vct_tpu_torch/asset_path.py) against the JAX package's
scripts/bench_asset_path.py at subdiv=1 (4,488 triangles, 20 textured
materials: the binned raycast), 32^3, 128x64, on the CPU:

  * the files the port's generate writes (OBJ, MTL, 14 PNGs) are
    byte-equal to the JAX generator's, and its six committed JPEGs are
    the bytes the JAX generator encodes here with Pillow;
  * the committed JPEGs decode through the port's read_jpg to their
    source arrays within the encoding's own loss: quality 92 with 4:2:0
    chroma (Pillow's default) gives mean errors of 2.41-2.75/255 and
    maxima of 10.6-19.7/255 on these noisy textures, so the mean is held
    below 3/255 and the max below 24/255;
  * the port's load_obj gives the JAX package's arrays and materials
    (textures included) on the same files;
  * the port's frame through asset_path.run (native samples, its own
    build, the plain versions of every kernel) against the JAX package's
    F.render_frame(interpret=True) on its own build of the same files:
    tests/test_torch_binrast.py's bounds, mean < 1e-3 and the max over
    channels > 0.02 on < 1% of pixels.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vct_tpu_torch import asset_path as A
from vct_tpu_torch.config import preset
from vct_tpu_torch.scene.obj import load_obj
from vct_tpu_torch.utils.image import read_jpg

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

ROOT = Path(__file__).resolve().parents[1]
SUBDIV, DIM, W, H = 1, 32, 128, 64
JPEGS = [i for i in range(A.NUM_MATERIALS) if i % 10 < 3]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(the port's directory, the JAX generator's directory)."""
    pytest.importorskip("PIL.Image")     # the JAX generator encodes JPEGs
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import bench_asset_path as JA
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    ours = tmp_path_factory.mktemp("port")
    theirs = tmp_path_factory.mktemp("jax")
    A.generate(str(ours), SUBDIV)
    JA.generate(str(theirs), SUBDIV)
    return ours, theirs


def test_generate_writes_the_jax_files(scenes):
    ours, theirs = scenes
    names = sorted(p.name for p in theirs.iterdir())
    assert names == sorted(p.name for p in ours.iterdir())
    assert len(names) == 2 + A.NUM_MATERIALS
    assert sum(n.endswith(".png") for n in names) == 14
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), \
            name


@pytest.mark.parametrize("i", JPEGS)
def test_committed_jpeg_decodes_to_its_array(i):
    img = A.texture_arrays()[i]
    got = read_jpg(str(A.JPEG_DIR / A.texture_file(i)))
    assert got.shape == img.shape == (256, 256, 3)
    err = np.abs(got - img)
    assert err.mean() < 3 / 255, err.mean() * 255
    assert err.max() < 24 / 255, err.max() * 255


def test_load_obj_equals_jax(scenes):
    from vct_tpu.scene.obj import load_obj as jload_obj
    path = str(scenes[0] / "atrium_hi.obj")
    ours, theirs = load_obj(path), jload_obj(path)
    assert ours.indices.shape == (4 * 1122, 3)
    for name in ("positions", "uvs", "normals", "indices", "tri_material"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name))
    assert len(ours.materials) == len(theirs.materials) == A.NUM_MATERIALS
    for a, b in zip(ours.materials, theirs.materials):
        assert (a.name, a.albedo, a.specular, a.emissive, a.shininess) == \
            (b.name, b.albedo, b.specular, b.emissive, b.shininess)
        for tex in ("albedo_texture", "specular_texture", "height_texture",
                    "mask_texture"):
            x, y = getattr(a, tex), getattr(b, tex)
            assert (x is None) == (y is None), (a.name, tex)
            if x is not None:
                np.testing.assert_array_equal(x, y)
        assert a.albedo_texture is not None


def _small_cfg(make_preset):
    cfg = make_preset("sponza256")
    return dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, dim=DIM, compute="float32"),
        cones=dataclasses.replace(cfg.cones, field_dim=DIM),
        render=dataclasses.replace(cfg.render, width=W, height=H))


def test_frame_matches_jax(scenes):
    import jax.numpy as jnp
    from vct_tpu.config import preset as jpreset
    from vct_tpu.core import camera as jcam
    from vct_tpu.render import fast as JF
    from vct_tpu.render import renderer as JR
    from vct_tpu.scene.obj import load_obj as jload_obj

    ours = scenes[0]
    res, state = A.run(str(ours), SUBDIV, _small_cfg(preset), device="cpu",
                       reps=1)
    assert (res["tris"], res["materials"], res["textured_materials"]) == (
        4 * 1122, A.NUM_MATERIALS, A.NUM_MATERIALS)
    assert res["samples"] == state["samples"].positions.shape[0] > 0
    assert res["frame_ms_1080p"] is None and res["device"] == "cpu"
    assert state["ds"].v0.shape[0] == 4 * 1122

    jcfg = _small_cfg(jpreset)
    jds, jmats, jsamples = JR.prepare_scene(
        jcfg, jload_obj(str(ours / "atrium_hi.obj")))
    assert jsamples.positions.shape[0] == res["samples"]
    voxels = JR.build_voxel_state_staged(jcfg, jsamples, jmats)
    jtables = JF.build_frame_tables(jcfg, voxels, jmats)
    origins, dirs = jcam.primary_rays(jcam.Camera(**A.CAMERA), W, H)
    ref = np.asarray(JF.render_frame(
        jcfg, jds, jtables, jmats, origins, dirs,
        jnp.asarray(A.CAMERA["position"], jnp.float32), interpret=True))

    out = state["img"].numpy()
    assert out.shape == ref.shape == (H, W, 3) and np.isfinite(out).all()
    assert res["image_mean"] == pytest.approx(float(out.mean()))
    err = np.abs(out - ref)
    assert err.mean() < 1e-3, err.mean()
    assert (err.max(axis=-1) > 0.02).mean() < 0.01
