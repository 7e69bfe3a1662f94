"""The port's copies of the JAX package's image codecs and OBJ loader
(vct_tpu_torch/utils/image.py, scene/obj.py) against the originals: PNG
bytes equal, read_png round-trips, read_jpg's pixels equal on
Pillow-made files (baseline 4:4:4, 4:2:2, 4:2:0, grayscale with restart
markers), tonemap equal, and load_obj's scene equal to the JAX
package's backend="python" on an OBJ + MTL + PNG/JPG/TGA fixture."""

import dataclasses

import numpy as np
import pytest

from vct_tpu_torch.scene import obj as O
from vct_tpu_torch.utils import image as I


def card(h=96, w=120):
    """tests/test_jpeg.py's test card."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([
        (np.sin(x * 0.2) * 0.5 + 0.5) * 255,
        ((x + y) % 32) / 31 * 255,
        (y / h) * 255], axis=-1)
    return img.astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_bytes_equal_jax(tmp_path, channels):
    from vct_tpu.utils import image as JI
    img = np.random.default_rng(channels).integers(
        0, 256, (37, 53, channels), dtype=np.uint8)
    if channels == 1:
        img = img[..., 0]
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    I.write_png(str(ours), img)
    JI.write_png(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    back = I.read_png(str(ours))
    assert np.array_equal(back.reshape(img.shape), img)


def test_tonemap_equals_jax():
    from vct_tpu.utils import image as JI
    hdr = np.random.default_rng(0).uniform(0.0, 3.0, (16, 16, 3)).astype(
        np.float32)
    for gamma, exposure in ((2.2, 1.0), (1.0, 0.5)):
        assert np.array_equal(I.tonemap(hdr, gamma, exposure),
                              JI.tonemap(hdr, gamma, exposure))


@pytest.mark.parametrize("subsampling,quality,gray", [
    (0, 95, False), (1, 85, False), (2, 75, False), (0, 90, True)])
def test_read_jpg_equals_jax(tmp_path, subsampling, quality, gray):
    PIL = pytest.importorskip("PIL.Image")
    from vct_tpu.utils import image as JI
    path = str(tmp_path / "t.jpg")
    if gray:
        PIL.fromarray(card()[:, :, 0]).convert("L").save(
            path, quality=quality, restart_marker_blocks=2)
    else:
        PIL.fromarray(card()).save(path, quality=quality,
                                       subsampling=subsampling)
    assert np.array_equal(I.read_jpg(path), JI.read_jpg(path))


def write_fixture(tmp_path):
    """An OBJ (quads, negative indices, two mtllib materials, a missing
    texture) with a PNG, a JPG and a TGA texture."""
    PIL = pytest.importorskip("PIL.Image")
    I.write_png(str(tmp_path / "wall.png"), np.tile(
        np.asarray([[200, 40, 40], [40, 40, 200]], np.uint8)[:, None, :],
        (8, 16, 1)).reshape(16, 16, 3))
    PIL.fromarray(card(64, 64)).save(str(tmp_path / "floor.jpg"),
                                         quality=92)
    PIL.fromarray(card(8, 8)[:, :, 0]).save(str(tmp_path / "bump.tga"))
    (tmp_path / "scene.mtl").write_text(
        "newmtl wall\nKd 0.9 0.8 0.7\nKs 0.1 0.2 0.3\nNs 32\n"
        "map_Kd wall.png\nmap_bump bump.tga\n"
        "newmtl floor\nKd 1 1 1\nKe 0.5 0.5 0\nmap_Kd floor.jpg\n"
        "map_Ks missing.png\n")
    (tmp_path / "scene.obj").write_text(
        "mtllib scene.mtl\n"
        "v -60 -20 -60\nv 60 -20 -60\nv 60 -20 60\nv -60 -20 60\n"
        "v -60 40 -60\nv 60 40 -60\n"
        "vt 0 0\nvt 4 0\nvt 4 4\nvt 0 4\n"
        "vn 0 1 0\nvn 0 0 1\n"
        "usemtl floor\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "usemtl wall\n"
        "f -6/-4/-1 -5/-3/-1 -1/-2/-1\nf 1/1/2 6/3/2 5/4/2\n")
    return str(tmp_path / "scene.obj")


@pytest.mark.parametrize("backend", ["auto", "python"])
def test_load_obj_equals_jax(tmp_path, backend):
    from vct_tpu.scene.obj import load_obj as jload_obj
    path = write_fixture(tmp_path)
    ours = O.load_obj(path, scale=0.5, backend=backend)
    theirs = jload_obj(path, scale=0.5, backend="python")
    for f in ("positions", "normals", "uvs", "tangents", "bitangents",
              "indices", "tri_material"):
        assert np.array_equal(getattr(ours, f), getattr(theirs, f)), f
    assert len(ours.materials) == len(theirs.materials) == 2
    for a, b in zip(ours.materials, theirs.materials):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                assert np.array_equal(x, y), f.name
            else:
                assert x == y, f.name
    assert ours.materials[1].albedo_texture is not None
    assert ours.materials[1].height_texture is not None


def test_load_obj_refuses_unknown_backend(tmp_path):
    with pytest.raises(ValueError, match="backend"):
        O.load_obj(write_fixture(tmp_path), backend="native")
