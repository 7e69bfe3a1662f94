"""The port's native host runtime (vct_tpu_torch/native: the C++ OBJ
geometry parser and surface sampler) against the port's plain paths
(scene/obj.py's Python parser, render/voxelize.py's numpy sampler) and
the JAX package's vct_tpu.native, on tests/test_native.py's OBJ (polygon
fans, negative and missing indices, scale 0.5), a bare OBJ, the Cornell
box and an irregular random mesh: every array bit-equal (the samples
after a stable sort by tri_ids where the numpy path batches by level;
the two native samplers are both triangle-major and equal as they
come).  Also: four processes that build the library at once all load
it; a build that cannot run or fails raises and nothing falls back to
the plain path; unknown backends raise.  Skips only where g++ is
absent."""

import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from vct_tpu_torch import native
from vct_tpu_torch.render.voxelize import generate_surface_samples
from vct_tpu_torch.scene.cornell import cornell_box
from vct_tpu_torch.scene.mesh import scene_from_arrays
from vct_tpu_torch.scene.obj import load_obj

ROOT = Path(__file__).resolve().parents[1]

OBJ = """
mtllib test.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 -1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl blue
f -5/-4 2/2 5/1
f 1 2 5
"""

MTL = """
newmtl red
Kd 0.9 0.1 0.1
Ks 0.2 0.2 0.2
newmtl blue
Kd 0.1 0.1 0.9
"""

BARE = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"


@pytest.fixture(autouse=True)
def toolchain():
    if shutil.which(native.CXX) is None:
        pytest.skip(f"{native.CXX} is not installed")


@pytest.fixture
def obj_path(tmp_path):
    (tmp_path / "test.obj").write_text(OBJ)
    (tmp_path / "test.mtl").write_text(MTL)
    return str(tmp_path / "test.obj")


def _fields(scene):
    return (scene.positions, scene.uvs, scene.normals, scene.indices,
            scene.tri_material)


def _materials(scene):
    return [(m.name, m.albedo, m.specular, m.emissive, m.shininess)
            for m in scene.materials]


@pytest.mark.parametrize("bare", [False, True], ids=["test_obj", "bare"])
def test_obj_parse_parity(tmp_path, obj_path, bare):
    """Native and Python parses equal, and equal to the JAX package's
    native one (smooth normals generated for a file without vn)."""
    from vct_tpu.scene.obj import load_obj as jload_obj
    if bare:
        obj_path = str(tmp_path / "bare.obj")
        Path(obj_path).write_text(BARE)
    kw = dict(scale=0.5) if not bare else {}
    nat = load_obj(obj_path, backend="auto", **kw)
    py = load_obj(obj_path, backend="python", **kw)
    jax_nat = jload_obj(obj_path, backend="auto", **kw)
    for a, b, c in zip(_fields(nat), _fields(py), _fields(jax_nat)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert a.dtype == b.dtype == c.dtype
    assert _materials(nat) == _materials(py) == _materials(jax_nat)


def test_parse_geometry_equals_jax_native(obj_path):
    from vct_tpu import native as jnative
    ours = native.parse_obj_geometry(obj_path, flip_uv=False, scale=2.0)
    theirs = jnative.parse_obj_geometry(obj_path, flip_uv=False, scale=2.0)
    for a, b in zip(ours[:5], theirs[:5]):
        np.testing.assert_array_equal(a, b)
    assert ours[5:] == theirs[5:] == (["red", "blue"], ["test.mtl"], True)


def test_parse_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_obj(str(tmp_path / "absent.obj"))


def _irregular(from_arrays=scene_from_arrays):
    rng = np.random.default_rng(7)
    v = rng.uniform(-60, 60, (30, 3)).astype(np.float32)
    tris = rng.integers(0, 30, (40, 3)).astype(np.int32)
    return from_arrays(
        v, tris, uvs=rng.uniform(0, 1, (30, 2)).astype(np.float32))


def _sorted_by_tri(s):
    order = np.argsort(s.tri_ids, kind="stable")
    return (s.positions[order], s.normals[order], s.uvs[order],
            s.material_ids[order], s.tri_ids[order])


def _as_tuple(s):
    return (s.positions, s.normals, s.uvs, s.material_ids, s.tri_ids)


@pytest.mark.parametrize("which,voxel", [("cornell", 100.0 / 32),
                                         ("irregular", 1.2)])
def test_surface_samples_parity(which, voxel):
    from vct_tpu.render.voxelize import generate_surface_samples as jgen
    from vct_tpu.scene import cornell_box as jcornell
    from vct_tpu.scene.mesh import scene_from_arrays as jfrom_arrays
    scene = cornell_box(size=100.0) if which == "cornell" else _irregular()
    jscene = (jcornell(size=100.0) if which == "cornell"
              else _irregular(jfrom_arrays))
    nat = generate_surface_samples(scene, voxel, 2.0, backend="auto")
    py = generate_surface_samples(scene, voxel, 2.0, backend="python")
    jax_nat = jgen(jscene, voxel, 2.0, backend="auto")
    assert nat.count == py.count == jax_nat.count > 0
    # both native samplers are triangle-major: equal as they come
    for a, b in zip(_as_tuple(nat), _as_tuple(jax_nat)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # the numpy path batches triangles by level; within a triangle both
    # emit the same sequence, so a stable sort by tri_id makes them equal
    for a, b in zip(_sorted_by_tri(nat), _sorted_by_tri(py)):
        np.testing.assert_array_equal(a, b)
    assert np.all(np.diff(nat.tri_ids) >= 0)


BUILD_SCRIPT = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    from vct_tpu_torch import native
    native.BUILD_DIR = Path(sys.argv[1])
    go = Path(sys.argv[2])
    while not go.exists():
        time.sleep(0.005)
    native.library()
    pos = native.parse_obj_geometry(sys.argv[3])[0]
    print("loaded", native.library_path().name, pos.shape[0])
""")


def test_concurrent_builds_all_load(tmp_path, obj_path):
    """Four processes build into one empty directory at once: each loads
    a whole library, and one library is left with no temporary files."""
    build_dir, go = tmp_path / "build", tmp_path / "go"
    cmd = [sys.executable, "-c", BUILD_SCRIPT, str(build_dir), str(go),
           obj_path]
    procs = [subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    time.sleep(0.5)          # every process waits at the start line
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    names = {out.split()[1] for out, _ in outs}
    nv = str(load_obj(obj_path, backend="python").positions.shape[0])
    assert len(names) == 1 and all(out.split()[2] == nv for out, _ in outs)
    assert sorted(f.name for f in build_dir.iterdir()) == sorted(
        names | {"native.lock"})


@pytest.mark.parametrize("how", ["missing_compiler", "failing_compiler",
                                 "broken_source"])
def test_failed_build_raises(tmp_path, monkeypatch, obj_path, how):
    """A library that cannot be built raises, with the compiler's output,
    from both native routes; backend="python" still works."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    if how == "missing_compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    elif how == "failing_compiler":
        monkeypatch.setattr(native, "CXX", "false")
    else:
        bad = tmp_path / "vct_native.cpp"
        bad.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
        monkeypatch.setattr(native, "SOURCE", bad)
    native.library.cache_clear()
    try:
        scene = cornell_box(size=100.0)
        with pytest.raises(RuntimeError, match="vct_native build failed") \
                as info:
            load_obj(obj_path)
        if how == "broken_source":
            assert "error" in str(info.value)
        with pytest.raises(RuntimeError, match="vct_native build failed"):
            generate_surface_samples(scene, 100.0 / 32)
        assert not native.available()
        assert load_obj(obj_path, backend="python").indices.shape == (4, 3)
        assert generate_surface_samples(scene, 100.0 / 32,
                                        backend="python").count > 0
        assert list((tmp_path / "build").glob("*.so")) == []
    finally:
        native.library.cache_clear()


def test_unknown_backends_raise(obj_path):
    with pytest.raises(ValueError, match="unknown OBJ backend"):
        load_obj(obj_path, backend="native")
    with pytest.raises(ValueError, match="unknown sampling backend"):
        generate_surface_samples(cornell_box(size=100.0), 1.0,
                                 backend="numpy")


def test_surface_samples_checks_shapes():
    tv = np.zeros((2, 3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        native.surface_samples(tv, np.zeros((2, 3, 2), np.float32),
                               np.zeros((2, 3), np.float32),
                               np.zeros((3,), np.int32), 1.0, 2.0)
