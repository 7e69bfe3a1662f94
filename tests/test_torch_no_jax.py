"""The port stands alone: a fresh interpreter in which `import jax` and
`import vct_tpu` (the JAX package) fail imports every module of
vct_tpu_torch and renders the tiny slices on the CPU from the port's own
config and scenes (sponza256 cut to a 32^3 grid, float32 compute: the
Cornell box at 64x48, the textured atrium at 96x64, the atrium
subdivided once, 4,488 triangles through the binned raycast, at 128x64,
sponza256_exact_specular cut the same way on the atrium at 96x64,
cornell64_full at 16^3 / 32x32 through the per-cone oracle renderer, and
presets reference, its shadow map at 128^2, and aniso128 the same way at
16^3 / 24x24),
and takes one inverse-rendering step (vct_tpu_torch.diff, preset inverse
at 16^3 / 16x16, on CPU tensors).  No source of the port or of
chip_smoke.py imports either.
Also the ops' device rule and the entry points' default device, which
need no card to check."""

import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from vct_tpu_torch.config import preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.ops import (_build, binrast, material, mip, prepass,
                               raycast, specmarch, tap)
from vct_tpu_torch.render import gbuffer as GB
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.render import voxelize as V
from vct_tpu_torch.scene.cornell import cornell_box

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import dataclasses, importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "vct_tpu")

    class Blocked:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Blocked())

    import torch
    torch.set_num_threads(1)
    import vct_tpu_torch
    for m in pkgutil.walk_packages(vct_tpu_torch.__path__, "vct_tpu_torch."):
        importlib.import_module(m.name)

    from vct_tpu_torch.config import preset
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.render import renderer as R
    from vct_tpu_torch.scene.atrium import atrium
    from vct_tpu_torch.scene.cornell import cornell_box
    from vct_tpu_torch.scene.mesh import subdivide_scene

    cpu = torch.device("cpu")
    bench_cam = CAM.Camera(position=(48.0, -10.0, 0.0), yaw=180.0)
    for name, scene, subdiv, cam, w, h in (
            ("sponza256", cornell_box(size=100.0), 0,
             CAM.Camera(position=(3.0, 2.0, 40.0)), 64, 48),
            ("sponza256", atrium(), 0, bench_cam, 96, 64),
            ("sponza256", atrium(), 1, bench_cam, 128, 64),
            ("sponza256_exact_specular", atrium(), 0, bench_cam, 96, 64)):
        cfg = preset(name)
        cfg = dataclasses.replace(
            cfg, grid=dataclasses.replace(cfg.grid, dim=32, compute="float32"),
            cones=dataclasses.replace(cfg.cones, field_dim=32),
            render=dataclasses.replace(cfg.render, width=w, height=h))
        ds, mats, samples = R.prepare_scene(cfg, scene, device=cpu)
        if subdiv:       # bench.py's frame: samples of the base scene
            ds, _, _ = R.prepare_scene(cfg, subdivide_scene(scene, subdiv),
                                       samples=samples, device=cpu)
        voxels = R.build_voxel_state(cfg, samples, mats)
        origins, dirs = CAM.primary_rays(cam, w, h, device=cpu)
        img = R.render_camera_pass(cfg, ds, voxels, mats, origins, dirs,
                                   torch.tensor(cam.position))
        assert img.shape == (h, w, 3) and bool(torch.isfinite(img).all())
        assert float(img.mean()) > 0.01
        print("rendered", name, tuple(img.shape), mats.atlas is not None,
              ds.v0.shape[0], float(img.mean()))
    # the per-cone oracle renderer: preset cornell64_full cut to 16^3
    cfg = preset("cornell64_full")
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=16),
        render=dataclasses.replace(cfg.render, width=32, height=32))
    img = R.render_image(cfg, cornell_box(size=100.0),
                         CAM.Camera(position=(0.0, 0.0, 140.0)), device=cpu)
    assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0.01
    print("rendered cornell64_full", tuple(img.shape), float(img.mean()))
    # the shadow map and the anisotropic mips through render_rays: presets
    # reference (map 128^2) and aniso128, cut to 16^3 / 24x24
    for name in ("reference", "aniso128"):
        cfg = preset(name)
        cfg = dataclasses.replace(
            cfg, grid=dataclasses.replace(cfg.grid, dim=16),
            shadow=dataclasses.replace(cfg.shadow, map_size=128),
            render=dataclasses.replace(cfg.render, width=24, height=24))
        img = R.render_image(cfg, cornell_box(size=100.0),
                             CAM.Camera(position=(0.0, 0.0, 140.0)),
                             device=cpu)
        assert img.shape == (24, 24, 3) and bool(torch.isfinite(img).all())
        assert float(img.mean()) > 0.01
        print("rendered", name, tuple(img.shape), float(img.mean()))
    # inverse rendering: one Adam step of preset inverse cut to 16^3
    from vct_tpu_torch.diff import InverseConfig, optimize
    cfg = preset("inverse")
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=16),
        render=dataclasses.replace(cfg.render, width=16, height=16))
    target = torch.full((16, 16, 3), 0.2)
    state, history = optimize(
        InverseConfig(optimize=("albedo",), num_steps=1, chunk_size=256),
        cfg, cornell_box(size=100.0), target, CAM.Camera())
    assert state.step == 1 and len(history) == 1
    assert state.params["albedo"].device == cpu
    print("inverse step", state.step, history[0])
    assert not any(k.split(".")[0] in BLOCKED for k in sys.modules)
""")


def test_imports_and_renders_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "rendered sponza256 (48, 64, 3) False 40 " in res.stdout
    assert "rendered sponza256 (64, 96, 3) True 1122 " in res.stdout
    assert "rendered sponza256 (64, 128, 3) True 4488 " in res.stdout  # binned
    assert ("rendered sponza256_exact_specular (64, 96, 3) True 1122 "
            in res.stdout)
    assert "rendered cornell64_full (32, 32, 3) " in res.stdout  # render_rays
    assert "rendered reference (24, 24, 3) " in res.stdout      # shadow map
    assert "rendered aniso128 (24, 24, 3) " in res.stdout       # aniso mips
    assert "inverse step 1 " in res.stdout                      # diff/


def _sources():
    return sorted((ROOT / "vct_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imports(blocked):
    for path in _sources():
        for line in path.read_text().splitlines():
            words = line.split()
            if (words[:1] in (["import"], ["from"])
                    and words[1].split(".")[0] in blocked):
                yield f"{path}: {line}"


def test_no_jax_import_in_sources():
    assert list(_imports(("jax", "jaxlib"))) == []


def test_no_jax_package_import_in_sources():
    """The port keeps its own copies of the JAX package's host modules
    (config, scenes): `vct_tpu` itself is never imported, even where a
    module of it does not import jax."""
    assert list(_imports(("vct_tpu",))) == []


def _scene():
    return cornell_box(size=100.0)


@pytest.mark.parametrize("call", [
    lambda: CAM.primary_rays(CAM.Camera(), 4, 4)[1],
    lambda: R.light_direction(preset("sponza256")),
    lambda: R.MaterialTable.from_scene(_scene()).albedo,
    lambda: GB.DeviceScene.from_scene(_scene()).v0,
    lambda: R.SamplesDevice.from_samples(V.generate_surface_samples(
        _scene(), 150.0 / 8)).positions,
    lambda: R.prepare_scene(preset("cornell64"), _scene())[0].v0,
    lambda: R.render_image(preset("cornell64"), _scene()),
    lambda: GB.raycast(GB.DeviceScene.from_scene(_scene()),
                       [[0.0, 0.0, 140.0]], [[0.0, 0.0, -1.0]]).hit,
], ids=["primary_rays", "light_direction", "material_table",
        "device_scene", "samples", "prepare_scene", "render_image",
        "raycast"])
def test_entry_points_default_to_the_card(call):
    """Named no device, an entry point puts its tensors on the card; on a
    machine without CUDA it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        assert call().is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def test_entry_point_defaults_name_cuda():
    import inspect
    for fn in (R.prepare_scene, R.MaterialTable.from_scene,
               R.SamplesDevice.from_samples, R.light_direction,
               GB.DeviceScene.from_scene, CAM.primary_rays, R.render_image,
               GB.raycast):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn.__qualname__


def test_no_native_build_at_import():
    """Importing the ops compiles nothing: the library is built at the
    first kernel launch only (CPU installations have no nvcc)."""
    assert _build.library.cache_info().currsize == 0


@pytest.mark.parametrize("call", [
    lambda t: mip.downsample2x(t),
    lambda t: raycast.raycast_gbuf24(t, t, t, t),
    lambda t: prepass.prepass_tiles(t, light_dims=(16,), field_dims=(8,),
                                    voxel=1.0, world_size=16.0,
                                    shadow_offset=1.0),
    lambda t: material.material_tiles(t, t, t, t, t, resolution=16),
    lambda t: raycast.raycast_stream(t[0, 0], t[0, 0, 0], t, t, t, t[0, 0],
                                     t),
    lambda t: binrast.raycast_binned(t[0, 0], t[0, 0, 0], t[0], t[0, 0],
                                     t[0, 0]),
    lambda t: specmarch.spec_march_tiles(t[0, 0], t[0, 0], t[0, 0], t[0],
                                         (t,), world_size=16.0,
                                         max_alpha=0.95),
], ids=["mip", "raycast", "prepass", "material", "raycast_stream",
        "binrast", "specmarch"])
def test_wrappers_refuse_other_devices(call):
    """CPU tensors take the plain version, CUDA tensors the kernel, and
    anything else is refused rather than sent down either path."""
    with pytest.raises(ValueError, match="CUDA or all on the CPU"):
        call(torch.zeros(4, 4, 4, 4, device="meta"))


def test_tap_refuses_mixed_devices():
    cpu = torch.zeros(256, 32)
    meta = torch.zeros(256, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA or all on the CPU"):
        tap.tap_tiles(cpu, meta, cpu, cpu, (cpu,), (cpu,))
