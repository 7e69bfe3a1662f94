"""The port stands without JAX: a fresh interpreter in which `import jax`
fails imports every module of vct_tpu_torch and renders the tiny slice
(sponza256 cut to a 32^3 grid, float32 compute, 64x48, the Cornell box)
on the CPU.  Also the ops' device rule, which needs no card to check."""

import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from vct_tpu_torch.ops import _build, mip, prepass, raycast, tap

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import dataclasses, importlib, pkgutil, sys

    class NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError(f"jax is blocked: {name}")
            return None

    sys.meta_path.insert(0, NoJax())

    import torch
    torch.set_num_threads(1)
    import vct_tpu_torch
    for m in pkgutil.walk_packages(vct_tpu_torch.__path__, "vct_tpu_torch."):
        importlib.import_module(m.name)

    from vct_tpu.config import preset
    from vct_tpu.scene.cornell import cornell_box
    from vct_tpu_torch.core import camera as CAM
    from vct_tpu_torch.render import renderer as R

    cfg = preset("sponza256")
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=32, compute="float32"),
        cones=dataclasses.replace(cfg.cones, field_dim=32),
        render=dataclasses.replace(cfg.render, width=64, height=48))
    ds, mats, samples = R.prepare_scene(cfg, cornell_box(size=100.0))
    voxels = R.build_voxel_state(cfg, samples, mats)
    cam = CAM.Camera(position=(3.0, 2.0, 40.0))
    origins, dirs = CAM.primary_rays(cam, 64, 48)
    img = R.render_camera_pass(cfg, ds, voxels, mats, origins, dirs,
                               torch.tensor(cam.position))
    assert img.shape == (48, 64, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0.01
    assert not any(k.split(".")[0] in ("jax", "jaxlib") for k in sys.modules)
    print("rendered", tuple(img.shape), float(img.mean()))
""")


def test_imports_and_renders_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "rendered (48, 64, 3)" in res.stdout


def test_no_jax_import_in_sources():
    for path in (ROOT / "vct_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"])
                        and words[1].split(".")[0] in ("jax", "jaxlib")), \
                f"{path}: {line}"


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
], ids=["mip", "raycast", "prepass"])
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
