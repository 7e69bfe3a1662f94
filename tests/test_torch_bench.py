"""vct_tpu_torch.bench against bench.py: the dense-sample count for every
preset, the diffuse march's plan against the build's field, the peak
tables, and
run() end to end on the CPU at 16^3 / 64x36 on the atrium subdivided
once (4,488 triangles, the binned raycast), whose frame geometry is the
JAX package's prepare_scene's."""

import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from vct_tpu.config import preset as jpreset
from vct_tpu.render import renderer as JR
from vct_tpu.scene.atrium import atrium as jatrium
from vct_tpu.scene.mesh import subdivide_scene as jsubdivide
from vct_tpu_torch import bench as B
from vct_tpu_torch.config import preset

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

ROOT = pathlib.Path(__file__).resolve().parents[1]
PRESETS = ("cornell64", "cornell64_full", "aniso128", "sponza256",
           "sponza256_exact_specular", "inverse", "multihost512",
           "reference")
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "frame_ms_1080p",
              "fps_1080p", "fast_path", "frame_tris", "raycast_ms",
              "march_achieved_gbps", "peak_gbps", "march_mxu_util",
              "build_ms")


def _bench_py():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_presets_listed():
    """PRESETS is every name config.preset accepts."""
    for name in PRESETS:
        preset(name)
    with pytest.raises(ValueError):
        preset("sponza512")


@pytest.mark.parametrize("name,dim", [(p, None) for p in PRESETS]
                         + [("sponza256", 32), ("sponza256", 256)])
def test_count_dense_samples_matches_bench_py(name, dim):
    cfg, jcfg = preset(name), jpreset(name)
    if dim is not None:
        cfg = dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid,
                                                                dim=dim))
        jcfg = dataclasses.replace(jcfg, grid=dataclasses.replace(jcfg.grid,
                                                                  dim=dim))
    want = _bench_py().count_dense_samples(jcfg)
    assert B.count_dense_samples(cfg) == want
    if (name, dim) == ("sponza256", 256):
        assert want == 3_598_712_832      # BENCH_r05: 3598.7M


def test_march_plan_is_the_builds_diffuse_march():
    """run() counts the bytes and operations of the plan it builds
    beside build_cone_field: that plan's march is the field itself."""
    from vct_tpu_torch.core import dense as D
    from vct_tpu_torch.core import grid as G
    from vct_tpu_torch.ops import dense as OD
    from vct_tpu_torch.render import shading

    f32, _ = B.bench_configs(16, 64, 36)
    g = torch.rand(16, 16, 16, 4, generator=torch.Generator().manual_seed(0))
    g[..., 3] = (g[..., 3] > 0.8).float()
    mips = G.build_mips(g)
    sched = shading.diffuse_schedule(f32)
    plan = D.march_plan(
        mips, D.direction_basis(f32.cones.field_basis), sched,
        f32.grid.world_size, field_dim=shading.field_dim(f32),
        max_alpha=f32.cones.max_alpha,
        occlusion_falloff=f32.cones.occlusion_falloff,
        compute_dtype=shading.march_compute_dtype(f32))
    assert torch.equal(OD.dense_march(mips, plan),
                       shading.build_cone_field(f32, mips, sched))
    nbytes, ops = OD.march_work(mips, plan)
    assert nbytes > sum(m.numel() * 4 for m in mips) and ops > 0


def test_peak_table():
    assert B.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert B.FP32_OPS_PER_S["NVIDIA H100 80GB HBM3"] == 67e12
    with pytest.raises(ValueError, match="no peak memory rate"):
        B.peak_bytes_per_s("TPU v5 lite")
    assert B.power_limit_w("NVIDIA H100 80GB HBM3, 700.00 W") == 700.0


def test_card_line(monkeypatch):
    """nvidia-smi's first line, or a raise where it fails."""
    import subprocess
    from vct_tpu_torch.utils import profiling

    def fake(out, rc):
        return lambda *a, **k: subprocess.CompletedProcess(a, rc, out, "no")

    monkeypatch.setattr(profiling.subprocess, "run", fake(
        "NVIDIA H100 80GB HBM3, 700.00 W\nsecond card\n", 0))
    assert profiling.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    for out, rc in (("", 0), ("x", 9)):
        monkeypatch.setattr(profiling.subprocess, "run", fake(out, rc))
        with pytest.raises(RuntimeError, match="nvidia-smi"):
            profiling.card_line()


def test_configs_follow_bench_py():
    f32, bf16 = B.bench_configs(256, 1920, 1080)
    assert (f32.grid.dim, f32.grid.world_size, f32.grid.compute) == (
        256, 150.0, "float32")
    assert bf16.grid == preset("sponza256").grid
    assert f32.cones == bf16.cones == preset("sponza256").cones
    assert (f32.render.width, f32.render.height) == (1920, 1080)


def test_run_on_cpu():
    res = B.run(dim=16, width=64, height=36, subdiv=1, reps=1,
                device="cpu")
    for k in BENCH_KEYS + ("device", "power_limit_w"):
        assert k in res, k
    assert res["metric"] == "cone_samples_per_s_per_chip"
    assert res["fast_path"] is True and res["device"] == "cpu"
    f32, _ = B.bench_configs(16, 64, 36)
    assert res["dense_samples"] == B.count_dense_samples(f32)
    assert res["march_bytes"] > 0 and res["march_ops"] > 0
    # no device figure from a CPU run: the host times stand apart
    for k in ("value", "vs_baseline", "build_ms", "frame_ms_1080p",
              "raycast_ms", "march_achieved_gbps", "peak_gbps",
              "power_limit_w", "march_mxu_util", "march_bound_ms",
              "march_bound_share"):
        assert res[k] is None, k
    host = res["host_ms"]
    assert set(host["raycast_split_ms"]) == {"pack", "bin", "raycast"}
    assert host["frame_ms"]["reps"] == 5
    assert host["build_ms_bf16"]["reps"] == 1
    assert all(v > 0 for v in (host["build_ms"], host["frame_ms_1080p"],
                               host["raycast_ms"], host["march_ms"]))
    jcfg = dataclasses.replace(jpreset("sponza256"), grid=dataclasses.replace(
        jpreset("sponza256").grid, dim=16))
    _, _, samples = JR.prepare_scene(jcfg, jatrium())
    ds_hi, _, _ = JR.prepare_scene(jcfg, jsubdivide(jatrium(), 1),
                                   samples=samples)
    assert res["frame_tris"] == int(ds_hi.v0.shape[0]) == 4488


def test_main_refuses_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert B.main() == 1
    assert "CUDA is not available" in capsys.readouterr().err
