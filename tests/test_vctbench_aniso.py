"""The benchmark's anisotropic configuration, `sponza256_aniso`, on the
CPU: the port's voxel build against its plain reference
(vctbench/reference_aniso) bit for bit, a planted fault that the state
comparison catches, the lower-precision control against the cell's
limits, what the reference imports, the cell as vctbench/spec.py loads
it, the pyramid's work count, and the two metric readers this
configuration adds on a profile made by hand."""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from vctbench import check, harness, spec
from vctbench import trace as TR
from vctbench.calibrate import calibrate
from vctbench.program import Program
from vctbench.reference_aniso import aniso as RA
from vctbench.reference_aniso import pipeline as RP

REPO = Path(__file__).resolve().parents[1]
CELL = "sponza256_aniso.relight"
CONFIG = REPO / "vctbench" / "configs" / "sponza256_aniso.json"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: several test workers share the host's
    cores."""
    keep = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(keep)


def _config(dim: int, compute: str = "bfloat16", width=48, height=32,
            subdivisions=0) -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg["config"]["grid"].update(dim=dim, compute=compute)
    cfg["config"]["render"].update(width=width, height=height)
    cfg["frame_subdivisions"] = subdivisions
    return cfg


def _sun(seed: int) -> np.ndarray:
    """A seeded sun above the horizon, toward the light."""
    rng = np.random.default_rng(seed)
    el = np.radians(rng.uniform(25.0, 75.0))
    az = rng.uniform(0.0, 2.0 * np.pi)
    return np.array([np.cos(el) * np.cos(az), np.sin(el),
                     np.cos(el) * np.sin(az)])


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_port_build_equals_the_aniso_reference(seed, compute):
    """32^3 on the atrium (1,122 triangles) under a seeded sun: every
    field of check.STATE_FIELDS the reference builds, each 6-direction
    level included, equals the port's bit for bit."""
    cfg = _config(32, compute)
    base, frame = harness.scenes(cfg)
    tree = cfg["config"]
    ps = Program(tree, base, frame, "cpu").build(_sun(seed))
    rs = RP.Reference(tree, base, frame, "cpu").build(_sun(seed))
    rad = rs.voxels.radiance_mips
    assert [m.dim() for m in rad] == [4] + [5] * (len(rad) - 1)
    assert [tuple(m.shape) for m in ps.voxels.radiance_mips] == \
        [tuple(m.shape) for m in rad]
    compared = 0
    for f in check.STATE_FIELDS:
        r, p = getattr(rs.voxels, f), getattr(ps.voxels, f)
        if r is None:
            assert p is None, f
            continue
        for a, b in zip(r if isinstance(r, tuple) else (r,),
                        p if isinstance(p, tuple) else (p,)):
            assert a.shape == b.shape and torch.equal(a, b), f
            compared += 1
    assert compared == 2 * len(rad) + 3
    assert max(check.state_errors(ps.voxels, rs.voxels).values()) == 0.0


def _tiny_root(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's data files under `dest`, the
    anisotropic configuration cut to 16^3 and 96x64 on the atrium
    subdivided once, the relight mix to short checks; the cell's own
    limits."""
    (dest / "vctbench").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", dest)
    for d in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(REPO / "vctbench" / d, dest / "vctbench" / d)
    (dest / "vctbench" / "configs" / CONFIG.name).write_text(json.dumps(
        _config(16, width=96, height=64, subdivisions=1)))
    mix = dest / "vctbench" / "traffic" / "relight.json"
    m = json.loads(mix.read_text())
    m.update(max_steps=64, warmup_steps=1, check={"samples": 2, "within": 3})
    mix.write_text(json.dumps(m))
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    return _tiny_root(tmp_path_factory.mktemp("tiny_aniso"))


class IsotropicPyramid(Program):
    """The planted fault: the isotropic pyramid in place of the
    6-direction one (the build runs isotropic, and each 6-direction level
    holds the isotropic level in all six directions)."""

    def build(self, light=None):
        keep = self.cfg
        self.cfg = dataclasses.replace(keep, grid=dataclasses.replace(
            keep.grid, anisotropic=False))
        try:
            state = super().build(light)
        finally:
            self.cfg = keep
        v = state.voxels
        rad = (v.radiance_mips[0],) + tuple(
            m.unsqueeze(-2).expand(m.shape[:3] + (6, m.shape[-1]))
            .contiguous() for m in v.radiance_mips[1:])
        return state._replace(voxels=dataclasses.replace(
            v, radiance_mips=rad))


def test_isotropic_pyramid_is_not_correct(tiny_root):
    res = harness.run_cell(tiny_root, CELL, 77, 0.5, False,
                           time.perf_counter(), device="cpu",
                           make_program=IsotropicPyramid)
    assert res["correct"] is False and res["failed"] >= 1
    state = res["checks"]["state_rel_rms"]
    assert state["value"] > state["limit"]


def test_the_port_is_correct_on_the_cell(tiny_root):
    res = harness.run_cell(tiny_root, CELL, 2 ** 31 + 77, 0.5, False,
                           time.perf_counter(), device="cpu")
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["state_rel_rms"]["value"] == 0.0
    assert set(res["metrics"]) == {"setup_s", "relight_ms",
                                   "relight_p95_ms"}


def test_the_control_fails_the_cell_limits(tiny_root):
    """The control (the anisotropic reference one precision down, its
    5-D levels rounded too): each sample fails one of the limits."""
    limits = spec.load_cell(tiny_root, CELL).limits
    rows = calibrate(tiny_root, CELL, [], [3], "cpu")
    nums = rows[0][2]
    assert nums and not any(check.passes(n, limits) for n in nums)


FORBIDDEN = {"vct_tpu_torch", "vct_tpu", "jax", "jaxlib", "flax"}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "import vctbench.reference_aniso.pipeline\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "vctbench" in top and not top & FORBIDDEN
    for path in sorted((REPO / "vctbench" / "reference_aniso").glob("*.py")):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in FORBIDDEN, \
                    f"{path.name}: {line}"


def test_load_cell_resolves_the_aniso_reference():
    cell = spec.load_cell(REPO, CELL)
    assert cell.reference is RP.Reference
    assert spec.reference_module(cell.config) == \
        "vctbench.reference_aniso.pipeline"
    tree = cell.config["config"]
    iso = json.loads((REPO / "vctbench" / "configs" /
                      "sponza256.json").read_text())["config"]
    assert tree["grid"].pop("anisotropic") is True
    assert iso["grid"].pop("anisotropic") is False
    assert tree == iso
    assert cell.traffic["step"] == "relight"
    assert set(cell.limits) == {"image_max_err", "image_mean_err",
                                "state_rel_rms"}
    assert [m["name"] for m in cell.end_to_end] == [
        "setup_s", "relight_ms", "relight_p95_ms"]
    names = {m["name"] for m in cell.per_layer}
    assert {"aniso_pyramid_roofline.relight",
            "aniso_pyramid_idle_ms.relight", "mip_ms.relight",
            "dense_march_roofline.relight", "idle_share.relight"} <= names
    for m in cell.per_layer:
        assert spec.metric_reader(REPO, m["name"]) is not None


@pytest.mark.parametrize("dim,num_levels", [(16, None), (16, 3), (8, None)])
def test_pyramid_work_matches_the_level_sizes(dim, num_levels):
    g = torch.rand((dim, dim, dim, 4), generator=torch.Generator()
                   .manual_seed(dim))
    mips = RA.build_aniso_mips(g, num_levels)
    shapes = [tuple(m.shape) for m in mips]
    assert RA.pyramid_shapes(dim, 4, num_levels) == shapes
    nbytes, ops = RA.pyramid_work(shapes)
    read = sum(m.numel() for m in mips[:-1])
    written = sum(m.numel() for m in mips[1:])
    assert nbytes == 4 * (read + written)
    assert ops == 16 * written


def test_pyramid_work_at_the_operating_point():
    """256^3 x 4 float32: about 0.50 GB read and 0.23 GB written a
    build, so the bound at 3.35 TB/s is about 0.22 ms."""
    nbytes, ops = RA.pyramid_work(RA.pyramid_shapes(256, 4, None))
    read = 4 * (256 ** 3 * 4 + sum((256 >> l) ** 3 * 24 for l in range(1, 8)))
    assert nbytes - read == 4 * sum((256 >> l) ** 3 * 24
                                    for l in range(1, 9))
    assert abs(read - 0.497e9) < 0.005e9
    assert abs(nbytes - read - 0.231e9) < 0.005e9
    assert ops == 16 * (nbytes - read) // 4


def test_reference_counts_its_own_pyramid():
    cfg = _config(16)
    base, frame = harness.scenes(cfg)
    ref = RP.Reference(cfg["config"], base, frame, "cpu")
    built = ref.build(None)
    assert ref.pyramid_work() == RA.pyramid_work(
        [tuple(m.shape) for m in built.voxels.radiance_mips])
    works = ref.march_work(None)
    assert len(works) == 3 and all(b > 0 and o > 0 for b, o in works)


def _ctx(device_ops, host_ops, reference, kind="NVIDIA H100 80GB HBM3"):
    prof = TR.Profile({0: (0.0, 1.0), 1: (1.0, 2.0)}, device_ops, host_ops)
    return harness.TraceContext({}, 2, [], prof, [0, 1], [None, None],
                                reference, kind)


class _Work:
    def pyramid_work(self):
        return (3.35e9, 1.0)       # 1 ms at 3.35 TB/s


def test_readers_on_a_profile():
    dev = [(0.10, 0.102, "void aniso_pyramid_kernel<4>(float const*)"),
           (0.20, 0.30, "void dense_kernel<1>(...)"),
           (1.10, 1.102, "void aniso_pyramid_kernel<4>(float const*)"),
           (1.20, 1.30, "void mip_kernel(float const*)")]
    host = [(0.05, 0.15, "vct.radiance_mips"), (0.06, 0.11, "vct.aniso_mips"),
            (1.06, 1.11, "vct.aniso_mips")]
    roof = spec.metric_reader(REPO, "aniso_pyramid_roofline.relight")
    idle = spec.metric_reader(REPO, "aniso_pyramid_idle_ms.relight")
    ctx = _ctx(dev, host, _Work())
    assert roof(ctx) == pytest.approx(50.0)
    # idle inside the span: 0.06-0.10 and 0.102-0.11 in each step
    assert idle(ctx) == pytest.approx(48.0)


def test_readers_read_nothing_without_the_kernel_or_span():
    """As on a program without the kernel and the span: both return
    None, and the roofline also without a reference that counts the
    pyramid."""
    dev = [(0.20, 0.30, "void dense_kernel<1>(...)")]
    host = [(0.05, 0.15, "vct.radiance_mips")]
    roof = spec.metric_reader(REPO, "aniso_pyramid_roofline.relight")
    idle = spec.metric_reader(REPO, "aniso_pyramid_idle_ms.relight")
    assert roof(_ctx(dev, host, _Work())) is None
    assert idle(_ctx(dev, host, _Work())) is None
    dev.append((0.10, 0.102, "void aniso_pyramid_kernel<4>(float const*)"))
    assert roof(_ctx(dev, host, object())) is None
    assert roof(_ctx(dev, host, _Work(), kind="cpu")) is None
