"""The benchmark's per-cone configuration, `aniso128`, on the CPU: the
port's render_rays against its plain reference (vctbench/reference_oracle)
within the cell's limits, two planted faults that the image comparison
catches, the lower-precision control against the limits, what the
reference imports, the cell as vctbench/spec.py loads it, the marches'
work count against a hand count, and the six metric readers this cell
adds, on contexts made by hand."""

from __future__ import annotations

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
from vctbench.inputs import traffic as T
from vctbench.program import Program
from vctbench.reference import pipeline as RP
from vctbench.reference.core import march as FM
from vctbench.reference_oracle import march as OM
from vctbench.reference_oracle import pipeline as OP

REPO = Path(__file__).resolve().parents[1]
CELL = "aniso128.walk"
CONFIG = REPO / "vctbench" / "configs" / "aniso128.json"
LIMITS = json.loads((REPO / "vctbench" / "limits" / f"{CELL}.json")
                    .read_text())


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: several test workers share the host's
    cores."""
    keep = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(keep)


def _config(dim: int, size: int) -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg["config"]["grid"]["dim"] = dim
    cfg["config"]["render"].update(width=size, height=size)
    return cfg


def _sun(seed: int) -> np.ndarray:
    """A seeded sun above the horizon, toward the light."""
    rng = np.random.default_rng(seed)
    el = np.radians(rng.uniform(25.0, 75.0))
    az = rng.uniform(0.0, 2.0 * np.pi)
    return np.array([np.cos(el) * np.cos(az), np.sin(el),
                     np.cos(el) * np.sin(az)])


@pytest.mark.parametrize("dim,size", [(16, 24), (32, 64)])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_render_rays_equals_the_oracle_reference(dim, size, seed):
    """The port's camera pass (render_camera_pass -> render_rays) under a
    seeded sun at a seeded pose of the cell's mix, against the reference
    on the same rays: within the cell's limits."""
    cfg = _config(dim, size)
    base, frame = harness.scenes(cfg)
    tree = cfg["config"]
    prog = Program(tree, base, frame, "cpu")
    ref = OP.Reference(tree, base, frame, "cpu")
    mix = json.loads((REPO / "vctbench" / "traffic" / "walk_oracle.json")
                     .read_text())
    step = seed % 40
    paths = T.make_paths(mix, seed, step + 1)
    rays = T.RayMaker(size, size, tree["render"]["fov_degrees"], "cpu")
    o, d, p = rays.rays(rays.basis(paths)[step])
    ps = prog.build(_sun(seed))
    assert ps.tables is None                 # the per-cone route
    a = prog.frame(ps, o, d, p)
    b = ref.frame(ref.build(_sun(seed)), o, d, p)
    nums = check.numbers(a, b)
    assert check.passes(nums, LIMITS), nums
    assert float(b.mean()) > 0.01


def test_reference_does_not_depend_on_its_block(monkeypatch):
    """The reference's frame in blocks of 256 rays (a 32x32 frame in 4)
    is the frame in one block, bit for bit."""
    from vctbench.reference_oracle import frame as FR
    cfg = _config(16, 32)
    base, frame = harness.scenes(cfg)
    tree = cfg["config"]
    ref = OP.Reference(tree, base, frame, "cpu")
    mix = json.loads((REPO / "vctbench" / "traffic" / "walk_oracle.json")
                     .read_text())
    paths = T.make_paths(mix, 7, 8)
    rays = T.RayMaker(32, 32, tree["render"]["fov_degrees"], "cpu")
    o, d, p = rays.rays(rays.basis(paths)[7])
    built = ref.build(_sun(7))
    whole = ref.frame(built, o, d, p)
    monkeypatch.setattr(FR, "BLOCK", 256)
    assert torch.equal(ref.frame(built, o, d, p), whole)


def _tiny_root(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's data files under `dest`, the
    configuration cut to 16^3 and 32x32, the mix to short checks; the
    cell's own limits."""
    (dest / "vctbench").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", dest)
    for d in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(REPO / "vctbench" / d, dest / "vctbench" / d)
    (dest / "vctbench" / "configs" / CONFIG.name).write_text(
        json.dumps(_config(16, 32)))
    mix = dest / "vctbench" / "traffic" / "walk_oracle.json"
    m = json.loads(mix.read_text())
    m.update(max_steps=64, warmup_steps=1, check={"samples": 2, "within": 3})
    mix.write_text(json.dumps(m))
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    return _tiny_root(tmp_path_factory.mktemp("tiny_oracle"))


class IsotropicSample(Program):
    """The planted fault: every 6-direction level sampled as the mean of
    its six directions, in place of the d_i^2 blend."""

    def frame(self, state, origins, dirs, position):
        from vct_tpu_torch.core import aniso as A
        keep = A.aniso_weights
        A.aniso_weights = lambda d: torch.full(d.shape[:-1] + (6,), 1 / 6,
                                               dtype=d.dtype, device=d.device)
        try:
            return super().frame(state, origins, dirs, position)
        finally:
            A.aniso_weights = keep


class NoSpecularCone(Program):
    """The planted fault: the specular cone left out (its light and its
    occlusion zero)."""

    def frame(self, state, origins, dirs, position):
        from vct_tpu_torch.render import shading as S

        def dropped(cfg, mips, position, normal, refl):
            return torch.zeros_like(position), torch.zeros_like(
                position[..., 0])

        keep = S.indirect_specular_percone
        S.indirect_specular_percone = dropped
        try:
            return super().frame(state, origins, dirs, position)
        finally:
            S.indirect_specular_percone = keep


@pytest.mark.parametrize("fault", [IsotropicSample, NoSpecularCone])
def test_a_planted_fault_is_not_correct(tiny_root, fault):
    res = harness.run_cell(tiny_root, CELL, 2 ** 31 + 9, 0.5, False,
                           time.perf_counter(), device="cpu",
                           make_program=fault)
    assert res["correct"] is False and res["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


def test_the_port_is_correct_on_the_cell(tiny_root):
    res = harness.run_cell(tiny_root, CELL, 2 ** 31 + 77, 0.5, False,
                           time.perf_counter(), device="cpu")
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "frame_ms", "frame_p95_ms"}


def test_the_control_fails_the_cell_limits(tiny_root):
    """The control (the reference with its build and every cone sample
    rounded to bfloat16): each sample fails one of the limits."""
    limits = spec.load_cell(tiny_root, CELL).limits
    rows = calibrate(tiny_root, CELL, [], [3], "cpu")
    nums = rows[0][2]
    assert nums and not any(check.passes(n, limits) for n in nums)


FORBIDDEN = {"vct_tpu_torch", "vct_tpu", "jax", "jaxlib", "flax"}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "import vctbench.reference_oracle.pipeline\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "vctbench" in top and not top & FORBIDDEN
    for path in sorted((REPO / "vctbench" / "reference_oracle")
                       .glob("*.py")):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in FORBIDDEN, \
                    f"{path.name}: {line}"


NEW_METRICS = ("oracle_raycast_ms.frame", "oracle_surface_ms.frame",
               "percone_ms.frame", "percone_idle_ms.frame",
               "percone_active_share.frame", "percone_roofline.frame")


def test_load_cell_resolves_the_oracle_configuration():
    import dataclasses

    from vct_tpu_torch.config import preset

    cell = spec.load_cell(REPO, CELL)
    assert cell.reference is OP.Reference
    assert spec.reference_module(cell.config) == \
        "vctbench.reference_oracle.pipeline"
    assert cell.config["preset"] == "aniso128"
    assert cell.config["frame_subdivisions"] == 0
    assert cell.config["config"] == json.loads(json.dumps(
        dataclasses.asdict(preset("aniso128"))))
    walk = json.loads((REPO / "vctbench" / "traffic" / "walk.json")
                      .read_text())
    mix = cell.traffic
    assert mix["camera"] == walk["camera"]
    assert (mix["step"], mix["rebuild_every"], mix["warmup_steps"],
            mix["profile_steps"], mix["max_steps"]) == ("frame", 0, 4, 2,
                                                        60000)
    assert mix["check"] == {"samples": 3, "within": 60}
    assert set(cell.limits) == {"image_max_err", "image_mean_err"}
    assert [m["name"] for m in cell.end_to_end] == [
        "setup_s", "frame_ms", "frame_p95_ms"]
    assert [m["name"] for m in cell.per_layer] == [
        "syncs.frame", "idle_share.frame", *NEW_METRICS]
    for m in cell.per_layer:
        assert spec.metric_reader(REPO, m["name"]) is not None
        assert m["moves"] == "frame_ms"
    s = spec.load_spec(REPO)
    cfg = {c["name"]: c for c in s["configs"]}["aniso128"]
    assert cfg["reduced"] == ["frame_subdivisions"]


def test_cone_steps_are_the_frozen_schedule():
    """The shader's recurrence written anew (march.cone_steps) gives the
    frozen reference's static schedule."""
    for tan in (0.577, 0.07, 0.03):
        for voxel in (150 / 128, 150 / 16, 150 / 8):
            got = OM.cone_steps(tan, voxel, 75.0)
            want = FM.march_schedule(tan, voxel, 75.0)
            assert [s.dist for s in got] == list(want.dists)
            assert [s.diameter for s in got] == list(want.diameters)
            assert [s.lod for s in got] == list(want.lods)


def test_percone_work_by_hand():
    """8^3 (voxel 18.75, levels 8, 4, 2, 1) and 4x4 pixels.  Diffuse
    (tan 0.577): dist 18.75, lod log2(1.154) = 0.207 (levels 0 and 1),
    then dist 40.39, lod 1.314 (levels 1 and 2); the next, 86.99, is past
    75.  Specular (tan 0.07): dist 18.75, 37.5, 56.25, lod 0 each.
    A level-0 read costs 12 + 21 x 4 = 96 operations, a 6-direction
    read of the three facing directions 12 + (21 x 3 + 5) x 4 = 284; a
    sample 15 for its point and 12 for its composite, and 3 x 4 for a
    lerp between two levels.  With a share of the samples active, the
    cheapest that many: of a ray's 15, the 3 specular (123 each), then
    the 6 first diffuse (419 each)."""
    cfg = _config(8, 4)
    base, frame = harness.scenes(cfg)
    ref = OP.Reference(cfg["config"], base, frame, "cpu")
    first, second, spec_ = 27 + 96 + 284 + 12, 27 + 284 + 284 + 12, 27 + 96
    ops = 16 * (6 * (first + second) + 3 * spec_)
    # levels 0, 1 and 2 are read: 8^3 x 4 + 4^3 x 24 + 2^3 x 24 floats;
    # each ray reads 15 and writes 8
    nbytes = 4 * (8 ** 3 * 4 + 4 ** 3 * 24 + 2 ** 3 * 24 + 16 * 23)
    assert ref.percone_work(1.0) == (nbytes, ops)
    assert ops == 104400 and nbytes == 16576
    assert ref.percone_work(9 / 15) == (nbytes, 16 * (3 * spec_ + 6 * first))
    # 7.5 samples a ray: half of the fifth first diffuse sample
    assert ref.percone_work(0.5) == (nbytes, 16 * (3 * spec_ + 4.5 * first))
    assert ref.percone_work(0.0) == (nbytes, 0)


def test_percone_work_at_the_operating_point():
    """512x512 pixels, 6 diffuse cones of 6 steps and a specular cone of
    23 at 128^3: 59 samples a pixel, 15.5 M a frame, about 500
    operations each, and 86 MB at least; at 90% active, the operations
    of the cheapest 90%: at most 90% of all samples' operations."""
    cell = spec.load_cell(REPO, CELL)
    ref = OP.Reference.__new__(OP.Reference)      # no scene: the count
    ref.cfg = RP.config_from_tree(cell.config["config"])
    nbytes, ops = ref.percone_work(1.0)
    c = ref.cfg.cones
    v = ref.cfg.grid.voxel_world_size
    n = 6 * len(OM.cone_steps(c.diffuse_tan_half_angle, v, 75.0)) + len(
        OM.cone_steps(c.specular_tan_half_angle, v, 75.0))
    assert n == 6 * 6 + 23
    assert 400 * n * 512 ** 2 < ops < 600 * n * 512 ** 2
    assert 80e6 < nbytes < 90e6
    assert 0.85 * ops < ref.percone_work(0.9)[1] <= 0.9 * ops


def _ctx(stage_ms=None, steps=2, profile=None, reference=None,
         kind="NVIDIA H100 80GB HBM3"):
    return harness.TraceContext(stage_ms or {}, steps, [], profile, [], None,
                                reference, kind)


class _Work:
    def percone_work(self, active):
        # 1 ms of bytes at 3.35 TB/s; 8 ms of operations at 67e12 a
        # second where every sample runs
        return (3.35e9, active * 8 * 67e9)


def _counted(monkeypatch, active, samples):
    from vct_tpu_torch import stages
    monkeypatch.setattr(stages, "_COUNTS", {
        "percone.active": [torch.tensor(active), 2],
        "percone.samples": [torch.tensor(samples), 2]})


def test_stage_readers(monkeypatch):
    _counted(monkeypatch, 30, 120)
    read = {n: spec.metric_reader(REPO, n) for n in NEW_METRICS}
    ctx = _ctx({"raycast": 10.0, "alpha_recast": 6.0, "oracle_surface": 4.0,
                "percone_diffuse": 300.0, "percone_specular": 100.0,
                "shade": 2.0}, reference=_Work())
    assert read["oracle_raycast_ms.frame"](ctx) == 8.0
    assert read["oracle_surface_ms.frame"](ctx) == 2.0
    assert read["percone_ms.frame"](ctx) == 200.0
    # a quarter of the samples active: 2 ms of operations over 200 ms a
    # frame; a fortieth: 0.2 ms, under the bytes' 1 ms
    assert read["percone_roofline.frame"](ctx) == pytest.approx(1.0)
    _counted(monkeypatch, 3, 120)
    assert read["percone_roofline.frame"](ctx) == pytest.approx(0.5)


def test_stage_readers_read_nothing_without_their_stages(monkeypatch):
    """As on a program whose oracle marks only raycast, alpha_recast and
    shade, or counts no per-cone samples, or a reference that counts no
    work, or an unlisted card."""
    _counted(monkeypatch, 30, 120)
    read = {n: spec.metric_reader(REPO, n) for n in NEW_METRICS}
    old = _ctx({"raycast": 10.0, "alpha_recast": 6.0, "shade": 900.0},
               reference=_Work())
    for n in ("oracle_surface_ms.frame", "percone_ms.frame",
              "percone_roofline.frame"):
        assert read[n](old) is None
    assert read["oracle_raycast_ms.frame"](_ctx({"shade": 1.0})) is None
    stages = {"percone_diffuse": 3.0, "percone_specular": 1.0}
    assert read["percone_roofline.frame"](
        _ctx(stages, reference=object())) is None
    assert read["percone_roofline.frame"](
        _ctx(stages, reference=_Work(), kind="cpu")) is None
    assert read["percone_roofline.frame"](
        _ctx(stages, reference=_Work())) is not None
    from vct_tpu_torch import stages as S
    monkeypatch.setattr(S, "_COUNTS", {})
    assert read["percone_roofline.frame"](
        _ctx(stages, reference=_Work())) is None


def _profile(host):
    """Two steps of 1 s; the device busy 0.1-0.3 and 1.1-1.3."""
    return TR.Profile({0: (0.0, 1.0), 1: (1.0, 2.0)},
                      [(0.1, 0.3, "k"), (1.1, 1.3, "k")], host)


def test_percone_idle_reader():
    read = spec.metric_reader(REPO, "percone_idle_ms.frame")
    host = [(0.0, 0.9, "vct.shade"), (0.05, 0.2, "vct.percone_diffuse"),
            (0.25, 0.5, "vct.percone_specular"), (1.0, 1.9, "vct.shade")]
    # idle inside the spans: 0.05-0.1 and 0.3-0.5 in step 0, none in 1
    assert read(_ctx(profile=_profile(host))) == pytest.approx(125.0)
    old = [(0.0, 0.9, "vct.shade"), (1.0, 1.9, "vct.shade")]
    assert read(_ctx(profile=_profile(old))) is None
    assert read(_ctx()) is None


def test_percone_active_share_reader(monkeypatch):
    from vct_tpu_torch import stages
    read = spec.metric_reader(REPO, "percone_active_share.frame")
    monkeypatch.setattr(stages, "_COUNTS", {
        "percone.active": [torch.tensor(30), 2],
        "percone.samples": [torch.tensor(120), 2],
        "binning.dropped": [torch.tensor(0), 2]})
    assert read(_ctx()) == 25.0
    monkeypatch.setattr(stages, "_COUNTS", {
        "binning.dropped": [torch.tensor(0), 2]})
    assert read(_ctx()) is None
    monkeypatch.delattr(stages, "counters")
    assert read(_ctx()) is None
