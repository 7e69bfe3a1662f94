"""The per-cone route's spans and sample counters (render/renderer
shade_gbuffer, core/march.composite), on the CPU:

  * render_rays on an aniso128 tree at 16^3 / 24x24 on the atrium marks
    raycast, alpha_recast, oracle_surface, percone_diffuse,
    percone_specular, shade a chunk, and under the profiler opens the
    three new spans as host ranges in that order, inside shade's; the
    fast frame opens none of them;
  * the counters percone.samples and percone.active equal the samples of
    every per-cone composite of the frame and the count of its loop mask
    (alpha so far under max_alpha), taken from the composites' own
    inputs;
  * with counting() false nothing is counted, and the composite runs the
    same operators with and without a counter name; with it true the
    counters add no host read;
  * render_camera_pass chunks camera rays by CAMERA_CHUNK, or by the
    frame's rays where it has fewer.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from vct_tpu_torch import stages as S
from vct_tpu_torch.config import preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.core import march as M
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.scene.atrium import atrium

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

CPU = torch.device("cpu")
SIZE = 24
CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0)
ORACLE = ["raycast", "alpha_recast", "oracle_surface", "percone_diffuse",
          "percone_specular", "shade"]
NEW = ("oracle_surface", "percone_diffuse", "percone_specular")


def _cfg(name, dim=16):
    cfg = preset(name)
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=dim),
        cones=dataclasses.replace(cfg.cones, field_dim=dim),
        render=dataclasses.replace(cfg.render, width=SIZE, height=SIZE))


@pytest.fixture(scope="module")
def oracle():
    """The aniso128 tree cut to 16^3 / 24x24, built on the atrium."""
    cfg = _cfg("aniso128")
    ds, mats, samples = R.prepare_scene(cfg, atrium(), device=CPU)
    voxels = R.build_voxel_state(cfg, samples, mats)
    origins, dirs = CAM.primary_rays(CAM.Camera(**CAMERA), SIZE, SIZE,
                                     device=CPU)
    return cfg, ds, mats, voxels, origins, dirs


def _frame(oracle, chunk_size=288):
    cfg, ds, mats, voxels, origins, dirs = oracle
    return R.render_rays(cfg, ds, voxels, mats, origins, dirs,
                         G.constant(CAMERA["position"], CPU),
                         chunk_size=chunk_size)


@pytest.fixture
def clean(monkeypatch):
    monkeypatch.setattr(S, "MARK", None)
    S.reset_counters()
    yield
    S.reset_counters()


def test_percone_marks_a_chunk(oracle, clean, monkeypatch):
    assert not R.use_fast_path(oracle[0])
    names = []
    monkeypatch.setattr(S, "MARK", names.append)
    _frame(oracle)
    assert names == ORACLE * 2


def test_percone_spans_under_profiler(oracle, clean):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame(oracle, chunk_size=SIZE * SIZE)
    events = sorted((e for e in prof.events() if e.name.startswith("vct.")),
                    key=lambda e: e.time_range.start)
    # shade's span holds shade_gbuffer, so it opens before the new three
    assert [e.name[4:] for e in events] == ORACLE[:2] + ["shade"] + list(NEW)
    assert all(e.scope == 0 for e in events)
    for e in events[3:]:
        p = e.cpu_parent
        while not p.name.startswith("vct."):
            p = p.cpu_parent
        assert p.name == "vct.shade"


def test_the_fast_frame_opens_no_percone_span(clean):
    cfg = _cfg("sponza256")
    _, mats, samples = R.prepare_scene(cfg, atrium(), device=CPU)
    ds, _, _ = R.prepare_scene(cfg, atrium(), samples=samples, device=CPU)
    origins, dirs = CAM.primary_rays(CAM.Camera(**CAMERA), SIZE, SIZE,
                                     device=CPU)
    voxels = R.build_voxel_state(cfg, samples, mats)
    tables = F.build_frame_tables(cfg, voxels, mats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        F.render_frame(cfg, ds, tables, mats, origins, dirs,
                       G.constant(CAMERA["position"], CPU))
    names = {e.name[4:] for e in prof.events() if e.name.startswith("vct.")}
    assert "tap" in names and not names & set(NEW)
    assert not any(k.startswith("percone.") for k in S.counters())


def _exclusive_mask(alphas, max_alpha):
    t = torch.cumprod(1.0 - alphas, dim=-1)
    t = torch.cat([torch.ones_like(t[..., :1]), t[..., :-1]], dim=-1)
    return (1.0 - t) < max_alpha


def test_counters_equal_the_composite_mask(oracle, clean, monkeypatch):
    seen = []
    real = M.composite

    def spy(colors, alphas, diameters, max_alpha=0.95, *a, **k):
        if k.get("count"):
            seen.append((alphas.clone(), max_alpha))
        return real(colors, alphas, diameters, max_alpha, *a, **k)

    monkeypatch.setattr(M, "composite", spy)
    monkeypatch.setattr(S, "MARK", lambda name: None)
    _frame(oracle)
    # two chunks, each the diffuse cones and the specular cone
    assert len(seen) == 4
    samples = sum(a.numel() for a, _ in seen)
    active = sum(int(_exclusive_mask(a, m).sum()) for a, m in seen)
    got = S.counters()
    assert got["percone.samples"][1] == got["percone.active"][1] == 4
    assert int(got["percone.samples"][0]) == samples
    assert int(got["percone.active"][0]) == active
    # the atrium's cones run past max_alpha: the early-out cuts samples
    assert 0 < active < samples


def test_nothing_counted_while_counting_is_off(oracle, clean, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a counter was added to with counting off")

    monkeypatch.setattr(S, "count", refuse)
    assert not S.counting()
    _frame(oracle)
    assert S.counters() == {}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _composite_ops(count):
    g = torch.Generator().manual_seed(3)
    colors = torch.rand((64, 6, 3), generator=g)
    alphas = torch.rand((64, 6), generator=g)
    with _Ops() as ops:
        M.composite(colors, alphas, (1.0, 2.0, 3.0, 4.0, 5.0, 6.0),
                    count=count)
    return ops.names


def test_the_counter_adds_no_operator_while_off(clean):
    assert _composite_ops(True) == _composite_ops(False)


def test_the_counter_reads_nothing_back(clean, monkeypatch):
    """Counting, a composite adds a fill, a sum and the two accumulations
    (after the first call, which makes the accumulators): no host read."""
    monkeypatch.setattr(S, "MARK", lambda name: None)
    _composite_ops(True)
    plain, counted = _composite_ops(False), _composite_ops(True)
    extra = list(counted)
    for name in plain:
        extra.remove(name)
    assert sorted(extra) == ["aten.add_", "aten.add_", "aten.detach",
                             "aten.detach", "aten.full", "aten.sum"]
    assert not {"aten._local_scalar_dense", "aten.item"} & set(counted)


@pytest.mark.parametrize("chunk,want", [(None, SIZE * SIZE), (100, 100)])
def test_camera_pass_chunks(oracle, chunk, want, monkeypatch):
    """render_camera_pass hands render_rays chunks of CAMERA_CHUNK rays,
    or of the frame's rays where it has fewer (no padding past them)."""
    cfg, ds, mats, voxels, origins, dirs = oracle
    seen = []
    real = R.render_rays

    def spy(*a, chunk_size, **k):
        seen.append(chunk_size)
        return real(*a, chunk_size=chunk_size, **k)

    monkeypatch.setattr(R, "render_rays", spy)
    kw = {} if chunk is None else {"chunk_size": chunk}
    R.render_camera_pass(cfg, ds, voxels, mats, origins, dirs,
                         G.constant(CAMERA["position"], CPU), **kw)
    assert seen == [want] and R.CAMERA_CHUNK == 65536
