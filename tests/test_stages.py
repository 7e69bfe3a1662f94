"""vct_tpu_torch.stages: the stage marks, host spans and device counters.

  * the MARK sequence (names and order) of a CPU build_voxel_state,
    build_frame_tables and render_frame under sponza256 and
    sponza256_exact_specular at 16^3 / 96x64, on the atrium (1,122
    triangles: the whole-table raycast) and on the atrium subdivided once
    (4,488 > raycast.MAX_TRIANGLES: the binned raycast), and of
    render_rays in two chunks, pinned as the program marked them before
    the marks became spans;
  * under a CPU torch.profiler every vct.* span is a host range at
    RecordScope.FUNCTION (scope 0, never the user scope 7 that the
    profiler mirrors onto the device's timeline), nested as the program
    nests them; with no profiler and no MARK a span is the shared null
    context and nothing is counted;
  * "binning.dropped" counts a forced column-budget overflow, summed on
    the tensor's device with no host read;
  * profile_stages.union_length, the busy time of overlapping intervals.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vct_tpu_torch import profile_stages
from vct_tpu_torch import stages as S
from vct_tpu_torch.config import preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.core import grid as G
from vct_tpu_torch.ops import binrast as BR
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import renderer as R
from vct_tpu_torch.scene.atrium import atrium
from vct_tpu_torch.scene.mesh import subdivide_scene

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

CPU = torch.device("cpu")
W, H = 96, 64
CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0)

BUILD = ["albedo_splat", "occupancy_mips", "light_volume",
         "shadow_and_radiance_splat", "radiance_mips", "diffuse_field"]
WHOLE = ["rays_and_tables", "raycast"]
BINNED = ["rays", "pack_rows", "bin", "raycast"]
SHADE = ["alpha_resolve", "prepass", "material", "bump_normal", "tap"]
MARKS = {
    ("sponza256", 0): BUILD + ["specular_field"] + WHOLE + SHADE
    + ["combine"],
    ("sponza256", 1): BUILD + ["specular_field"] + BINNED + SHADE
    + ["combine"],
    ("sponza256_exact_specular", 0): BUILD + WHOLE + SHADE
    + ["specmarch", "combine"],
    ("sponza256_exact_specular", 1): BUILD + BINNED + SHADE
    + ["specmarch", "combine"],
}


def _cfg(name, w=W, h=H):
    cfg = preset(name)
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=16),
        cones=dataclasses.replace(cfg.cones, field_dim=16),
        render=dataclasses.replace(cfg.render, width=w, height=h))


@pytest.fixture(scope="module")
def atrium_scenes():
    base = atrium()
    return {0: base, 1: subdivide_scene(base, 1)}


def _run(name, sub, scenes, w=W, h=H):
    """build_voxel_state, build_frame_tables and render_frame on the CPU."""
    cfg = _cfg(name, w, h)
    _, mats, samples = R.prepare_scene(cfg, scenes[0], device=CPU)
    ds, _, _ = R.prepare_scene(cfg, scenes[sub], samples=samples,
                               device=CPU)
    origins, dirs = CAM.primary_rays(CAM.Camera(**CAMERA), w, h,
                                     device=CPU)
    voxels = R.build_voxel_state(cfg, samples, mats)
    tables = F.build_frame_tables(cfg, voxels, mats)
    return F.render_frame(cfg, ds, tables, mats, origins, dirs,
                          G.constant(CAMERA["position"], CPU))


@pytest.fixture
def clean(monkeypatch):
    monkeypatch.setattr(S, "MARK", None)
    S.reset_counters()
    yield
    S.reset_counters()


@pytest.mark.parametrize("name,sub", sorted(MARKS))
def test_mark_sequence(name, sub, atrium_scenes, clean, monkeypatch):
    names = []
    monkeypatch.setattr(S, "MARK", names.append)
    _run(name, sub, atrium_scenes)
    assert names == MARKS[(name, sub)]


def test_mark_sequence_render_rays(clean, monkeypatch):
    """The oracle's per-chunk marks: raycast, alpha_recast, shade a chunk."""
    from vct_tpu_torch.scene.cornell import cornell_box
    cfg = preset("cornell64")
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=16),
        render=dataclasses.replace(cfg.render, width=32, height=16))
    ds, mats, samples = R.prepare_scene(cfg, cornell_box(size=100.0),
                                        device=CPU)
    names = []
    monkeypatch.setattr(S, "MARK", names.append)
    voxels = R.build_voxel_state(cfg, samples, mats)
    origins, dirs = CAM.primary_rays(CAM.Camera(position=(3.0, 2.0, 40.0)),
                                     32, 16, device=CPU)
    R.render_rays(cfg, ds, voxels, mats, origins, dirs,
                  G.constant((3.0, 2.0, 40.0), CPU), chunk_size=256)
    assert names == (BUILD[:5] + ["raycast", "alpha_recast", "shade"] * 2)


def _vct_events(prof):
    return [e for e in prof.events() if e.name.startswith("vct.")]


def _vct_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("vct."):
        p = p.cpu_parent
    return None if p is None else p.name[4:]


@pytest.mark.parametrize("name", ["sponza256", "sponza256_exact_specular"])
def test_spans_under_profiler(name, atrium_scenes, clean):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(name, 1, atrium_scenes)
    events = _vct_events(prof)
    assert events and all(e.scope == 0 for e in events)
    parent = {}
    for e in events:
        parent.setdefault(e.name[4:], set()).add(_vct_parent(e))
    stage_names = MARKS[(name, 1)]
    for stage in stage_names:
        want = "build" if stage in BUILD + ["specular_field"] else "frame"
        assert parent[stage] == {want}, stage
    assert parent["frame"] == parent["build"] == parent["tables"] == {None}
    assert parent["dense.plan"] == ({"light_volume", "diffuse_field",
                                     "specular_field"} & set(stage_names))
    assert parent["splat.sort"] == {"albedo_splat",
                                    "shadow_and_radiance_splat"}
    for part in ("light_mips", "fuse", "field_mips", "atlas_pages"):
        assert parent["tables." + part] == {"tables"}
    assert ("tables.spec_mips" in parent) == (name != "sponza256")
    assert parent["alpha_resolve.pack"] == {"alpha_resolve"}
    assert parent["alpha_resolve.flag"] == {"alpha_resolve"}
    if name != "sponza256":
        for part in ("inputs", "kernel", "scatter"):
            assert parent["specmarch." + part] == {"specmarch"}
    # the frame's stage spans open in the order their marks fire
    frame = sorted((e for e in events if _vct_parent(e) == "frame"),
                   key=lambda e: e.time_range.start)
    assert [e.name[4:] for e in frame] == [
        n for n in stage_names if n not in BUILD + ["specular_field"]]


def test_spans_off(atrium_scenes, clean, monkeypatch):
    """No profiler, no MARK: the shared null context, no range opened and
    no counter kept."""
    assert S.span("bin") is S.span("frame", mark=False)

    def refuse(*a, **k):
        raise AssertionError("a host range opened with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not S.counting()
    _run("sponza256", 1, atrium_scenes)
    assert S.counters() == {}


def test_span_marks_only_on_success(clean, monkeypatch):
    names = []
    monkeypatch.setattr(S, "MARK", names.append)
    with S.span("a"):
        pass
    with S.span("b", mark=False):
        pass
    with pytest.raises(ValueError):
        with S.span("c"):
            raise ValueError
    assert names == ["a"]


def test_dropped_triangles_counted(atrium_scenes, clean, monkeypatch):
    """At 256x48 (12 strips, so triangles reach the column tier), a
    column budget of one triangle and a medium budget of two: the column
    tier past its first triangle is dropped, and counted a frame."""
    monkeypatch.setattr(BR, "_budgets", lambda t: (2, 1))
    w, h = 256, 48
    cfg = _cfg("sponza256", w, h)
    # no alpha re-cast: its plain streamed raycast is the CPU frame's cost
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, alpha_mask_depth=0))
    _, mats, samples = R.prepare_scene(cfg, atrium_scenes[0], device=CPU)
    ds, _, _ = R.prepare_scene(cfg, atrium_scenes[1], samples=samples,
                               device=CPU)
    origins, dirs = CAM.primary_rays(CAM.Camera(**CAMERA), w, h,
                                     device=CPU)
    origin = origins.reshape(-1, 3)[0].contiguous()
    dimg = F._pad_edge(dirs, h, w)
    d = F._tile_order(dimg, h, w).contiguous()
    isect, _ = BR.pack_rows(ds, origin)
    n_col = int(BR.bin_triangles(ds, origin, d, dimg, isect)[2])
    assert n_col > 1

    tables = F.build_frame_tables(cfg, R.build_voxel_state(cfg, samples,
                                                           mats), mats)

    def frame():
        F.render_frame(cfg, ds, tables, mats, origins, dirs,
                       G.constant(CAMERA["position"], CPU))

    frame()                                      # counts nothing: off
    assert S.counters() == {}
    monkeypatch.setattr(S, "MARK", lambda name: None)
    frame()
    frame()
    total, calls = S.counters()["binning.dropped"]
    assert calls == 2
    assert total.dim() == 0 and total.device == CPU
    assert int(total) == 2 * (n_col - 1)


def test_count_reads_nothing_back(clean, monkeypatch):
    """count() adds on the device: no host read of the value or the sum
    (on a card, under the sync debug mode's "error")."""
    monkeypatch.setattr(S, "MARK", lambda name: None)

    def refuse(*a, **k):
        raise AssertionError("a host read in count()")

    dev = torch.device("cuda") if torch.cuda.is_available() else CPU
    values = [torch.tensor(v, device=dev) for v in (3, 0, 4)]
    with monkeypatch.context() as m:
        for attr in ("item", "tolist", "__bool__", "__int__", "__float__",
                     "__index__", "cpu", "numpy"):
            m.setattr(torch.Tensor, attr, refuse)
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            for v in values:
                S.count("c", v)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    total, calls = S.counters()["c"]
    assert calls == 3 and int(total) == 7 and total.device == dev


def test_count_off_without_marks(clean):
    S.count("c", torch.tensor(5))
    assert S.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert S.counting()
        S.count("c", torch.tensor(5))
    assert int(S.counters()["c"][0]) == 5
    S.reset_counters()
    assert S.counters() == {}


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 1.0)], 1.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),              # overlapping: once
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),              # nested
    ([(5.0, 6.0), (0.0, 1.0), (1.0, 2.0)], 3.0),  # adjacent, unsorted
])
def test_profile_union_length(intervals, want):
    assert profile_stages.union_length(intervals) == want
