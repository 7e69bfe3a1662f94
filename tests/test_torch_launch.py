"""The port's one kernel boundary, ops/_build.py, on the CPU: `launch`
with the library and the stream stood in for, `operand` and `require`,
and the autograd Function `Replay` with plain forwards injected."""

import types

import pytest
import torch

from vct_tpu_torch.ops import _build

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

STREAM = 0x5EED

# every launcher, its row and the kernels one call starts (the binning's
# four launchers start 9 kernels a frame: pack 1, bin 8)
LAUNCHERS = [("vct_mip_downsample", "mip", 1),
             ("vct_mip_downsample_bwd", "mip_bwd", 1),
             ("vct_aniso_downsample", "aniso", 1),
             ("vct_raycast", "raycast", 1),
             ("vct_raycast_stream", "raycast_stream", 1),
             ("vct_prepass", "prepass", 1),
             ("vct_material", "material", 1),
             ("vct_tap", "tap", 1),
             ("vct_binrast", "binrast", 1),
             ("vct_bin_pack", "binning", 1),
             ("vct_bin_strips", "binning", 2),
             ("vct_bin_tris", "binning", 3),
             ("vct_bin_table", "binning", 3),
             ("vct_specmarch", "specmarch", 1),
             ("vct_dense_march", "dense_march", 1),
             ("vct_dense_pack", "dense_pack", 1),
             ("vct_dense_taps", "dense_taps", 1),
             ("vct_percone", "percone", 1)]


class _FakeLibrary:
    """The kernel library stood in for: every launcher records its
    arguments and returns `status`."""

    def __init__(self, status=0):
        self.status = status
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("vct_"):
            raise AttributeError(name)

        def launcher(*args):
            self.calls.append((name, args))
            return self.status
        return launcher

    def vct_error_string(self, status):
        return b"stand-in error"


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: STREAM)
    return lib


def test_rows_are_the_counters_readers_know():
    assert set(_build.launches()) == {row for _, row, _ in LAUNCHERS}
    table = {name for name, (row, _, _) in _build.SIGNATURES.items() if row}
    assert table == {name for name, _, _ in LAUNCHERS}
    for name, (row, kernels, _) in _build.SIGNATURES.items():
        if name.endswith("_occupancy"):
            assert row is None and kernels == 0


@pytest.mark.parametrize("name,row,kernels", LAUNCHERS)
def test_launch_counts_its_row_and_passes_the_stream_last(fake, name, row,
                                                          kernels):
    before = _build.launches()
    _build.launch(name, 1, None, 2.5)
    after = _build.launches()
    assert fake.calls == [(name, (1, None, 2.5, STREAM))]
    assert after[row] - before[row] == kernels
    assert {k: v for k, v in after.items() if k != row} == {
        k: v for k, v in before.items() if k != row}


def test_binning_counts_nine_a_frame(fake):
    before = _build.launches()["binning"]
    for name in ("vct_bin_pack", "vct_bin_strips", "vct_bin_tris",
                 "vct_bin_table"):
        _build.launch(name)
    assert _build.launches()["binning"] - before == 9


def test_refused_launch_raises_and_counts_nothing(fake):
    fake.status = 9
    before = _build.launches()
    with pytest.raises(RuntimeError, match="vct_tap: CUDA error 9"):
        _build.launch("vct_tap", 1, 2)
    assert fake.calls == [("vct_tap", (1, 2, STREAM))]
    assert _build.launches() == before


def test_launches_is_a_copy_and_resets(fake):
    _build.launch("vct_mip_downsample")
    got = _build.launches()
    got["mip"] = -1
    assert _build.launches()["mip"] >= 1
    _build.reset_launches()
    assert set(_build.launches().values()) == {0}


def _on_card(t):
    """A CPU tensor's metadata as a CUDA tensor's: what operand reads."""
    return types.SimpleNamespace(is_cuda=True, dtype=t.dtype, shape=t.shape,
                                 is_contiguous=t.is_contiguous,
                                 device=torch.device("cuda", 0))


def test_operand_passes_a_good_tensor():
    _build.operand(_on_card(torch.zeros(4, 3)), torch.float32, (4, 3),
                   "tap kernel: gbuf")
    _build.operand(_on_card(torch.zeros(3, dtype=torch.int32)), torch.int32,
                   torch.Size([3]), "tap kernel: campos")


@pytest.mark.parametrize("bad", [
    torch.zeros(4, 3),                                  # on the CPU
    _on_card(torch.zeros(4, 3, dtype=torch.float64)),   # dtype
    _on_card(torch.zeros(3, 4).T),                      # not contiguous
    _on_card(torch.zeros(4, 2)),                        # shape
], ids=["device", "dtype", "layout", "shape"])
def test_operand_refuses_naming_the_operand(bad):
    with pytest.raises(ValueError, match="^tap kernel: gbuf: expected"):
        _build.operand(bad, torch.float32, (4, 3), "tap kernel: gbuf")


class _Unformattable:
    def __format__(self, spec):
        raise AssertionError("formatted though the check held")


def test_require_builds_its_message_only_on_failure():
    _build.require(True, "never {}", _Unformattable())
    with pytest.raises(ValueError, match="^kernel: 3 levels, got 4$"):
        _build.require(False, "kernel: {} levels, got {}", 3, 4)
    with pytest.raises(ValueError, match="^plain {braces} kept$"):
        _build.require(False, "plain {braces} kept")


def _plain(x, idx, w, y):
    return x[idx] * w * y.sum()


def test_replay_gives_the_plain_gradient_and_none_where_frozen():
    rng = torch.Generator().manual_seed(3)
    x, w, y = (torch.rand(5, generator=rng).requires_grad_()
               for _ in range(3))
    idx = torch.tensor([4, 0, 2, 2, 1])
    gout = torch.rand(5, generator=rng)
    out = _build.Replay.apply(_plain, _plain, (2,), x, idx, w, y)
    assert torch.equal(out, _plain(x, idx, w, y))
    # the backward's own tuple: fwd, plain, frozen, x, the integer idx,
    # the frozen w, y
    raw = out.grad_fn.apply(gout)
    assert len(raw) == 7
    assert [g is None for g in raw] == [True, True, True, False, True, True,
                                        False]
    want = torch.autograd.grad(_plain(x, idx, w, y), (x, y), gout)
    got = torch.autograd.grad(out, (x, w, y), gout, allow_unused=True)
    assert got[1] is None
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[1])


def test_replay_runs_the_injected_forward():
    x = torch.rand(4, requires_grad=True)
    out = _build.Replay.apply(lambda t: t * 3.0, lambda t: t * 2.0, (), x)
    assert torch.equal(out, x.detach() * 3.0)
    (g,) = torch.autograd.grad(out.sum(), (x,))
    assert torch.equal(g, torch.full((4,), 2.0))      # the plain version's
