"""The anisotropic pyramid's kernel route (vct_tpu_torch/ops/aniso.py,
csrc/aniso.cu): on the CPU the dispatch rule, the plain route and the
autograd Function's backward (its plain forward injected); on a CUDA card
the kernel bit for bit against core/aniso.py's plain pyramid.  The voxel
build's `aniso_mips` span opens inside `radiance_mips` on the anisotropic
route only."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vct_tpu_torch import stages
from vct_tpu_torch.config import preset
from vct_tpu_torch.core import aniso as A
from vct_tpu_torch.ops import _build
from vct_tpu_torch.ops import aniso as OA
from vct_tpu_torch.render import renderer as R


@pytest.fixture
def card():
    """The CUDA card, decided when a test runs: the kernel has no CPU
    mode, so without a card the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _grid(d, c, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.0, 0.8, (d, d, d, c)).astype(
        np.float32), device=device)


@pytest.mark.parametrize("num_levels", [None, 3])
def test_cpu_route_is_the_plain_pyramid(num_levels):
    g = _grid(16, 4, 1)
    got = OA.build_aniso_mips(g, num_levels)
    want = A.build_aniso_mips(g, num_levels)
    assert len(got) == len(want) == (3 if num_levels else 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [m.dim() for m in got] == [4] + [5] * (len(got) - 1)


def test_plain_level_routes_by_rank():
    g = _grid(8, 4, 2)
    one = OA.downsample_aniso_plain(g)
    assert torch.equal(one, A.downsample_aniso_from_iso(g))
    assert torch.equal(OA.downsample_aniso_plain(one),
                       A.downsample_aniso(one))


def test_function_backward_replays_the_plain_version():
    """The autograd Function with the plain forward injected: the same
    values, and the gradient of autograd through the plain version."""
    g = _grid(8, 4, 3)
    a = g.clone().requires_grad_()
    b = g.clone().requires_grad_()
    one_a = _build.Replay.apply(OA.downsample_aniso_plain,
                                OA.downsample_aniso_plain, (), a)
    two_a = _build.Replay.apply(OA.downsample_aniso_plain,
                                OA.downsample_aniso_plain, (), one_a)
    one_b = OA.downsample_aniso_plain(b)
    two_b = OA.downsample_aniso_plain(one_b)
    assert torch.equal(two_a, two_b)
    w = torch.as_tensor(np.random.default_rng(4).normal(
        size=two_b.shape).astype(np.float32))
    (two_a * w).sum().backward()
    (two_b * w).sum().backward()
    assert torch.allclose(a.grad, b.grad, rtol=0, atol=1e-7)
    assert float(a.grad.abs().sum()) > 0


def test_mixed_devices_raise():
    """The dispatch rule refuses a device that is neither all CUDA nor
    all CPU (a meta tensor stands in)."""
    with pytest.raises(ValueError):
        OA.downsample_aniso(torch.empty((4, 4, 4, 4), device="meta"))


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        OA.downsample_aniso_cuda(_grid(8, 4, 5))


def _span_names(cfg_aniso: bool):
    """The radiance pyramid of an 8^3 grid inside the `radiance_mips`
    span under the profiler, and the program's host ranges."""
    cfg = preset("sponza256")
    cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, dim=8, anisotropic=cfg_aniso))
    lit = _grid(8, 4, 6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stages.span("radiance_mips"):
            mips = R._radiance_mips(cfg, lit)
    ranges = {e.name: e.time_range for e in prof.events()
              if e.device_type == DeviceType.CPU
              and e.name.startswith("vct.")}
    return mips, ranges


def test_aniso_span_inside_radiance_mips():
    mips, ranges = _span_names(True)
    assert A.is_aniso_stack(mips)
    assert {"vct.radiance_mips", "vct.aniso_mips"} <= set(ranges)
    outer, inner = ranges["vct.radiance_mips"], ranges["vct.aniso_mips"]
    assert outer.start <= inner.start and inner.end <= outer.end


def test_isotropic_route_opens_no_aniso_span():
    mips, ranges = _span_names(False)
    assert not A.is_aniso_stack(mips)
    assert "vct.aniso_mips" not in ranges


@pytest.mark.parametrize("dim,channels,num_levels",
                         [(32, 4, None), (64, 4, None), (64, 4, 3),
                          (16, 3, None)])
def test_kernel_equals_plain_bit_for_bit(card, dim, channels, num_levels):
    g = _grid(dim, channels, 7 + dim, device=card)
    before = _build.launches()["aniso"]
    got = OA.build_aniso_mips(g, num_levels)
    assert _build.launches()["aniso"] - before == len(got) - 1
    want = A.build_aniso_mips(g, num_levels)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cpu = A.build_aniso_mips(g.cpu(), num_levels)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu))


def test_kernel_keeps_gradients(card):
    g = _grid(16, 4, 8, device=card)
    a = g.clone().requires_grad_()
    b = g.clone().requires_grad_()
    OA.build_aniso_mips(a)[-1].sum().backward()
    A.build_aniso_mips(b)[-1].sum().backward()
    assert torch.allclose(a.grad, b.grad, rtol=0, atol=1e-7)
