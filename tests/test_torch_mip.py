"""Kernel 1 (mip reduction): the port's build_mips against the JAX
package's grid.build_mips and its Pallas kernel (interpret mode on the
CPU), atol 1e-6 as tests/test_ops_pallas.py.  On CPU tensors the wrapper
runs the plain version; the CUDA kernel is checked against it on the card
by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.core import grid as jgrid
from vct_tpu.ops import mip_pallas as jmip
from vct_tpu_torch.ops import mip

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4


def _grid(d, c, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.random((d, d, d, c), np.float32)
    g[..., -1] = (g[..., -1] > 0.7)          # sparse occupancy alpha
    return g


@pytest.mark.parametrize("mode", ["mean", "max"])
@pytest.mark.parametrize("d,c", [(32, 4), (16, 1), (8, 13), (16, 208)])
def test_build_mips_matches_grid(d, c, mode):
    g = _grid(d, c)
    before = mip.LAUNCHES
    a = mip.build_mips(torch.as_tensor(g), alpha_mode=mode)
    b = jgrid.build_mips(jnp.asarray(g), alpha_mode=mode)
    assert mip.LAUNCHES == before        # CPU tensors never launch
    assert len(a) == len(b) == d.bit_length()
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("num_levels", [1, 3, 99])
def test_num_levels(num_levels):
    g = torch.as_tensor(_grid(16, 4))
    assert len(mip.build_mips(g, num_levels)) == \
        len(jgrid.build_mips(jnp.asarray(g.numpy()), num_levels))


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_matches_pallas_kernel(mode):
    g = _grid(32, 4, seed=1)
    a = mip.downsample2x(torch.as_tensor(g), mode)
    b = jmip.downsample2x_pallas(jnp.asarray(g), mode)   # interpret on CPU
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_max_alpha_is_exact_max():
    g = _grid(8, 4, seed=2)
    a = mip.downsample2x(torch.as_tensor(g), "max").numpy()
    ref = g[..., 3].reshape(4, 2, 4, 2, 4, 2).max(axis=(1, 3, 5))
    np.testing.assert_array_equal(a[..., 3], ref)


def test_rejects_bad_input():
    with pytest.raises(ValueError):
        mip.build_mips(torch.zeros(6, 6, 6, 4))
    with pytest.raises(ValueError):
        mip.downsample2x(torch.zeros(4, 4, 4, 4), "min")
