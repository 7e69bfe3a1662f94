"""The port's forward step (vct_tpu_torch/entry.py) against
__graft_entry__.entry() on the CPU: JAX's forward under jax.jit on its
own example arguments, the port's forward on those arguments carried
across by interop, and on its own.  Bounds: tests/test_torch_oracle.py's
render_rays bounds, mean < 1e-4 and p99 < 1e-3 of the absolute error."""

import dataclasses

import numpy as np
import pytest
import torch

from vct_tpu_torch import entry as E
from vct_tpu_torch import interop

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

CPU = torch.device("cpu")
MEAN, P99 = 1e-4, 1e-3


@pytest.fixture(scope="module")
def jax_entry():
    import jax
    import __graft_entry__ as GE
    fn, args = GE.entry()
    img = np.asarray(jax.jit(fn)(*args))
    host = jax.tree_util.tree_map(np.asarray, args)
    return img, host


@pytest.fixture(scope="module")
def port_entry():
    return E.entry(device="cpu")


def held(img, ref):
    assert img.shape == ref.shape == (64, 64, 3)
    assert np.isfinite(img).all()
    e = np.abs(img - ref)
    assert e.mean() < MEAN and np.percentile(e, 99) < P99, (
        e.mean(), np.percentile(e, 99))


def test_example_args_equal_jax(jax_entry, port_entry):
    """The port's example arguments are JAX's: the same rays, camera,
    surface samples and material constants."""
    origins, dirs, cam_pos, samples, mats = jax_entry[1]
    p_origins, p_dirs, p_cam, p_samples, p_mats = port_entry[1]
    np.testing.assert_array_equal(p_origins.numpy(), origins)
    np.testing.assert_allclose(p_dirs.numpy(), dirs, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(p_cam.numpy(), cam_pos)
    for f in dataclasses.fields(p_samples):
        np.testing.assert_allclose(getattr(p_samples, f.name).numpy(),
                                   getattr(samples, f.name), rtol=0,
                                   atol=1e-5, err_msg=f.name)
    for name in ("albedo", "specular", "emissive", "shininess"):
        np.testing.assert_array_equal(getattr(p_mats, name).numpy(),
                                      getattr(mats, name))


def test_forward_on_jax_args_matches_jax(jax_entry, port_entry):
    img, (origins, dirs, cam_pos, samples, mats) = jax_entry
    forward = port_entry[0]
    out = forward(interop.tensor(origins, CPU), interop.tensor(dirs, CPU),
                  interop.tensor(cam_pos, CPU), interop.samples(samples, CPU),
                  interop.material_table(mats, CPU))
    held(out.numpy(), img)


def test_forward_on_own_args_matches_jax(jax_entry, port_entry):
    forward, args = port_entry
    held(forward(*args).numpy(), jax_entry[0])


def test_dryrun_multichip_is_tile_dp():
    from vct_tpu_torch.parallel import tile_dp
    assert E.dryrun_multichip is tile_dp.dryrun_multichip
