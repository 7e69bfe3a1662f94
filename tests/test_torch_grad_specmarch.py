"""The specular march's backward against the JAX package's, and its
autograd Function's wiring (the other kernels: test_torch_grad.py, whose
tolerances this file shares: REL for float32 gradients, BF16_REL for the
bfloat16 pyramid's, summed in bfloat16 in two orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_specmarch as TSM
from test_torch_grad import (BF16_REL, REL, _packed_leaf, _same, _vjp_torch,
                             cotangent, f32, leaf)
from vct_tpu.ops import specmarch_pallas as JSP
from vct_tpu_torch.ops import _build, mip
from vct_tpu_torch.ops import specmarch as SM

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4


# specmarch: gradients to start4, refl4 and the radiance pyramid

@pytest.fixture(scope="module")
def spec_case():
    """test_torch_specmarch's "coherent" case: the JAX pages and brick
    lists, and the port's pyramid and step table, without the interpret
    kernel's forward."""
    mip_kw, ray_kw = TSM.CASES["coherent"]
    jmips = TSM._mips(**mip_kw)
    start4, refl4 = TSM._rays(**ray_kw)
    pages = JSP.pack_spec_mips(jmips)
    dims = JSP.pages_dims(pages)
    groups = TSM._groups(dims)
    nt, tile = TSM.NT, TSM.TILE
    valid = start4[:, 3] > 0.5
    lists, _ = JSP.select_spec_bricks(
        jnp.asarray(start4[:, :3].reshape(nt, tile, 3)),
        jnp.asarray(refl4[:, :3].reshape(nt, tile, 3)),
        jnp.asarray(valid.reshape(nt, tile)), groups, dims, TSM.WS,
        occlusion_falloff=TSM.FALLOFF)
    t_start4, t_refl4 = torch.as_tensor(start4), torch.as_tensor(refl4)
    levels = SM.select_spec_levels(
        t_start4[:, :3].reshape(nt, tile, 3),
        t_refl4[:, :3].reshape(nt, tile, 3),
        torch.as_tensor(valid).reshape(nt, tile), groups, dims, TSM.WS)
    step_lv, weights = SM.step_table(groups, levels, TSM.FALLOFF)
    return dict(jmips=jmips, start4=start4, refl4=refl4, pages=pages,
                dims=dims, groups=groups, lists=lists, step_lv=step_lv,
                weights=weights)


@pytest.mark.parametrize("tables", ["float32", "bfloat16"])
def test_specmarch_vjp_matches_jax(spec_case, tables):
    """spec_march_ref's VJP, which is the JAX package's custom VJP of
    spec_march_tiles (specmarch_pallas.py:722-736): taken here directly,
    as the interpret kernel's forward adds a minute and no gradient."""
    c = spec_case
    pages = c["pages"]
    if tables == "float32":
        pages = pages.astype(jnp.float32)

    def fn(s4, r4, pg):
        return JSP.spec_march_ref(s4, r4, c["lists"], pg, c["groups"],
                                  c["dims"], TSM.WS, TSM.MAX_ALPHA,
                                  TSM.FALLOFF, tile=TSM.TILE)

    out, vjp = jax.vjp(fn, jnp.asarray(c["start4"]), jnp.asarray(c["refl4"]),
                       pages)
    ct = cotangent(out.shape, seed=7)
    js, jr, jp = vjp(jnp.asarray(ct))
    # the level gradients of the page copy spec_march_ref reads
    # (interop.spec_pyramid's cut)
    jp = f32(jp)
    d0 = c["dims"][0]
    ref_p = np.concatenate([
        jp[0, 0, 2 * d0 - 2 * d:2 * d0 - 2 * d + d, :d, :d * SM.NC]
        .reshape(-1) for d in c["dims"]])
    pyr = SM.pack_spec_mips([torch.as_tensor(np.array(m))
                             for m in c["jmips"]])
    st, rt = leaf(c["start4"]), leaf(c["refl4"])
    pflat, pv = _packed_leaf([m.to(getattr(torch, tables)) for m in pyr])
    out_p = SM.spec_march_plain(st, rt, c["step_lv"], c["weights"], pv,
                                world_size=TSM.WS, max_alpha=TSM.MAX_ALPHA)
    ds, dr, dp = _vjp_torch(out_p, (st, rt, pflat), ct)
    _same(ds, js)
    _same(dr, jr)
    _same(dp, ref_p, REL if tables == "float32" else BF16_REL)


def test_specmarch_function_wiring(spec_case):
    c = spec_case
    ct = torch.as_tensor(cotangent(c["start4"].shape, seed=8))
    kw = dict(world_size=TSM.WS, max_alpha=TSM.MAX_ALPHA)
    lv, wt = c["step_lv"], c["weights"]

    def grads(fn):
        st, rt = leaf(c["start4"]), leaf(c["refl4"])
        m0 = leaf(c["jmips"][0])
        pyr = SM.pack_spec_mips(mip.build_mips(m0))
        out = fn(st, rt, pyr)
        return [x.numpy() for x in torch.autograd.grad(out, (st, rt, m0),
                                                       ct)]

    want = grads(lambda s, r, p: SM.spec_march_plain(s, r, lv, wt, p, **kw))
    plain = SM.flat(SM.spec_march_plain, **kw)
    got = grads(lambda s, r, p: _build.Replay.apply(plain, plain, SM.FROZEN,
                                                    s, r, lv, wt, *p))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert np.abs(a).max() > 0
