"""The backward passes of the port's kernels against the JAX package's.

Per kernel on the inverse-rendering path:
  * the mip adjoint: `mip.downsample2x_bwd_plain` against jax.vjp of
    core/grid.py downsample2x and torch autograd of the plain version, on
    grids whose alphas are 0/1 occupancy (ties everywhere): exact;
  * raycast, material and tap (specmarch: test_torch_grad_specmarch.py):
    jax.vjp of the JAX package's
    public function (its custom VJP, the kernel in interpret mode
    forward) against torch.autograd.grad of the port's plain version,
    with one seeded cotangent, on the inputs of tests/test_torch_{raycast,
    material,tap}.py: relative L2 error <= 1e-5 (the bfloat16 tables'
    gradients: below);
  * each autograd Function (what the card runs) on the CPU with its plain
    forward (and for mip its plain backward) injected: the wiring (the
    raycast's chunks, the None slots of inputs that get no gradient, the
    levels that are views into one pack_mips buffer) gives what autograd
    of the plain version gives;
  * the refusals: the binned and streamed raycasts raise on inputs that
    need grad, and camera_pass="fast" above raycast.MAX_TRIANGLES raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_material as TMT
import test_torch_raycast as TRC
import test_torch_tap as TTP
from vct_tpu.core import grid as jgrid
from vct_tpu.ops import material_pallas as JMP
from vct_tpu.ops import raycast_pallas as JRP
from vct_tpu.ops import tap_pallas as JTP
from vct_tpu_torch import interop
from vct_tpu_torch.config import preset
from vct_tpu_torch.core import camera as CAM
from vct_tpu_torch.diff import inverse as I
from vct_tpu_torch.ops import binrast as BR
from vct_tpu_torch.ops import material as MT
from vct_tpu_torch.ops import mip
from vct_tpu_torch.ops import raycast as RP
from vct_tpu_torch.ops import tap as TP
from vct_tpu_torch.render import fast as F
from vct_tpu_torch.render import gbuffer as GB
from vct_tpu_torch.scene.cornell import cornell_box
from vct_tpu_torch.scene.mesh import subdivide_scene

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

REL = 1e-5                  # relative L2 error of a gradient against JAX's


def rel_err(port, ref) -> float:
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert np.linalg.norm(ref) > 0
    return float(np.linalg.norm(port - ref) / np.linalg.norm(ref))


def f32(x) -> np.ndarray:
    """torch (bf16 included) or jax array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def cotangent(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def leaf(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x)).requires_grad_()


# ---------------------------------------------------------------------------
# mip: the hand-written adjoint and its plain version
# ---------------------------------------------------------------------------

def _occupancy_grid(d, c, seed):
    """Random colors; alphas 0/1 with whole occupied and empty octants,
    so that most parents see 8 equal children."""
    rng = np.random.default_rng(seed)
    g = rng.random((d, d, d, c), np.float32)
    a = (rng.random((d, d, d)) < 0.4).astype(np.float32)
    a[: d // 2, : d // 2] = 1.0
    a[d // 2:, d // 2:, : d // 2] = 0.0
    g[..., -1] = a
    return g


@pytest.mark.parametrize("mode", ["max", "mean"])
@pytest.mark.parametrize("d,c", [(8, 1), (8, 4), (16, 4), (4, 7)])
def test_mip_adjoint_matches_jax_and_autograd(mode, d, c):
    g = _occupancy_grid(d, c, seed=d + c)
    ct = cotangent((d // 2,) * 3 + (c,), seed=c)
    _, vjp = jax.vjp(lambda x: jgrid.downsample2x(x, mode), jnp.asarray(g))
    ref = np.asarray(vjp(jnp.asarray(ct))[0])
    t = leaf(g)
    (auto,) = torch.autograd.grad(mip.downsample2x_plain(t, mode), t,
                                  torch.as_tensor(ct))
    plain = mip.downsample2x_bwd_plain(
        torch.as_tensor(ct), torch.as_tensor(g[..., -1]).contiguous(), mode)
    np.testing.assert_array_equal(auto.numpy(), ref)
    np.testing.assert_array_equal(plain.numpy(), ref)


def test_mip_tie_weights():
    """Eight equal alphas: the maximum chain passes 1/128, 1/128, 1/64,
    ..., 1/2 of the cotangent to the corners, x outer and z inner."""
    ct = torch.ones((1, 1, 1, 1))
    gin = mip.downsample2x_bwd_plain(ct, torch.ones((2, 2, 2)), "max")
    want = [1 / 128, 1 / 128, 1 / 64, 1 / 32, 1 / 16, 1 / 8, 1 / 4, 1 / 2]
    np.testing.assert_array_equal(gin[..., 0].reshape(-1).numpy(),
                                  np.float32(want))


@pytest.mark.parametrize("mode", ["max", "mean"])
def test_mip_function_wiring(mode):
    """A 16^3 pyramid through the autograd Function (plain forward and
    backward injected) gives autograd's gradient of the plain pyramid,
    bit for bit: every level feeds the loss and the next level."""
    g = _occupancy_grid(16, 4, seed=3)
    cts = [torch.as_tensor(cotangent((16 >> k,) * 3 + (4,), seed=k))
           for k in range(5)]

    def grad(down):
        t = leaf(g)
        mips = [t]
        for _ in range(4):
            mips.append(down(mips[-1]))
        loss = sum((m * c).sum() for m, c in zip(mips, cts))
        return torch.autograd.grad(loss, t)[0].numpy()

    want = grad(lambda x: mip.downsample2x_plain(x, mode))
    got = grad(lambda x: mip.Downsample2x.apply(
        x, mode, mip.downsample2x_plain, mip.downsample2x_bwd_plain))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# raycast: gradients to the attribute table
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(TRC.SCENES))
def ray_case(request):
    """test_torch_raycast's setup: the JAX tables, the frame's rays."""
    return TRC.setup.__wrapped__(request)


def test_raycast_vjp_matches_jax(ray_case):
    _, d, o, _, isect, attrs, t = ray_case
    jargs = tuple(map(jnp.asarray, (d, o, isect, attrs)))
    out, vjp = jax.vjp(lambda *a: JRP.raycast_gbuf24(*a, interpret=True),
                       *jargs)
    ct = cotangent(out.shape, seed=1)
    jd, jo, ji, ja = (np.asarray(x) for x in vjp(jnp.asarray(ct)))
    assert not (jd.any() or jo.any() or ji.any())    # geometry: no gradient
    assert not ja[t:].any()                          # padding rows
    at = leaf(attrs[:t])
    out_p = RP.raycast_plain(torch.as_tensor(d), torch.as_tensor(o),
                             torch.as_tensor(isect.T[:t].copy()), at)
    (ga,) = torch.autograd.grad(out_p, at, torch.as_tensor(ct))
    assert rel_err(ga, ja[:t]) <= REL


@pytest.mark.parametrize("chunk", [100, RP.BWD_CHUNK])
def test_raycast_function_wiring(ray_case, monkeypatch, chunk):
    """The Function's backward replays in chunks of BWD_CHUNK rays and
    leaves the directions, origin and hit tests without a gradient.  In
    one chunk it equals autograd of the plain version bit for bit; in
    chunks of 100 rays (several, and a short last one) it adds the same
    terms in another order: relative L2 error <= 1e-6."""
    _, d, o, _, isect, attrs, t = ray_case
    monkeypatch.setattr(RP, "BWD_CHUNK", chunk)
    ct = torch.as_tensor(cotangent((d.shape[0], RP.NOUT), seed=2))
    dt, ot = leaf(d), leaf(o)
    it = torch.as_tensor(isect.T[:t].copy())
    at = leaf(attrs[:t])
    out = RP.Raycast.apply(dt, ot, it, at, RP.raycast_plain)
    assert out.grad_fn is not None
    out.backward(ct)
    assert dt.grad is None and ot.grad is None
    want = leaf(attrs[:t])
    (gw,) = torch.autograd.grad(
        RP.raycast_plain(dt.detach(), ot.detach(), it, want), want, ct)
    if chunk >= d.shape[0]:
        np.testing.assert_array_equal(at.grad.numpy(), gw.numpy())
    else:
        assert rel_err(at.grad, gw) <= 1e-6


# ---------------------------------------------------------------------------
# the table kernels: material and tap (specmarch: test_torch_grad_specmarch)
#
# Their tables are bfloat16, and both frameworks give a bfloat16 input a
# bfloat16 gradient, summed in bfloat16 in each one's own order (a table
# cell collects many pixels' terms).  So each is checked twice: with the
# tables in float32 (the same values), where every gradient is within
# REL of the JAX package's; and as it runs, with bfloat16 tables, where
# the float32 gradients are within REL and the tables' within BF16_REL.
# ---------------------------------------------------------------------------

BF16_REL = 2e-2     # bf16 sums in two orders: each add rounds at 2**-9


def _same(port, ref, rel=REL):
    """A gradient against JAX's: None (the input does not reach the
    output) stands for zeros."""
    ref = f32(ref)
    if port is None or not np.abs(ref).any():
        assert port is None or not f32(port).any()
        assert not np.abs(ref).any()
        return
    assert rel_err(f32(port), ref) <= rel


def _vjp_torch(out, leaves, ct):
    return torch.autograd.grad(out, leaves, torch.as_tensor(ct),
                               allow_unused=True)


# material: gradients to the G-buffer and the atlas pages

@pytest.fixture(scope="module")
def jpages():
    jatlas = TMT.JTX.TextureAtlas.from_materials(
        [TMT.JMaterial(**t) for t in TMT._textures()], resolution=TMT.RES)
    return JMP.atlas_mip_pages(jatlas.albedo, jatlas.specular, jatlas.height)


def _material_inputs(case):
    """test_torch_material's G-buffer and the JAX package's material
    tables for one of its cases."""
    uv, mat, hit = TMT._case(case)
    ntiles = uv.shape[0] // TMT.TILE
    scal, lists, slots = JMP.select_material_bricks(
        jnp.asarray(mat).reshape(ntiles, TMT.TILE).astype(jnp.int32),
        jnp.asarray(uv).reshape(ntiles, TMT.TILE, 2),
        jnp.asarray(hit).reshape(ntiles, TMT.TILE).astype(bool),
        num_materials=3, resolution=TMT.RES,
        num_levels=TMT.RES.bit_length())
    g = np.zeros((uv.shape[0], 32), np.float32)
    g[:, 15:17], g[:, 17], g[:, 19] = uv, mat, hit
    return g, np.asarray(slots).reshape(-1, 1), np.asarray(scal), \
        np.asarray(lists)


def _material_port(g, slots, scal, lists, pages):
    gt = leaf(g)
    pt = pages.detach().clone().requires_grad_()
    out = MT.material_plain(gt, torch.as_tensor(slots),
                            torch.as_tensor(scal),
                            torch.as_tensor(lists[:scal.shape[0]]), pt,
                            TMT.RES)
    return out, (gt, pt)


@pytest.mark.parametrize("case", ["level0", "random"])
def test_material_vjp_float32_tables(jpages, case):
    g, slots, scal, lists = _material_inputs(case)
    p32 = jnp.asarray(jpages, jnp.float32)

    def fn(gb, pg):
        return JMP.material_tiles_ref(gb, jnp.asarray(slots),
                                      jnp.asarray(scal), jnp.asarray(lists),
                                      pg, TMT.RES, tile=TMT.TILE)

    out, vjp = jax.vjp(fn, jnp.asarray(g), p32)
    ct = cotangent(out.shape, seed=3)
    out_p, leaves = _material_port(g, slots, scal, lists,
                                   torch.as_tensor(np.asarray(p32)))
    for port, ref in zip(_vjp_torch(out_p, leaves, ct),
                         vjp(jnp.asarray(ct))):
        _same(port, ref)


def test_material_vjp_matches_jax(jpages):
    """The JAX package's public material_tiles (its custom VJP; forward
    in interpret mode) on bfloat16 pages."""
    g, slots, scal, lists = _material_inputs("multi")

    def fn(gb, pg):
        return JMP.material_tiles(gb, jnp.asarray(slots), jnp.asarray(scal),
                                  jnp.asarray(lists), pg,
                                  resolution=TMT.RES, interpret=True,
                                  tile=TMT.TILE)

    out, vjp = jax.vjp(fn, jnp.asarray(g), jpages)
    ct = cotangent(out.shape, seed=3)
    jg, jp = vjp(jnp.asarray(ct))
    out_p, leaves = _material_port(g, slots, scal, lists,
                                   interop.tensor(jpages, "cpu"))
    dg, dp = _vjp_torch(out_p, leaves, ct)
    assert dp.dtype == torch.bfloat16
    _same(dg, jg)
    _same(dp, jp, BF16_REL)


def test_material_function_wiring(jpages):
    g, slots, scal, lists = _material_inputs("multi")
    pages = interop.tensor(jpages, "cpu")
    ct = torch.as_tensor(cotangent((g.shape[0], MT.NOUT), seed=4))
    ints = (torch.as_tensor(slots), torch.as_tensor(scal),
            torch.as_tensor(lists[:scal.shape[0]]))

    def grads(fn):
        gt = leaf(g)
        pt = pages.clone().requires_grad_()
        return [x.float().numpy() for x in torch.autograd.grad(
            fn(gt, pt), (gt, pt), ct)]

    want = grads(lambda gt, pt: MT.material_plain(gt, *ints, pt, TMT.RES))
    got = grads(lambda gt, pt: MT.Material.apply(
        gt, *ints, pt, TMT.RES, TMT.TILE, MT.material_plain))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert np.abs(a).max() > 0


# tap: gradients to the G-buffer, bump normals, camera and both tables

@pytest.fixture(scope="module", params=[2, 1], ids=["spec", "nospec"])
def tap_case(request):
    return TTP.setup.__wrapped__(request)


def _packed_leaf(levels):
    """One leaf buffer holding the levels back to back, and the levels as
    views into it (the pack_mips layout)."""
    flat = torch.cat([m.reshape(-1) for m in levels]).detach() \
        .requires_grad_()
    views, off = [], 0
    for m in levels:
        views.append(flat[off:off + m.numel()].view(m.shape))
        off += m.numel()
    return flat, tuple(views)


def _tap_unpad(jl, jf, cfield):
    """The JAX package's padded light and field levels (or their
    gradients) -> the port's levels back to back, flat, in float32."""
    return (np.concatenate([f32(m)[:, :m.shape[0], :m.shape[0]].reshape(-1)
                            for m in jl]),
            np.concatenate([f32(m)[:, :, :m.shape[0], :cfield].reshape(-1)
                            for m in jf]))


def _tap_port(jargs, kw, tables, dtype):
    g, scal, bumpn, campos = (np.asarray(x) for x in jargs[:4])
    leaves = [leaf(g), leaf(bumpn), leaf(campos)]
    lflat, lv = _packed_leaf([m.to(dtype) for m in tables.light_mips])
    fflat, fv = _packed_leaf([m.to(dtype) for m in tables.field_mips])
    out = TP.tap_plain(leaves[0], torch.as_tensor(scal), leaves[1],
                       leaves[2], lv, fv, **kw)
    return out, leaves + [lflat, fflat]


@pytest.mark.parametrize("tables", ["float32", "bfloat16"])
def test_tap_vjp_matches_jax(tap_case, tables):
    """float32: tap_tiles_ref's VJP on float32 tables; bfloat16: the JAX
    package's public tap_tiles (its custom VJP, forward in interpret
    mode) on its own tables."""
    _, jargs, kw, (_, _, port_tables) = tap_case
    g, scal, bumpn, campos, jlight, jfield = jargs
    if tables == "float32":
        jlight = [m.astype(jnp.float32) for m in jlight]
        jfield = [m.astype(jnp.float32) for m in jfield]

        def fn(gb, bn, cp, lm, fm):
            return JTP.tap_tiles_ref(gb, scal, bn, cp, lm, fm, **kw)
    else:
        def fn(gb, bn, cp, lm, fm):
            return JTP.tap_tiles(gb, scal, bn, cp, lm, fm, interpret=True,
                                 **kw)

    out, vjp = jax.vjp(fn, g, bumpn, campos, jlight, jfield)
    ct = cotangent(out.shape, seed=5)
    jg, jb, jc, jl, jf = vjp(jnp.asarray(ct))
    out_p, leaves = _tap_port(jargs, kw, port_tables, getattr(torch, tables))
    grads = _vjp_torch(out_p, leaves, ct)
    table_rel = REL if tables == "float32" else BF16_REL
    refs = (jg, jb, jc) + _tap_unpad(jl, jf, kw["cfield"])
    for k, (port, ref) in enumerate(zip(grads, refs)):
        _same(port, ref, REL if k < 3 else table_rel)


def test_tap_function_wiring(tap_case):
    """Through the Function, the tables' gradients reach the float32 mips
    through pack_mips' bfloat16 cast."""
    _, jargs, kw, (light, field, _) = tap_case
    g, scal, bumpn, campos = (np.asarray(x) for x in jargs[:4])
    ct = torch.as_tensor(cotangent((g.shape[0], TP.NOUT), seed=6))

    def grads(fn):
        lt = leaf(np.asarray(light)[..., 0])
        ft = leaf(np.asarray(field))
        leaves = (leaf(g), leaf(bumpn), leaf(campos), lt, ft)
        lm = TP.pack_mips(mip.build_mips(lt, num_levels=2))
        fm = TP.pack_mips(mip.build_mips(ft, num_levels=2))
        out = fn(leaves[0], torch.as_tensor(scal), leaves[1], leaves[2], lm,
                 fm)
        return torch.autograd.grad(out, leaves, ct, allow_unused=True)

    want = grads(lambda *a: TP.tap_plain(*a, **kw))
    got = grads(lambda g_, s_, b_, c_, lm, fm: TP.Tap.apply(
        kw, len(lm), TP.tap_plain, g_, s_, b_, c_, *lm, *fm))
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (want[1] is None) == (kw["cfield"] == 4 * kw["nb"])


# ---------------------------------------------------------------------------
# kernels without a backward refuse inputs that need one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell_frame():
    """The Cornell box's primary rays at 64x16 in tile order."""
    o, dimg = CAM.primary_rays(CAM.Camera(position=(3.0, 2.0, 140.0)), 64,
                               16, device="cpu")
    d = F._tile_order(dimg, 16, 64).contiguous()
    ds = GB.DeviceScene.from_scene(cornell_box(size=100.0), device="cpu")
    alb = torch.full((8, 4), 0.5)
    return ds, o.reshape(-1, 3)[0].contiguous(), d, dimg, alb


def _binned(frame, alb):
    ds, origin, d, dimg, _ = frame
    return BR.raycast_pinhole_binned(ds, origin, d, dimg, albedo=alb)


def _streamed(frame, alb):
    ds, origin, d, _, _ = frame
    isect, attrs, spheres = RP.pack_tables_stream(ds, origin, albedo=alb)
    lists, counts = RP.select_chunks(d.reshape(-1, RP.TILE, 3), spheres)
    return RP.raycast_stream(d, origin, isect, attrs, lists, counts, spheres)


@pytest.mark.parametrize("cast", [_binned, _streamed],
                         ids=["binned", "streamed"])
def test_no_backward_refuses_grad(cornell_frame, cast):
    alb = cornell_frame[4]
    with pytest.raises(RuntimeError, match="has no backward"):
        cast(cornell_frame, alb.clone().requires_grad_())
    with torch.no_grad():
        out = cast(cornell_frame, alb.clone().requires_grad_())
    ref = cast(cornell_frame, alb)
    assert bool((ref[:, 19] > 0.5).any())
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_fast_pass_refuses_above_max_triangles():
    cfg = preset("inverse")
    cfg = dataclasses.replace(
        cfg, cones=dataclasses.replace(cfg.cones, diffuse_mode="field",
                                       specular_mode="field"))
    scene = subdivide_scene(cornell_box(size=100.0), 3)
    ds = GB.DeviceScene.from_scene(scene, device="cpu")
    assert ds.v0.shape[0] > RP.MAX_TRIANGLES
    inv = I.InverseConfig(optimize=("albedo",), camera_pass="fast")
    with pytest.raises(ValueError, match="differentiable only up to 2048"):
        I.make_loss_fn(inv, cfg, ds, torch.zeros(3))
    small = GB.DeviceScene.from_scene(cornell_box(size=100.0), device="cpu")
    I.make_loss_fn(inv, cfg, small, torch.zeros(3))
