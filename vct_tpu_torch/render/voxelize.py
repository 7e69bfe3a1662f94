"""Deterministic scatter voxelization (port of vct_tpu/render/voxelize.py:36-174).

Host (once per scene): stratified surface samples per triangle, from the
native C++ generator (vct_tpu_torch/native, triangle-major) or the numpy
path (batched by subdivision level), bit-identical sample for sample.
Device (torch): scatter-mean of sample values into the grid.  The scatter
is a stable sort by cell followed by a segment reduction in sample order,
never float atomics, so two builds give bit-identical grids.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from vct_tpu_torch import native
from vct_tpu_torch.scene.mesh import Scene
from vct_tpu_torch.core.grid import world_to_uvw
from vct_tpu_torch.stages import span

Tensor = torch.Tensor


@dataclasses.dataclass
class SurfaceSamples:
    """Static point-sampling of scene surfaces (host-side prep output)."""

    positions: np.ndarray      # (S, 3) world space
    normals: np.ndarray        # (S, 3) face normals
    uvs: np.ndarray            # (S, 2)
    material_ids: np.ndarray   # (S,) int32
    tri_ids: np.ndarray        # (S,) int32

    @property
    def count(self) -> int:
        return int(self.positions.shape[0])


def generate_surface_samples(
    scene: Scene,
    voxel_world_size: float,
    samples_per_voxel_width: float = 2.0,
    max_samples_per_tri: int = 4096,
    backend: str = "auto",
) -> SurfaceSamples:
    """Stratified barycentric samples, ~density^2 per voxel-sized patch.

    Per triangle the subdivision n is chosen so sample spacing is at most
    voxel_size/density along the longest edge, so every voxel a triangle
    crosses receives samples.

    backend="auto" takes the native C++ generator (vct_tpu_torch/native),
    which raises if the library cannot be built: triangle-major order.
    "python" takes the numpy path here, which batches triangles by
    subdivision level.  Both give the same samples of each triangle in
    the same order, bit for bit, so a stable sort by tri_ids makes them
    equal; the splat sums a voxel's samples in input order, so builds
    from the two may differ in the last bits.  Anything else raises
    ValueError.
    """
    if backend not in ("auto", "python"):
        raise ValueError(f"unknown sampling backend {backend!r}")
    tv = scene.triangle_vertices()                    # (T, 3, 3)
    fn = scene.face_normals()
    t_uv = scene.uvs[scene.indices]                   # (T, 3, 2)
    if backend == "auto":
        pos, nrm, uv, mat, tri = native.surface_samples(
            tv, t_uv, fn, scene.tri_material, voxel_world_size,
            samples_per_voxel_width, max_samples_per_tri)
        return SurfaceSamples(positions=pos, normals=nrm, uvs=uv,
                              material_ids=mat, tri_ids=tri)

    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    e3 = tv[:, 2] - tv[:, 1]
    longest = np.maximum(np.maximum(
        np.linalg.norm(e1, axis=-1), np.linalg.norm(e2, axis=-1)),
        np.linalg.norm(e3, axis=-1))
    n_per_tri = np.ceil(longest / voxel_world_size * samples_per_voxel_width)
    n_per_tri = np.clip(n_per_tri, 1,
                        int(np.sqrt(max_samples_per_tri))).astype(np.int64)

    pos_out, nrm_out, uv_out, mat_out, tri_out = [], [], [], [], []
    for n in np.unique(n_per_tri):
        sel = np.nonzero(n_per_tri == n)[0]
        ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        keep_lo = (ii + jj) <= n - 1
        u_lo = (ii[keep_lo] + 1.0 / 3.0) / n
        v_lo = (jj[keep_lo] + 1.0 / 3.0) / n
        keep_hi = (ii + jj) <= n - 2
        u_hi = (ii[keep_hi] + 2.0 / 3.0) / n
        v_hi = (jj[keep_hi] + 2.0 / 3.0) / n
        u = np.concatenate([u_lo, u_hi]).astype(np.float32)
        v = np.concatenate([v_lo, v_hi]).astype(np.float32)
        w0 = 1.0 - u - v
        p = (w0[None, :, None] * tv[sel, None, 0]
             + u[None, :, None] * tv[sel, None, 1]
             + v[None, :, None] * tv[sel, None, 2])
        uvs = (w0[None, :, None] * t_uv[sel, None, 0]
               + u[None, :, None] * t_uv[sel, None, 1]
               + v[None, :, None] * t_uv[sel, None, 2])
        pcount = p.shape[1]
        pos_out.append(p.reshape(-1, 3))
        uv_out.append(uvs.reshape(-1, 2))
        nrm_out.append(np.repeat(fn[sel], pcount, axis=0))
        mat_out.append(np.repeat(scene.tri_material[sel], pcount))
        tri_out.append(np.repeat(sel.astype(np.int32), pcount))

    return SurfaceSamples(
        positions=np.concatenate(pos_out).astype(np.float32),
        normals=np.concatenate(nrm_out).astype(np.float32),
        uvs=np.concatenate(uv_out).astype(np.float32),
        material_ids=np.concatenate(mat_out).astype(np.int32),
        tri_ids=np.concatenate(tri_out).astype(np.int32),
    )


def splat_partials(
    positions: Tensor,         # (S, 3) world
    values: Tensor,            # (S, C) per-sample radiance/albedo
    weights: Tensor,           # (S,) sample weights (0 drops a sample)
    dim: int,
    world_size: float,
    mode: str = "mean",
):
    """The per-cell partials of splat over these samples: (color (dim^3,
    C), wsum (dim^3,)), where color is sum(w*value) (mode "mean") or the
    per-channel max of the weighted-in values clamped at 0 ("max").  The
    partials of two sample sets combine by a sum (wsum, and color in mode
    "mean") or a max (color in mode "max"); samples outside the grid (a
    padded shard's, at 1e6) are dropped."""
    if mode not in ("mean", "max"):
        raise ValueError(f"unknown splat mode {mode!r}")
    idx = torch.floor(world_to_uvw(positions, world_size) * dim).long()
    inside = torch.all((idx >= 0) & (idx < dim), dim=-1)
    idx = idx.clamp(0, dim - 1)
    flat = (idx[:, 0] * dim + idx[:, 1]) * dim + idx[:, 2]
    w = torch.where(inside, weights, 0.0)
    n = dim ** 3
    c = values.shape[-1]

    # stable sort by cell, then one reduction per occupied cell in sample
    # order: deterministic on every device (no atomics)
    with span("splat.sort", mark=False):    # the count syncs the host
        order = torch.sort(flat, stable=True).indices
        cells, counts = torch.unique_consecutive(flat[order],
                                                 return_counts=True)

    def segments(x, reduce):
        return torch.segment_reduce(x[order], reduce, lengths=counts, axis=0)

    wsum = torch.zeros((n,), dtype=values.dtype, device=values.device)
    wsum[cells] = segments(w, "sum")
    color = torch.zeros((n, c), dtype=values.dtype, device=values.device)
    if mode == "mean":
        color[cells] = segments(w[:, None] * values, "sum")
    else:
        picked = torch.where(w[:, None] > 0, values, 0.0)
        color[cells] = torch.clamp_min(segments(picked, "max"), 0.0)
    return color, wsum


def splat_finish(color: Tensor, wsum: Tensor, dim: int,
                 mode: str = "mean") -> Tensor:
    """Partials -> the (dim, dim, dim, C+1) grid: the mean (or the max)
    in rgb, alpha = occupancy."""
    if mode == "mean":
        color = color / torch.clamp_min(wsum[:, None], 1e-8)
    alpha = (wsum > 0).to(color.dtype)
    out = torch.cat([color, alpha[:, None]], dim=-1)
    return out.reshape(dim, dim, dim, color.shape[-1] + 1)


def splat(
    positions: Tensor,         # (S, 3) world
    values: Tensor,            # (S, C) per-sample radiance/albedo
    weights: Tensor,           # (S,) sample weights (0 drops a sample)
    dim: int,
    world_size: float,
    mode: str = "mean",
    reduce: Optional[Callable] = None,
) -> Tensor:
    """Scatter samples into a (dim, dim, dim, C+1) grid; alpha = occupancy.

    mode="mean": color = sum(w*value)/sum(w) (Voxelization.fs:88's store,
    made deterministic); mode="max": per-channel max.

    reduce(x, op) combines the partials of every shard of a sharded
    sample set (op "sum" or "max", parallel/comm.reducer) before the
    finish; None splats these samples alone."""
    color, wsum = splat_partials(positions, values, weights, dim,
                                 world_size, mode)
    if reduce is not None:
        color = reduce(color, "sum" if mode == "mean" else "max")
        wsum = reduce(wsum, "sum")
    return splat_finish(color, wsum, dim, mode)
