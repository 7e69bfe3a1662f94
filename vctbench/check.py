"""The comparison that decides `correct`: what the timed path produced
against the plain reference (vctbench/reference) on the same inputs.

Numbers compared, each against the cell's limit
(`vctbench/limits/<cell>.json`):
  * image_max_err: the largest absolute difference of any pixel channel
    of the final image (linear RGB);
  * image_mean_err: the mean absolute difference over every pixel
    channel;
  * state_rel_rms: in cells whose steps rebuild the voxel state, the
    largest relative RMS error, (RMS of the difference) / (RMS of the
    reference), over every piece of the state that the reference's route
    builds: the light volume, every level of the radiance and occupancy
    pyramids, the diffuse and specular fields and the shadow map.  A
    piece of any shape compares as it is, so the anisotropic pyramid's
    6-direction levels (5-D) need nothing of their own; a piece the
    reference's route does not build (None) is not compared.
A sample fails when any of its numbers exceeds its limit; the run is
correct when no sample fails and at least one was compared.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

STATE_FIELDS = ("light_volume", "radiance_mips", "unlit_mips",
                "diffuse_field", "specular_field", "shadow_map")


def _pieces(state) -> Iterator[Tuple[str, torch.Tensor]]:
    for f in STATE_FIELDS:
        v = getattr(state, f, None)
        if v is None:
            continue
        if isinstance(v, (tuple, list)):
            for k, t in enumerate(v):
                yield f"{f}[{k}]", t
        else:
            yield f, v


def state_errors(prog, ref) -> Dict[str, float]:
    """{piece: relative RMS error} of the program's voxel state against
    the reference's; a piece one side lacks, or of another shape, reads
    infinity."""
    theirs = dict(_pieces(prog))
    out = {}
    for name, r in _pieces(ref):
        p = theirs.get(name)
        if p is None or tuple(p.shape) != tuple(r.shape):
            out[name] = float("inf")
            continue
        r = r.double()
        d = p.to(r.device).double() - r
        den = float(torch.sqrt(torch.mean(r * r)))
        out[name] = float(torch.sqrt(torch.mean(d * d))) / max(den, 1e-30)
    return out


def image_errors(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    if tuple(prog.shape) != tuple(ref.shape):
        return {"image_max_err": float("inf"),
                "image_mean_err": float("inf")}
    d = (prog.to(ref.device).double() - ref.double()).abs()
    bad = ~torch.isfinite(d)
    if bool(bad.any()):
        return {"image_max_err": float("inf"),
                "image_mean_err": float("inf")}
    return {"image_max_err": float(d.max()),
            "image_mean_err": float(d.mean())}


def numbers(prog_image, ref_image, prog_state=None, ref_state=None
            ) -> Dict[str, float]:
    """The numbers compared for one sample."""
    out = image_errors(prog_image, ref_image)
    if ref_state is not None:
        errs = state_errors(prog_state, ref_state)
        out["state_rel_rms"] = max(errs.values())
    return out


def passes(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(nums[k] <= limits[k] for k in nums)


def worst(samples, limits) -> Dict[str, dict]:
    """{name: {"value": the largest reading over the samples, "limit"}}
    for every number compared."""
    out: Dict[str, dict] = {}
    for nums in samples:
        for k, v in nums.items():
            if k not in out or v > out[k]["value"]:
                out[k] = {"value": v, "limit": limits[k]}
    return out

