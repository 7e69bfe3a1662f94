"""aniso_pyramid_roofline.relight: the anisotropic pyramid kernel's share
of its roofline over seed-chosen profiled relight steps.

Numerator: the least time the 6-direction radiance pyramid of those
steps' builds needs, the larger of its bytes over the HBM rate and its
float operations over the float32 rate (vctbench/peaks.py, published,
not halved).  The work is the reference's own count from its level
shapes (Reference.pyramid_work: each level read once, each 6-direction
level written once, 16 operations a value), never the kernel's.
Denominator: the profiler's time of the kernels named
aniso_pyramid_kernel inside those steps.  Nothing is read where the
reference counts no pyramid or no such kernel ran."""

from vctbench.peaks import PEAKS

KERNEL = "aniso_pyramid_kernel"


def read(ctx):
    peak = PEAKS.get(ctx.kind)
    work = getattr(ctx.reference, "pyramid_work", None)
    if (peak is None or work is None or ctx.profile is None
            or not ctx.work_steps):
        return None
    seconds = ctx.profile.kernel_seconds(KERNEL, ctx.work_steps)
    if seconds <= 0:
        return None
    nbytes, ops = work()
    bound = max(nbytes / peak["hbm_bytes_per_s"],
                ops / peak["fp32_flops_per_s"])
    return 100.0 * bound * len(ctx.work_steps) / seconds
