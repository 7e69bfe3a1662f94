"""dense_march_roofline.relight: the dense-march kernel's share of its
roofline over seed-chosen profiled relight steps.

Numerator: the least time the work of those steps' three marches (light
volume, diffuse and specular fields) needs, each march the larger of its
bytes over the HBM rate and its float operations over the float32 rate
(vctbench/peaks.py, published, not halved).  The work is the benchmark's
own count (vctbench/work.py) on the reference's plain march of the same
step's inputs (its sun), never the kernel's own count.  Denominator: the
profiler's time of the kernels named dense_kernel inside those steps."""

from vctbench.peaks import PEAKS

KERNEL = "dense_kernel"


def read(ctx):
    peak = PEAKS.get(ctx.kind)
    if peak is None or ctx.profile is None or not ctx.work_steps:
        return None
    seconds = ctx.profile.kernel_seconds(KERNEL, ctx.work_steps)
    if seconds <= 0:
        return None
    bound = 0.0
    for i in ctx.work_steps:
        for nbytes, ops in ctx.reference.march_work(ctx.light[i]):
            bound += max(nbytes / peak["hbm_bytes_per_s"],
                         ops / peak["fp32_flops_per_s"])
    return 100.0 * bound / seconds
