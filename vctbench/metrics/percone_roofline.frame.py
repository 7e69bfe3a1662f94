"""percone_roofline.frame: the per-cone marches' share of their roofline
over the traced window.

Numerator: the least time one frame's marches need, the larger of their
bytes over the HBM rate and their float operations over the float32 rate
(vctbench/peaks.py, published, not halved).  The work is the reference's
own count (Reference.percone_work, vctbench/reference_oracle/march.py:
the least sample, three directions read at a 6-direction level; the
pyramid read once and each ray's inputs and outputs), taken over as many
of the cheapest scheduled samples as the program's counters say ran
before the early-out ("percone.active" over "percone.samples"), so it is
the same whatever implements the march.  Denominator: percone_ms.frame,
the device ms a frame of the stages percone_diffuse and
percone_specular.  Nothing is read where the reference counts no such
work, or the program marks no such stage or counts no such samples."""

from vctbench import program
from vctbench.peaks import PEAKS

STAGES = ("percone_diffuse", "percone_specular")


def read(ctx):
    peak = PEAKS.get(ctx.kind)
    work = getattr(ctx.reference, "percone_work", None)
    got = [ctx.stage_ms[s] for s in STAGES if s in ctx.stage_ms]
    counters = getattr(program.stages, "counters", None)
    counts = counters() if counters else {}
    active, samples = counts.get("percone.active"), counts.get(
        "percone.samples")
    if (peak is None or work is None or not got or not ctx.steps
            or not active or not samples or not float(samples[0])):
        return None
    ms = sum(got) / ctx.steps
    if ms <= 0:
        return None
    nbytes, ops = work(float(active[0]) / float(samples[0]))
    bound = max(nbytes / peak["hbm_bytes_per_s"],
                ops / peak["fp32_flops_per_s"])
    return 100.0 * bound / (ms * 1e-3)
