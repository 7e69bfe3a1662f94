"""aniso_pyramid_idle_ms.relight: the device's idle ms a relight step
while the host builds the anisotropic radiance pyramid (vct.aniso_mips,
inside the radiance_mips stage), over the profiled steps
(vctbench/spans.py).  Nothing is read where the program opens no such
span."""

from vctbench import spans

SPAN = "aniso_mips"


def read(ctx):
    p = ctx.profile
    if p is None or not any(n == spans.PREFIX + SPAN
                            for _, _, n in p.host_ops):
        return None
    return spans.mean(spans.idle_ms(ctx, (SPAN,)))
