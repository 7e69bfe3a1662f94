"""percone_idle_ms.frame: the device's idle ms a frame while the host is
inside the per-cone marches' spans (vct.percone_diffuse,
vct.percone_specular, opened by render/renderer.shade_gbuffer on the
per-cone route), over the profiled frames (vctbench/spans.py).  Nothing
is read where the program opens neither span."""

from vctbench import spans

SPANS = ("percone_diffuse", "percone_specular")


def read(ctx):
    p = ctx.profile
    want = {spans.PREFIX + s for s in SPANS}
    if p is None or not any(n in want for _, _, n in p.host_ops):
        return None
    return spans.mean(spans.idle_ms(ctx, SPANS))
