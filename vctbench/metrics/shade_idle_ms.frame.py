"""shade_idle_ms.frame: the device's idle ms a frame while the host is
inside the shading's spans (vct.prepass, vct.material, vct.bump_normal,
vct.tap, vct.combine), over the profiled frames (vctbench/spans.py)."""

from vctbench import spans

SHADE = ("prepass", "material", "bump_normal", "tap", "combine")


def read(ctx):
    return spans.mean(spans.idle_ms(ctx, SHADE))
