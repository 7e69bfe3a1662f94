"""splat_idle_ms.relight: the device's idle ms a relight step while the
host is inside the splats' spans (vct.albedo_splat,
vct.shadow_and_radiance_splat), over the profiled steps
(vctbench/spans.py)."""

from vctbench import spans


def read(ctx):
    return spans.mean(spans.idle_ms(
        ctx, ("albedo_splat", "shadow_and_radiance_splat")))
