"""specmarch_idle_ms.frame: the device's idle ms a frame while the host is
inside the exact specular pass's span (vct.specmarch, its parts nested in
it), over the profiled frames (vctbench/spans.py)."""

from vctbench import spans


def read(ctx):
    return spans.mean(spans.idle_ms(ctx, ("specmarch",)))
