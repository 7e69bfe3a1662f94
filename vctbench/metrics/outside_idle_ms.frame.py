"""outside_idle_ms.frame: the device's idle ms a frame while the host is
in no vct.frame, vct.build or vct.tables span (the loop and the entry
points' glue), over the profiled frames (vctbench/spans.py)."""

from vctbench import spans


def read(ctx):
    return spans.mean(spans.outside_ms(ctx))
