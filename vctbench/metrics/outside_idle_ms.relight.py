"""outside_idle_ms.relight: the device's idle ms a relight step while the
host is in no vct.frame, vct.build or vct.tables span (the loop and the
entry points' glue), over the profiled steps (vctbench/spans.py)."""

from vctbench import spans


def read(ctx):
    return spans.mean(spans.outside_ms(ctx))
