"""binning_idle_ms.frame: the device's idle ms a frame while the host is
inside the binning's spans (vct.pack_rows, vct.bin), over the profiled
frames (vctbench/spans.py)."""

from vctbench import spans


def read(ctx):
    return spans.mean(spans.idle_ms(ctx, ("pack_rows", "bin")))
