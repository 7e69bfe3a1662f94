"""binning_dropped.frame: the triangles the binning dropped a frame (its
column tier over budget), the program's counter "binning.dropped"
(vct_tpu_torch.stages.counters(): the device sum over the frames counted
while marks or the profiler were on, over their count).  None where the
program has no such counter."""

from vctbench import program


def read(ctx):
    counters = getattr(program.stages, "counters", None)
    got = counters().get("binning.dropped") if counters else None
    if not got or not got[1]:
        return None
    total, calls = got
    return float(total) / calls
