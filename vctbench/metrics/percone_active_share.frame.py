"""percone_active_share.frame: the share, in %, of the per-cone marches'
scheduled samples that the loop still runs, its cone's alpha under
max_alpha when it reaches them (VoxelConeTracing.fs:94): 100 times the
program's counter "percone.active" over "percone.samples"
(vct_tpu_torch.stages.counters(), device sums over the frames counted
while marks or the profiler were on).  None where the program has no
such counters."""

from vctbench import program


def read(ctx):
    counters = getattr(program.stages, "counters", None)
    got = counters() if counters else {}
    active, samples = got.get("percone.active"), got.get("percone.samples")
    if not active or not samples or not float(samples[0]):
        return None
    return 100.0 * float(active[0]) / float(samples[0])
