"""Stage marks for profiling.  The voxel build and the frame call
`mark(name)` right after they enqueue each stage's work; by default that
does nothing.  A profiler (vct_tpu_torch/profile_stages.py) sets `MARK`
to a callable that records a CUDA event, so the device time between two
marks is the named stage's."""

MARK = None


def mark(name: str) -> None:
    if MARK is not None:
        MARK(name)
