"""dispatch_ms.offline (layer pipeline, and parallel.mesh over cards): median
host ms from a call of `PoseNetPipeline` to its return, over the window."""
from benchmarks import readers


def read(run):
    return readers.dispatch_ms(run)
