"""mfu.offline (layer the model step): % of the chips' bf16 peak that the
window's forward passes reach, operations counted from the shapes."""
from benchmarks import readers


def read(run):
    return readers.mfu(run)
