"""k2_roofline.offline (layer ops.sepconv, K2): % of K2's device time that its
roofline bound accounts for, over the traced stretch."""
from benchmarks import readers


def read(run):
    return readers.k2_roofline(run)
