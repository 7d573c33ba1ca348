"""idle_share.offline (layer device): % of the traced stretch in which the
device ran nothing, averaged over the cards."""
from benchmarks import readers


def read(run):
    return readers.idle_share(run)
