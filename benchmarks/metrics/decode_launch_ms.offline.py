"""decode_launch_ms.offline (layer decode dispatch): median host ms a
traced call spends in the program's span `pipeline.decode`, the launches
of the decode's prepare, K1 and greedy rounds."""
from benchmarks import spans


def read(run):
    return spans.host_ms(run, 'pipeline.decode')
