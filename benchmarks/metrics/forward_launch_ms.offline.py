"""forward_launch_ms.offline (layer models.mobilenet_v1 dispatch): median
host ms a traced call spends in the program's span `pipeline.forward`,
normalize and the trunk's and heads' launches."""
from benchmarks import spans


def read(run):
    return spans.host_ms(run, 'pipeline.forward')
