"""stage_ms.offline (layer pipeline.to_device staging): median host ms a
traced call spends in the program's span `pipeline.to_device`, the pinned
staging of the host frames and the enqueue of their copy to the card."""
from benchmarks import spans


def read(run):
    return spans.host_ms(run, 'pipeline.to_device')
