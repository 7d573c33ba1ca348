"""decode_device_ms.offline (layer decode device interval): device ms an
image between the two timing events of the program's span
`pipeline.decode` (prepare, K1, greedy rounds), over the traced stretch;
None off the card. The interval holds the decode's kernels and whatever
time the device waits between them for the host's launches: it is not the
device's busy time."""
from benchmarks import spans


def read(run):
    return spans.device_ms_per_image(run, 'pipeline.decode')
