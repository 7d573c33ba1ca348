"""forward_device_ms.offline (layer models.mobilenet_v1 device interval):
device ms an image between the two timing events of the program's span
`pipeline.forward`, over the traced stretch; None off the card. The
interval holds the forward's kernels and whatever time the device waits
between them for the host's launches: it is not the device's busy time."""
from benchmarks import spans


def read(run):
    return spans.device_ms_per_image(run, 'pipeline.forward')
