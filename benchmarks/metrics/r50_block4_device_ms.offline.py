"""r50_block4_device_ms.offline (layer models.resnet50 block4, rate 2):
device ms an image between the two timing events of the program's span
`resnet.block4` (block 4's three units, their 3x3 convs at rate 2 at
stride 16), over the traced stretch; None off the card or where the
program has no such span."""
from benchmarks import spans


def read(run):
    return spans.device_ms_per_image(run, 'resnet.block4')
