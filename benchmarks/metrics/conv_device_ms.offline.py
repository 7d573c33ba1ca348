"""conv_device_ms.offline (layer models.mobilenet_v1, cuDNN layers): device
ms an image in cuDNN convolutions (conv0, the stride-2 and dilated
layers, the heads), from the traced stretch."""
from benchmarks import readers


def read(run):
    return readers.device_ms_per_image(run, 'cuDNN convs')
