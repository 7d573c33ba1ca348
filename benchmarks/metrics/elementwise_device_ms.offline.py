"""elementwise_device_ms.offline (layer eager passes): device ms an image in
PyTorch's elementwise and reduction kernels (bias + ReLU6 outside K2,
normalize, the decode's rounds), from the traced stretch."""
from benchmarks import readers


def read(run):
    return readers.device_ms_per_image(run, 'elementwise and other')
