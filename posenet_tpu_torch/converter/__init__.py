"""Checkpoints for the PyTorch port: the tfjs download and converter, and
the shared `.npz` format's reader and writer (`weights`)."""

from posenet_tpu_torch.converter.tfjs2torch import convert, variables_to_pytree  # noqa: F401
from posenet_tpu_torch.converter.weights import (load_params_npz,  # noqa: F401
                                                 save_params_npz)
# Bound last: the name `download` is the function from here on, as in the
# JAX package (the module stays in sys.modules, and in tfjs2torch.download_lib).
from posenet_tpu_torch.converter.download import download  # noqa: F401,E402
