"""The demo CLIs, the Streamlit app and the training CLI on the port: the
counterparts of the repository's `image_demo.py`, `benchmark.py`,
`webcam_demo.py`, `video_demo.py`, `streamlit_demo.py` and `train.py`, with
their flags, defaults, printed lines and outputs, and one flag more,
`--device` (default `cuda`; `cpu` runs them on the host). Each demo runs the
float32 model with TF32 off (`full_float32`). Run one as
`python -m posenet_tpu_torch.apps.<name>`."""

import torch


def add_device_flag(parser):
    """`--device`: where the model runs and the poses decode (default the
    card, which raises on a host without one; `cpu` for the host)."""
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device: 'cuda' (default; raises without a "
                             "CUDA device) or 'cpu'")


def full_float32():
    """The apps run the float32 model, as the JAX apps do. PyTorch lets
    cuDNN round a float32 convolution's inputs to TF32 on the card unless
    told not to; turn that off, for cuDNN and cuBLAS both."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
