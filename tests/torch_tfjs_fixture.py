"""A tfjs checkpoint on disk, written without JAX: the checkpoint of
tests/tfjs_fixture.py (the same variables, shapes, seeds and bytes), built
on the port's architecture tables, so that `chip_smoke.py` can give the
port's converter a cold start at published widths. Imports nothing of JAX.

The format is the one the tfjs bucket serves: `manifest.json` mapping each
variable name to `{"filename", "shape", "dtype"}`, one raw little-endian
float32 blob per variable, named after the variable with '/' -> '_'.
"""

from __future__ import annotations

import json
import os

import numpy as np

from posenet_tpu_torch.models.mobilenet_v1 import ARCHS, HEAD_CHANNELS

# Variables real checkpoints carry that the converter skips.
_IGNORED_EXTRAS = {
    'MobilenetV1/part_heatmap_2/weights': lambda last: (1, 1, last, 24),
    'MobilenetV1/part_heatmap_2/biases': lambda last: (24,),
}


def tfjs_variable_specs(model_id: int):
    """{tfjs variable name: shape} of a PoseNet MobileNetV1 checkpoint:
    Conv2d_0, then Conv2d_N_depthwise (kernels (H, W, C, 1)) and
    Conv2d_N_pointwise per separable layer, the heads suffixed `_2`."""
    specs = {}
    arch = ARCHS[model_id]
    for i, (conv_type, inp, outp, _stride) in enumerate(arch):
        if conv_type == 'input':
            specs[f'MobilenetV1/Conv2d_{i}/weights'] = (3, 3, inp, outp)
            specs[f'MobilenetV1/Conv2d_{i}/biases'] = (outp,)
        else:
            specs[f'MobilenetV1/Conv2d_{i}_depthwise/depthwise_weights'] = (3, 3, inp, 1)
            specs[f'MobilenetV1/Conv2d_{i}_depthwise/biases'] = (inp,)
            specs[f'MobilenetV1/Conv2d_{i}_pointwise/weights'] = (1, 1, inp, outp)
            specs[f'MobilenetV1/Conv2d_{i}_pointwise/biases'] = (outp,)
    last = arch[-1][2]
    for head, ch in HEAD_CHANNELS.items():
        specs[f'MobilenetV1/{head}_2/weights'] = (1, 1, last, ch)
        specs[f'MobilenetV1/{head}_2/biases'] = (ch,)
    for name, shape_fn in _IGNORED_EXTRAS.items():
        specs[name] = shape_fn(last)
    return specs


def write_tfjs_checkpoint(base_dir: str, checkpoint: str = 'mobilenet_v1_050',
                          model_id: int = 50, seed: int = 20240816) -> str:
    """Write a complete tfjs checkpoint directory
    `<base_dir>/<checkpoint>` (kernels normal with std 1/sqrt(fan_in),
    biases uniform in [-0.8, 0.8], checkpoint scale); returns its path."""
    ckpt_dir = os.path.join(base_dir, checkpoint)
    os.makedirs(ckpt_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    manifest = {}
    for name, shape in tfjs_variable_specs(model_id).items():
        fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else 64
        if name.endswith('biases'):
            arr = rng.uniform(-0.8, 0.8, size=shape)
        else:
            arr = rng.normal(0.0, 1.0 / np.sqrt(fan_in), size=shape)
        filename = name.replace('/', '_')
        with open(os.path.join(ckpt_dir, filename), 'wb') as f:
            f.write(arr.astype('<f4').tobytes())
        manifest[name] = {'filename': filename, 'shape': list(shape), 'dtype': 'float32'}
    with open(os.path.join(ckpt_dir, 'manifest.json'), 'w') as f:
        json.dump(manifest, f)
    return ckpt_dir
