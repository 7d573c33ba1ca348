"""tfjs checkpoint -> the shared `.npz` checkpoint, the counterpart of
`posenet_tpu.converter.tfjs2jax`.

A tfjs checkpoint is a `manifest.json` mapping each variable name to its
shard file and shape, one raw little-endian float32 blob per variable.
`load_tfjs_variables` reads them (downloading the checkpoint first when
its manifest is missing), `variables_to_pytree` maps them onto the JAX
package's HWIO pytree (kernels HWIO as tfjs ships them; depthwise kernels
(H, W, C, 1) to (H, W, 1, C)), and `convert` writes that pytree as the
flat `.npz` both packages read (`weights.load_params_npz`), which
`load_model` then turns into the port's OIHW tensors.
"""

from __future__ import annotations

import importlib
import json
import os
import re
from typing import Any, Dict

import numpy as np
import torch

from posenet_tpu_torch.converter.weights import params_from_jax, save_params_npz
from posenet_tpu_torch.models.mobilenet_v1 import (ARCHS, HEAD_CHANNELS,
                                                   MOBILENET_V1_CHECKPOINTS)

# The module itself: the package exports its function `download` under the
# module's name, as the JAX package's converter does.
download_lib = importlib.import_module('posenet_tpu_torch.converter.download')

# tfjs variable names:
#   MobilenetV1/Conv2d_0/weights                      -> backbone[0] full conv
#   MobilenetV1/Conv2d_5_depthwise/depthwise_weights  -> backbone[5] depthwise
#   MobilenetV1/Conv2d_5_pointwise/weights            -> backbone[5] pointwise
#   MobilenetV1/heatmap_2/weights                     -> heads['heatmap']
_CONV_RE = re.compile(r'^mobilenetv1/conv2d_(\d+)(?:_(depthwise|pointwise))?/'
                      r'(weights|depthwise_weights|biases)$')
_HEAD_RE = re.compile(r'^mobilenetv1/(heatmap|offset|displacement_fwd|displacement_bwd)_2/'
                      r'(weights|biases)$')

CHECK_IMAGE = './images/tennis_in_crowd.jpg'


def load_tfjs_variables(checkpoint: str, base_dir: str | None = None) -> Dict[str, np.ndarray]:
    """Every variable of the checkpoint's manifest as {tfjs name: float32
    array}, from `<base_dir>/<checkpoint>` (base_dir None:
    `download.BASE_DIR`), downloaded first when its manifest is missing."""
    base_dir = download_lib.BASE_DIR if base_dir is None else base_dir
    manifest_path = os.path.join(base_dir, checkpoint, 'manifest.json')
    if not os.path.exists(manifest_path):
        print(f'Weights for checkpoint {checkpoint} are not downloaded. '
              f'Downloading to {base_dir} ...')
        download_lib.download(checkpoint, base_dir)

    with open(manifest_path) as f:
        manifest = json.load(f)
    variables = {}
    for name, meta in manifest.items():
        with open(os.path.join(base_dir, checkpoint, meta['filename']), 'rb') as f:
            raw = f.read()
        variables[name] = np.frombuffer(raw, dtype='<f4').reshape(meta['shape'])
    return variables


def variables_to_pytree(variables: Dict[str, np.ndarray], model_id: int) -> Dict[str, Any]:
    """The tfjs variables as the JAX package's HWIO parameter pytree.
    Variables of no layer (the part heads some checkpoints carry) are
    skipped; a missing one raises ValueError naming its layer."""
    backbone: list = [dict() for _ in ARCHS[model_id]]
    heads: Dict[str, Dict[str, np.ndarray]] = {name: {} for name in HEAD_CHANNELS}
    for name, arr in variables.items():
        key = name.lower()
        m = _CONV_RE.match(key)
        if m:
            layer, kind, var = backbone[int(m.group(1))], m.group(2), m.group(3)
            if kind == 'depthwise':
                if var == 'biases':
                    layer['dw_b'] = arr
                else:   # (H, W, C, 1) -> (H, W, 1, C)
                    layer['dw_w'] = np.ascontiguousarray(arr.transpose(0, 1, 3, 2))
            elif kind == 'pointwise':
                layer['pw_w' if var == 'weights' else 'pw_b'] = arr
            else:   # conv0
                layer['w' if var == 'weights' else 'b'] = arr
            continue
        m = _HEAD_RE.match(key)
        if m:
            heads[m.group(1)]['w' if m.group(2) == 'weights' else 'b'] = arr

    for i, layer in enumerate(backbone):
        missing = ({'w', 'b'} if i == 0 else {'dw_w', 'dw_b', 'pw_w', 'pw_b'}) - set(layer)
        if missing:
            raise ValueError(f'backbone layer {i} missing variables: {missing}')
    for head, p in heads.items():
        if set(p) != {'w', 'b'}:
            raise ValueError(f'head {head} missing variables: {set(p)}')
    return {'backbone': backbone, 'heads': heads}


def convert(model_id: int, model_dir: str, base_dir: str | None = None,
            output_stride: int = 16, image_size: int = 513, check: bool = True,
            device: torch.device | str = 'cuda') -> str:
    """Download (where needed) and convert the tfjs checkpoint of
    `model_id`, and save it as `<model_dir>/<checkpoint>.npz`; returns that
    path.

    With `check` and `./images/tennis_in_crowd.jpg` present, a float32
    forward of that image on `device` prints the heatmap's shape, corner
    and mean, as the JAX package's converter does."""
    name = MOBILENET_V1_CHECKPOINTS[model_id]
    params = variables_to_pytree(load_tfjs_variables(name, base_dir), model_id)
    # Only now: a download that fails leaves no empty model directory behind.
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, name + '.npz')
    save_params_npz(path, params)

    if check and os.path.exists(CHECK_IMAGE):
        import cv2

        from posenet_tpu_torch.config import ModelConfig
        from posenet_tpu_torch.models import mobilenet_v1
        from posenet_tpu_torch.models.model_factory import resolve_device

        device = resolve_device(device)
        img = cv2.resize(cv2.imread(CHECK_IMAGE), (image_size, image_size))
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32)
        x = torch.from_numpy(img * (2.0 / 255.0) - 1.0)[None].to(device)
        cfg = ModelConfig(model_id=model_id, output_stride=output_stride)
        hm = mobilenet_v1.forward(params_from_jax(params, device), x, cfg)['heatmap'].cpu()
        print('Heatmaps')
        print(tuple(hm.shape))
        print(hm[:, 0:1, 0:1].numpy())
        print(float(hm.mean()))
    return path
