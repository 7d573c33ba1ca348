"""Checkpoint reading and layout conversion.

The JAX package stores parameters as a pytree of HWIO kernels and saves it
as a flat `.npz` (`backbone/{i}/{k}`, `heads/{name}/{k}`). `load_params_npz`
reads that file with numpy alone, giving the same HWIO pytree;
`params_from_jax` turns such a pytree into the port's tensors, whose
kernels are OIHW as `torch.nn.functional.conv2d` takes them.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# HWIO -> OIHW. The same permutation turns a depthwise (3, 3, 1, C) kernel
# into (C, 1, 3, 3) and a pointwise (1, 1, C, C2) one into (C2, C, 1, 1).
_HWIO_TO_OIHW = (3, 2, 0, 1)
_KERNEL_KEYS = ('w', 'dw_w', 'pw_w')


def load_params_npz(path: str) -> Dict[str, Any]:
    """Read a JAX-package `.npz` checkpoint into its numpy HWIO pytree."""
    with np.load(path) as data:
        n_layers = 1 + max(int(k.split('/')[1]) for k in data.files
                           if k.startswith('backbone/'))
        backbone = [dict() for _ in range(n_layers)]
        heads: Dict[str, Dict[str, np.ndarray]] = {}
        for k in data.files:
            parts = k.split('/')
            if parts[0] == 'backbone':
                backbone[int(parts[1])][parts[2]] = data[k]
            else:
                heads.setdefault(parts[1], {})[parts[2]] = data[k]
    return {'backbone': backbone, 'heads': heads}


def _layer_from_jax(layer, device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in layer.items():
        a = np.asarray(v, dtype=np.float32)
        if k in _KERNEL_KEYS:
            a = a.transpose(_HWIO_TO_OIHW)
        out[k] = torch.tensor(np.ascontiguousarray(a), device=device)
    return out


def params_from_jax(params: Dict[str, Any],
                    device: torch.device | str = 'cpu') -> Dict[str, Any]:
    """JAX pytree (numpy or array-likes, HWIO) -> the port's float32 OIHW
    tensors on `device`, in the same nested layout."""
    return {
        'backbone': [_layer_from_jax(l, device) for l in params['backbone']],
        'heads': {name: _layer_from_jax(p, device)
                  for name, p in params['heads'].items()},
    }
