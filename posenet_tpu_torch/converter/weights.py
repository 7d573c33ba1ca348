"""Checkpoint reading and layout conversion.

The JAX package stores parameters as a pytree of HWIO kernels and saves it
as a flat `.npz` (`backbone/{i}/{k}`, `heads/{name}/{k}`).
`load_params_npz` and `save_params_npz` read and write that file with
numpy alone, as the same HWIO pytree, so both packages read one file;
`params_from_jax` turns such a pytree into the port's tensors, whose
kernels are OIHW as `torch.nn.functional.conv2d` takes them;
`quantized_params_from_jax` does the same for the JAX package's folded
int8 pytree (`posenet_tpu.models.quantized.quantize_params`), and
`adam_state_from_jax` for optax's Adam moments, into a `torch.optim.Adam`'s
state.
"""

from __future__ import annotations

import os
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


def save_params_npz(path: str, params: Dict[str, Any]) -> None:
    """Write an HWIO pytree of arrays as the flat `.npz` `load_params_npz`
    reads. The file is written under a temporary name and renamed, so an
    interrupted save leaves no truncated checkpoint at `path` (a missing
    one is converted again; a truncated one would be trusted)."""
    flat = {}
    for i, layer in enumerate(params['backbone']):
        for k, v in layer.items():
            flat[f'backbone/{i}/{k}'] = np.asarray(v)
    for name, p in params['heads'].items():
        for k, v in p.items():
            flat[f'heads/{name}/{k}'] = np.asarray(v)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


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


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a), device=device).to(dtype)


def quantized_params_from_jax(qparams: Dict[str, Any],
                              device: torch.device | str = 'cpu') -> Dict[str, Any]:
    """The JAX package's folded int8 pytree (HWIO, `pw_w8` (C_in, C_out))
    -> the port's (`models.quantized.quantize_params`' layout) on `device`:
    bf16 kernels OIHW, `pw_w8` the transposed view of a (C_out, C_in)
    tensor, the other leaves in their dtypes."""
    def kernel(a):   # bf16 -> float32 is exact, and numpy has no bf16 of its own
        return _tensor(np.asarray(a, np.float32).transpose(_HWIO_TO_OIHW), torch.bfloat16,
                       device)

    backbone = []
    for p in qparams['backbone']:
        if 'w' in p:
            backbone.append({'w': kernel(p['w']), 'b': _tensor(p['b'], torch.float32, device)})
            continue
        backbone.append({
            'dw_w': kernel(p['dw_w']),
            'dw_b': _tensor(p['dw_b'], torch.float32, device),
            'pw_w8': _tensor(np.asarray(p['pw_w8']).T, torch.int8, device).t(),
            'pw_alpha': _tensor(p['pw_alpha'], torch.float32, device),
            'pw_corr': _tensor(p['pw_corr'], torch.int32, device),
            'pw_b': _tensor(p['pw_b'], torch.float32, device),
        })
    heads = {name: {'w': kernel(hp['w']), 'b': _tensor(hp['b'], torch.float32, device)}
             for name, hp in qparams['heads'].items()}
    return {'backbone': backbone, 'heads': heads}


def _jax_leaf(tree, path):
    """The leaf of a JAX pytree at `path`, or None where a subtree is None
    (a part `optax.masked` keeps no state for)."""
    for key in path:
        if tree is None:
            return None
        tree = tree[key]
    return tree


def adam_state_from_jax(mu, nu, count, params: Dict[str, Any],
                        optimizer: torch.optim.Optimizer) -> None:
    """Load optax Adam state into `optimizer`, a `torch.optim.Adam` over
    tensors of `params` (the port's pytree).

    `mu` and `nu` are optax's first and second moments as JAX-layout
    pytrees of numpy arrays (HWIO kernels, converted to OIHW here, as
    `params_from_jax` does); `count` is its step count. `optax.masked`
    keeps moments only for the leaves it trains (the heads, heads-only):
    give each leaf it masked out (a `MaskedNode`) as None. Every tensor the
    optimizer trains needs moments, and no other tensor may have them."""
    trained = {id(t) for group in optimizer.param_groups for t in group['params']}
    step_device = (None if optimizer.defaults.get('capturable')
                   or optimizer.defaults.get('fused') else 'cpu')
    layers = ([(('backbone', i), layer) for i, layer in enumerate(params['backbone'])]
              + [(('heads', name), p) for name, p in params['heads'].items()])
    for path, layer in layers:
        for k, t in layer.items():
            m, v = _jax_leaf(mu, path + (k,)), _jax_leaf(nu, path + (k,))
            if id(t) not in trained:
                if m is not None or v is not None:
                    raise ValueError(f'Adam moments for {path + (k,)}, which the '
                                     f'optimizer does not train')
                continue
            if m is None or v is None:
                raise ValueError(f'no Adam moments for the trained tensor {path + (k,)}')
            moments = _layer_from_jax({k: m}, t.device)[k], _layer_from_jax({k: v}, t.device)[k]
            for name, a in zip(('mu', 'nu'), moments):
                if a.shape != t.shape:
                    raise ValueError(f'{name} of {path + (k,)}: {tuple(a.shape)}, the '
                                     f'tensor is {tuple(t.shape)}')
            optimizer.state[t] = {
                'step': torch.tensor(float(count), dtype=torch.float32,
                                     device=step_device or t.device),
                'exp_avg': moments[0], 'exp_avg_sq': moments[1]}
