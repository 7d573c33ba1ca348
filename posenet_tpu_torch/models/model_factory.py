"""Model loading facade, mirroring `posenet_tpu.models.model_factory`.

`load_model(model_id, output_stride, model_dir)` returns a `PoseNet` whose
call takes an NCHW or NHWC float tensor and returns the four head tensors
in the same layout. It reads `<model_dir>/<checkpoint>.npz` (the JAX
package's checkpoint format) when the file exists; otherwise it draws
random weights when `allow_random_init=True`, and raises when not.

Models are built on the card unless the caller names another device
(`device='cpu'`); on a host without a CUDA device the default raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch
from torch import nn

from posenet_tpu_torch.config import MODEL_DIR, ModelConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.models import mobilenet_v1


def resolve_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; raises where it is a CUDA device and this
    host has none, so that nothing is built on the CPU unless asked for."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f"{str(device)!r} needs a CUDA device, and none is available here: run "
            f"on a CUDA host, or ask for the CPU (device='cpu', platforms=('cpu',), "
            f"--platforms cpu)")
    return device


class _Tensors(nn.Module):
    """One layer's named tensors, held as buffers so that `.to()` and
    `state_dict()` reach them."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t)


class PoseNet(nn.Module):
    """MobileNetV1 PoseNet over a parameter pytree (see
    `mobilenet_v1.init_params` for its layout)."""

    def __init__(self, params: Dict[str, Any], cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = nn.ModuleList(_Tensors(l) for l in params['backbone'])
        self.head_params = nn.ModuleDict(
            {name: _Tensors(p) for name, p in params['heads'].items()})

    @property
    def params(self) -> Dict[str, Any]:
        """The parameter pytree, as `mobilenet_v1.forward` takes it."""
        return {
            'backbone': [dict(m.named_buffers()) for m in self.backbone],
            'heads': {name: dict(m.named_buffers())
                      for name, m in self.head_params.items()},
        }

    @property
    def device(self) -> torch.device:
        return self.backbone[0].b.device

    @property
    def output_stride(self) -> int:
        return self.cfg.output_stride

    @property
    def model_id(self) -> int:
        return self.cfg.model_id

    def forward_nhwc(self, x_nhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
        """NHWC in, dict of NHWC heads out."""
        return mobilenet_v1.forward(self.params, x_nhwc, self.cfg)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        """(heatmap, offset, displacement_fwd, displacement_bwd) for an
        NCHW or NHWC input (a batch, or one image without the batch axis),
        in the layout it was given."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.ndim == 3:
            x = x[None]
        nchw = x.shape[1] == 3 and x.shape[-1] != 3
        if nchw:
            x = x.permute(0, 2, 3, 1)
        out = self.forward_nhwc(x)
        heads = (out['heatmap'], out['offset'],
                 out['displacement_fwd'], out['displacement_bwd'])
        if nchw:
            heads = tuple(h.permute(0, 3, 1, 2) for h in heads)
        return heads


def MobileNetV1(model_id: int = 101, output_stride: int = 16, *,
                compute_dtype: torch.dtype = torch.float32, seed: int = 0,
                device: torch.device | str = 'cuda') -> PoseNet:
    """A randomly initialised model on `device` (see `resolve_device`);
    weights drawn from a CPU `torch.Generator` seeded with `seed`, so they
    do not depend on `device`. Use `load_model` for checkpoint weights."""
    device = resolve_device(device)
    cfg = ModelConfig(model_id=model_id, output_stride=output_stride,
                      compute_dtype=compute_dtype)
    generator = torch.Generator().manual_seed(seed)
    return PoseNet(mobilenet_v1.init_params(generator, cfg, device), cfg)


def load_model(model_id: int = 101, output_stride: int = 16,
               model_dir: str = MODEL_DIR, *,
               compute_dtype: torch.dtype = torch.float32,
               allow_random_init: bool = False, seed: int = 0,
               device: torch.device | str = 'cuda') -> PoseNet:
    """Load `<model_dir>/<checkpoint>.npz` onto `device` (see
    `resolve_device`), or, when it is missing and `allow_random_init` is
    set, build random weights."""
    device = resolve_device(device)
    cfg = ModelConfig(model_id=model_id, output_stride=output_stride,
                      compute_dtype=compute_dtype)
    name = mobilenet_v1.MOBILENET_V1_CHECKPOINTS[model_id]
    path = os.path.join(model_dir, name + '.npz')
    if os.path.exists(path):
        params = weights.params_from_jax(weights.load_params_npz(path), device)
        return PoseNet(params, cfg)
    if not allow_random_init:
        raise FileNotFoundError(
            f"no checkpoint at {path}; convert one with the JAX package "
            f"(posenet_tpu.converter.tfjs2jax) or pass allow_random_init=True")
    return MobileNetV1(model_id, output_stride, compute_dtype=compute_dtype,
                       seed=seed, device=device)
