"""Model loading facade, mirroring `posenet_tpu.models.model_factory`.

`PoseNet` holds either architecture of `ModelConfig.architecture`:
MobileNetV1 (`mobilenet_v1`) or ResNet50 (`resnet50`, built with random
weights by `ResNet50`; no checkpoint of it is read yet).

`load_model(model_id, output_stride, model_dir)` returns a `PoseNet` whose
call takes an NCHW or NHWC float tensor and returns the four head tensors
in the same layout. It reads `<model_dir>/<checkpoint>.npz` (the JAX
package's checkpoint format). Cold start: where that file is missing, it
downloads the tfjs checkpoint and converts it (`converter.tfjs2torch`).
Without network egress it draws random weights when
`allow_random_init=True`, and raises the network error when not.

Models are built on the card unless the caller names another device
(`device='cpu'`); on a host without a CUDA device the default raises.
"""

from __future__ import annotations

import os
import urllib.error
from typing import Any, Dict, Tuple

import torch
from torch import nn

from posenet_tpu_torch.config import MODEL_DIR, ModelConfig, resolve_device
from posenet_tpu_torch.converter import tfjs2torch, weights
from posenet_tpu_torch.models import mobilenet_v1, resnet50

# The module that runs each `ModelConfig.architecture`: its `normalize`,
# `forward` and `cast_params`.
ARCHITECTURE_MODULES = {'mobilenet_v1': mobilenet_v1, 'resnet50': resnet50}


class _Tensors(nn.Module):
    """One layer's named tensors, held as buffers so that `.to()` and
    `state_dict()` reach them."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t)


class PoseNet(nn.Module):
    """PoseNet over a parameter pytree (see `mobilenet_v1.init_params` and
    `resnet50.init_params` for its layout)."""

    def __init__(self, params: Dict[str, Any], cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = nn.ModuleList(_Tensors(l) for l in params['backbone'])
        self.head_params = nn.ModuleDict(
            {name: _Tensors(p) for name, p in params['heads'].items()})

    @property
    def params(self) -> Dict[str, Any]:
        """The parameter pytree, as the architecture's `forward` takes it."""
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
        """NHWC in (MobileNetV1: in [-1, 1]; ResNet50: RGB plus the ImageNet
        mean), dict of NHWC heads out."""
        return ARCHITECTURE_MODULES[self.cfg.architecture].forward(
            self.params, x_nhwc, self.cfg)

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


def ResNet50(output_stride: int = 16, *, compute_dtype: torch.dtype = torch.float32,
             seed: int = 0, device: torch.device | str = 'cuda') -> PoseNet:
    """A randomly initialised PoseNet ResNet50 on `device` (see
    `resolve_device`), weights drawn as `MobileNetV1`'s are."""
    device = resolve_device(device)
    cfg = ModelConfig(output_stride=output_stride, compute_dtype=compute_dtype,
                      architecture='resnet50')
    generator = torch.Generator().manual_seed(seed)
    return PoseNet(resnet50.init_params(generator, cfg, device), cfg)


def load_model(model_id: int = 101, output_stride: int = 16,
               model_dir: str = MODEL_DIR, *,
               compute_dtype: torch.dtype = torch.float32,
               allow_random_init: bool = False, seed: int = 0,
               device: torch.device | str = 'cuda',
               architecture: str = 'mobilenet_v1') -> PoseNet:
    """Load `<model_dir>/<checkpoint>.npz` onto `device` (see
    `resolve_device`, which runs first), downloading and converting the
    tfjs checkpoint into it when it is missing (`tfjs2torch.convert`, with
    the shard cache `converter.download.BASE_DIR` as it is at the call).

    Only a network failure (`urllib.error.URLError`, or `TimeoutError`
    from a stalled read) falls back, to random weights drawn from `seed`,
    and only with `allow_random_init`; otherwise it is raised. Any other
    error (a half-written shard cache, a full disk) is raised in both
    cases: random weights behind a "download failed" line would look like
    a broken detector.

    `architecture='resnet50'`: no ResNet50 checkpoint is read yet (the
    tfjs ResNet50 converter waits for its checkpoint files), so this raises
    FileNotFoundError naming the checkpoint, or, with `allow_random_init`,
    draws random weights (`ResNet50`); `model_id` is not read."""
    device = resolve_device(device)
    cfg = ModelConfig(model_id=model_id, output_stride=output_stride,
                      compute_dtype=compute_dtype, architecture=architecture)
    if architecture == 'resnet50':
        checkpoint = resnet50.CHECKPOINT.format(stride=output_stride)
        if not allow_random_init:
            raise FileNotFoundError(
                f'no ResNet50 checkpoint: the port reads none yet ({checkpoint} needs '
                f'the tfjs ResNet50 converter); allow_random_init=True draws random weights')
        print(f'No ResNet50 checkpoint ({checkpoint}); using random initialization.')
        return ResNet50(output_stride, compute_dtype=compute_dtype, seed=seed, device=device)
    name = mobilenet_v1.MOBILENET_V1_CHECKPOINTS[model_id]
    path = os.path.join(model_dir, name + '.npz')
    if not os.path.exists(path):
        try:
            print(f'Cannot find checkpoint {path}, converting from tfjs...')
            tfjs2torch.convert(model_id, model_dir, device=device)
        except (urllib.error.URLError, TimeoutError) as e:
            if not allow_random_init:
                raise
            print(f'Download failed ({e}); using random initialization.')
            return MobileNetV1(model_id, output_stride, compute_dtype=compute_dtype,
                               seed=seed, device=device)
    params = weights.params_from_jax(weights.load_params_npz(path), device)
    return PoseNet(params, cfg)
