"""Input preprocessing on the device: BGR -> RGB, bilinear resize to a
stride-valid resolution, normalization to [-1, 1].

The counterpart of `posenet_tpu.preprocess.valid_resolution` and
`preprocess_on_device`. The host paths (`process_input`, `read_imgfile`,
`read_cap`) resize with cv2 and are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def valid_resolution(width: float, height: float,
                     output_stride: int = 16) -> Tuple[int, int]:
    """Largest stride-compatible (w, h) = (d//s)*s + 1 not exceeding the
    scaled source dims."""
    target_width = (int(width) // output_stride) * output_stride + 1
    target_height = (int(height) // output_stride) * output_stride + 1
    return target_width, target_height


def preprocess_on_device(frame_bgr_u8: torch.Tensor,
                         target_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 BGR (H, W, 3) or (B, H, W, 3) -> normalized (B, th, tw, 3)
    float32 RGB in [-1, 1], on the frames' device.

    Bilinear resize with half-pixel centres and no antialiasing (as
    `jax.image.resize(..., antialias=False)`, cv2.INTER_LINEAR and the JAX
    package's raw-frame path), in float32 on a channels_last view, then
    x * (2/255) - 1 with each operation rounded to float32. The output is
    NHWC-contiguous.
    """
    x = frame_bgr_u8
    if x.ndim == 3:
        x = x[None]
    if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f'expected (B, H, W, 3) or (H, W, 3) uint8 BGR frames, '
                         f'got {tuple(frame_bgr_u8.shape)} {frame_bgr_u8.dtype}')
    x = x.flip(-1).to(torch.float32).permute(0, 3, 1, 2)   # BGR -> RGB, NCHW view
    x = F.interpolate(x, size=tuple(target_hw), mode='bilinear',
                      align_corners=False, antialias=False)
    x = x.permute(0, 2, 3, 1).contiguous()
    scale = torch.tensor(2.0 / 255.0, dtype=torch.float32, device=x.device)
    return x * scale - 1.0
