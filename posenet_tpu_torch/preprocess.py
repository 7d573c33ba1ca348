"""Input preprocessing: resize to a stride-valid resolution, BGR -> RGB,
normalization to [-1, 1].

The counterpart of `posenet_tpu.preprocess`, in two paths:

- Host path (`process_input`, `process_input_fixed`, `read_imgfile`,
  `read_cap`): cv2 bilinear resize on numpy arrays, returning NCHW float32
  with the (2,) scale that decoded coordinates are multiplied by, the same
  bits as the JAX package's functions. cv2 is imported inside each
  function, so the module imports where cv2 is absent.
- Device path (`preprocess_on_device`): the resize and normalization as
  tensor ops on the frames' device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def valid_resolution(width: float, height: float,
                     output_stride: int = 16) -> Tuple[int, int]:
    """Largest stride-compatible (w, h) = (d//s)*s + 1 not exceeding the
    scaled source dims."""
    target_width = (int(width) // output_stride) * output_stride + 1
    target_height = (int(height) // output_stride) * output_stride + 1
    return target_width, target_height


def _resize_normalize(source_img: np.ndarray, target_width: int,
                      target_height: int):
    """Shared body of the host paths: cv2 bilinear resize, BGR -> RGB,
    *2/255-1, HWC -> NCHW, and the (2,) coordinate scale."""
    import cv2

    scale = np.array([source_img.shape[0] / target_height,
                      source_img.shape[1] / target_width])
    input_img = cv2.resize(source_img, (target_width, target_height),
                           interpolation=cv2.INTER_LINEAR)
    input_img = cv2.cvtColor(input_img, cv2.COLOR_BGR2RGB).astype(np.float32)
    input_img = input_img * (2.0 / 255.0) - 1.0
    input_img = input_img.transpose((2, 0, 1)).reshape(
        1, 3, target_height, target_width)
    return input_img, source_img, scale


def process_input(source_img: np.ndarray, scale_factor: float = 1.0,
                  output_stride: int = 16):
    """BGR uint8 HWC frame -> (input (1,3,th,tw) float32 in [-1,1],
    source_img, scale (2,)), at the stride-valid size of the scaled
    source."""
    target_width, target_height = valid_resolution(
        source_img.shape[1] * scale_factor, source_img.shape[0] * scale_factor,
        output_stride=output_stride)
    return _resize_normalize(source_img, target_width, target_height)


def process_input_fixed(source_img: np.ndarray, target_hw,
                        output_stride: int = 16):
    """`process_input` at one fixed stride-valid resolution (snapped from
    `target_hw`), so that frames of any source size make one batch shape;
    coordinates scale back through the same (2,) `scale`."""
    target_width, target_height = valid_resolution(
        target_hw[1], target_hw[0], output_stride=output_stride)
    return _resize_normalize(source_img, target_width, target_height)


def read_imgfile(path: str, scale_factor: float = 1.0,
                 output_stride: int = 16, target_hw=None):
    """Read and preprocess an image file; `target_hw` takes the
    fixed-resolution path."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise IOError(f"could not read image: {path}")
    if target_hw is not None:
        return process_input_fixed(img, target_hw, output_stride)
    return process_input(img, scale_factor, output_stride)


def read_cap(cap, scale_factor: float = 1.0, output_stride: int = 16):
    """Read and preprocess one frame of a capture (`cap.read()`)."""
    res, img = cap.read()
    if not res:
        raise IOError("webcam failure")
    return process_input(img, scale_factor, output_stride)


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
    scale = torch.full((), 2.0 / 255.0, dtype=torch.float32, device=x.device)   # no host copy
    return x * scale - 1.0
