"""Fused inference: uint8 frames -> normalize -> backbone -> decode.

The counterpart of `posenet_tpu.pipeline` on one device. A call queues the
whole program on the device and returns `DecodedPoses` tensors there; the
host waits only when the caller reads them. Two entries: `infer` takes RGB
frames at the model resolution, `infer_raw` BGR frames at the source
resolution, which it resizes on the device. Not ported yet: the mesh
(data and spatial partition), the int8 trunk.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from posenet_tpu_torch.config import DecodeConfig, ModelConfig
from posenet_tpu_torch.decode import DecodedPoses, decode_batch
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.models.model_factory import PoseNet
from posenet_tpu_torch.preprocess import preprocess_on_device


def normalize(frames_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 -> [-1, 1] in `dtype`, as x * (2/255) - 1.

    The scale is rounded to `dtype` before it multiplies, as the JAX
    package's weak-typed 2/255 is; in bf16 a Python float would multiply
    unrounded and give other values for 111 of the 256 inputs."""
    scale = torch.tensor(2.0 / 255.0, dtype=dtype, device=frames_u8.device)
    return frames_u8.to(dtype) * scale - 1.0


def to_device(frames_u8, device: torch.device) -> torch.Tensor:
    """A frame batch (numpy array or tensor) as a tensor on `device`.

    A host batch bound for a CUDA device is staged in pinned memory (unless
    it is pinned already) and copied with `non_blocking=True`. A copy from
    pageable memory would make the host wait until the stream reaches it,
    that is, until the device has finished the work queued before it, so a
    server could not queue batch N+1 while batch N runs. PyTorch's pinned
    allocator keeps the staging buffer from reuse until the copy is done."""
    frames = torch.as_tensor(frames_u8)
    if frames.device == device:
        return frames
    if device.type == 'cuda' and frames.device.type == 'cpu':
        if not frames.is_pinned():
            frames = torch.empty(frames.shape, dtype=frames.dtype,
                                 pin_memory=True).copy_(frames)
        return frames.to(device, non_blocking=True)
    return frames.to(device)


def infer(params: Dict[str, Any], frames_u8: torch.Tensor, cfg: ModelConfig,
          decode_cfg: DecodeConfig) -> DecodedPoses:
    """(B, H, W, 3) uint8 RGB frames -> DecodedPoses (B, P, ...), on the
    frames' device. `params` must be on that device, cast as
    `mobilenet_v1.cast_params` does for `cfg.compute_dtype`."""
    x = normalize(frames_u8, cfg.compute_dtype)
    heads = mobilenet_v1.forward(params, x, cfg)
    return decode_batch(
        heads['heatmap'], heads['offset'], heads['displacement_fwd'],
        heads['displacement_bwd'], cfg.output_stride, decode_cfg)


def infer_raw(params: Dict[str, Any], frames_bgr_u8: torch.Tensor,
              target_hw: Tuple[int, int], cfg: ModelConfig,
              decode_cfg: DecodeConfig) -> DecodedPoses:
    """(B, Hs, Ws, 3) uint8 BGR frames at the source resolution ->
    DecodedPoses, with coordinates at `target_hw` (th, tw), stride-valid.

    `preprocess_on_device` (BGR -> RGB, float32 bilinear resize, normalize
    in float32), then `forward`, whose trunk casts to the compute dtype,
    then `decode_batch`, on the frames' device; the same calls made one by
    one give the same bits. (`infer` normalizes in the compute dtype
    instead, as the JAX package's `_infer` does.)"""
    x = preprocess_on_device(frames_bgr_u8, target_hw)
    heads = mobilenet_v1.forward(params, x, cfg)
    return decode_batch(
        heads['heatmap'], heads['offset'], heads['displacement_fwd'],
        heads['displacement_bwd'], cfg.output_stride, decode_cfg)


class PoseNetPipeline:
    """The fused program on one device.

    Usage:
        model = load_model(101, 16, allow_random_init=True, device='cuda',
                           compute_dtype=torch.bfloat16)
        pipe = PoseNetPipeline(model)
        poses = pipe(frames_u8)   # (B, H, W, 3) uint8 RGB, H, W = stride*n + 1

        raw = PoseNetPipeline(model, device_resize_to=(513, 513))
        poses = raw(frames_bgr)   # (B, Hs, Ws, 3) uint8 BGR, any source size
    """

    def __init__(self, model: PoseNet,
                 decode_cfg: DecodeConfig = DecodeConfig(min_pose_score=0.25),
                 device: torch.device | str | None = None,
                 device_resize_to: Optional[Tuple[int, int]] = None):
        """`device`: where the program runs (None: the model's device). The
        kernels are cast once here to the model's compute dtype.

        `device_resize_to`: (th, tw) stride-valid processing resolution.
        When set, a call takes uint8 BGR frames at the SOURCE resolution and
        the program flips them to RGB, resizes and normalizes them on the
        device (`infer_raw`). Decoded coordinates are at (th, tw)."""
        self.cfg = model.cfg
        self.decode_cfg = decode_cfg
        self.device = torch.device(device) if device is not None else model.device
        self.params = mobilenet_v1.cast_params(
            model.params, model.cfg.compute_dtype, self.device)
        self.device_resize_to = (tuple(device_resize_to)
                                 if device_resize_to is not None else None)

    def __call__(self, frames_u8) -> DecodedPoses:
        """Run forward + decode on a uint8 frame batch (B, H, W, 3). Frames
        on another device are copied (`to_device`: host frames for a CUDA
        device without waiting for the device).

        The input colour order flips with `device_resize_to`:
          * default: RGB frames at the model resolution (what host
            preprocessing produces);
          * `device_resize_to` set: BGR frames at the source resolution, as
            a capture gives them; the program swaps BGR -> RGB on the
            device.
        Frames in the wrong order raise no error but lower the pose scores.
        """
        frames = to_device(frames_u8, self.device)
        if frames.dtype != torch.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f'expected (B, H, W, 3) uint8 frames, got '
                             f'{tuple(frames.shape)} {frames.dtype}')
        if self.device_resize_to is not None:
            return infer_raw(self.params, frames, self.device_resize_to, self.cfg,
                             self.decode_cfg)
        return infer(self.params, frames, self.cfg, self.decode_cfg)

    def warmup(self, input_hw: Tuple[int, int], batch: int = 1):
        """Run one batch of zeros (builds the CUDA kernels on first use) and
        wait for it. `input_hw` is the frames' (H, W): the model resolution,
        or the source resolution with `device_resize_to`."""
        dummy = torch.zeros((batch, *input_hw, 3), dtype=torch.uint8,
                            device=self.device)
        self(dummy).pose_scores.cpu()
