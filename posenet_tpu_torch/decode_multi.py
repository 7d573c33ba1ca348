"""Multi-pose decoding with the reference API, mirroring
`posenet_tpu.decode_multi`.

`decode_multiple_poses` takes one image's CHW head tensors and returns
numpy `(pose_scores (P,), keypoint_scores (P,17), keypoint_coords (P,17,2),
pose_offsets (P,17,2))` with zero-filled unused slots, computed on
`device` by the batched decoder.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from posenet_tpu_torch.config import DecodeConfig
from posenet_tpu_torch.decode import DecodedPoses, decode_batch
from posenet_tpu_torch.models.model_factory import resolve_device


def _to_hwc(t, device) -> torch.Tensor:
    """One image's CHW array-like -> HWC float32 tensor on `device`, its
    channels adjacent in memory, as the tree walk's kernel reads them."""
    a = torch.as_tensor(t, dtype=torch.float32, device=device)
    if a.ndim == 4:  # tolerate an un-squeezed batch dim of 1, NOT a batch
        if a.shape[0] != 1:
            raise ValueError(
                f"decode_multiple_poses takes ONE image's CHW heads; got a "
                f"batch of {a.shape[0]}; use decode_batch for batched decoding")
        a = a[0]
    return a.permute(1, 2, 0).contiguous()


def decode_multiple_poses(
        scores, offsets, displacements_fwd, displacements_bwd, output_stride,
        max_pose_detections: int = 10, score_threshold: float = 0.5,
        nms_radius: int = 20, min_pose_score: float = 0.5,
        max_candidates: int = 128, *, device: torch.device | str = 'cuda',
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Inputs are CHW: (17,H,W), (34,H,W), (32,H,W), (32,H,W). Raises on a
    host without a CUDA device unless `device` is the CPU."""
    device = resolve_device(device)
    cfg = DecodeConfig(
        max_pose_detections=max_pose_detections,
        score_threshold=score_threshold,
        nms_radius=nms_radius,
        min_pose_score=min_pose_score,
        max_candidates=max_candidates,
    )
    heads = [_to_hwc(t, device)[None] for t in
             (scores, offsets, displacements_fwd, displacements_bwd)]
    result = decode_batch(*heads, int(output_stride), cfg)
    return (result.pose_scores[0].cpu().numpy(),
            result.keypoint_scores[0].cpu().numpy(),
            result.keypoint_coords[0].cpu().numpy().astype(np.float64),
            result.pose_offsets[0].cpu().numpy().astype(np.float64))


def decode_multiple_poses_batch(scores, offsets, displacements_fwd,
                                displacements_bwd, output_stride,
                                cfg: DecodeConfig = DecodeConfig()) -> DecodedPoses:
    """Batched NHWC decode: (B,H,W,C) heads in, (B,P,...) DecodedPoses out,
    on the heads' device."""
    return decode_batch(scores, offsets, displacements_fwd, displacements_bwd,
                        int(output_stride), cfg)
