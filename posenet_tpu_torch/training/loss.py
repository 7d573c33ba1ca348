"""Heatmap + offset aggregation loss on tensors, the counterpart of
`posenet_tpu.training.loss`.

Per GT pose, a binary disk target (radius 3) around each annotated
keypoint scores the heatmap logits by BCE-with-logits, and a disk-dilated
mask gates a SmoothL1 regression of the offsets; the two terms combine
4:1. The JAX package vmaps a single-item loss over the batch; here every
function takes any leading batch axes, and the per-item means reduce only
the item's own axes, so that `reduce=False` returns exact per-item values.

Offsets are packed [all-y || all-x] as the decoder reads them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from posenet_tpu_torch.constants import NUM_KEYPOINTS
from posenet_tpu_torch.decode import split_yx
from posenet_tpu_torch.training.ground_truth import GAUSSIAN_KERNEL_SIZE

# Missing keypoints are sentinels: GT loaders pad with -1 and unannotated
# points are (0, 0).
_DISK_RADIUS = 3


def _grid(height: int, width: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, 1) row and (1, W) column indices as float32."""
    yy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    return yy, xx


def keypoint_validity(keypoints: torch.Tensor) -> torch.Tensor:
    """(..., 17, 2) grid-coord keypoints -> (..., 17) bool validity: a
    keypoint is invalid when BOTH coords are sentinels (0 or -1)."""
    is_sentinel = (keypoints == 0.0) | (keypoints == -1.0)
    return ~is_sentinel.all(dim=-1)


def binary_disk_targets(keypoints: torch.Tensor, height: int, width: int,
                        radius: int = _DISK_RADIUS) -> torch.Tensor:
    """(..., 17, 2) y-x grid coords -> (..., 17, H, W) binary disk targets.

    disk(k) = {cell : ||cell - trunc(k)||_2 <= radius}, zero for invalid
    keypoints."""
    valid = keypoint_validity(keypoints)
    kp = keypoints.to(torch.int32).to(torch.float32)          # truncate like int()
    yy, xx = _grid(height, width, keypoints.device)
    ky = kp[..., 0][..., None, None]
    kx = kp[..., 1][..., None, None]
    d2 = (yy - ky) ** 2 + (xx - kx) ** 2
    disks = (d2 <= radius ** 2).to(torch.float32)
    return disks * valid[..., None, None].to(torch.float32)


def offset_targets_and_mask(keypoints: torch.Tensor, height: int, width: int,
                            output_stride: int,
                            radius: int = _DISK_RADIUS,
                            kernel_size: int = GAUSSIAN_KERNEL_SIZE
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GT offset maps + regression mask.

    offset_map[..., k, y, x] = keypoint_image_coord - cell_image_coord, the
    quantity the decoder adds back. The mask is the max-pool dilation (by
    `radius`) of the thresholded (> 0.1) Gaussian GT heatmap pasted at the
    TRUNCATED cell c = trunc(kp), in closed form:
        max(|ey - cy| - r, 0)^2 + max(|ex - cx| - r, 0)^2 < 2 sigma^2 ln 10
    with sigma = kernel_size / 10 (the derivation is in the JAX module's
    docstring). Pass the kernel_size the dataset's heatmaps were made with.

    Returns:
      offsets (..., 17, H, W, 2) float32, mask (..., 17, H, W) float32.
    """
    valid = keypoint_validity(keypoints).to(torch.float32)
    yy, xx = _grid(height, width, keypoints.device)
    grid = torch.stack(torch.broadcast_tensors(yy, xx), dim=-1) * output_stride  # (H,W,2)
    kp_img = keypoints * output_stride
    offsets = kp_img[..., None, None, :] - grid

    ey = (yy - torch.trunc(keypoints[..., 0])[..., None, None]).abs()
    ex = (xx - torch.trunc(keypoints[..., 1])[..., None, None]).abs()
    dy = torch.clamp(ey - radius, min=0.0)
    dx = torch.clamp(ex - radius, min=0.0)
    disk_r2 = 2.0 * (kernel_size / 10.0) ** 2 * math.log(10.0)
    mask = (dy * dy + dx * dx) < disk_r2
    mask = mask.to(torch.float32) * valid[..., None, None]
    return offsets, mask


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise binary cross-entropy on logits."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Huber/SmoothL1 with beta=1."""
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def batched_loss(heatmap_logits, pred_offsets, keypoints, output_stride: int,
                 heatmap_weight: float = 4.0, offset_weight: float = 1.0,
                 gaussian_kernel_size: int = GAUSSIAN_KERNEL_SIZE,
                 reduce: bool = True) -> Dict[str, torch.Tensor]:
    """The loss of each item of a batch.

    Args:
      heatmap_logits: (B, H, W, 17) pre-sigmoid head output.
      pred_offsets: (B, H, W, 34) packed [y||x] offsets head output.
      keypoints: (B, P, 17, 2) y-x GRID coordinates, sentinel-padded.
    Returns:
      dict(loss, heatmap_loss, offset_loss): batch means, or with
      `reduce=False` the per-item (B,) vectors (the eval path uses them to
      exclude wrap-padding duplicates and weight partial batches exactly).
      Per item, per-pose terms are averaged over the present poses and
      combined (w_h*hm + w_o*off)/(w_h+w_o).
    """
    h, w = heatmap_logits.shape[1], heatmap_logits.shape[2]
    pose_present = keypoint_validity(keypoints).any(dim=-1).to(torch.float32)  # (B,P)
    num_people = torch.clamp(pose_present.sum(dim=-1), min=1.0)                 # (B,)

    # Heatmap term: mean BCE of the full 17xHxW map against each pose's
    # disk target, averaged over present poses.
    disks = binary_disk_targets(keypoints, h, w)                 # (B,P,17,H,W)
    logits_chw = heatmap_logits.permute(0, 3, 1, 2)              # (B,17,H,W)
    per_pose_hm = bce_with_logits(logits_chw[:, None], disks).mean(dim=(2, 3, 4))
    heatmap_loss = (per_pose_hm * pose_present).sum(dim=-1) / num_people

    # Offset term: masked SmoothL1, mean over ALL elements (both operands
    # masked, then an unmasked mean).
    off_yx = split_yx(pred_offsets, NUM_KEYPOINTS).permute(0, 3, 1, 2, 4)  # (B,17,H,W,2)
    gt_off, mask = offset_targets_and_mask(
        keypoints, h, w, output_stride, kernel_size=gaussian_kernel_size)
    m = mask[..., None]                                          # (B,P,17,H,W,1)
    per_pose_off = smooth_l1(off_yx[:, None] * m, gt_off * m).mean(dim=(2, 3, 4, 5))
    offset_loss = (per_pose_off * pose_present).sum(dim=-1) / num_people

    total = (heatmap_weight * heatmap_loss + offset_weight * offset_loss) / (
        heatmap_weight + offset_weight)
    per_item = {'loss': total, 'heatmap_loss': heatmap_loss,
                'offset_loss': offset_loss}
    if not reduce:
        return per_item
    return {k: v.mean() for k, v in per_item.items()}


def heatmap_offset_loss(heatmap_logits, pred_offsets, keypoints, output_stride: int,
                        heatmap_weight: float = 4.0, offset_weight: float = 1.0,
                        gaussian_kernel_size: int = GAUSSIAN_KERNEL_SIZE
                        ) -> Dict[str, torch.Tensor]:
    """Single-item loss: (H, W, 17) logits, (H, W, 34) offsets and (P, 17, 2)
    keypoints -> dict(loss, heatmap_loss, offset_loss) of scalars."""
    per_item = batched_loss(heatmap_logits[None], pred_offsets[None], keypoints[None],
                            output_stride, heatmap_weight, offset_weight,
                            gaussian_kernel_size, reduce=False)
    return {k: v[0] for k, v in per_item.items()}
