"""Part selection: local-maximum NMS and the top-K candidate list.

The counterpart of `posenet_tpu.ops.nms`, on keypoint-major planes
(B, 17, H, W). What it must reproduce is the ordering all the JAX
selectors share: the flat (keypoint, y, x) order of the masked scores,
with -1 for masked entries, sorted descending, ties going to the lowest
flat index first. One stable sort on the negated scores gives exactly that
(`torch.topk` documents no order for ties on CUDA, so it is not used).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def local_max_mask(scores: torch.Tensor, score_threshold: float,
                   radius: int) -> torch.Tensor:
    """Cells that are the maximum of their (2r+1)^2 window and meet the
    threshold. `scores` (B, 17, H, W); max pooling pads with -inf, so a
    border window holds only real cells."""
    max_vals = F.max_pool2d(scores, 2 * radius + 1, stride=1, padding=radius)
    return (scores == max_vals) & (scores >= score_threshold)


def top_k_candidates(scores: torch.Tensor, mask: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The k best masked cells of each image, by score, descending.

    Args:
      scores, mask: (B, 17, H, W).
    Returns:
      (scores (B,k) float32, keypoint ids, ys, xs (B,k) int64). Slots past
      the masked volume carry the sentinel score -1 at keypoint 0, cell 0.
    """
    b, n_kp, h, w = scores.shape
    flat = torch.where(mask, scores, -1.0).reshape(b, n_kp * h * w)
    neg_sorted, idx = torch.sort(-flat, dim=1, stable=True)
    k_out = min(k, flat.shape[1])
    top_scores, idx = -neg_sorted[:, :k_out], idx[:, :k_out]
    pad = k - k_out
    if pad > 0:
        top_scores = F.pad(top_scores, (0, pad), value=-1.0)
        idx = F.pad(idx, (0, pad), value=0)
    kp = idx // (h * w)
    rem = idx % (h * w)
    return top_scores, kp, rem // w, rem % w
