"""Batched multi-pose decoder (PersonLab-style greedy decoding) in PyTorch.

The counterpart of `posenet_tpu.decode`, batched over images throughout:

1. `_prepare_decode`: the heads as row views (no copy), local-max NMS,
   the top-K candidate list and each candidate's refined root coordinate.
2. `ops.traversal.traverse_all_candidates`: every candidate's 17-keypoint
   tree walk, in parallel (the CUDA kernel on the card).
3. `_greedy_accept`: the sequential accept over the ranked candidates, as
   exactly P rounds batched over images, with no host synchronisation.

Every stage is static-shape, so a call queues device work and returns;
nothing waits for the device until the caller reads a result.

The single-pose decode (`decode_single_pose`, `decode_pose`) grows one
pose from the best keypoint: the same tree walk for one candidate of one
image, one kernel launch on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from posenet_tpu_torch.config import DecodeConfig
from posenet_tpu_torch.constants import EDGES, LOCAL_MAXIMUM_RADIUS, NUM_KEYPOINTS
from posenet_tpu_torch.ops.nms import local_max_mask, top_k_candidates
from posenet_tpu_torch.ops.traversal import traverse_all_candidates


def _tree_levels():
    """Group the 16 kinematic edges into dependency levels.

    The tree is rooted at the nose with depth 4. Within one level no edge's
    source is another's target, so walking a level's edges in one batch is
    exactly the edge-by-edge walk. Returns (bwd_levels, fwd_levels), each a
    list of levels of (edge_id, source_kp, target_kp).
    """
    depth = {0: 0}
    for parent, child in EDGES.tolist():
        depth[child] = depth[parent] + 1
    bwd, fwd = {}, {}
    for edge_id, (parent, child) in enumerate(EDGES.tolist()):
        # backward: child -> parent, deepest child first
        bwd.setdefault(depth[child], []).append((edge_id, child, parent))
        # forward: parent -> child, shallowest parent first
        fwd.setdefault(depth[parent], []).append((edge_id, parent, child))
    bwd_levels = [bwd[d] for d in sorted(bwd, reverse=True)]
    fwd_levels = [fwd[d] for d in sorted(fwd)]
    return bwd_levels, fwd_levels


_BWD_LEVELS, _FWD_LEVELS = _tree_levels()


class DecodedPoses(NamedTuple):
    """Fixed-size decode result, (B, P, ...); unfilled slots are zero."""

    pose_scores: torch.Tensor       # (B, P)
    keypoint_scores: torch.Tensor   # (B, P, 17)
    keypoint_coords: torch.Tensor   # (B, P, 17, 2)  y, x image px
    pose_offsets: torch.Tensor      # (B, P, 17, 2)
    # (B,) int32: above-threshold local maxima BEFORE the top-K cut. More
    # than max_candidates means the image decoded from a truncated pool.
    candidate_count: Optional[torch.Tensor] = None

    def as_tuple(self) -> Tuple[Optional[torch.Tensor], ...]:
        """The fields as a plain tuple: what an exported serving program
        returns, because `torch.export.save` serializes no NamedTuple."""
        return tuple(self)

    @classmethod
    def from_tuple(cls, values) -> 'DecodedPoses':
        """The inverse of `as_tuple`, for the loader of such a program."""
        return cls(*values)

    def overflowed(self, max_candidates: int) -> torch.Tensor:
        """(B,) bool: did the candidate pool exceed the top-K budget?"""
        if self.candidate_count is None:
            raise ValueError("this DecodedPoses carries no candidate_count")
        return self.candidate_count > max_candidates


def _prepare_decode(heatmap, offsets, dfwd, dbwd, output_stride: int,
                    cfg: DecodeConfig):
    """Stage 1 on NHWC heads (B, H, W, C).

    Returns (scores (B,HW,17), offsets (B,HW,34), dfwd, dbwd (B,HW,32),
    cand_scores (B,K), cand_kp (B,K) int32, root_coords (B,K,2),
    candidate_count (B,) int32). The four row tensors are views of the
    heads: on `run_heads`' output the offsets and displacements stay views
    of its one 115-channel tensor, which the tree walk reads in place.
    """
    b, h, w, _ = heatmap.shape
    scores, offsets, dfwd, dbwd = (t.view(b, h * w, t.shape[-1])
                                   for t in (heatmap, offsets, dfwd, dbwd))

    planes = heatmap.permute(0, 3, 1, 2)                         # (B,17,H,W)
    mask = local_max_mask(planes, cfg.score_threshold, LOCAL_MAXIMUM_RADIUS)
    n_cand = mask.sum(dim=(1, 2, 3), dtype=torch.int32)
    cand_scores, cand_kp, cand_y, cand_x = top_k_candidates(
        planes, mask, cfg.max_candidates)

    # Root image coords: cell*stride + the root keypoint's offset there.
    rows = torch.gather(offsets, 1, (cand_y * w + cand_x)[..., None].expand(
        -1, -1, 2 * NUM_KEYPOINTS))                              # (B, K, 34)
    off = rows.gather(2, torch.stack([cand_kp, cand_kp + NUM_KEYPOINTS], dim=-1))
    cand_cell = torch.stack([cand_y, cand_x], dim=-1).float()
    root_coords = cand_cell * output_stride + off                # (B, K, 2)
    return (scores, offsets, dfwd, dbwd, cand_scores, cand_kp.to(torch.int32),
            root_coords, n_cand)


def _greedy_accept(cand_scores, cand_kp, root_coords, all_scores, all_coords,
                   all_offsets, cfg: DecodeConfig) -> DecodedPoses:
    """Stage 3: greedy accept over the ranked candidates of each image.

    Each round accepts, per image, the lowest-indexed candidate that is
    valid, not within nms_radius of an accepted pose's same keypoint, and
    whose overlap-discounted instance score passes min_pose_score. A
    candidate's eligibility only falls as poses are accepted, so this is
    the reference's per-candidate loop, and a round that accepts nothing
    changes nothing: exactly P rounds equal the JAX package's while_loop.

    A candidate's instance score adds its 17 kept keypoint scores left to
    right, the order of XLA's CPU reduction, so that it is within 1 ulp of
    the JAX package's (XLA multiplies by a rounded 1/17 where this
    divides) and bitwise the same on the card and on the CPU. `torch.sum`
    adds in other orders there, up to 3 ulp from JAX's
    (tools/fuzz_decode_parity_torch.py).
    """
    b, k = cand_scores.shape
    p = cfg.max_pose_detections
    device = cand_scores.device
    r2 = float(cfg.nms_radius ** 2)
    slot_ids = torch.arange(p, device=device)
    cand_ids = torch.arange(k, device=device)
    batch_ids = torch.arange(b, device=device)
    valid = cand_scores > -0.5                 # top-K sentinel is -1
    kp_index = cand_kp.long()[:, None, :, None].expand(b, p, k, 2)
    # A device tensor: CUDA divides by a CPU scalar as a multiply by its
    # reciprocal, which is not IEEE division. Filled in on the device: a
    # copy from the host would wait for the work queued before it.
    n_kp = torch.full((), float(NUM_KEYPOINTS), device=device)

    pose_scores = torch.zeros((b, p), device=device)
    kp_scores = torch.zeros((b, p, NUM_KEYPOINTS), device=device)
    kp_coords = torch.zeros((b, p, NUM_KEYPOINTS, 2), device=device)
    pose_offsets = torch.zeros((b, p, NUM_KEYPOINTS, 2), device=device)
    count = torch.zeros((b,), dtype=torch.long, device=device)

    for _ in range(p):
        occupied = slot_ids[None] < count[:, None]                # (B, P)
        # Root NMS: accepted poses' coords at each candidate's root keypoint.
        d = torch.gather(kp_coords, 2, kp_index) - root_coords[:, None]
        d2_root = (d * d).sum(-1)                                 # (B, P, K)
        root_sup = (occupied[:, :, None] & (d2_root <= r2)).any(1)

        d = kp_coords[:, :, None] - all_coords[:, None]           # (B,P,K,17,2)
        d2 = (d * d).sum(-1)
        overlapped = (occupied[:, :, None, None] & (d2 <= r2)).any(1)
        kept = torch.where(overlapped, 0.0, all_scores).unbind(-1)
        inst = functools.reduce(torch.add, kept) / n_kp          # (B, K)

        score_ok = (cfg.min_pose_score == 0.0) | (inst >= cfg.min_pose_score)
        eligible = valid & ~root_sup & score_ok
        accept = eligible.any(1) & (count < p)                    # (B,)
        first = torch.where(eligible, cand_ids, k).argmin(1)      # lowest index

        slot = (slot_ids[None] == count[:, None]) & accept[:, None]   # (B, P)
        pose_scores = torch.where(slot, inst[batch_ids, first][:, None], pose_scores)
        kp_scores = torch.where(slot[..., None],
                                all_scores[batch_ids, first][:, None], kp_scores)
        kp_coords = torch.where(slot[..., None, None],
                                all_coords[batch_ids, first][:, None], kp_coords)
        pose_offsets = torch.where(slot[..., None, None],
                                   all_offsets[batch_ids, first][:, None], pose_offsets)
        count = count + accept.long()
    return DecodedPoses(pose_scores, kp_scores, kp_coords, pose_offsets)


def decode_batch(heatmap, offsets, dfwd, dbwd, output_stride: int,
                 cfg: DecodeConfig) -> DecodedPoses:
    """Batched decode: NHWC heads (B, H, W, C) -> DecodedPoses (B, P, ...),
    on the heads' device. The tree walk is the CUDA kernel for CUDA
    tensors and its plain version for CPU tensors."""
    h, w = heatmap.shape[1], heatmap.shape[2]
    rows = _prepare_decode(heatmap, offsets, dfwd, dbwd, output_stride, cfg)
    cand_scores, cand_kp, root_coords, n_cand = rows[4:]
    all_scores, all_coords, all_offsets = traverse_all_candidates(
        cand_scores, cand_kp, root_coords, *rows[:4], h, w, output_stride)
    return _greedy_accept(cand_scores, cand_kp, root_coords, all_scores,
                          all_coords, all_offsets, cfg)._replace(
                              candidate_count=n_cand)


def decode_single(heatmap, offsets, dfwd, dbwd, output_stride: int,
                  cfg: DecodeConfig) -> DecodedPoses:
    """One image's HWC heads -> an unbatched DecodedPoses (P, ...), with
    `candidate_count` a 0-d tensor: element 0 of `decode_batch` on a
    batch of one (one tree-walk launch on the card).

    Args:
      heatmap: (H, W, 17) sigmoid scores.
      offsets: (H, W, 34) packed [y||x].
      dfwd/dbwd: (H, W, 32) packed [y||x].
    """
    out = decode_batch(heatmap[None], offsets[None], dfwd[None], dbwd[None],
                       output_stride, cfg)
    return DecodedPoses(*(t[0] for t in out))


# ---------------------------------------------------------------------------
# Single-pose decoding
# ---------------------------------------------------------------------------

def split_yx(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(H, W, 2n) channel-packed field [all-y || all-x] -> (H, W, n, 2),
    y-component first."""
    return torch.stack([packed[..., :n], packed[..., n:2 * n]], dim=-1)


def _rows(field_yx: torch.Tensor) -> torch.Tensor:
    """(H, W, n, 2) -> the (1, H*W, 2n) [y || x] rows the tree walk reads."""
    h, w, n, _ = field_yx.shape
    return torch.cat([field_yx[..., 0].reshape(h * w, n),
                      field_yx[..., 1].reshape(h * w, n)], dim=1)[None]


def _walk_one(root_score, root_id, root_image_coord, scores_map, offsets, dfwd, dbwd,
              output_stride: int):
    """The tree walk of one root over (1, H*W, C) [y || x] rows with unit
    column stride (the scores (H, W, 17)): one launch of the walk's kernel
    on the card. Returns (keypoint_scores (17,), keypoint_coords (17, 2),
    offsets (17, 2))."""
    h, w, _ = scores_map.shape
    device = scores_map.device
    scores = scores_map.reshape(1, h * w, NUM_KEYPOINTS)
    cand_score = torch.as_tensor(root_score, dtype=torch.float32, device=device).reshape(1, 1)
    cand_kp = torch.as_tensor(root_id, dtype=torch.int32, device=device).reshape(1, 1)
    root = torch.as_tensor(root_image_coord, dtype=torch.float32, device=device).reshape(1, 1, 2)
    kp_scores, kp_coords, kp_offsets = traverse_all_candidates(
        cand_score, cand_kp, root, scores, offsets, dfwd, dbwd, h, w, output_stride)
    return kp_scores[0, 0], kp_coords[0, 0], kp_offsets[0, 0]


def decode_pose(root_score, root_id, root_image_coord, scores_map, offsets_yx,
                dfwd_yx, dbwd_yx, output_stride: int):
    """Grow a full 17-keypoint pose from one root: `scores_map` (H, W, 17),
    the stacked (H, W, n, 2) fields that `split_yx` makes, the root's score,
    keypoint id and (y, x) image coordinate (tensors or numbers).

    One tree walk for one candidate of one image: on the card, one launch
    of the walk's kernel. Returns (keypoint_scores (17,), keypoint_coords
    (17, 2), offsets (17, 2)) on the maps' device."""
    return _walk_one(root_score, root_id, root_image_coord, scores_map, _rows(offsets_yx),
                     _rows(dfwd_yx), _rows(dbwd_yx), output_stride)


def decode_single_pose(heatmap: torch.Tensor, offsets: torch.Tensor,
                       dfwd: torch.Tensor, dbwd: torch.Tensor, output_stride: int,
                       score_threshold: float = 0.5
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-person decode of one image's HWC heads: (H, W, 17) scores,
    (H, W, 34) offsets and (H, W, 32) displacements, [y || x] packed.

    Per keypoint the best local maximum at or above `score_threshold`; the
    root is the keypoint with the best of those; one pose grows from it.
    The root is refined by its offset, as the multi-pose decode's roots
    are (the reference's single-pose decode takes the bare cell).

    Returns (keypoint_scores (17,), keypoint_coords (17, 2), root_id)."""
    best_scores, best_cells = build_part_with_score_single_pose(
        score_threshold, LOCAL_MAXIMUM_RADIUS, heatmap)
    root_score, root_id, root_cell = find_root(best_scores, best_cells)
    root_offset = offsets[root_cell[0], root_cell[1]][
        torch.stack([root_id, root_id + NUM_KEYPOINTS])]
    root_coord = root_cell.float() * output_stride + root_offset
    h, w, _ = heatmap.shape
    # The packed heads are already the walk's rows: views where their
    # channels are adjacent in memory.
    kp_scores, kp_coords, _ = _walk_one(
        root_score, root_id, root_coord, heatmap,
        *(t.reshape(1, h * w, t.shape[-1]) for t in (offsets, dfwd, dbwd)), output_stride)
    return kp_scores, kp_coords, root_id


def build_part_with_score_single_pose(score_threshold, local_max_radius,
                                      heatmap: torch.Tensor):
    """Per keypoint, the best local maximum of the (H, W, 17) heatmap at or
    above the threshold: a masked argmax per channel (the first cell in
    row-major order on ties; a channel with none gives score 0 at cell 0).

    Returns (highest_scores (17,), highest_score_indices (17, 2) y-x cells)."""
    h, w, _ = heatmap.shape
    planes = heatmap.permute(2, 0, 1)[None]                      # (1,17,H,W)
    mask = local_max_mask(planes, score_threshold, local_max_radius)
    flat = torch.where(mask, planes, 0.0).reshape(NUM_KEYPOINTS, h * w)
    best_idx = flat.argmax(dim=1)
    best_scores = flat.gather(1, best_idx[:, None])[:, 0]
    return best_scores, torch.stack([best_idx // w, best_idx % w], dim=-1)


def find_root(highest_scores, highest_score_indices):
    """The root: the keypoint with the best score. Returns (root_score,
    root_id, root_cell (2,))."""
    root_id = highest_scores.argmax()
    return highest_scores[root_id], root_id, highest_score_indices[root_id]
