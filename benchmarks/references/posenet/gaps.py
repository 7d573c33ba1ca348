"""The comparison that decides `correct`: the poses the timed path produced,
judged against the reference's float32 heads and decode of the same frames.

With random weights the best candidate roots of an image score within
rounding of each other, so a sound bf16 program picks other roots and
lands other hops than the float32 reference in places. The comparison
therefore does not match poses one for one. It reads each pose the
program produced and asks how far the reference's heads are from having
produced it, as a served model's token is judged by how far its logit
lies below the reference's best:

- `score_gap`: the heatmap head, the trunk under it, and the choice of
  roots, in heatmap units; the worst of two gaps. At each keypoint: its
  cell is the one (among those whose offset can reach it) whose centre
  plus the reference offset lies nearest the keypoint, and the gap lies
  between the program's keypoint score and the reference heatmap there.
  At each pose's root: how far the reference heatmap is from having made
  it a candidate accepted in this order. The root may be any keypoint
  under which every hop lands within one cell (`output_stride` px) of its
  target's cell; each reads its shortfall below the score threshold and
  the excess of its 3x3 neighbours over it (the NMS), the least of these
  over the possible roots; and a pose whose lowest possible root score
  exceeds an earlier pose's highest reads the excess (the top-K order and
  the greedy accept's).
- `offset_gap_px`: that nearest distance, in pixels. The offset head.
- `walk_gap_px`: for each of the 16 tree edges, the landing point of the
  hop (source coordinate + the reference displacement at the source's
  rounded cell), and its distance to the rounding box of the cell the
  program's target keypoint sits in (0 inside it); the worst edge of a
  pose, under the root that explains the pose best (the root fixes which
  edges were walked backward). The displacement heads and K1's walk.
- `pose_score_gap`: the program's pose score against the instance score
  recomputed from the reference heatmap at the keypoints' cells, each
  keypoint within the NMS radius of an earlier pose's same keypoint
  counted as zero (the greedy accept's arithmetic); and the pose score
  of a pose in a slot that one side filled and the other left empty
  (the count of poses: a batch or a shard left out).

Each is the worst over every sampled pose. A sound program reads rounding
noise in each; a lower precision reads several times that (PERF.md gives
the readings and the limits set between them).
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmarks.references.posenet import model as ref

NAMES = ('score_gap', 'offset_gap_px', 'walk_gap_px', 'pose_score_gap')


def _ancestors() -> torch.Tensor:
    """(17, 16) bool: edge e was walked backward when the root is r, i.e.
    its child lies on the path from r up to the nose."""
    parent = {c: p for p, c in ref.EDGES}
    table = torch.zeros((ref.NUM_KEYPOINTS, ref.NUM_EDGES), dtype=torch.bool)
    for r in range(ref.NUM_KEYPOINTS):
        on_path, k = {r}, r
        while k in parent:
            k = parent[k]
            on_path.add(k)
        for e, (_, c) in enumerate(ref.EDGES):
            table[r, e] = c in on_path
    return table


BACKWARD = _ancestors()


def _box_distance(land: torch.Tensor, cell: torch.Tensor, n: int, stride: int):
    """Distance along one axis from `land` to the coordinates that round to
    `cell` (the grid's edge cells reach out to infinity: the walk clamps)."""
    lo = torch.where(cell > 0, (cell - 0.5) * stride, -torch.inf)
    hi = torch.where(cell < n - 1, (cell + 0.5) * stride, torch.inf)
    return torch.clamp(torch.maximum(lo - land, land - hi), min=0.0)


def gaps(poses: Dict[str, torch.Tensor], heads: Dict[str, torch.Tensor],
         decoded: Dict[str, torch.Tensor], output_stride: int, decode_cfg: dict
         ) -> Dict[str, float]:
    """The four numbers over a block of images. `poses`: the program's
    pose_scores (N, P), keypoint_scores (N, P, 17), keypoint_coords
    (N, P, 17, 2); `heads` and `decoded`: the reference's for the same
    frames (`reference.forward`, `reference.decode`)."""
    hm, off = heads['heatmap'], heads['offset']
    dev = hm.device
    n_img, h, w, _ = hm.shape
    s = output_stride
    pose_scores = poses['pose_scores'].to(dev).float()
    kp_scores = poses['keypoint_scores'].to(dev).float()
    coords = poses['keypoint_coords'].to(dev).float()
    p = pose_scores.shape[1]
    valid = pose_scores > 0                                        # (N, P)
    nk = ref.NUM_KEYPOINTS
    earlier = torch.tril(torch.ones((p, p), dtype=torch.bool, device=dev), -1)  # (P, P')
    bidx = torch.arange(n_img, device=dev)[:, None, None]
    kidx = torch.arange(nk, device=dev)[None, None, :]

    # The cell each keypoint came from, and how far the reference's offset
    # there puts it; a cell whose offset reaches it lies within `reach`.
    reach = int(torch.ceil(off.abs().max() / s)) + 1
    base_y = torch.round(coords[..., 0] / s)
    base_x = torch.round(coords[..., 1] / s)
    best = torch.full(base_y.shape, torch.inf, device=dev)
    cell_y, cell_x = torch.zeros_like(base_y), torch.zeros_like(base_x)
    for dy in range(-reach, reach + 1):
        for dx in range(-reach, reach + 1):
            cy = (base_y + dy).clamp(0, h - 1)
            cx = (base_x + dx).clamp(0, w - 1)
            oy = off[bidx, cy.long(), cx.long(), kidx]
            ox = off[bidx, cy.long(), cx.long(), kidx + nk]
            dist = torch.hypot(cy * s + oy - coords[..., 0], cx * s + ox - coords[..., 1])
            closer = dist < best
            best = torch.where(closer, dist, best)
            cell_y = torch.where(closer, cy, cell_y)
            cell_x = torch.where(closer, cx, cell_x)
    ref_score = hm[bidx, cell_y.long(), cell_x.long(), kidx]      # (N, P, 17)
    score_gap = (ref_score - kp_scores).abs()
    offset_gap = best

    # Each edge's hop, forward and backward, against the cell the program's
    # target keypoint sits in.
    def hop_gap(src, tgt, e, disp):
        sy = ref.cell_of(coords[..., src, 0], h, s)
        sx = ref.cell_of(coords[..., src, 1], w, s)
        b = torch.arange(n_img, device=dev)[:, None]
        ly = coords[..., src, 0] + disp[b, sy.long(), sx.long(), e]
        lx = coords[..., src, 1] + disp[b, sy.long(), sx.long(), ref.NUM_EDGES + e]
        return torch.hypot(_box_distance(ly, cell_y[..., tgt], h, s),
                           _box_distance(lx, cell_x[..., tgt], w, s))
    fwd = torch.stack([hop_gap(pa, ch, e, heads['displacement_fwd'])
                       for e, (pa, ch) in enumerate(ref.EDGES)], -1)   # (N, P, 16)
    bwd = torch.stack([hop_gap(ch, pa, e, heads['displacement_bwd'])
                       for e, (pa, ch) in enumerate(ref.EDGES)], -1)
    backward = BACKWARD.to(dev)
    per_root = torch.where(backward[None, None], bwd[:, :, None], fwd[:, :, None])
    root_walk = per_root.amax(-1)                                  # (N, P, 17)
    walk_gap = root_walk.amin(-1)                                  # (N, P)

    # The pose's possible roots, each as a candidate of the reference's
    # heatmap: above the threshold, a 3x3 maximum, and in the order of
    # acceptance.
    rooted = root_walk <= s
    excess = torch.full_like(ref_score, -torch.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ny = (cell_y + dy).clamp(0, h - 1).long()
            nx = (cell_x + dx).clamp(0, w - 1).long()
            excess = torch.maximum(excess, hm[bidx, ny, nx, kidx] - ref_score)
    shortfall = torch.maximum(float(decode_cfg['score_threshold']) - ref_score, excess)
    unfit = torch.where(rooted, shortfall, torch.inf).amin(-1).clamp(min=0.0)
    has_root = rooted.any(-1)                                      # (N, P)
    unfit = torch.where(has_root, unfit, 0.0)           # no root: walk_gap's to tell
    low = torch.where(rooted, ref_score, torch.inf).amin(-1)
    high = torch.where(rooted, ref_score, -torch.inf).amax(-1)
    pairs = earlier[None] & has_root[:, :, None] & (has_root & valid)[:, None, :]
    order = torch.where(pairs, low[:, :, None] - high[:, None, :], 0.0).amax(-1)
    order = order.clamp(min=0.0)
    root_gap = torch.maximum(unfit, order)

    ref_valid = torch.arange(p, device=dev)[None] < decoded['count'][:, None]

    # The instance score from the reference heatmap at the keypoints' cells.
    r2 = float(decode_cfg['nms_radius']) ** 2
    d2 = ((coords[:, :, None] - coords[:, None]) ** 2).sum(-1)   # (N, P, P', 17)
    overlapped = ((d2 <= r2) & earlier[None, :, :, None] & valid[:, None, :, None]).any(2)
    inst = torch.where(overlapped, 0.0, ref_score).sum(-1) / nk
    pose_gap = torch.where(valid, (inst - pose_scores).abs(), 0.0)
    pose_gap = torch.maximum(pose_gap, torch.where(ref_valid & ~valid,
                                                   decoded['pose_scores'], 0.0))
    pose_gap = torch.maximum(pose_gap, torch.where(valid & ~ref_valid, pose_scores, 0.0))

    v3 = valid[..., None]
    return {
        'score_gap': max(float(torch.where(v3, score_gap, 0.0).max()),
                         float(torch.where(valid, root_gap, 0.0).max())),
        'offset_gap_px': float(torch.where(v3, offset_gap, 0.0).max()),
        'walk_gap_px': float(torch.where(valid, walk_gap, 0.0).max()),
        'pose_score_gap': float(pose_gap.max()),
    }


def worst(blocks) -> Dict[str, float]:
    """The worst of each number over several blocks' `gaps`."""
    out = {name: 0.0 for name in NAMES}
    for block in blocks:
        for name in NAMES:
            out[name] = max(out[name], block[name])
    return out
