"""Pose evaluation metrics: Hungarian matching, OKS, precision/recall, mAP.

A numpy and scipy copy of `posenet_tpu.training.metrics`. OKS is the COCO
mean keypoint similarity exp(-d_k^2 / (2 s^2 k_i^2)) with the object scale
s; precision and recall count keypoints over Hungarian-matched poses, with
every keypoint of an unmatched predicted or GT pose counted as a false
positive or negative. Host-side, over small (P, 17, 2) arrays.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from posenet_tpu_torch.constants import OKS_SIGMAS


def _is_sentinel(kp: np.ndarray) -> np.ndarray:
    """(…, 2) -> (…,) bool: keypoint is an unannotated placeholder. GT
    loaders pad with (-1,-1) and unannotated points are (0,0).

    Per-coord rule (each coord in {0,-1}), the SAME convention as
    loss.keypoint_validity: training and eval never classify one keypoint
    oppositely."""
    return np.all((kp == 0.0) | (kp == -1.0), axis=-1)


def match_poses(preds: np.ndarray, gts: np.ndarray) -> List[Tuple[int, int]]:
    """Optimal pred<->gt pose assignment minimizing total keypoint L2 cost.
    Returns (pred_idx, gt_idx) pairs."""
    from scipy.optimize import linear_sum_assignment

    preds = np.asarray(preds, dtype=np.float64)
    gts = np.asarray(gts, dtype=np.float64)
    if len(preds) == 0 or len(gts) == 0:
        return []
    diff = preds[:, None] - gts[None, :]               # (Np, Ng, 17, 2)
    cost = np.sqrt((diff ** 2).sum(axis=(-2, -1)))
    row_ind, col_ind = linear_sum_assignment(cost)
    return list(zip(row_ind.tolist(), col_ind.tolist()))


def object_scale(gt_pose: np.ndarray) -> float:
    """COCO object scale s = sqrt(bbox area) from annotated keypoints."""
    valid = ~_is_sentinel(gt_pose)
    if valid.sum() < 2:
        return 1.0
    pts = gt_pose[valid]
    extent = pts.max(axis=0) - pts.min(axis=0)
    return float(max(np.sqrt(extent[0] * extent[1]), 1.0))


def calculate_oks(matched_pairs: Sequence[Tuple[int, int]],
                  preds: np.ndarray, gts: np.ndarray,
                  sigmas: np.ndarray = OKS_SIGMAS) -> float:
    """Mean Object Keypoint Similarity over matched pose pairs.

    COCO definition: per keypoint i, ks_i = exp(-d_i^2 / (2 s^2 k_i^2))
    with k_i = 2*sigma_i, averaged over annotated keypoints, then over
    scored pairs.
    """
    preds = np.asarray(preds, dtype=np.float64)
    gts = np.asarray(gts, dtype=np.float64)
    total = 0.0
    scored = 0
    for i, j in matched_pairs:
        gt = gts[j]
        valid = ~_is_sentinel(gt)
        if not valid.any():
            continue
        s = object_scale(gt)
        d2 = ((preds[i] - gt) ** 2).sum(axis=-1)        # (17,)
        ks = np.exp(-d2 / (2.0 * (s ** 2) * (2.0 * sigmas) ** 2))
        total += float(ks[valid].mean())
        scored += 1
    return total / scored if scored else 0.0


def normalize_keypoints(keypoints: np.ndarray) -> np.ndarray:
    """Zero-mean / unit-std per pose (ddof=1), so that the precision/recall
    distance threshold is scale-invariant."""
    kp = np.asarray(keypoints, dtype=np.float64)
    std = kp.std(axis=0, ddof=1, keepdims=True)
    return (kp - kp.mean(axis=0, keepdims=True)) / np.maximum(std, 1e-8)


def _match_statistics(preds: np.ndarray, gts: np.ndarray):
    """One Hungarian pass -> threshold-independent match statistics.

    Returns (dists, fp0, fn0): `dists` holds the normalized distances of
    keypoints annotated in GT AND predicted within a matched pair (each
    contributes tp if dist <= threshold else fp+fn); `fp0`/`fn0` count
    predictions without a GT annotation, GT annotations without a
    prediction, and every keypoint of UNMATCHED surplus predicted/GT
    poses."""
    matched = match_poses(preds, gts)
    mp = {i for i, _ in matched}
    mg = {j for _, j in matched}
    dists = []
    fp0 = fn0 = 0
    for pi, gi in matched:
        pred = normalize_keypoints(preds[pi])
        gt = normalize_keypoints(gts[gi])
        raw_pred = np.asarray(preds[pi], dtype=np.float64)
        raw_gt = np.asarray(gts[gi], dtype=np.float64)
        for k in range(pred.shape[0]):
            gt_missing = _is_sentinel(raw_gt[k])
            pred_missing = _is_sentinel(raw_pred[k])
            if gt_missing:
                if not pred_missing:
                    fp0 += 1      # predicted where GT has no annotation
            elif pred_missing:
                fn0 += 1
            else:
                dists.append(float(np.linalg.norm(pred[k] - gt[k])))
    for i in range(len(preds)):   # hallucinated whole poses
        if i not in mp:
            fp0 += int((~_is_sentinel(np.asarray(preds[i], np.float64))).sum())
    for j in range(len(gts)):     # entirely-missed GT poses
        if j not in mg:
            fn0 += int((~_is_sentinel(np.asarray(gts[j], np.float64))).sum())
    return np.asarray(dists), fp0, fn0


def precision_recall(preds: np.ndarray, gts: np.ndarray,
                     threshold: float = 2.0) -> Tuple[float, float]:
    """Keypoint-level precision and recall at a normalized distance
    threshold over Hungarian-matched poses."""
    dists, fp0, fn0 = _match_statistics(preds, gts)
    return _precision_recall_at(dists, fp0, fn0, threshold)


def _precision_recall_at(dists, fp0, fn0, threshold):
    tp = int((dists <= threshold).sum())
    miss = len(dists) - tp
    fp = fp0 + miss
    fn = fn0 + miss
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    return precision, recall


def calculate_precision(preds, gts, threshold: float = 2.0) -> float:
    return precision_recall(preds, gts, threshold)[0]


def calculate_recall(preds, gts, threshold: float = 2.0) -> float:
    return precision_recall(preds, gts, threshold)[1]


def calculate_mAP(precisions: np.ndarray, recalls: np.ndarray) -> float:
    """Average precision by the precision-envelope method over a
    (precision, recall) sweep, each recall increment weighted by the
    envelope at its right endpoint."""
    precisions = np.asarray(precisions, dtype=np.float64)
    recalls = np.asarray(recalls, dtype=np.float64)
    order = np.argsort(recalls)
    p = np.concatenate(([0.0], precisions[order], [0.0]))
    r = np.concatenate(([0.0], recalls[order], [1.0]))
    # Precision envelope: p[i] = max(p[i:], right to left).
    p = np.maximum.accumulate(p[::-1])[::-1]
    return float(np.sum(np.diff(r) * p[1:]))


def threshold_sweep(preds, gts, thresholds=None) -> Tuple[np.ndarray, np.ndarray, float]:
    """Precision/recall over a threshold sweep (50 thresholds in
    [0.0, 10.0] by default) + mAP. The Hungarian matching and keypoint
    normalization are threshold-independent, so they run ONCE and all
    thresholds sweep over the cached distances."""
    if thresholds is None:
        thresholds = np.linspace(0.0, 10.0, 50)
    dists, fp0, fn0 = _match_statistics(preds, gts)
    ps, rs = [], []
    for t in thresholds:
        p, r = _precision_recall_at(dists, fp0, fn0, t)
        ps.append(p)
        rs.append(r)
    ps, rs = np.asarray(ps), np.asarray(rs)
    return ps, rs, calculate_mAP(ps, rs)
