"""Host-side overlay drawing (keypoints + skeleton), the counterpart of
`posenet_tpu.draw`.

cv2 keypoints sized 10*score and yellow polylines over
CONNECTED_PART_INDICES, with pose- and part-score thresholds, drawn on the
host from the decoded (P, 17, 2) numpy coordinates. cv2 is imported inside
each function, so the module imports where cv2 is absent.
"""

from __future__ import annotations

import numpy as np

from posenet_tpu_torch.constants import CONNECTED_PART_INDICES

_YELLOW = (255, 255, 0)


def get_adjacent_keypoints(keypoint_scores, keypoint_coords,
                           min_confidence: float = 0.1):
    """Line segment endpoints (x,y int32) for every skeleton edge whose both
    keypoints clear `min_confidence`."""
    results = []
    for left, right in CONNECTED_PART_INDICES:
        if (keypoint_scores[left] < min_confidence or
                keypoint_scores[right] < min_confidence):
            continue
        # coords are (y, x); cv2 wants (x, y)
        results.append(np.array([keypoint_coords[left][::-1],
                                 keypoint_coords[right][::-1]]).astype(np.int32))
    return results


def draw_keypoints(img, instance_scores, keypoint_scores, keypoint_coords,
                   min_pose_confidence: float = 0.5,
                   min_part_confidence: float = 0.5):
    """Draw plain keypoint markers."""
    import cv2

    cv_keypoints = []
    for ii, score in enumerate(instance_scores):
        if score < min_pose_confidence:
            continue
        for ks, kc in zip(keypoint_scores[ii, :], keypoint_coords[ii, :, :]):
            if ks < min_part_confidence:
                continue
            cv_keypoints.append(cv2.KeyPoint(float(kc[1]), float(kc[0]), 10. * float(ks)))
    return cv2.drawKeypoints(img, cv_keypoints, outImage=np.array([]))


def draw_skeleton(img, instance_scores, keypoint_scores, keypoint_coords,
                  min_pose_confidence: float = 0.5,
                  min_part_confidence: float = 0.5):
    """Draw skeleton polylines only."""
    import cv2

    adjacent = []
    for ii, score in enumerate(instance_scores):
        if score < min_pose_confidence:
            continue
        adjacent.extend(get_adjacent_keypoints(
            keypoint_scores[ii, :], keypoint_coords[ii, :, :],
            min_part_confidence))
    return cv2.polylines(img, adjacent, isClosed=False, color=_YELLOW)


def draw_skel_and_kp(img, instance_scores, keypoint_scores, keypoint_coords,
                     min_pose_score: float = 0.5, min_part_score: float = 0.5):
    """Keypoints + skeleton in one pass."""
    import cv2

    out_img = img
    adjacent = []
    cv_keypoints = []
    for ii, score in enumerate(instance_scores):
        if score < min_pose_score:
            continue
        adjacent.extend(get_adjacent_keypoints(
            keypoint_scores[ii, :], keypoint_coords[ii, :, :], min_part_score))
        for ks, kc in zip(keypoint_scores[ii, :], keypoint_coords[ii, :, :]):
            if ks < min_part_score:
                continue
            cv_keypoints.append(
                cv2.KeyPoint(float(kc[1]), float(kc[0]), 10. * float(ks)))
    if cv_keypoints:
        out_img = cv2.drawKeypoints(
            out_img, cv_keypoints, outImage=np.array([]), color=_YELLOW,
            flags=cv2.DRAW_MATCHES_FLAGS_DRAW_RICH_KEYPOINTS)
    return cv2.polylines(out_img, adjacent, isClosed=False, color=_YELLOW)
