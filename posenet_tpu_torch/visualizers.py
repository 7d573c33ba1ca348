"""Visualization helpers, the counterpart of `posenet_tpu.visualizers`:
heatmap dumps, keypoint overlays written to a file, displacement vector
plots. numpy and cv2 on the host (matplotlib where it is installed); cv2 is
imported inside each function.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from posenet_tpu_torch.constants import PARENT_CHILD_TUPLES
from posenet_tpu_torch.draw import draw_skel_and_kp


def print_heatmap(heatmap: np.ndarray, output_dir: str = "./heatmap_dumps",
                  prefix: str = "heatmap", use_matplotlib: bool = True):
    """Dump each keypoint channel of a (17, H, W) or (B, 17, H, W) heatmap
    (numpy, or a tensor on any device) as an image,
    `<output_dir>/image_<b>/joint_<k>_<prefix>.png`."""
    import cv2

    plt = None
    if use_matplotlib:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            plt = None  # fall through to the cv2 colormap path

    hm = _numpy(heatmap)
    if hm.ndim == 3:
        hm = hm[None]
    os.makedirs(output_dir, exist_ok=True)
    for b in range(hm.shape[0]):
        d = os.path.join(output_dir, f"image_{b}")
        os.makedirs(d, exist_ok=True)
        for k in range(hm.shape[1]):
            channel = hm[b, k]
            path = os.path.join(d, f"joint_{k}_{prefix}.png")
            if plt is not None:
                fig = plt.figure()
                plt.imshow(channel, cmap="hot", interpolation="nearest")
                plt.colorbar()
                plt.savefig(path)
                plt.close(fig)
                continue
            lo, hi = float(channel.min()), float(channel.max())
            norm = (channel - lo) / (hi - lo) if hi > lo else channel * 0
            cv2.imwrite(path, cv2.applyColorMap(
                (norm * 255).astype(np.uint8), cv2.COLORMAP_HOT))


def _numpy(a) -> np.ndarray:
    """A numpy array, or a tensor copied to the host as one."""
    return a.detach().cpu().numpy() if hasattr(a, 'detach') else np.asarray(a)


def draw_coordinates_to_image_file(
        image_path: str, output_path: str,
        pose_scores: np.ndarray, keypoint_scores: np.ndarray,
        keypoint_coords: np.ndarray, output_scale,
        min_pose_score: float = 0.25, min_part_score: float = 0.25,
        image: Optional[np.ndarray] = None):
    """Read an image, scale decoded coords by `output_scale`, draw the
    skeleton overlay on the full-resolution source and write it out. Pass
    `image` (BGR array) to skip the disk read. Returns the overlay."""
    import cv2

    img = image if image is not None else cv2.imread(image_path)
    if img is None:
        raise IOError(f"could not read {image_path}")

    coords = _numpy(keypoint_coords).astype(np.float64) * np.asarray(output_scale)
    overlay = draw_skel_and_kp(
        img, _numpy(pose_scores), _numpy(keypoint_scores), coords,
        min_pose_score=min_pose_score, min_part_score=min_part_score)
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    cv2.imwrite(output_path, overlay)
    return overlay


def draw_displacement_vectors(
        image: np.ndarray, keypoint_coords: np.ndarray,
        displacement_vectors: np.ndarray,
        edges: Sequence = PARENT_CHILD_TUPLES,
        color=(0, 255, 0), thickness: int = 2):
    """Draw per-edge displacement arrows along the kinematic tree:
    `keypoint_coords` (17, 2) y-x px, `displacement_vectors` (16, 2) y-x px."""
    import cv2

    out = image.copy()
    for edge_id, (parent, _child) in enumerate(edges):
        y, x = keypoint_coords[parent]
        dy, dx = displacement_vectors[edge_id]
        cv2.arrowedLine(out, (int(x), int(y)), (int(x + dx), int(y + dy)),
                        color, thickness, tipLength=0.3)
    return out
