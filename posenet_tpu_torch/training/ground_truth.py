"""Ground-truth generation: annotations -> heatmaps / keypoints / offsets.

A numpy copy of `posenet_tpu.training.ground_truth` (that module imports
the JAX package's facade, and so jax): parse Dataloop JSON or Roboflow
YOLO-style txt annotations, scale keypoints to the output grid, synthesize
per-keypoint Gaussian heatmaps (11x11 kernel, sigma=1.1, max-normalized),
derive argmax keypoints + offset vectors, and persist/load the
`*_keypoints.txt` / `*_generated.txt` text formats, so that a directory
prepared by either package trains either.

Coordinate convention: annotation files store (x, y) pairs; `to_yx()`
converts to the (y, x) order the training loss and decoder use.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

from posenet_tpu_torch.constants import NUM_KEYPOINTS, PART_NAMES

HEATMAP_SHAPE = (33, 33)
MAX_NUM_POSES = 15          # GT is padded to 15 poses an image
GAUSSIAN_KERNEL_SIZE = 11
GAUSSIAN_SIGMA = GAUSSIAN_KERNEL_SIZE / 10.0


def gaussian_heatmaps(keypoints_xy: np.ndarray,
                      heatmap_shape: Tuple[int, int] = HEATMAP_SHAPE,
                      kernel_size: int = GAUSSIAN_KERNEL_SIZE) -> np.ndarray:
    """(P, 17, 2) (x, y) grid keypoints -> (P, 17, H, W) Gaussian heatmaps.

    A sampled Gaussian (sigma = k/10) centered at the truncated integer
    cell, windowed to the k x k neighborhood, max-normalized; (0, 0)
    keypoints produce a zero map. One broadcasted grid expression.
    """
    h, w = heatmap_shape
    half = kernel_size // 2
    sigma = kernel_size / 10.0
    kx = np.trunc(keypoints_xy[..., 0])[..., None, None]   # (P,17,1,1)
    ky = np.trunc(keypoints_xy[..., 1])[..., None, None]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    dy = yy - ky
    dx = xx - kx
    g = np.exp(-(dy ** 2 + dx ** 2) / (2.0 * sigma ** 2))
    window = (np.abs(dy) <= half) & (np.abs(dx) <= half)
    g = g * window

    peak = g.max(axis=(-2, -1), keepdims=True)
    g = np.where(peak > 0, g / np.maximum(peak, 1e-12), 0.0)

    absent = (keypoints_xy[..., 0] == 0) & (keypoints_xy[..., 1] == 0)
    g = g * (~absent)[..., None, None]
    return g.astype(np.float32)


def keypoints_from_heatmaps(heatmaps: np.ndarray) -> np.ndarray:
    """(P, 17, H, W) -> (P, 17, 2) integer (x, y) argmax keypoints."""
    p, k, h, w = heatmaps.shape
    flat_idx = heatmaps.reshape(p, k, -1).argmax(axis=-1)
    ys, xs = flat_idx // w, flat_idx % w
    return np.stack([xs, ys], axis=-1).astype(np.float64)


def offset_vectors(keypoints_xy: np.ndarray,
                   generated_xy: np.ndarray) -> np.ndarray:
    """Sub-cell refinement vectors: annotated minus argmax position."""
    return keypoints_xy - generated_xy


def to_yx(keypoints_xy: np.ndarray) -> np.ndarray:
    """(…, 2) (x, y) -> (y, x), preserving sentinel values."""
    return keypoints_xy[..., ::-1].copy()


# ---------------------------------------------------------------------------
# Annotation parsers (host-side)
# ---------------------------------------------------------------------------

def _label_to_index() -> Dict[str, int]:
    """Dataloop labels are camelCase part names rendered as spaced
    lowercase ('left shoulder')."""
    def spaced(s: str) -> str:
        return re.sub(r'([A-Z])', r' \1', s)
    return {spaced(name).lower(): i for i, name in enumerate(PART_NAMES)}


def parse_dataloop_json(path: str,
                        heatmap_shape: Tuple[int, int] = HEATMAP_SHAPE
                        ) -> np.ndarray:
    """Dataloop export -> (num_poses, 17, 2) (x, y) keypoints scaled to the
    heatmap grid; unannotated keypoints are (-1, -1); poses with no
    annotated keypoints are dropped."""
    with open(path) as f:
        data = json.load(f)
    annotations = data["annotations"]
    image_height = data["metadata"]["system"]["height"]
    image_width = data["metadata"]["system"]["width"]
    x_scale = heatmap_shape[1] / image_width
    y_scale = heatmap_shape[0] / image_height

    label_idx = _label_to_index()
    poses: List[Dict] = []
    points: List[Tuple] = []
    for ann in annotations:
        if ann["type"] == "pose":
            poses.append({"id": ann["id"],
                          "keypoints": [(-1.0, -1.0)] * NUM_KEYPOINTS})
        elif ann["type"] == "point":
            parent = ann["metadata"]["system"]["parentId"]
            kp_id = label_idx[ann["label"].lower()]
            points.append((parent, kp_id,
                           ann["coordinates"]["x"] * x_scale,
                           ann["coordinates"]["y"] * y_scale))
    by_id = {p["id"]: p for p in poses}
    for parent, kp_id, x, y in points:
        if parent in by_id:
            by_id[parent]["keypoints"][kp_id] = (x, y)

    valid = [p for p in poses
             if not all(kp == (-1.0, -1.0) for kp in p["keypoints"])]
    if not valid:
        return np.empty((0, NUM_KEYPOINTS, 2), dtype=np.float64)
    return np.asarray([p["keypoints"] for p in valid], dtype=np.float64)


def parse_roboflow_txt(path: str,
                       heatmap_shape: Tuple[int, int] = HEATMAP_SHAPE
                       ) -> np.ndarray:
    """Roboflow YOLO-style export -> (1, 17, 2) (x, y) grid keypoints.

    Each line: `<class_id> <x_norm> <y_norm> [w h]`. Roboflow class ids
    enumerate the alphabetically sorted label names '0-nose', '1-leftEye',
    '10-rightWrist', ...: the numeric prefix IS the posenet keypoint index;
    class 17 is the person box and is dropped. Single-person format.
    """
    sorted_names = sorted(
        [f"{i}-{n}" for i, n in enumerate(PART_NAMES)] + ["17-person"])
    class_to_kp = [int(name.split("-")[0]) for name in sorted_names]

    keypoints = np.zeros((NUM_KEYPOINTS, 2), dtype=np.float64)
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            kp_id = class_to_kp[int(parts[0])]
            if kp_id >= NUM_KEYPOINTS:   # person bounding box
                continue
            keypoints[kp_id] = (float(parts[1]) * heatmap_shape[1],
                                float(parts[2]) * heatmap_shape[0])
    return keypoints[None]


# ---------------------------------------------------------------------------
# Offline preparation + loading
# ---------------------------------------------------------------------------

def prepare_ground_truth_data(images_dir: str, keypoints_dir: str,
                              num_keypoints: int = NUM_KEYPOINTS,
                              heatmaps_dir: str = "heatmaps",
                              heatmap_shape: Tuple[int, int] = HEATMAP_SHAPE,
                              keypoints_updated_dir: str = "keypoints_updated",
                              annotation_format: str = "dataloop",
                              save_heatmap_arrays: bool = False,
                              save_heatmap_images: bool = False) -> List[str]:
    """For every image with a matching annotation file, write
    `<stem>/<stem>_keypoints.txt` and `<stem>/<stem>_generated.txt` under
    `keypoints_updated_dir` (flattened (num_poses*17, 2) CSV). Returns the
    processed stems.

    `annotation_format`: 'dataloop' (JSON, multi-person) or 'roboflow'
    (txt, single-person). Heatmap dumps are optional and off by default:
    `save_heatmap_arrays` writes the stacked npy, `save_heatmap_images` the
    per-pose/per-keypoint pngs under
    `heatmaps_dir/<stem>/pose_<p>/png/heatmap_<k>.png`.
    """
    os.makedirs(keypoints_updated_dir, exist_ok=True)
    if save_heatmap_arrays or save_heatmap_images:
        os.makedirs(heatmaps_dir, exist_ok=True)

    ext = ".json" if annotation_format == "dataloop" else ".txt"
    parse = (parse_dataloop_json if annotation_format == "dataloop"
             else parse_roboflow_txt)

    processed = []
    for image_file in sorted(os.listdir(images_dir)):
        stem = os.path.splitext(image_file)[0]
        ann_path = os.path.join(keypoints_dir, stem + ext)
        if not os.path.exists(ann_path):
            print("Keypoint file does not exist for image:", image_file)
            continue

        keypoints = parse(ann_path, heatmap_shape)
        if keypoints.shape[0] == 0:
            continue
        heatmaps = gaussian_heatmaps(keypoints, heatmap_shape)
        generated = keypoints_from_heatmaps(heatmaps)

        image_dir = os.path.join(keypoints_updated_dir, stem)
        os.makedirs(image_dir, exist_ok=True)
        np.savetxt(os.path.join(image_dir, stem + "_keypoints.txt"),
                   keypoints.reshape(-1, 2), delimiter=",")
        np.savetxt(os.path.join(image_dir, stem + "_generated.txt"),
                   generated.reshape(-1, 2), delimiter=",")

        if save_heatmap_arrays:
            out = os.path.join(heatmaps_dir, stem)
            os.makedirs(out, exist_ok=True)
            np.save(os.path.join(out, "heatmaps.npy"), heatmaps)
            np.save(os.path.join(out, "offset_vectors.npy"),
                    offset_vectors(keypoints, generated))
        if save_heatmap_images:
            save_heatmap_pngs(heatmaps, os.path.join(heatmaps_dir, stem))
        processed.append(stem)
    return processed


def save_heatmap_pngs(heatmaps: np.ndarray, out_dir: str) -> None:
    """Per-pose/per-keypoint png dumps (max-normalized, colormapped)."""
    import cv2

    hm = np.asarray(heatmaps)
    for p in range(hm.shape[0]):
        png_dir = os.path.join(out_dir, f"pose_{p}", "png")
        os.makedirs(png_dir, exist_ok=True)
        for k in range(hm.shape[1]):
            ch = hm[p, k]
            hi = float(ch.max())
            norm = ch / hi if hi > 0 else ch
            cv2.imwrite(os.path.join(png_dir, f"heatmap_{k}.png"),
                        cv2.applyColorMap((norm * 255).astype(np.uint8),
                                          cv2.COLORMAP_HOT))


def load_ground_truth_data(image_file_names: Sequence[str],
                           keypoints_updated_dir: str,
                           max_num_poses: int = MAX_NUM_POSES,
                           with_heatmaps: bool = True):
    """Load prepared GT for a list of image stems, padded to
    `max_num_poses` with -1.

    Returns (keypoints (N,15,17,2) (x,y), heatmaps (N,15,17,33,33) or None,
    offset_vectors (N,15,17,2)) as numpy arrays.
    """
    n = len(image_file_names)
    kps = np.full((n, max_num_poses, NUM_KEYPOINTS, 2), -1.0, np.float32)
    offs = np.full((n, max_num_poses, NUM_KEYPOINTS, 2), -1.0, np.float32)
    hms = (np.full((n, max_num_poses, NUM_KEYPOINTS, *HEATMAP_SHAPE), -1.0,
                   np.float32) if with_heatmaps else None)

    for i, stem in enumerate(image_file_names):
        d = os.path.join(keypoints_updated_dir, stem)
        keypoints = np.loadtxt(os.path.join(d, stem + "_keypoints.txt"),
                               delimiter=",").reshape(-1, NUM_KEYPOINTS, 2)
        generated = np.loadtxt(os.path.join(d, stem + "_generated.txt"),
                               delimiter=",").reshape(-1, NUM_KEYPOINTS, 2)
        p = min(keypoints.shape[0], max_num_poses)
        kps[i, :p] = keypoints[:p]
        offs[i, :p] = offset_vectors(keypoints, generated)[:p]
        if with_heatmaps:
            hms[i, :p] = gaussian_heatmaps(keypoints[:p])
    return kps, hms, offs
