"""Keypoint topology, decoder and training constants (numpy only).

A copy of `posenet_tpu.constants`, not an import: the JAX package's facade
imports jax eagerly, and this package must run without it. The part order,
edge order and NMS radius are the decoder's contract, so the tests hold
this copy equal to the JAX one.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "PART_NAMES", "NUM_KEYPOINTS", "PART_IDS", "CONNECTED_PART_NAMES",
    "CONNECTED_PART_INDICES", "LOCAL_MAXIMUM_RADIUS", "POSE_CHAIN",
    "PARENT_CHILD_TUPLES", "NUM_EDGES", "EDGES", "PART_CHANNELS", "LEFT_RIGHT_SWAP",
    "OKS_SIGMAS",
]

PART_NAMES = [
    "nose", "leftEye", "rightEye", "leftEar", "rightEar", "leftShoulder",
    "rightShoulder", "leftElbow", "rightElbow", "leftWrist", "rightWrist",
    "leftHip", "rightHip", "leftKnee", "rightKnee", "leftAnkle", "rightAnkle",
]

NUM_KEYPOINTS = len(PART_NAMES)  # 17

PART_IDS = {pn: pid for pid, pn in enumerate(PART_NAMES)}

# Keypoint index permutation under a horizontal image flip: every left*
# part swaps with its right* counterpart, symmetric parts map to
# themselves (the training flip augmentation).
LEFT_RIGHT_SWAP = np.asarray([
    PART_IDS["right" + n[4:]] if n.startswith("left")
    else PART_IDS["left" + n[5:]] if n.startswith("right")
    else i
    for i, n in enumerate(PART_NAMES)
], dtype=np.int32)

# Pairs of keypoints drawn as skeleton line segments, in the order the
# overlays draw them.
CONNECTED_PART_NAMES = [
    ("leftHip", "leftShoulder"), ("leftElbow", "leftShoulder"),
    ("leftElbow", "leftWrist"), ("leftHip", "leftKnee"),
    ("leftKnee", "leftAnkle"), ("rightHip", "rightShoulder"),
    ("rightElbow", "rightShoulder"), ("rightElbow", "rightWrist"),
    ("rightHip", "rightKnee"), ("rightKnee", "rightAnkle"),
    ("leftShoulder", "rightShoulder"), ("leftHip", "rightHip"),
]

CONNECTED_PART_INDICES = [
    (PART_IDS[a], PART_IDS[b]) for a, b in CONNECTED_PART_NAMES
]

# Radius (in output-grid cells) of the local-maximum window used for part
# NMS. Window size is 2*r+1.
LOCAL_MAXIMUM_RADIUS = 1

# Kinematic tree (parent -> child) the greedy decoder walks, rooted at the
# nose. Edge order matters: the decoder walks the edges backward with the
# backward displacements, then forward with the forward displacements.
POSE_CHAIN = [
    ("nose", "leftEye"), ("leftEye", "leftEar"), ("nose", "rightEye"),
    ("rightEye", "rightEar"), ("nose", "leftShoulder"),
    ("leftShoulder", "leftElbow"), ("leftElbow", "leftWrist"),
    ("leftShoulder", "leftHip"), ("leftHip", "leftKnee"),
    ("leftKnee", "leftAnkle"), ("nose", "rightShoulder"),
    ("rightShoulder", "rightElbow"), ("rightElbow", "rightWrist"),
    ("rightShoulder", "rightHip"), ("rightHip", "rightKnee"),
    ("rightKnee", "rightAnkle"),
]

PARENT_CHILD_TUPLES = [
    (PART_IDS[parent], PART_IDS[child]) for parent, child in POSE_CHAIN
]

NUM_EDGES = len(PARENT_CHILD_TUPLES)  # 16

# Column 0 = parent id, column 1 = child id.
EDGES = np.asarray(PARENT_CHILD_TUPLES, dtype=np.int32)  # (16, 2)

# Body-part segmentation channel names of the reference; kept for API
# parity, unused by the decoder.
PART_CHANNELS = [
    'left_face',
    'right_face',
    'right_upper_leg_front',
    'right_lower_leg_back',
    'right_upper_leg_back',
    'left_lower_leg_front',
    'left_upper_leg_front',
    'left_upper_leg_back',
    'left_lower_leg_back',
    'right_feet',
    'right_lower_leg_front',
    'left_feet',
    'torso_front',
    'torso_back',
    'right_upper_arm_front',
    'right_upper_arm_back',
    'right_lower_arm_back',
    'left_lower_arm_front',
    'left_upper_arm_front',
    'left_upper_arm_back',
    'left_lower_arm_back',
    'right_hand',
    'right_lower_arm_front',
    'left_hand',
]

# COCO OKS per-keypoint falloff sigmas (the training metrics).
OKS_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89], dtype=np.float32) / 10.0
