"""Offline sweep: the port's `training.ground_truth.gaussian_heatmaps`
against the reference's per-keypoint cv2 kernel pasting and against the
JAX package's `gaussian_heatmaps`, across random grids, kernel sizes,
fractional and border keypoints.

The cases and the reference replica are `tools/fuzz_ground_truth_parity.py`'s
(the same draws and seeds; the replica of the reference's
`points_to_heatmap` is imported from it). Per case the port's heatmaps
must equal, bit for bit, the JAX package's and the replica's rounded to
float32 (the replica computes in float64, both packages return float32;
the JAX tool holds JAX's within 1e-6 of the float64 values).

Usage:
    python tools/fuzz_ground_truth_parity_torch.py --count 200
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from posenet_tpu.training import ground_truth as jax_gt  # noqa: E402
from tools.fuzz_ground_truth_parity import reference_points_to_heatmap  # noqa: E402

from posenet_tpu_torch.training import ground_truth as gt  # noqa: E402


def run_case(seed: int) -> str:
    """Returns '' on parity, else a description of the mismatch."""
    rng = np.random.RandomState(seed)
    h = int(rng.choice([17, 33, 45, 65]))
    w = int(rng.choice([17, 33, 45, 65]))
    kernel = int(rng.choice([5, 7, 11, 15]))
    n_poses = rng.randint(1, 6)
    # fractional coords anywhere in the grid, borders included; ~10%
    # forced absent (0, 0)
    kp = rng.uniform(0, [w - 1e-6, h - 1e-6], (n_poses, 17, 2))
    absent = rng.uniform(size=(n_poses, 17)) < 0.1
    kp[absent] = 0.0
    ctx = f"seed={seed} grid=({h},{w}) kernel={kernel}"

    ours = gt.gaussian_heatmaps(kp, heatmap_shape=(h, w), kernel_size=kernel)
    theirs = jax_gt.gaussian_heatmaps(kp, heatmap_shape=(h, w), kernel_size=kernel)
    if ours.dtype != theirs.dtype or not np.array_equal(ours, theirs):
        return (f"differs from the JAX package's (max "
                f"{np.abs(ours.astype(np.float64) - theirs).max():.3g}) [{ctx}]")
    for p in range(n_poses):
        for k in range(17):
            ref = reference_points_to_heatmap(kp[p, k, 0], kp[p, k, 1], kernel, (h, w))
            if not np.array_equal(ours[p, k], ref.astype(np.float32)):
                err = float(np.abs(ours[p, k] - ref).max())
                return f"pose {p} kp {k} at {kp[p, k]} max err {err:.3g} [{ctx}]"
    return ""


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--count", type=int, default=200)
    p.add_argument("--seed_base", type=int, default=31_000)
    args = p.parse_args()

    for i in range(args.start, args.start + args.count):
        msg = run_case(args.seed_base + i * 7)
        if msg:
            print(f"FAIL case {i}: {msg}")
            sys.exit(1)
        if i % 25 == 0:
            print(f"ok through case {i}", flush=True)
    print(f"done: {args.count} cases, 0 failures")


if __name__ == "__main__":
    main()
