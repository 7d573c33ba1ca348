"""Offline sweep: randomized multi-pose decode parity, the JAX package
against the port, on the CPU.

The cases are `tools/fuzz_decode_parity.py`'s (the same generator and
seeds): multi-person heads with continuous amplitudes, so that exact
score ties, where the two argsorts may order candidates apart
(PARITY.md), have measure zero, and a candidate budget sized from the
true masked local-max count, so that no top-K truncation can trigger.
Each case runs the JAX package's `decode_multiple_poses` and the port's
(`device='cpu'`, the tree walk's plain version) on the same heads.
Keypoint coordinates, keypoint scores and pose offsets must match bit for
bit, pose scores within 2 ulp (a 17-term mean summed in another order).
The first mismatch exits non-zero with a repro dump.

Usage:
    python tools/fuzz_decode_parity_torch.py --start 0 --count 100
"""

import argparse
import os
import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from posenet_tpu.constants import LOCAL_MAXIMUM_RADIUS  # noqa: E402
from posenet_tpu.decode_multi import decode_multiple_poses as jax_decode  # noqa: E402
from posenet_tpu.ops.nms import local_max_mask  # noqa: E402

from posenet_tpu_torch.decode_multi import decode_multiple_poses  # noqa: E402


def make_case(seed: int):
    """`fuzz_decode_parity.run_case`'s inputs for `seed`: HWC heads, the
    stride, the decoder's keywords and the candidate budget."""
    rng = np.random.RandomState(seed)
    stride = int(rng.choice([8, 16, 32]))
    r_h = int(rng.choice([5, 9, 17, 33, 65, 91]))
    r_w = int(rng.choice([5, 9, 17, 33, 65, 161]))
    n_people = rng.randint(0, 11)
    hm = rng.uniform(0, 0.45, (r_h, r_w, 17))
    yy, xx = np.mgrid[0:r_h, 0:r_w]
    for _ in range(n_people):
        ky = rng.randint(1, max(2, r_h - 1), 17)
        kx = rng.randint(1, max(2, r_w - 1), 17)
        g = np.exp(-((yy[None] - ky[:, None, None]) ** 2
                     + (xx[None] - kx[:, None, None]) ** 2) / 3.0)
        amp = rng.uniform(0.75, 1.0, 17)[None, None, :]
        hm = np.maximum(hm, amp * np.transpose(g, (1, 2, 0)))
    hm = hm.astype(np.float32)
    off = rng.uniform(-stride, stride, (r_h, r_w, 34)).astype(np.float32)
    dfw = rng.uniform(-2 * stride, 2 * stride, (r_h, r_w, 32)).astype(np.float32)
    dbw = rng.uniform(-2 * stride, 2 * stride, (r_h, r_w, 32)).astype(np.float32)
    kw = dict(
        max_pose_detections=int(rng.choice([1, 3, 5, 10, 15, 25])),
        score_threshold=float(rng.choice([0.1, 0.25, 0.4, 0.5, 0.7])),
        nms_radius=int(rng.choice([0, 1, 5, 20, 45, 90, 200])),
        min_pose_score=float(rng.choice([0.0, 0.15, 0.25, 0.5])),
    )
    n_local_max = int(np.asarray(local_max_mask(
        jnp.asarray(hm), kw["score_threshold"], LOCAL_MAXIMUM_RADIUS)).sum())
    budget = max(128, -(-n_local_max // 64) * 64)
    ctx = (f"seed={seed} stride={stride} grid=({r_h},{r_w}) people={n_people} {kw} "
           f"budget={budget} local_max={n_local_max}")
    return (hm, off, dfw, dbw), stride, kw, budget, ctx


def run_case(seed: int) -> str:
    """Returns '' on parity, else a description of the mismatch."""
    heads, stride, kw, budget, ctx = make_case(seed)
    chw = [np.ascontiguousarray(np.transpose(a, (2, 0, 1))) for a in heads]
    ref = jax_decode(*chw, stride, max_candidates=budget, **kw)
    ours = decode_multiple_poses(*chw, stride, max_candidates=budget, device='cpu', **kw)
    n_ref = int((ref[0] > 0).sum())
    n_ours = int((ours[0] > 0).sum())
    if n_ours != n_ref:
        return f"pose count {n_ours} != {n_ref} [{ctx}]"
    for name, a, b in (("keypoint scores", ours[1], ref[1]),
                       ("keypoint coords", ours[2], ref[2]),
                       ("pose offsets", ours[3], ref[3])):
        if not np.array_equal(a, np.asarray(b)):
            return (f"{name} differ (max {np.abs(a - np.asarray(b)).max():.3g}) "
                    f"[{ctx}]")
    try:
        np.testing.assert_array_max_ulp(ours[0], np.asarray(ref[0]), maxulp=2)
    except AssertionError as e:
        return f"pose scores beyond 2 ulp ({e}) [{ctx}]"
    return ""


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--count", type=int, default=50)
    p.add_argument("--seed_base", type=int, default=910_000)
    args = p.parse_args()

    for n, i in enumerate(range(args.start, args.start + args.count)):
        # Nearly every case compiles fresh program shapes for the JAX side;
        # drop its compiled-program cache now and then (the JAX tool's note).
        if n and n % 10 == 0:
            jax.clear_caches()
        seed = args.seed_base + i * 17
        msg = run_case(seed)
        if msg:
            heads, stride, kw, budget, _ = make_case(seed)
            path = f"fuzz_decode_torch_fail_{seed}.npz"
            np.savez(path, *heads, stride=stride, budget=budget, **kw)
            print(f"FAIL case {i}: {msg}\nrepro dump: {path} (heads HWC, keywords)")
            sys.exit(1)
        if i % 10 == 0:
            print(f"ok through case {i}", flush=True)
    print(f"done: {args.count} cases, 0 failures")


if __name__ == "__main__":
    main()
