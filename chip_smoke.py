#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits nonzero and prints
no result:
1. device: needs CUDA; prints the card's `name, power.limit` (nvidia-smi)
   and the torch / CUDA versions. TF32 is turned off (f32 parity mode).
2. build: compiles the traversal kernel K1 (csrc/traversal.cu) with nvcc.
3. K1 against its plain PyTorch version on the card, bit for bit, at the
   main path's 33x33 stride-16 grid (B=8, K=128) and at 91x161 stride 8.
4. float32 parity on the card, fixture m50 s16 weights, synthesized photos:
   CUDA heads against CPU heads within 1e-4 of each head's scale; CUDA
   decode_batch (through K1) against CPU decode_batch (plain version) on
   the same heads: coordinates and keypoint scores bitwise, pose scores
   within 2 ulp; and the whole slice on the card against it on the CPU.
5. the main path: PoseNetPipeline over load_model(101, 16, bf16, random
   init) on 8 uint8 513x513 frames, then decode_batch on peaked heads.
   Shapes, finite values, >=1 pose per peaked image, and K1's launch count
   over exactly this run.
6. timing (CUDA events / synchronize-bracketed host clock): fused m101 s16
   513x513 b128 bf16 forward + peaked decode in img/s, best of 3 windows;
   forward and decode alone; K1 against its plain version at B=128, K=128.
Then one JSON line describing the kernels, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from posenet_tpu_torch import PoseNetPipeline, load_model
from posenet_tpu_torch.config import DecodeConfig, ModelConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.decode import DecodedPoses, _prepare_decode, decode_batch
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.ops import _build, traversal
from posenet_tpu_torch.pipeline import infer, normalize

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'fixture_m50_s16.npz')
K1_SOURCE = 'posenet_tpu_torch/csrc/traversal.cu'
K1_REPLACES = 'posenet_tpu/ops/pallas/traversal.py:551'


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f'chip_smoke: FAILED: {what}')


def synth_heads(rng, b, h, w):
    """NHWC heads like tests/test_decode.py's synth_heads: uniform background
    scores, 1-3 people of 17 gaussian peaks each, smooth random offsets and
    displacements."""
    yy, xx = np.mgrid[0:h, 0:w]
    hm = rng.uniform(0, 0.3, (b, h, w, 17)).astype(np.float32)
    for i in range(b):
        for _ in range(rng.randint(1, 4)):
            cy, cx = rng.randint(3, h - 3), rng.randint(3, w - 3)
            for k in range(17):
                ky = np.clip(cy + rng.randint(-4, 5), 0, h - 1)
                kx = np.clip(cx + rng.randint(-4, 5), 0, w - 1)
                g = np.exp(-((yy - ky) ** 2 + (xx - kx) ** 2) / 4.0)
                hm[i, :, :, k] = np.maximum(hm[i, :, :, k], (0.6 + 0.4 * rng.rand()) * g)
    return [hm,
            rng.uniform(-8, 8, (b, h, w, 34)).astype(np.float32),
            rng.uniform(-24, 24, (b, h, w, 32)).astype(np.float32),
            rng.uniform(-24, 24, (b, h, w, 32)).astype(np.float32)]


def peaked_heads(batch, r, seed, device):
    """bench.py-style peaked heads: 3 gaussian people x 17 keypoints (peak
    0.9), uniform offsets and displacements in [-8, 8). Each person's
    keypoints lie within 4 cells of its centre (as in synth_heads), so that
    poses pass min_pose_score=0.25 and the accept does real work;
    independent random keypoints, as bench.py draws them, accept none.
    Drawn from a CPU generator, so every device gets the same heads."""
    g = torch.Generator().manual_seed(seed)
    centre = [torch.randint(5, r - 5, (batch, 3, 1, 1, 1), generator=g) for _ in range(2)]
    ky, kx = [(c + torch.randint(-4, 5, (batch, 3, 17, 1, 1), generator=g)).clamp(0, r - 1)
              for c in centre]
    yy = torch.arange(r)[:, None]
    xx = torch.arange(r)[None, :]
    blobs = torch.exp(-((yy - ky) ** 2 + (xx - kx) ** 2) / 4.0)   # (B,3,17,R,R)
    hm = (0.9 * blobs).amax(1).permute(0, 2, 3, 1).contiguous().to(device)
    flat = (torch.rand((batch, r, r, 98), generator=g) * 16 - 8).to(device)
    return hm, flat[..., :34], flat[..., 34:66], flat[..., 66:98]


def synth_photo(height, width, seed):
    """A photograph-like RGB uint8 scene with two person-shaped figures, the
    geometry of tests/tfjs_fixture.synth_photo (the scenes the fixture
    heads were fitted on), drawn with numpy alone."""
    rng = np.random.RandomState(seed)
    img = np.zeros((height, width, 3), np.float32)
    for c, (top, bot) in enumerate(((90, 70), (140, 110), (180, 60))):
        img[:, :, c] = np.linspace(top, bot, height)[:, None]
    yy, xx = np.mgrid[0:height, 0:width]

    def seg(p0, p1, thick, color):
        (x0, y0), (x1, y1) = p0, p1
        dx, dy = x1 - x0, y1 - y0
        t = np.clip(((xx - x0) * dx + (yy - y0) * dy) / max(dx * dx + dy * dy, 1), 0, 1)
        near = (xx - x0 - t * dx) ** 2 + (yy - y0 - t * dy) ** 2 <= (thick / 2) ** 2
        img[near] = color

    for cx, cy, s, color in ((width // 3, height // 2, height // 8, (150, 40, 40)),
                             (2 * width // 3, height // 2 + 20, height // 10, (40, 120, 30))):
        head = (xx - cx) ** 2 + (yy - (cy - 2.2 * s)) ** 2 <= (0.5 * s) ** 2
        img[head] = color
        seg((cx, cy - 1.6 * s), (cx, cy), max(2, 0.45 * s), color)
        seg((cx, cy - 1.3 * s), (cx - s, cy - 0.4 * s), max(1, 0.3 * s), color)
        seg((cx, cy - 1.3 * s), (cx + s, cy - 0.6 * s), max(1, 0.3 * s), color)
        seg((cx, cy), (cx - 0.6 * s, cy + 1.6 * s), max(1, 0.35 * s), color)
        seg((cx, cy), (cx + 0.5 * s, cy + 1.7 * s), max(1, 0.35 * s), color)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def assert_poses_equal(got: DecodedPoses, ref: DecodedPoses, what: str):
    """Keypoints bitwise, pose scores within 2 ulp, counts equal."""
    for f in ('keypoint_scores', 'keypoint_coords', 'pose_offsets', 'candidate_count'):
        check(torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu()), f'{what}: {f}')
    a, b = got.pose_scores.cpu().numpy(), ref.pose_scores.cpu().numpy()
    ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    check(int(ulps.max()) <= 2, f'{what}: pose scores {int(ulps.max())} ulp apart')


def k1_against_plain(args, h, w, stride):
    """(bitwise equal, max abs difference, keypoints filled) of K1 against
    the plain version on the same device tables."""
    sov, dft, dbt, cs, ck, rc = args
    got = traversal.traverse_all_candidates(cs, ck, rc, sov, dft, dbt, h, w, stride)
    torch.cuda.synchronize()
    ref = traversal.traverse_all_candidates_reference(cs, ck, rc, sov, dft, dbt,
                                                      h, w, stride)
    equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    return equal, err, int((ref[0] > 0).sum())


def cuda_ms(fn, iters):
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on an NVIDIA GPU',
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    print(f'device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; '
          f'cuDNN {torch.backends.cudnn.version()}', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build('traversal')
    _build.load('traversal')
    print(f'build: K1 {K1_SOURCE} -> {os.path.relpath(lib, REPO)} in '
          f'{time.perf_counter() - t0:.2f} s (nvcc {" ".join(_build.NVCC_FLAGS)})',
          flush=True)

    # 3. K1 against its plain version on the card
    rng = np.random.RandomState(0)
    max_err = 0.0
    for b, h, w, stride, k in ((8, 33, 33, 16, 128), (4, 91, 161, 8, 32)):
        heads = [torch.from_numpy(a).to(dev) for a in synth_heads(rng, b, h, w)]
        cfg = DecodeConfig(min_pose_score=0.25, max_candidates=k, score_threshold=0.3)
        args = _prepare_decode(*heads, stride, cfg)[:6]
        equal, err, filled = k1_against_plain(args, h, w, stride)
        max_err = max(max_err, err)
        check(equal, f'K1 differs from its plain version at B={b} {h}x{w} K={k} (max {err})')
        check(filled > b * k, f'K1 walk filled only {filled} keypoints at {h}x{w}')
        print(f'K1 vs plain: B={b} {h}x{w} s{stride} K={k}: bitwise equal '
              f'(tolerance 0), {filled} keypoints filled', flush=True)

    # 4. float32 parity on the card (fixture weights, synthesized photos)
    params = weights.load_params_npz(FIXTURE)
    cfg50 = ModelConfig(model_id=50, output_stride=16)
    frames = torch.from_numpy(np.stack([synth_photo(353, 481, 100 + i) for i in range(3)]))
    heads = {}
    for name, d in (('cpu', 'cpu'), ('cuda', dev)):
        p = weights.params_from_jax(params, d)
        heads[name] = mobilenet_v1.forward(p, normalize(frames.to(d), torch.float32), cfg50)
    worst = 0.0
    for k, ref in heads['cpu'].items():
        got = heads['cuda'][k].cpu()
        rel = float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))
        worst = max(worst, rel)
        check(rel <= 1e-4, f'f32 head {k}: CUDA vs CPU {rel:.3g} of scale (limit 1e-4)')
    print(f'f32 heads, fixture m50 s16, 3x353x481: CUDA vs CPU within {worst:.3g} '
          f'of each head\'s scale (limit 1e-4)', flush=True)
    dcfg = DecodeConfig(min_pose_score=0.25)
    order = ('heatmap', 'offset', 'displacement_fwd', 'displacement_bwd')
    cpu_heads = [heads['cpu'][k] for k in order]
    ref = decode_batch(*cpu_heads, 16, dcfg)
    got = decode_batch(*[t.to(dev) for t in cpu_heads], 16, dcfg)
    assert_poses_equal(got, ref, 'decode_batch CUDA (K1) vs CPU (plain)')
    n_ref = (ref.pose_scores > 0).sum(1)
    check(bool((n_ref >= 1).all()), f'fixture decode found no pose: {n_ref.tolist()}')
    slice_gpu = decode_batch(*[heads['cuda'][k] for k in order], 16, dcfg)
    check(torch.equal((slice_gpu.pose_scores > 0).sum(1).cpu(), n_ref),
          'slice on CUDA finds another pose count than on the CPU')
    coord_err = float((slice_gpu.keypoint_coords.cpu() - ref.keypoint_coords).abs().max())
    score_err = float((slice_gpu.pose_scores.cpu() - ref.pose_scores).abs().max())
    check(coord_err <= 1e-2 and score_err <= 1e-4,
          f'slice on CUDA vs CPU: coords {coord_err} px, pose scores {score_err}')
    print(f'f32 decode: CUDA (K1) vs CPU (plain) on the same heads: coords and '
          f'keypoint scores bitwise, pose scores within 2 ulp; poses per image '
          f'{n_ref.tolist()}; whole slice CUDA vs CPU: coords {coord_err:.2g} px, '
          f'pose scores {score_err:.2g}', flush=True)

    # 5. the main path: m101 s16 bf16, random init, 513x513
    model = load_model(101, 16, allow_random_init=True, device=dev,
                       compute_dtype=torch.bfloat16)
    pipe = PoseNetPipeline(model)
    g = torch.Generator(device=dev).manual_seed(0)
    frames8 = torch.randint(0, 256, (8, 513, 513, 3), generator=g, device=dev,
                            dtype=torch.uint8)
    peaked8 = peaked_heads(8, 33, 7, dev)
    pipe.warmup((513, 513), batch=8)
    torch.cuda.synchronize()
    traversal.launches = 0
    poses = pipe(frames8)
    peaked_poses = decode_batch(*peaked8, 16, pipe.decode_cfg)
    torch.cuda.synchronize()
    launches = traversal.launches
    check(launches >= 2, f'K1 launched {launches} times on the main path')
    for out in (poses, peaked_poses):
        check(tuple(out.keypoint_coords.shape) == (8, 10, 17, 2),
              f'keypoint_coords shape {tuple(out.keypoint_coords.shape)}')
        check(tuple(out.pose_scores.shape) == (8, 10), 'pose_scores shape')
        check(all(bool(torch.isfinite(t.float()).all()) for t in out), 'non-finite output')
    per_image = (peaked_poses.pose_scores > 0).sum(1)
    check(bool((per_image >= 1).all()), f'peaked decode accepted {per_image.tolist()}')
    assert_poses_equal(peaked_poses, decode_batch(*[t.cpu() for t in peaked8], 16,
                                                  pipe.decode_cfg),
                       'peaked decode CUDA vs CPU')
    print(f'main path: m101 s16 bf16 8x513x513 -> {tuple(poses.keypoint_coords.shape)}, '
          f'finite; peaked decode poses per image {per_image.tolist()} (equal to the '
          f'CPU decode); K1 launches {launches}', flush=True)

    # 6. timing at batch 128
    batch = 128
    frames = torch.randint(0, 256, (batch, 513, 513, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    peaked = peaked_heads(batch, 33, 8, dev)
    cfg101 = pipe.cfg

    def fused():
        heads = mobilenet_v1.forward(pipe.params, normalize(frames, cfg101.compute_dtype),
                                     cfg101)
        return heads, decode_batch(*peaked, 16, pipe.decode_cfg)

    n_iters = 10
    fused()
    torch.cuda.synchronize()
    best = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            fused()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    img_s = n_iters * batch / best
    fwd_ms = cuda_ms(lambda: mobilenet_v1.forward(
        pipe.params, normalize(frames, cfg101.compute_dtype), cfg101), n_iters)
    dec_ms = cuda_ms(lambda: decode_batch(*peaked, 16, pipe.decode_cfg), n_iters)
    pipe_ms = cuda_ms(lambda: infer(pipe.params, frames, cfg101, pipe.decode_cfg), n_iters)
    print(f'fused m101 s16 513x513 b{batch} bf16 forward + peaked decode: '
          f'{img_s:.1f} img/s (best of 3 windows of {n_iters}); forward {fwd_ms:.3f} ms, '
          f'peaked decode {dec_ms:.3f} ms, pipeline on its own heads {pipe_ms:.3f} ms '
          f'per batch', flush=True)

    args = _prepare_decode(*peaked, 16, pipe.decode_cfg)[:6]
    equal, err, _ = k1_against_plain(args, 33, 33, 16)
    max_err = max(max_err, err)
    check(equal, f'K1 differs from its plain version at B={batch} (max {err})')
    sov, dft, dbt, cs, ck, rc = args
    k1_args = (cs, ck, rc, sov, dft, dbt, 33, 33, 16)
    times = {}
    for name, fn in (('plain', traversal.traverse_all_candidates_reference),
                     ('kernel', traversal.traverse_all_candidates),
                     ('kernel', traversal.traverse_all_candidates),
                     ('plain', traversal.traverse_all_candidates_reference)):
        times.setdefault(name, []).append(cuda_ms(lambda: fn(*k1_args), 50))
    k1_ms = sum(times['kernel']) / 2
    plain_ms = sum(times['plain']) / 2
    print(f'K1 at B={batch} K=128 33x33: kernel {k1_ms:.4f} ms, plain {plain_ms:.4f} ms '
          f'(runs plain, kernel, kernel, plain: {times})', flush=True)

    print(json.dumps({'kernels': [{
        'name': 'traverse_all_candidates', 'route': 'cuda', 'source': K1_SOURCE,
        'replaces': K1_REPLACES, 'launches': launches, 'max_abs_err': max_err,
        'ms': k1_ms, 'plain_ms': plain_ms}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
