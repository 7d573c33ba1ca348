"""The PyTorch port's headline benchmark, the counterpart of `bench.py`:
img/s of MobileNetV1-101 s16 at 513x513, batch 128, bf16 trunk, forward
plus the whole multi-pose decode, on one card.

Prints ONE JSON line with `bench.py`'s keys: {"metric", "value", "unit",
"vs_baseline", "extra"}. `vs_baseline` compares against the reference's
only published number, the README's "200-300 fps" forward-only GPU claim
(BASELINE.md), at its midpoint of 250 img/s; this number also holds the
decode.

The timed step (`fused_step`) is the forward on seeded uint8 frames made
on the device, then `decode_batch` on peaked multi-person heads
(`peaked_heads`: 3 people of 17 keypoints an image, each person's
keypoints near its centre, so that poses pass min_pose_score=0.25 and the
greedy accept does real work). Eager PyTorch runs the two serially, and
the forward writes all four heads, so nothing needs tying together. The
value is the best of 3 windows of `--iters` steps, each closed by
`torch.cuda.synchronize()`; `extra` holds every window's rate, the p50 of
single steps, the fused pipeline on the frames' own (near-flat) heads
(`flat_content_img_per_s`), the forward and the peaked decode alone (ms a
call, best of 3 windows: the decode's is mostly the host's dispatch), the
poses accepted per peaked image, the kernels' launches in one step, and
the device (`nvidia-smi`'s `name, power.limit`, or `cpu`). TF32 is off
(`apps.full_float32`), as in chip_smoke.py and the apps: the heads' float32
1x1 conv then runs without tensor cores, as in every earlier figure.

    python3 bench_torch.py                 # on the card
    python3 bench_torch.py --device cpu --model 50 --size 193 --batch 2 --iters 2
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from posenet_tpu_torch.apps import full_float32
from posenet_tpu_torch.config import DecodeConfig, ModelConfig
from posenet_tpu_torch.decode import decode_batch
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.models.model_factory import resolve_device
from posenet_tpu_torch.ops import sepconv, traversal
from posenet_tpu_torch.pipeline import infer, normalize

BASELINE_IMG_S = 250.0   # reference README.md:12 midpoint (forward only, GPU)


def grid_size(height: int, width: int, output_stride: int) -> Tuple[int, int]:
    """The heads' (rows, columns) at an input of height x width."""
    return (height - 1) // output_stride + 1, (width - 1) // output_stride + 1


def peaked_heads(batch: int, grid, seed: int, device) -> Tuple[torch.Tensor, ...]:
    """NHWC peaked heads (heatmap, offsets, dfwd, dbwd) on a grid of
    `grid` cells (an int: square; or (rows, columns)): 3 gaussian people
    x 17 keypoints (peak 0.9), uniform offsets and displacements in
    [-8, 8). Each person's keypoints lie within 4 cells of its centre, so
    that poses pass min_pose_score=0.25 and the accept does real work;
    independent random keypoints, as `bench.py` draws them, accept none.
    The centres lie in [5, n - 5), so each side needs at least 11 cells.
    Drawn from a CPU generator, so every device gets the same heads."""
    rows, cols = (grid, grid) if isinstance(grid, int) else grid
    if min(rows, cols) < 11:
        raise ValueError(f'peaked heads need a grid of at least 11x11 cells, got '
                         f'{rows}x{cols}')
    g = torch.Generator().manual_seed(seed)
    centre = [torch.randint(5, n - 5, (batch, 3, 1, 1, 1), generator=g) for n in (rows, cols)]
    ky, kx = [(c + torch.randint(-4, 5, (batch, 3, 17, 1, 1), generator=g)).clamp(0, n - 1)
              for c, n in zip(centre, (rows, cols))]
    yy = torch.arange(rows)[:, None]
    xx = torch.arange(cols)[None, :]
    blobs = torch.exp(-((yy - ky) ** 2 + (xx - kx) ** 2) / 4.0)   # (B,3,17,R,C)
    hm = (0.9 * blobs).amax(1).permute(0, 2, 3, 1).contiguous().to(device)
    flat = (torch.rand((batch, rows, cols, 98), generator=g) * 16 - 8).to(device)
    return hm, flat[..., :34], flat[..., 34:66], flat[..., 66:98]


def fused_step(params, frames: torch.Tensor, peaked: Sequence[torch.Tensor],
               cfg: ModelConfig, dcfg: DecodeConfig):
    """The timed step: the forward on uint8 `frames`, then `decode_batch`
    on the peaked heads; returns (the forward's heads, the poses). On the
    card the bf16 m101 s16 forward launches K2 10 times and the decode K1
    once."""
    heads = mobilenet_v1.forward(params, normalize(frames, cfg.compute_dtype), cfg)
    return heads, decode_batch(*peaked, cfg.output_stride, dcfg)


def setup(model_id: int, output_stride: int, height: int, width: int, batch: int,
          device: torch.device):
    """(params, frames, peaked heads, ModelConfig, DecodeConfig) of the
    bf16 fused step: weights drawn from seed 0 (a CPU generator), uint8
    frames from seed 0 on `device`, peaked heads from seed 7."""
    cfg = ModelConfig(model_id=model_id, output_stride=output_stride,
                      compute_dtype=torch.bfloat16)
    params = mobilenet_v1.cast_params(
        mobilenet_v1.init_params(torch.Generator().manual_seed(0), cfg),
        cfg.compute_dtype, device)
    gen = torch.Generator(device=device).manual_seed(0)
    frames = torch.randint(0, 256, (batch, height, width, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    peaked = peaked_heads(batch, grid_size(height, width, output_stride), 7, device)
    return params, frames, peaked, cfg, DecodeConfig(min_pose_score=0.25)


def synchronizer(device: torch.device) -> Callable[[], None]:
    """What waits for `device`'s queued work: `torch.cuda.synchronize` on a
    card; on the CPU the work is done when the call returns."""
    if device.type == 'cuda':
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def device_name(device: torch.device) -> str:
    """The card's `name, power.limit` as nvidia-smi gives them, or 'cpu'."""
    if device.type != 'cuda':
        return 'cpu'
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def windows(step: Callable[[], object], sync: Callable[[], None], iters: int,
            batch: int, n: int = 3) -> list:
    """img/s of each of `n` windows of `iters` steps, each closed by
    `sync`, after one warm step."""
    step()
    sync()
    rates = []
    for _ in range(n):
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        sync()
        rates.append(iters * batch / (time.perf_counter() - t0))
    return rates


def launches_of(fn: Callable[[], object], sync: Callable[[], None]) -> Dict[str, int]:
    """K1's and K2's launches in one call of `fn` (0 on the CPU, where the
    wrappers run the kernels' plain versions)."""
    sync()
    traversal.launches = sepconv.launches = 0
    fn()
    sync()
    return {'K1': traversal.launches, 'K2': sepconv.launches}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--device', default='cuda',
                   help="torch device: 'cuda' (default; raises without a CUDA device) "
                        "or 'cpu'")
    p.add_argument('--model', type=int, default=101)
    p.add_argument('--output_stride', type=int, default=16)
    p.add_argument('--size', type=int, default=513)
    p.add_argument('--batch', type=int, default=128)
    p.add_argument('--iters', type=int, default=40)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    full_float32()
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    sync = synchronizer(device)
    params, frames, peaked, cfg, dcfg = setup(args.model, args.output_stride, args.size,
                                              args.size, args.batch, device)

    def step():
        return fused_step(params, frames, peaked, cfg, dcfg)

    rates = windows(step, sync, args.iters, args.batch)
    launches = launches_of(step, sync)

    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        _, poses = step()
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
    per_image = (poses.pose_scores > 0).sum(1).float()

    flat = windows(lambda: infer(params, frames, cfg, dcfg), sync, args.iters, args.batch)
    x = normalize(frames, cfg.compute_dtype)
    forward_ms = 1e3 * args.batch / max(windows(
        lambda: mobilenet_v1.forward(params, x, cfg), sync, args.iters, args.batch))
    decode_ms = 1e3 * args.batch / max(windows(
        lambda: decode_batch(*peaked, cfg.output_stride, dcfg), sync, args.iters, args.batch))

    where = 'card' if device.type == 'cuda' else 'CPU (host, not a device metric)'
    value = max(rates)
    result = {
        'metric': f'img/s on one {where}, {args.size}x{args.size} m{args.model} '
                  f's{args.output_stride} fused forward+decode, peaked multi-person '
                  f'heads (batch={args.batch}, bf16)',
        'value': value,
        'unit': 'img/s',
        'vs_baseline': value / BASELINE_IMG_S,
        'extra': {'windows_img_per_s': rates, 'iters_per_window': args.iters,
                  'p50_batch_ms': float(np.percentile(lat, 50)), 'batch': args.batch,
                  'flat_content_img_per_s': max(flat),
                  'forward_ms': forward_ms, 'peaked_decode_ms': decode_ms,
                  'poses_per_peaked_image': float(per_image.mean()),
                  'min_poses_per_peaked_image': int(per_image.min()),
                  'launches_per_step': launches, 'device': device_name(device)},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == '__main__':
    main()
