"""Large-grid spatial-partition exactness of the port, the counterpart of
`tools/verify_spatial_large.py`.

Runs the port's row-range spatial partition (`PoseNetPipeline(mesh=...,
partition='spatial')`, `parallel/spatial.py`) at production shapes against
the unsharded pipeline, with the JAX tool's settings: MobileNetV1-50 in
float32 (TF32 off), every trunk bias + 1.0 (so that a row leaking across
a shard edge through relu6(bias) shows), min_pose_score 0,
score_threshold 0.3, max_candidates 64, one frame from RandomState(11):

  - 513x513 stride 16 (the flagship serving shape; 33x33 grid)
  - 721x1281 stride 8  (s8 720p; 91x161 grid, the dilated stride plan)

over 8 shards: the card repeated (`['cuda:0'] * 8`) on a host with one,
every card in turn on a host with several, or `['cpu'] * 8` with
`--device cpu`. Passes at the JAX tool's bounds (pose scores within 1e-5,
coordinates within 1e-3 px) and prints whether the poses are bitwise
equal. The port has no `valid_h` (its shards are row ranges with a halo
exchange, a departure on purpose), so this checks what the port does.

Usage: python3 tools/verify_spatial_large_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from posenet_tpu_torch.apps import full_float32  # noqa: E402
from posenet_tpu_torch.config import DecodeConfig, ModelConfig  # noqa: E402
from posenet_tpu_torch.models import mobilenet_v1  # noqa: E402
from posenet_tpu_torch.models.model_factory import PoseNet, resolve_device  # noqa: E402
from posenet_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from posenet_tpu_torch.pipeline import PoseNetPipeline  # noqa: E402

GRIDS = (('513x513-s16', (513, 513), 16), ('721x1281-s8', (721, 1281), 8))
SHARDS = 8
MODEL = 50


def shard_devices(device: torch.device, shards: int) -> list:
    """`shards` devices: the CPU repeated, or the cards in turn (one card
    repeated on a host with one)."""
    if device.type == 'cpu':
        return ['cpu'] * shards
    return [f'cuda:{i % torch.cuda.device_count()}' for i in range(shards)]


def inflated_model(stride: int, device) -> PoseNet:
    """MODEL's seeded random weights (seed 0), every trunk bias + 1.0."""
    cfg = ModelConfig(model_id=MODEL, output_stride=stride)
    params = mobilenet_v1.init_params(torch.Generator().manual_seed(0), cfg, device)
    for layer in params['backbone']:
        for k in layer:
            if k.endswith('b'):
                layer[k] = layer[k] + 1.0
    return PoseNet(params, cfg)


def compare(name: str, hw, stride: int, devices) -> dict:
    """The spatial partition over `devices` against the unsharded pipeline
    on devices[0]; prints one line and returns its numbers."""
    model = inflated_model(stride, devices[0])
    dcfg = DecodeConfig(min_pose_score=0.0, score_threshold=0.3, max_candidates=64)
    frames = np.random.RandomState(11).randint(0, 255, (1, *hw, 3), dtype=np.uint8)
    plain = PoseNetPipeline(model, dcfg)(frames)
    spatial = PoseNetPipeline(model, dcfg, mesh=make_mesh(devices=devices),
                              partition='spatial')(frames)
    n = int((plain.pose_scores > 0).sum())
    d_ps = float((plain.pose_scores - spatial.pose_scores).abs().max())
    d_kc = float((plain.keypoint_coords - spatial.keypoint_coords).abs().max())
    bitwise = all(torch.equal(a, b) for a, b in zip(plain, spatial))
    ok = d_ps <= 1e-5 and d_kc <= 1e-3
    print(f'{name}: poses={n} max|d pose_scores|={d_ps:.3g} max|d coords|={d_kc:.3g} px, '
          f'{"bitwise equal" if bitwise else "not bitwise"}, over {len(devices)} shards of '
          f'{sorted(set(devices))} -> {"OK" if ok else "FAIL"}', flush=True)
    return {'name': name, 'poses': n, 'd_pose_scores': d_ps, 'd_coords': d_kc,
            'bitwise': bitwise, 'ok': ok}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--device', default='cuda',
                   help="torch device: 'cuda' (default; raises without a CUDA device) "
                        "or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    device = resolve_device(args.device)
    full_float32()
    devices = shard_devices(device, SHARDS)
    results = [compare(name, hw, stride, devices) for name, hw, stride in GRIDS]
    ok = all(r['ok'] for r in results)
    print('PASS: spatial partition exact at production grids' if ok
          else 'FAIL: spatial partition diverges')
    if not ok:
        raise SystemExit(1)
    return results


if __name__ == '__main__':
    main()
