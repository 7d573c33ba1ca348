"""The multi-device dry run on the CPU, the counterpart of the repository's
`__graft_entry__.dryrun_multichip`: the three layouts the port ships, on
tiny shapes (m50 s16, 65x65).

    python -m posenet_tpu_torch.parallel.dryrun 4

1. one data-parallel training step over n gloo ranks, which it starts;
2. spatial-partition inference, one image's height over ['cpu'] * n;
3. data-partition inference over ['cpu'] * n, on an uneven batch of n + 1.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from posenet_tpu_torch.config import DecodeConfig, ModelConfig, TrainConfig
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.models.model_factory import PoseNet
from posenet_tpu_torch.parallel import mesh as mesh_lib

MODEL_CFG = ModelConfig(model_id=50, output_stride=16)


def _params():
    return mobilenet_v1.init_params(torch.Generator().manual_seed(0), MODEL_CFG)


def _dp_step_rank(n: int, out_path: str):
    """One rank: the step on the global batch of n 65x65 images; rank 0
    writes the loss."""
    from posenet_tpu_torch.training import train_step as ts

    train_cfg = TrainConfig(model_id=50, batch_size=n)
    rng = np.random.RandomState(0)
    batch = {'image': rng.uniform(-1, 1, (n, 65, 65, 3)).astype(np.float32),
             'keypoints': rng.uniform(0, 4, (n, 3, 17, 2)).astype(np.float32)}
    state = ts.init_train_state(_params(), train_cfg, 'cpu')
    step = ts.make_train_step(MODEL_CFG, train_cfg, mesh=mesh_lib.make_mesh(n))
    _, metrics = step(state, batch)
    if dist.get_rank() == 0:
        with open(out_path, 'w') as f:
            json.dump({'loss': float(metrics['loss'])}, f)


def dryrun_multichip(n_devices: int) -> None:
    """The three layouts over n devices of the CPU; prints a line for each
    and raises on a non-finite or misshapen result."""
    from posenet_tpu_torch.pipeline import PoseNetPipeline

    with tempfile.TemporaryDirectory() as root:
        out_path = os.path.join(root, 'loss.json')
        mesh_lib.launch(_dp_step_rank, n_devices, args=(n_devices, out_path),
                        backend='gloo')
        with open(out_path) as f:
            loss = json.load(f)['loss']
    if not np.isfinite(loss):
        raise RuntimeError(f'non-finite loss {loss}')
    print(f"dryrun_multichip({n_devices}): DP step ok, loss={loss:.4f}")

    model = PoseNet(_params(), MODEL_CFG)
    mesh = mesh_lib.make_mesh(devices=['cpu'] * n_devices)
    rng = np.random.RandomState(0)
    spatial = PoseNetPipeline(model, DecodeConfig(min_pose_score=0.0), mesh=mesh,
                              partition='spatial')
    ps = spatial(rng.randint(0, 255, (1, 65, 65, 3)).astype(np.uint8)).pose_scores
    if ps.shape[0] != 1 or not torch.isfinite(ps).all():
        raise RuntimeError(f'spatial partition: pose scores {ps}')
    print(f"dryrun_multichip({n_devices}): spatial-partition inference ok")

    data = PoseNetPipeline(model, DecodeConfig(min_pose_score=0.0), mesh=mesh,
                           partition='data')
    ps = data(rng.randint(0, 255, (n_devices + 1, 65, 65, 3)).astype(np.uint8)).pose_scores
    if ps.shape[0] != n_devices + 1 or not torch.isfinite(ps).all():
        raise RuntimeError(f'data partition: pose scores of shape {tuple(ps.shape)}')
    print(f"dryrun_multichip({n_devices}): data-partition (shard_map) "
          f"inference ok")


if __name__ == '__main__':
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
