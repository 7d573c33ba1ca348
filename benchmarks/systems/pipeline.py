"""The system `pipeline`: the port's user entry, `PoseNetPipeline`, on one
device. The only module of the benchmark that imports the program
(`posenet_tpu_torch`).

It builds `PoseNet(params, ModelConfig(**config['model']))` from the
benchmark's float32 pytree, with `DecodeConfig(**config['decode'])`, and
brings each call's poses to the host (`fetch`, `read`), and
reads the program's launch counters of K1 (`ops.traversal.launches`) and
K2 (`ops.sepconv.launches`). A key of either group that the program does
not take is refused by its constructor.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from posenet_tpu_torch import DecodeConfig, ModelConfig, PoseNet, PoseNetPipeline
from posenet_tpu_torch.ops import sepconv, traversal

# The configuration's and the traffic's keys that this system reads.
CONFIG_KEYS = frozenset({'model', 'decode'})
TRAFFIC_KEYS = frozenset({'resize_to'})


def model_config(config: dict) -> ModelConfig:
    """The configuration's `model` group as the program's ModelConfig; the
    compute dtype by its torch name."""
    model = dict(config['model'])
    if 'compute_dtype' in model:
        model['compute_dtype'] = getattr(torch, model['compute_dtype'])
    return ModelConfig(**model)


def build(params: Dict, config: dict, traffic: dict,
          devices: Optional[Sequence[str]] = None) -> PoseNetPipeline:
    """The pipeline a user of this configuration runs. `params` lie on the
    device it runs on; `devices` names it for a run on the CPU."""
    return PoseNetPipeline(PoseNet(params, model_config(config)),
                           DecodeConfig(**config['decode']),
                           device_resize_to=traffic.get('resize_to'),
                           device=devices[0] if devices else None)


POSES = ('pose_scores', 'keypoint_scores', 'keypoint_coords')


def fetch(out) -> dict:
    """Queues the copy of a call's poses into pinned host memory right
    behind the call's own work, and marks the stream there. Reading them
    then waits for this call alone: a blocking `.cpu()` made after the next
    call was sent would wait for that call too, and leave the device idle
    while the host stages the one after."""
    device = out.pose_scores.device
    if device.type != 'cuda':
        return {'poses': {k: getattr(out, k).cpu() for k in POSES}, 'done': None}
    poses = {k: torch.empty(getattr(out, k).shape, dtype=getattr(out, k).dtype,
                            pin_memory=True).copy_(getattr(out, k), non_blocking=True)
             for k in POSES}
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return {'poses': poses, 'done': done}


def read(fetched: dict) -> dict:
    """The poses of a fetched call, on the host, once its copy is done."""
    if fetched['done'] is not None:
        fetched['done'].synchronize()
    return fetched['poses']


def counters() -> Dict[str, int]:
    """The program's kernel launches so far in this process."""
    return {'K1': traversal.launches, 'K2': sepconv.launches}
