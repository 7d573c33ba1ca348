"""The reference `posenet_resnet50`: PoseNet ResNet50's plain float32 forward
(`model`), with the reference `posenet`'s multi-pose decode and its
comparison of a program's poses (`gaps`), and the float8 control. Imports
nothing of the program.

A configuration that names it holds `model` (`output_stride`; the
reference computes in float32 whatever `compute_dtype` says, and reads
neither `architecture` nor `compute_dtype`), `decode` (the decoder's five
settings) and `weights` (`kernel_gain`, `residual_gain`, `head_gain`: how
the seed's parameters are drawn); a traffic mix `check_frames` and
`reference_block`.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Sequence

import numpy as np
import torch

from benchmarks.references.posenet import fp8, gaps
from benchmarks.references.posenet import model as posenet_model
from benchmarks.references.posenet_resnet50 import model

NAMES = gaps.NAMES
# The configuration's and the traffic's keys that this reference reads.
CONFIG_KEYS = frozenset({'model', 'decode', 'weights'})
TRAFFIC_KEYS = frozenset({'check_frames', 'reference_block'})


def draw_params(config: dict, seed: int, device) -> Dict:
    """The configuration's float32 parameters, drawn from the seed on
    `device` in one call."""
    return model.draw_params(config['model']['output_stride'], seed % 2 ** 63, device,
                             **config['weights'])


def _heads(params, frames_u8: np.ndarray, config: dict, device, quantize=None):
    x = model.normalize(torch.from_numpy(frames_u8).to(device))
    return model.forward(params, x, config['model']['output_stride'], quantize=quantize)


def _decode(heads, config: dict) -> Dict[str, torch.Tensor]:
    dc = config['decode']
    return posenet_model.decode(heads, config['model']['output_stride'],
                                dc['score_threshold'], dc['nms_radius'], dc['min_pose_score'],
                                dc['max_pose_detections'], dc['max_candidates'])


def judge(params: Dict, config: dict, traffic: dict, pool: np.ndarray,
          answers: Sequence[dict], device, quantize=None) -> Dict[str, float]:
    """The worst of each of `NAMES` over `answers`, each a dict of the
    program's host `pose_scores`, `keypoint_scores`, `keypoint_coords` and
    the pool indices `frames` of its frames, judged in blocks of
    `reference_block` frames. `quantize` runs the reference's forward in a
    lower precision."""
    block = max(1, int(traffic.get('reference_block', 16)))
    frames = np.concatenate([np.asarray(a['frames']) for a in answers])
    poses = {k: torch.cat([torch.as_tensor(a[k]) for a in answers]) for k in
             ('pose_scores', 'keypoint_scores', 'keypoint_coords')}
    results = []
    for lo in range(0, len(frames), block):
        sl = slice(lo, lo + block)
        with torch.no_grad():
            heads = _heads(params, pool[frames[sl]], config, device, quantize)
            results.append(gaps.gaps({k: v[sl] for k, v in poses.items()}, heads,
                                     _decode(heads, config), config['model']['output_stride'],
                                     config['decode']))
    return gaps.worst(results)


def control_build(params, config, traffic, devices=None):
    """The control: a callable in the program's place, host frames ->
    poses, from this reference computed in float8 (e4m3, one scale per
    tensor, every conv's input and kernel; products in float32), the
    precision below the configuration's bfloat16."""
    device = params['heads']['heatmap']['w'].device

    def call(frames):
        with torch.no_grad():
            out = _decode(_heads(params, frames, config, device, quantize=fp8), config)
        return {k: out[k].cpu() for k in ('pose_scores', 'keypoint_scores',
                                           'keypoint_coords')}
    return call


# The control as a system under test (`harness.execute(system=...)`): its
# calls answer on the host already.
CONTROL = SimpleNamespace(build=control_build, fetch=lambda answer: answer,
                          read=lambda answer: answer, counters=None)
