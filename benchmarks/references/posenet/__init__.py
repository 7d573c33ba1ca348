"""The reference `posenet`: PoseNet MobileNetV1's plain float32 forward and
multi-pose decode (`model`), the comparison of a program's poses with it
(`gaps`), and its float8 control. Imports nothing of the program.

A configuration that names it holds `model` (`model_id`, `output_stride`;
the reference computes in float32 whatever `compute_dtype` says), `decode`
(the decoder's five settings) and `weights` (`kernel_gain`, `head_gain`:
how the seed's parameters are drawn); a traffic mix `check_frames`,
`reference_block` and, for raw frames, `resize_to`.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Sequence

import numpy as np
import torch

from benchmarks.references.posenet import gaps, model

NAMES = gaps.NAMES
# The configuration's and the traffic's keys that this reference reads.
CONFIG_KEYS = frozenset({'model', 'decode', 'weights'})
TRAFFIC_KEYS = frozenset({'check_frames', 'reference_block', 'resize_to'})


def draw_params(config: dict, seed: int, device) -> Dict:
    """The configuration's float32 parameters, drawn from the seed on
    `device` in one call."""
    m = config['model']
    return model.draw_params(m['model_id'], m['output_stride'], seed % 2 ** 63, device,
                             **config['weights'])


def inputs(frames_u8: np.ndarray, traffic: dict, device) -> torch.Tensor:
    """The model's float32 input for host frames, as the traffic sends them:
    RGB at the model's resolution, or raw BGR resized to `resize_to`."""
    x = torch.from_numpy(frames_u8).to(device)
    if traffic.get('resize_to'):
        return model.preprocess_raw(x, tuple(traffic['resize_to']))
    return model.normalize(x)


def _decode(heads, config: dict) -> Dict[str, torch.Tensor]:
    dc = config['decode']
    return model.decode(heads, config['model']['output_stride'], dc['score_threshold'],
                        dc['nms_radius'], dc['min_pose_score'], dc['max_pose_detections'],
                        dc['max_candidates'])


def judge(params: Dict, config: dict, traffic: dict, pool: np.ndarray,
          answers: Sequence[dict], device, quantize=None) -> Dict[str, float]:
    """The worst of each of `NAMES` over `answers`, each a dict of the
    program's host `pose_scores`, `keypoint_scores`, `keypoint_coords` and
    the pool indices `frames` of its frames, judged in blocks of
    `reference_block` frames. `quantize` runs the reference's forward in a
    lower precision."""
    m = config['model']
    block = max(1, int(traffic.get('reference_block', 16)))
    frames = np.concatenate([np.asarray(a['frames']) for a in answers])
    poses = {k: torch.cat([torch.as_tensor(a[k]) for a in answers]) for k in
             ('pose_scores', 'keypoint_scores', 'keypoint_coords')}
    results = []
    for lo in range(0, len(frames), block):
        sl = slice(lo, lo + block)
        with torch.no_grad():
            heads = model.forward(params, inputs(pool[frames[sl]], traffic, device),
                                  m['model_id'], m['output_stride'], quantize=quantize)
            results.append(gaps.gaps({k: v[sl] for k, v in poses.items()}, heads,
                                     _decode(heads, config), m['output_stride'],
                                     config['decode']))
    return gaps.worst(results)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to e4m3's largest, and back to float32."""
    scale = 448.0 / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def control_build(params, config, traffic, devices=None):
    """The control: a callable in the program's place, host frames ->
    poses, from this reference computed in float8 (e4m3, one scale per
    tensor, every conv's input and kernel; products in float32), the
    precision below the configuration's bfloat16."""
    device = params['heads']['heatmap']['w'].device
    m = config['model']

    def call(frames):
        with torch.no_grad():
            heads = model.forward(params, inputs(frames, traffic, device), m['model_id'],
                                  m['output_stride'], quantize=fp8)
            out = _decode(heads, config)
        return {k: out[k].cpu() for k in ('pose_scores', 'keypoint_scores',
                                           'keypoint_coords')}
    return call


# The control as a system under test (`harness.execute(system=...)`): its
# calls answer on the host already.
CONTROL = SimpleNamespace(build=control_build, fetch=lambda answer: answer,
                          read=lambda answer: answer, counters=None)
