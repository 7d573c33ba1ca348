"""The benchmark's fixed arithmetic for PoseNet ResNet50: each trunk conv's
shape at a frame size, the operations of a forward pass, and each conv's
roofline bound on one H100 (the peaks of `yardstick`). The shapes come
from the plain reference's plan (`references/posenet_resnet50/model.py`);
imports nothing of the program.
"""

from __future__ import annotations

from typing import List

from benchmarks.references.posenet.model import HEADS
from benchmarks.references.posenet_resnet50 import model as reference
from benchmarks.yardstick import BF16_TENSOR_FLOPS, F32_FLOPS, HBM_BYTES_S, kind_of

HEAD_CHANNELS = sum(ch for _, ch in HEADS)
# cuDNN runs some 1x1 convs as GEMMs of the `nvjet` family, whose names hold
# none of the conv words of `yardstick.KINDS` (which files them under
# 'elementwise and other'): the convs' device time counts them too.
GEMM_KEYS = ('nvjet',)


def _out(n: int, k: int, stride: int, rate: int) -> int:
    """Output length of a conv with torch-style symmetric padding."""
    pad = ((stride - 1) + rate * (k - 1)) // 2
    return (n + 2 * pad - rate * (k - 1) - 1) // stride + 1


def conv_shapes(output_stride: int, height: int, width: int) -> List[dict]:
    """Every trunk conv of `reference.conv_plan` with its input (`h_in`,
    `w_in`) and output (`h`, `w`) sizes, then the four heads as one 1x1
    conv (role 'heads', float32) on the features."""
    convs = reference.conv_plan(output_stride)
    out, h, w = [], height, width
    stem = convs[0]
    out.append(dict(stem, h_in=h, w_in=w, h=_out(h, 7, 2, 1), w=_out(w, 7, 2, 1)))
    h, w = _out(out[0]['h'], 3, 2, 1), _out(out[0]['w'], 3, 2, 1)     # the max pool
    for c in convs[1:]:
        ho, wo = _out(h, c['k'], c['stride'], c['rate']), _out(w, c['k'], c['stride'], c['rate'])
        out.append(dict(c, h_in=h, w_in=w, h=ho, w=wo))
        if c['role'] in ('spatial', 'expand'):
            h, w = ho, wo
    out.append(dict(role='heads', block=5, c_in=reference.FEATURES, c_out=HEAD_CHANNELS,
                    k=1, stride=1, rate=1, h_in=h, w_in=w, h=h, w=w))
    return out


def _macs(c: dict) -> int:
    return c['h'] * c['w'] * c['c_out'] * c['c_in'] * c['k'] ** 2


def forward_flops(output_stride: int, height: int, width: int) -> float:
    """Operations (2 per multiply-add) of one image's forward pass: the 53
    trunk convs and the four 1x1 heads (the pool, bias, residual adds and
    ReLUs do no multiply-add)."""
    return 2.0 * sum(_macs(c) for c in conv_shapes(output_stride, height, width))


def conv_bound_ms(b: int, c: dict) -> float:
    """The least time of one conv of `conv_shapes` over a batch of `b`: its
    input read once, its output written once and its kernel read once at
    HBM speed, against its products on the tensor cores, whichever is
    longer. Trunk convs in bf16 (2 bytes a value, the bf16 tensor peak);
    the heads in float32 (4 bytes, the float32 peak: TF32 is off)."""
    heads = c['role'] == 'heads'
    size, peak = (4, F32_FLOPS) if heads else (2, BF16_TENSOR_FLOPS)
    values = b * (c['h_in'] * c['w_in'] * c['c_in'] + c['h'] * c['w'] * c['c_out'])
    nbytes = size * (values + c['c_out'] * c['c_in'] * c['k'] ** 2)
    return max(nbytes / HBM_BYTES_S, 2.0 * b * _macs(c) / peak) * 1e3


def conv_device_s(trace: dict) -> float:
    """Device seconds in the convs of a summarised trace
    (`yardstick.summarize_trace`): the kind 'cuDNN convs' and the GEMM
    kernels of `GEMM_KEYS` that `yardstick.KINDS` files elsewhere."""
    gemms = sum(s for name, s in trace['by_name_s'].items()
                if any(k in name.lower() for k in GEMM_KEYS)
                and kind_of({'name': name}) != 'cuDNN convs')
    return trace['by_kind_s'].get('cuDNN convs', 0.0) + gemms
