"""The int8 trunk: MobileNetV1 with s8 activations between layers.

The counterpart of `posenet_tpu.models.quantized`, in the port's OIHW
layout, with the same numerics. Selected by `ModelConfig.quantized`
(with compute_dtype=bfloat16); `PoseNetPipeline` folds the weights once
(`quantize_params`) and runs `forward_quantized` in place of the float
trunk. Inference only.

The scheme needs no calibration:
- Every tensor between layers is post-ReLU6, so its range is [0, 6] by
  construction, and q = round(x * 254/6) - 127 uses the whole s8 range.
- The pointwise convs have no padding, so the zero point folds into a
  per-output-channel constant:
      y[c] = s_a * w_scale[c] * (acc[c] + 127 * colsum[c]) + b[c]
  with acc = q @ qW in int32 and colsum[c] = sum_i qW[i, c], folded at
  quantize time. Each pointwise conv is one s8 x s8 -> s32 product
  (`torch._int_mm`, cuBLASLt's int8 GEMM on the card; the JAX package
  leaves it to XLA's `dot_general`), then a float32 epilogue.
- The depthwise convs and conv0 stay bf16 and read the dequantized input:
  the dequantize runs before the conv's zero padding, so pad cells are
  real zeros.
- Weights are symmetric per output channel (w_scale[c] = max|W[:, c]|/127).
- The last separable layer is not quantized again: the heads read its
  bf16 features through `mobilenet_v1.run_heads`, as the bf16 trunk's do.

Numerics copied from the JAX package, op by op:
- `_quantize_act` multiplies and rounds (half to even) in float32: bf16's
  8 mantissa bits would alias the 254-level grid.
- A bf16 conv is rounded to bf16 and its bias, rounded to bf16, added
  after, as the JAX package's `_conv2d` does. In [4, 6) one bf16 ulp
  (0.03125) is wider than one int8 level (6/254), so a bias added inside
  the conv's float32 sum lands on other levels.
- The epilogue `(acc + corr).float() * alpha + b` rounds after each
  operation, with no fused multiply-add: each is its own elementwise op.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from posenet_tpu_torch.config import ModelConfig
from posenet_tpu_torch.models import mobilenet_v1

# Post-ReLU6 x in [0, 6] maps to q in [-127, 127] by q = round(x * QSCALE) + QZERO.
QSCALE = 254.0 / 6.0
QZERO = -127.0
# `torch._int_mm` on the card refuses a product of 16 rows or fewer.
_INT_MM_MIN_ROWS = 17


def _quantize_act(y: torch.Tensor) -> torch.Tensor:
    """Post-ReLU6 activation (any float dtype) -> s8, in float32."""
    return (torch.round(y.float() * QSCALE) + QZERO).to(torch.int8)


def _dequantize_act(q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """s8 -> the real-valued activation in [0, 6], in `dtype`."""
    return ((q.float() - QZERO) * (1.0 / QSCALE)).to(dtype)


def _divisor(like: torch.Tensor, value: float) -> torch.Tensor:
    """`value` as a float32 tensor on `like`'s device. Divided by a Python
    number, a CUDA tensor is multiplied by its reciprocal, which can round
    otherwise than the division the CPU and the JAX package make."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def quantize_params(params: Dict[str, Any],
                    device: torch.device | str | None = None) -> Dict[str, Any]:
    """Fold a float parameter pytree (`init_params`, `params_from_jax`) into
    the int8 layout, on `device` (None: where the parameters are).

    Per separable layer:
      dw_w     (C, 1, 3, 3)  bf16
      dw_b     (C,)          f32
      pw_w8    (C_in, C_out) int8, symmetric per output channel; a
                             transposed view of a (C_out, C_in) tensor, the
                             operand layout cuBLASLt's int8 GEMM takes
      pw_alpha (C_out,)      f32    s_a * w_scale[c]
      pw_corr  (C_out,)      int32  127 * sum_i qW[i, c]
      pw_b     (C_out,)      f32
    conv0: 'w' bf16, 'b' f32. Heads: 'w' bf16, 'b' f32."""
    def move(t, dtype):
        return t.to(device=device, dtype=dtype)

    backbone = []
    for p in params['backbone']:
        if 'w' in p:   # conv0
            backbone.append({'w': move(p['w'], torch.bfloat16),
                             'b': move(p['b'], torch.float32)})
            continue
        pw = move(p['pw_w'], torch.float32).flatten(1)            # (C_out, C_in)
        w_scale = pw.abs().amax(1).clamp_min(1e-12) / _divisor(pw, 127.0)
        qw = torch.round(pw / w_scale[:, None]).to(torch.int8)   # (C_out, C_in)
        backbone.append({
            'dw_w': move(p['dw_w'], torch.bfloat16),
            'dw_b': move(p['dw_b'], torch.float32),
            'pw_w8': qw.t(),
            'pw_alpha': w_scale / _divisor(pw, QSCALE),
            'pw_corr': qw.sum(1, dtype=torch.int32) * 127,
            'pw_b': move(p['pw_b'], torch.float32),
        })
    heads = {name: {'w': move(hp['w'], torch.bfloat16), 'b': move(hp['b'], torch.float32)}
             for name, hp in params['heads'].items()}
    return {'backbone': backbone, 'heads': heads}


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) s8 @ (K, N) s8 -> (M, N) s32, by `torch._int_mm`. A product
    of fewer than 17 rows (a one-frame batch at a small grid) is padded
    with zero rows, which are cut off again."""
    m = a.shape[0]
    if m < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_INT_MM_MIN_ROWS - m, a.shape[1]))])
    return torch._int_mm(a, b)[:m]


def _pw_int8(q: torch.Tensor, layer: Dict[str, Any]) -> torch.Tensor:
    """The quantized pointwise conv: (B, H, W, C_in) s8 -> (B, H, W, C_out)
    float32, bias added, before ReLU6."""
    b, h, w, ci = q.shape
    acc = int8_matmul(q.reshape(-1, ci), layer['pw_w8'])         # (BHW, C_out)
    y = (acc + layer['pw_corr']).float() * layer['pw_alpha'] + layer['pw_b']
    return y.reshape(b, h, w, -1)


def _conv_bf16_relu6(x, w, b, *, stride, dilation, groups=1):
    """bf16 conv, then its bias rounded to bf16 and added in bf16, then
    ReLU6, as the JAX package's `_conv2d` and `_relu6` compute them."""
    pad = mobilenet_v1.torch_same_padding(w.shape[-1], stride, dilation)
    y = F.conv2d(x, w, None, stride=stride, padding=pad, dilation=dilation,
                 groups=groups)
    return F.relu6(y + b.to(torch.bfloat16)[:, None, None])


def run_sep_layer(q: torch.Tensor, layer: Dict[str, Any], p: Dict[str, Any]) -> torch.Tensor:
    """One separable `stride_plan` layer on its s8 input: the bf16 depthwise
    of the dequantized input, quantized, the s8 pointwise product and its
    epilogue, ReLU6; returns the float32 output. Input and output are NCHW
    in channels_last memory, whose NHWC rows the product reads."""
    y = _conv_bf16_relu6(_dequantize_act(q, torch.bfloat16), p['dw_w'], p['dw_b'],
                         stride=layer['stride'], dilation=layer['rate'], groups=q.shape[1])
    y = _pw_int8(_quantize_act(y).permute(0, 2, 3, 1), p).clamp(0.0, 6.0)
    return y.permute(0, 3, 1, 2)


def forward_quantized(qparams: Dict[str, Any], x_nhwc: torch.Tensor,
                      cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The int8 trunk + the float32 heads. Same contract as
    `mobilenet_v1.forward` (NHWC input in [-1, 1], a dict of NHWC heads),
    over `quantize_params`' pytree on the device of `x_nhwc`. The trunk
    runs NCHW tensors in channels_last memory, as the float trunk does."""
    plan = mobilenet_v1.stride_plan(cfg.model_id, cfg.output_stride)
    p0 = qparams['backbone'][0]
    x = x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2)
    q = _quantize_act(_conv_bf16_relu6(x, p0['w'], p0['b'], stride=plan[0]['stride'],
                                       dilation=plan[0]['rate']))
    for layer, p in zip(plan[1:-1], qparams['backbone'][1:-1]):
        q = _quantize_act(run_sep_layer(q, layer, p))
    # The last layer feeds the heads its bf16 features, not quantized again.
    feat = run_sep_layer(q, plan[-1], qparams['backbone'][-1]).to(torch.bfloat16)
    return mobilenet_v1.run_heads(qparams['heads'], feat)
