"""PoseNet ResNet50 in PyTorch: tfjs-models posenet's other published model
(`architecture: 'ResNet50'`), whose trunk is TF-slim's `resnet_v1_50`.

- Input: RGB pixels plus the ImageNet mean [-123.15, -115.90, -103.06], as
  tfjs's `resnet.ts` adds it (`normalize`); no scaling to [-1, 1].
- Stem: `conv1` 7x7 stride 2 to 64 channels, bias, ReLU, then a 3x3
  stride-2 max pool.
- Four blocks of bottleneck units (3, 4, 6, 3 units; bottleneck widths 64,
  128, 256, 512, outputs 4x those). A unit: 1x1, 3x3, 1x1 convs, each with
  a bias, ReLU after the first two, then relu(shortcut + residual). The
  shortcut is a 1x1 projection conv where the channel count changes (the
  first unit of each block), else the identity or `x[:, :, ::s, ::s]`.
- Strides (`unit_plan`): slim puts each block's stride (2, 2, 2, 1) on the
  3x3 conv of its last unit; once the running stride reaches the output
  stride, each later stride becomes 1 and multiplies the dilation rate of
  the 3x3 convs after it. At stride 16 block 4's three 3x3 convs run at
  rate 2 on block 3's grid.
- Heads: MobileNetV1's (`mobilenet_v1.head_conv` and `split_heads`), on
  the 2048 features.

Padding is torch-style symmetric; at the sizes PoseNet takes (stride * n +
1) TF's `SAME` padding is symmetric too. Batch norm is folded into each
conv's bias, as a converted graph holds it.

Parameters (`init_params`): `{'backbone': [...], 'heads': {...}}`, the
MobileNetV1 pytree's form, `backbone` one `{'w', 'b'}` per conv (kernels
OIHW) in the order `conv_plan` walks them. In bf16 (`cast_params`) the
trunk runs cuDNN convs on bf16 channels_last tensors; the heads run in
float32. On the card each conv that a ReLU follows is one call of cuDNN's
fused conv-bias-ReLU (`torch.cudnn_convolution_relu`), and a unit's last
conv one of its fused conv-bias-add-ReLU (`torch.cudnn_convolution_add_relu`,
the shortcut added), each sum formed in the conv's float32 epilogue before
its one rounding. Eager passes after each bf16 conv (a float32 bias add,
the residual add, the ReLU) took the b256 trunk 145.6 ms on an H100 80GB
HBM3 at 700 W, the fused calls 62.7. Off the card, which has no such ops,
the same sums run as eager passes. `cast_params` folds each projection's
bias into its unit's last conv's, on every device alike. On the card the
bf16 stem (conv, bias, ReLU and max pool) is one launch of the fused
kernel `ops.stem`, whose conv output never reaches device memory; cuDNN's
conv and `F.max_pool2d` took 15.7 ms of a b256 call on an H100 80GB HBM3
at 700 W, writing and reading back its 2.16 GB.

Each forward is traced by `profiling.span`s `resnet.stem` and
`resnet.block1` ... `resnet.block4`, and counts its trunk convs in
`convs` (53 a forward: the stem, 16 units x 3, 4 projections).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

import torch
import torch.nn.functional as F

from posenet_tpu_torch import profiling
from posenet_tpu_torch.config import ModelConfig
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.ops import stem

IMAGENET_MEAN = (-123.15, -115.90, -103.06)
STEM_CHANNELS = 64
# (bottleneck width, units, stride of the last unit) of each block.
BLOCKS = ((64, 3, 2), (128, 4, 2), (256, 6, 2), (512, 3, 1))
EXPANSION = 4
FEATURES = BLOCKS[-1][0] * EXPANSION
# The tfjs checkpoint the converter would read, were it ported.
CHECKPOINT = 'tfjs-models posenet resnet50/float/model-stride{stride}.json'

# Trunk conv launches in this process (the counter `resnet.convs`).
convs = 0


def unit_plan(output_stride: int) -> List[Dict[str, Any]]:
    """Each bottleneck unit: its block (1-4), `c_in`, bottleneck `width`,
    `c_out`, the `stride` and dilation `rate` of its 3x3 conv, and whether
    its shortcut is a 1x1 projection (`project`)."""
    current, rate, c_in, plan = 4, 1, STEM_CHANNELS, []
    for block, (width, units, block_stride) in enumerate(BLOCKS, start=1):
        for i in range(units):
            stride = block_stride if i == units - 1 else 1
            if current == output_stride:
                unit_stride, unit_rate = 1, rate
                rate *= stride
            else:
                unit_stride, unit_rate = stride, 1
                current *= stride
            c_out = width * EXPANSION
            plan.append(dict(block=block, c_in=c_in, width=width, c_out=c_out,
                             stride=unit_stride, rate=unit_rate, project=c_in != c_out))
            c_in = c_out
    return plan


def conv_plan(output_stride: int) -> List[Dict[str, Any]]:
    """(c_in, c_out, k) of every trunk conv in the order of
    `params['backbone']`: the stem, then per unit its projection (where it
    has one), then its 1x1, 3x3 and last 1x1 convs."""
    out = [dict(c_in=3, c_out=STEM_CHANNELS, k=7)]
    for u in unit_plan(output_stride):
        if u['project']:
            out.append(dict(c_in=u['c_in'], c_out=u['c_out'], k=1))
        out += [dict(c_in=u['c_in'], c_out=u['width'], k=1),
                dict(c_in=u['width'], c_out=u['width'], k=3),
                dict(c_in=u['width'], c_out=u['c_out'], k=1)]
    return out


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str = 'cpu') -> Dict[str, Any]:
    """Random float32 parameters, drawn from `generator` as MobileNetV1's
    are (nn.Conv2d's default init), placed on `device`:
      params['backbone'][i]: {'w': (C_out, C_in, k, k), 'b': (C_out,)}
      params['heads'][name]: {'w': (K, 2048, 1, 1), 'b': (K,)}"""
    backbone = []
    for c in conv_plan(cfg.output_stride):
        w, b = mobilenet_v1._conv_init(generator, (c['c_out'], c['c_in'], c['k'], c['k']),
                                       c['c_in'] * c['k'] ** 2, device)
        backbone.append({'w': w, 'b': b})
    heads = {}
    for name, ch in mobilenet_v1.HEAD_CHANNELS.items():
        w, b = mobilenet_v1._conv_init(generator, (ch, FEATURES, 1, 1), FEATURES, device)
        heads[name] = {'w': w, 'b': b}
    return {'backbone': backbone, 'heads': heads}


def cast_params(params: Dict[str, Any], dtype: torch.dtype,
                device: torch.device | str | None = None) -> Dict[str, Any]:
    """The parameters as `forward` runs them, on `device` (None: where they
    are): trunk kernels in `dtype` and channels_last memory, trunk biases in
    `dtype` (cuDNN's fused ops take the input's dtype, and add the bias in
    their float32 epilogue), the heads in float32, and 'mean', the ImageNet
    mean on the device for `normalize` (so that a call copies nothing from
    the host).

    Each projection's bias is folded into its unit's last conv's bias, in
    float32 before the one rounding to `dtype`, and the projection keeps
    none: both add into the same sum, and on the card the last conv's fused
    epilogue adds it where a bias on a conv without a ReLU would take an
    eager pass of its own (7.5 ms of a b256 call on an H100 80GB HBM3 at
    700 W). The card and the CPU run the same sums."""
    backbone = [dict(p) for p in params['backbone']]
    i = 1   # after the stem; which units project is the same at every output stride
    for u in unit_plan(16):
        if u['project']:
            project = backbone[i]
            backbone[i] = {'w': project['w']}
            backbone[i + 3] = {'w': backbone[i + 3]['w'],
                               'b': backbone[i + 3]['b'].float() + project['b'].float()}
        i += 4 if u['project'] else 3

    def trunk_conv(p):
        out = {'w': p['w'].to(device=device, dtype=dtype).contiguous(
                   memory_format=torch.channels_last)}
        if 'b' in p:
            out['b'] = p['b'].to(device=device, dtype=dtype)
        return out
    return {
        'backbone': [trunk_conv(p) for p in backbone],
        'heads': {name: {k: v.to(device=device, dtype=torch.float32) for k, v in p.items()}
                  for name, p in params['heads'].items()},
        'mean': torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
    }


def normalize(frames_u8: torch.Tensor, params: Dict[str, Any],
              dtype: torch.dtype) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> RGB plus the ImageNet mean `params['mean']`
    (float32, on the frames' device; `cast_params`), in `dtype`. One pass:
    each sum is formed in float32 and rounded once to `dtype`. In bfloat16
    that rounding moves a value by at most 0.5 (values lie in [-123.15,
    151.94], where 8 significant bits leave steps of 0.5 from 64 to 128 and
    of 1 above)."""
    out = torch.empty(frames_u8.shape, dtype=dtype, device=frames_u8.device)
    return torch.add(frames_u8, params['mean'], out=out)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, stride: int = 1,
          rate: int = 1, relu: bool = True, add: torch.Tensor | None = None) -> torch.Tensor:
    """One trunk conv with torch-style symmetric padding: conv(x, w) + b
    (+ `add`), then the ReLU where `relu`, in `x`'s dtype. On the card, with
    a ReLU, one fused cuDNN call."""
    global convs
    convs += 1
    w = w.to(x.dtype)
    b = None if b is None else b.to(x.dtype)
    pad = mobilenet_v1.torch_same_padding(w.shape[-1], stride, rate)
    if x.is_cuda and relu:
        geometry = ((stride, stride), (pad, pad), (rate, rate), 1)
        if add is None:
            return torch.cudnn_convolution_relu(x, w, b, *geometry)
        return torch.cudnn_convolution_add_relu(x, w, add, 1.0, b, *geometry)
    y = F.conv2d(x, w, b, stride=stride, padding=pad, dilation=rate)
    if add is not None:
        y = y.add_(add)
    return F.relu_(y) if relu else y


def _unit(x: torch.Tensor, u: Dict[str, Any], params: Iterator) -> torch.Tensor:
    """One bottleneck unit; `params` yields its convs' parameters in
    `conv_plan` order (a projection without 'b' has had its bias folded
    into the last conv's, `cast_params`)."""
    s = u['stride']
    if u['project']:
        project = next(params)
        shortcut = _conv(x, project['w'], project.get('b'), stride=s, relu=False)
    else:
        shortcut = x[:, :, ::s, ::s].contiguous(memory_format=torch.channels_last)
    p = next(params)
    r = _conv(x, p['w'], p['b'])
    p = next(params)
    r = _conv(r, p['w'], p['b'], stride=s, rate=u['rate'])
    p = next(params)
    return _conv(r, p['w'], p['b'], add=shortcut)


def uses_stem_kernel(x_nhwc: torch.Tensor) -> bool:
    """Whether the stem runs as the fused kernel (`ops.stem`): a bf16
    input on the card. Float32 and the CPU take `_conv` and
    `F.max_pool2d`."""
    return x_nhwc.is_cuda and x_nhwc.dtype == torch.bfloat16


def run_stem(x_nhwc: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """The stem on NHWC input in the compute dtype -> (B, 64, H', W')
    channels_last: conv 7x7/2 + bias, ReLU, max pool 3x3/2. One launch of
    the fused kernel where `uses_stem_kernel`, else `_conv` and
    `F.max_pool2d`; one conv of `convs` either way."""
    global convs
    if uses_stem_kernel(x_nhwc):
        convs += 1
        # No-ops for `cast_params`'s parameters; `init_params`'s (float32,
        # NCHW memory) are cast here, as `_conv` casts its kernels.
        return stem.stem(x_nhwc, p['w'].to(torch.bfloat16, memory_format=torch.channels_last),
                         p['b'].to(torch.bfloat16))
    return F.max_pool2d(_conv(x_nhwc.permute(0, 3, 1, 2), p['w'], p['b'], stride=2), 3,
                        stride=2, padding=1)


def run_trunk(params: Dict[str, Any], x_nhwc: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """NHWC input (RGB plus the mean) -> (B, 2048, R, R') features in the
    compute dtype, channels_last; one span for the stem (`run_stem`) and
    one a block. The input is made NHWC-contiguous in the compute dtype
    (a no-op for `normalize`'s output; one pass for a permuted NCHW input,
    as `PoseNet.forward` passes it)."""
    x_nhwc = x_nhwc.to(cfg.compute_dtype, memory_format=torch.contiguous_format)
    conv_params = iter(params['backbone'])
    with profiling.span('resnet.stem', x_nhwc.device):
        x = run_stem(x_nhwc, next(conv_params))
    plan = unit_plan(cfg.output_stride)
    for block in range(1, len(BLOCKS) + 1):
        with profiling.span(f'resnet.block{block}', x.device):
            for u in plan:
                if u['block'] == block:
                    x = _unit(x, u, conv_params)
    return x


def forward(params: Dict[str, Any], x_nhwc: torch.Tensor,
            cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Trunk + heads.

    Args:
      params: from `init_params` or `cast_params`, on the device of `x_nhwc`.
      x_nhwc: (B, H, W, 3) RGB plus the ImageNet mean (`normalize`), H and W
        of the form output_stride * n + 1.
    Returns:
      the heads as `mobilenet_v1.forward` returns them: NHWC float32
      heatmap (B, R, R', 17) after its sigmoid, heatmap_logits, offset (34),
      displacement_fwd and displacement_bwd (32).
    """
    return mobilenet_v1.run_heads(params['heads'], run_trunk(params, x_nhwc, cfg))
