"""MobileNetV1 backbone + PoseNet heads in PyTorch.

The counterpart of `posenet_tpu.models.mobilenet_v1`: the same
architecture tables, stride plan, torch-style symmetric padding and
parameter pytree, with kernels stored OIHW. `forward` takes and returns the
JAX package's layouts (NHWC input in [-1, 1], a dict of NHWC heads);
inside, the trunk runs NCHW tensors in `channels_last` memory format, which
is what a permuted NHWC tensor already is.

Two modes, set by `ModelConfig.compute_dtype`:
- float32, the parity mode. On CUDA the caller turns TF32 off
  (`torch.backends.cudnn.allow_tf32` and `torch.backends.cuda.matmul.allow_tf32`)
  or cuDNN rounds the convolutions' inputs to TF32.
- bfloat16, the inference mode: bf16 activations and kernels between
  layers. Every separable layer runs as one fused block at the layer's
  stride and dilation rate (`ops.sepconv`: the CUDA kernel K2 on the card,
  its plain version on the CPU), which accumulates in float32. At stride 1
  (the rate-1 layers and the dilated ones, rate 2, and 4 at m101 s8's
  last layer) it adds its biases in float32, as the TPU kernel it
  replaces does; at stride 2 it adds them rounded to bf16, as the conv
  pair these layers ran as before does. conv0 runs a cuDNN conv with its
  bias rounded to bf16 before it is added, as the JAX package's trunk
  does.
The heads accumulate in float32 in both modes.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from posenet_tpu_torch.config import ModelConfig
from posenet_tpu_torch.ops import sepconv

# Checkpoint names per depth multiplier.
MOBILENET_V1_CHECKPOINTS = {
    50: 'mobilenet_v1_050',
    75: 'mobilenet_v1_075',
    100: 'mobilenet_v1_100',
    101: 'mobilenet_v1_101',
}

# (conv_type, in_ch, out_ch, stride) per layer. 'input' is a full 3x3
# conv, 'sep' a depthwise 3x3 + pointwise 1x1. Models 100 and 101 share a
# table and differ only in their checkpoint weights.
_ARCH_100 = [
    ('input', 3, 32, 2),
    ('sep', 32, 64, 1),
    ('sep', 64, 128, 2),
    ('sep', 128, 128, 1),
    ('sep', 128, 256, 2),
    ('sep', 256, 256, 1),
    ('sep', 256, 512, 2),
    ('sep', 512, 512, 1),
    ('sep', 512, 512, 1),
    ('sep', 512, 512, 1),
    ('sep', 512, 512, 1),
    ('sep', 512, 512, 1),
    ('sep', 512, 1024, 2),
    ('sep', 1024, 1024, 1),
]

_ARCH_75 = [
    ('input', 3, 24, 2),
    ('sep', 24, 48, 1),
    ('sep', 48, 96, 2),
    ('sep', 96, 96, 1),
    ('sep', 96, 192, 2),
    ('sep', 192, 192, 1),
    ('sep', 192, 384, 2),
    ('sep', 384, 384, 1),
    ('sep', 384, 384, 1),
    ('sep', 384, 384, 1),
    ('sep', 384, 384, 1),
    ('sep', 384, 384, 1),
    ('sep', 384, 384, 1),
    ('sep', 384, 384, 1),
]

_ARCH_50 = [
    ('input', 3, 16, 2),
    ('sep', 16, 32, 1),
    ('sep', 32, 64, 2),
    ('sep', 64, 64, 1),
    ('sep', 64, 128, 2),
    ('sep', 128, 128, 1),
    ('sep', 128, 256, 2),
    ('sep', 256, 256, 1),
    ('sep', 256, 256, 1),
    ('sep', 256, 256, 1),
    ('sep', 256, 256, 1),
    ('sep', 256, 256, 1),
    ('sep', 256, 256, 1),
    ('sep', 256, 256, 1),
]

ARCHS = {50: _ARCH_50, 75: _ARCH_75, 100: _ARCH_100, 101: _ARCH_100}

# Head name -> output channels, in the order the fused head conv emits them.
HEAD_CHANNELS = {
    'heatmap': 17,
    'offset': 34,
    'displacement_fwd': 32,
    'displacement_bwd': 32,
}

_KERNEL_KEYS = ('w', 'dw_w', 'pw_w')


def stride_plan(model_id: int, output_stride: int) -> List[Dict[str, Any]]:
    """Rewrite nominal layer strides so the net's cumulative stride equals
    `output_stride`: once it is reached, every further nominally-strided
    layer runs at stride 1 and the dilation rate multiplies up instead."""
    current_stride = 1
    rate = 1
    plan = []
    for block_id, (conv_type, inp, outp, stride) in enumerate(ARCHS[model_id]):
        if current_stride == output_stride:
            layer_stride = 1
            layer_rate = rate
            rate *= stride
        else:
            layer_stride = stride
            layer_rate = 1
            current_stride *= stride
        plan.append(dict(
            block_id=block_id, conv_type=conv_type, inp=inp, outp=outp,
            stride=layer_stride, rate=layer_rate, cumulative_stride=current_stride,
        ))
    return plan


def torch_same_padding(kernel_size: int, stride: int, dilation: int) -> int:
    """Symmetric padding ((stride-1) + dilation*(k-1)) // 2."""
    return ((stride - 1) + dilation * (kernel_size - 1)) // 2


def _conv_init(generator, shape, fan_in, device):
    """Kaiming-uniform as nn.Conv2d's default: bound = 1/sqrt(fan_in) for
    both the OIHW kernel and the bias."""
    bound = 1.0 / fan_in ** 0.5
    w = torch.empty(shape, device=generator.device).uniform_(
        -bound, bound, generator=generator)
    b = torch.empty((shape[0],), device=generator.device).uniform_(
        -bound, bound, generator=generator)
    return w.to(device), b.to(device)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str = 'cpu') -> Dict[str, Any]:
    """Random float32 parameters, drawn from `generator`, placed on `device`.

    Layout (all kernels OIHW):
      params['backbone'][i]:
        input layer:  {'w': (C,3,3,3), 'b': (C,)}
        sep layer:    {'dw_w': (C,1,3,3), 'dw_b': (C,), 'pw_w': (C2,C,1,1), 'pw_b': (C2,)}
      params['heads'][name]: {'w': (K,C_last,1,1), 'b': (K,)}
    """
    plan = stride_plan(cfg.model_id, cfg.output_stride)
    layers = []
    for layer in plan:
        inp, outp = layer['inp'], layer['outp']
        if layer['conv_type'] == 'input':
            w, b = _conv_init(generator, (outp, inp, 3, 3), 9 * inp, device)
            layers.append({'w': w, 'b': b})
        else:
            dw_w, dw_b = _conv_init(generator, (inp, 1, 3, 3), 9, device)
            pw_w, pw_b = _conv_init(generator, (outp, inp, 1, 1), inp, device)
            layers.append({'dw_w': dw_w, 'dw_b': dw_b, 'pw_w': pw_w, 'pw_b': pw_b})
    last_depth = plan[-1]['outp']
    heads = {}
    for name, ch in HEAD_CHANNELS.items():
        w, b = _conv_init(generator, (ch, last_depth, 1, 1), last_depth, device)
        heads[name] = {'w': w, 'b': b}
    return {'backbone': layers, 'heads': heads}


def cast_params(params: Dict[str, Any], dtype: torch.dtype,
                device: torch.device | str | None = None) -> Dict[str, Any]:
    """Kernels to `dtype`, biases float32 (they add into the float32
    epilogues of the heads and of the fused sepconv block; the cuDNN layers
    round them to the trunk's dtype per call), all on `device` (None: where
    they are). In bfloat16, each separable layer also gets 'dw_taps', its
    depthwise kernel in the fused block's (9, C) layout."""
    def cast_layer(layer):
        out = {k: v.to(device=device,
                       dtype=dtype if k in _KERNEL_KEYS else torch.float32)
               for k, v in layer.items()}
        if dtype == torch.bfloat16 and 'dw_w' in out:
            out['dw_taps'] = sepconv.pack_depthwise(out['dw_w'])
        return out

    return {
        'backbone': [cast_layer(l) for l in params['backbone']],
        'heads': {name: cast_layer(p) for name, p in params['heads'].items()},
    }


def _conv_relu6(x, w, b, *, stride=1, dilation=1, groups=1, pad_rows=True):
    """Conv + bias + ReLU6 with torch-style symmetric padding; `pad_rows`
    False pads the width only (the rows the padding would add are in `x`)."""
    pad = torch_same_padding(w.shape[-1], stride, dilation)
    y = F.conv2d(x, w.to(x.dtype), b.to(x.dtype), stride=stride,
                 padding=(pad if pad_rows else 0, pad), dilation=dilation, groups=groups)
    return F.relu6(y)


def _sepconv_relu6(x, p, rate, stride=1):
    """One separable layer at dilation `rate` and `stride` as the fused
    block, on the NHWC memory of the channels_last tensor `x`; returns
    channels_last."""
    c_in = x.shape[1]
    taps = p.get('dw_taps')
    if taps is None:   # parameters not cast by `cast_params`
        taps = sepconv.pack_depthwise(p['dw_w'])
    pw_w = p['pw_w'].to(torch.bfloat16).reshape(-1, c_in)
    y = sepconv.sepconv(x.permute(0, 2, 3, 1), taps, p['dw_b'].float(), pw_w,
                        p['pw_b'].float(), rate, stride)
    return y.permute(0, 3, 1, 2)


def uses_sepconv(layer: Dict[str, Any], cfg: ModelConfig) -> bool:
    """Whether the trunk runs this `stride_plan` layer as the fused block:
    a bf16 separable layer, at any stride and dilation rate."""
    return cfg.compute_dtype == torch.bfloat16 and layer['conv_type'] == 'sep'


def run_layer(layer: Dict[str, Any], p: Dict[str, Any], x: torch.Tensor,
              cfg: ModelConfig, row_halo: bool = False) -> torch.Tensor:
    """One `stride_plan` layer on an NCHW (channels_last) tensor.

    `row_halo`: `x` holds exactly the input rows the layer's output rows
    read, rows beyond the image as zeros (a slab of a height-sharded
    image, `parallel.spatial`), so that no row is padded: the convs pad
    the width only, and the fused block, which pads every side by the
    layer's rate, has its first and last `rate` output rows cut. At stride
    2 the slab's first row is the one above its first output row's centre,
    so the windows centre on its odd rows: one zero row above it moves them
    to the even rows the fused block centres on, and the output row that
    row adds is cut."""
    s, r = layer['stride'], layer['rate']
    if layer['conv_type'] == 'input':
        return _conv_relu6(x, p['w'], p['b'], stride=s, dilation=r, pad_rows=not row_halo)
    if uses_sepconv(layer, cfg):
        if row_halo and s > 1:
            x = F.pad(x, (0, 0, 1, 0)).contiguous(memory_format=torch.channels_last)
            return _sepconv_relu6(x, p, r, s)[:, :, 1:]
        y = _sepconv_relu6(x, p, r, s)
        return y[:, :, r:-r] if row_halo else y
    x = _conv_relu6(x, p['dw_w'], p['dw_b'], stride=s, dilation=r, groups=x.shape[1],
                    pad_rows=not row_halo)
    return _conv_relu6(x, p['pw_w'], p['pw_b'])


def run_trunk(params: Dict[str, Any], x_nhwc: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """The 14-layer trunk: NHWC input -> NCHW (channels_last) features in
    the compute dtype."""
    x = x_nhwc.to(cfg.compute_dtype).permute(0, 3, 1, 2)
    plan = stride_plan(cfg.model_id, cfg.output_stride)
    for layer, p in zip(plan, params['backbone']):
        x = run_layer(layer, p, x, cfg)
    return x


def backbone_features(params: Dict[str, Any], x_nhwc: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """The trunk only (the pre-head features, a debugging tap): NHWC input
    -> (B, R, R', C) NHWC features in the compute dtype, as the JAX
    package's `backbone_features` returns them; a view of `run_trunk`'s
    channels_last output, whose memory is NHWC. The bf16 trunk runs K2 on
    its separable layers as `forward` does. JAX's `precision=` has
    no counterpart: float32 parity on the card needs TF32 off, as
    `apps.full_float32` sets it."""
    return run_trunk(params, x_nhwc, cfg).permute(0, 2, 3, 1)


def normalize(frames_u8: torch.Tensor, params: Dict[str, Any],
              dtype: torch.dtype) -> torch.Tensor:
    """uint8 -> [-1, 1] in `dtype`, as x * (2/255) - 1; `params` is not read
    (it is, for ResNet50's mean: `resnet50.normalize`).

    The scale is rounded to `dtype` before it multiplies, as the JAX
    package's weak-typed 2/255 is; in bf16 a Python float would multiply
    unrounded and give other values for 111 of the 256 inputs. The scale
    is filled in on the device: `torch.tensor(..., device=)` would copy it
    from the host and wait for the device's queued work first."""
    scale = torch.full((), 2.0 / 255.0, dtype=dtype, device=frames_u8.device)
    return frames_u8.to(dtype) * scale - 1.0


def head_conv(heads_params: Dict[str, Any], feat: torch.Tensor) -> torch.Tensor:
    """All four 1x1 heads as ONE float32 conv over the concatenated 115
    output channels, so the trunk features are read once: (B, R, R', 115)
    NHWC, the heads' channels in `HEAD_CHANNELS` order.

    bf16 features and kernels are upcast first: every bf16 value is exact
    in float32, so this is the float32-accumulated bf16 product the JAX
    package asks for with `preferred_element_type=float32`."""
    names = tuple(HEAD_CHANNELS)
    w_all = torch.cat([heads_params[n]['w'] for n in names]).float()
    b_all = torch.cat([heads_params[n]['b'] for n in names]).float()
    return F.conv2d(feat.float(), w_all, b_all).permute(0, 2, 3, 1)


def split_heads(all_heads: torch.Tensor) -> Dict[str, torch.Tensor]:
    """`head_conv`'s 115 channels as the heads dict: the heatmap after its
    sigmoid, and the logits, offsets and displacements as channel views of
    `all_heads` (the decoder's tree walk reads them in place)."""
    c0 = HEAD_CHANNELS['heatmap']
    c1 = c0 + HEAD_CHANNELS['offset']
    c2 = c1 + HEAD_CHANNELS['displacement_fwd']
    heatmap_logits = all_heads[..., :c0]
    return {
        'heatmap': torch.sigmoid(heatmap_logits),
        'heatmap_logits': heatmap_logits,
        'offset': all_heads[..., c0:c1],
        'displacement_fwd': all_heads[..., c1:c2],
        'displacement_bwd': all_heads[..., c2:],
    }


def run_heads(heads_params: Dict[str, Any],
              feat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The heads of the trunk features `feat`: `split_heads(head_conv(...))`."""
    return split_heads(head_conv(heads_params, feat))


def forward(params: Dict[str, Any], x_nhwc: torch.Tensor,
            cfg: ModelConfig, stop_trunk_gradient: bool = False) -> Dict[str, torch.Tensor]:
    """Backbone + heads.

    Args:
      params: from `init_params`, `converter.weights.params_from_jax` or
        `cast_params`, on the device of `x_nhwc`.
      x_nhwc: (B, H, W, 3) float input in [-1, 1], H and W of the form
        output_stride*n + 1.
      stop_trunk_gradient: heads-only fine-tuning. The trunk runs under
        `torch.no_grad()` (no graph is kept for it, and the fused sepconv
        kernel, which has no backward, is never differentiated) and its
        features are detached; bf16 features are upcast to float32 before
        the heads, so that the heads' gradients are float32.
    Returns:
      dict of NHWC float32 heads: heatmap (B,R,R',17) after sigmoid,
      heatmap_logits, offset (B,R,R',34), displacement_fwd and
      displacement_bwd (B,R,R',32), with R = (H-1)/output_stride + 1.
    """
    if not stop_trunk_gradient:
        return run_heads(params['heads'], run_trunk(params, x_nhwc, cfg))
    with torch.no_grad():
        feat = run_trunk(params, x_nhwc, cfg)
    return run_heads(params['heads'], feat.detach().float())
