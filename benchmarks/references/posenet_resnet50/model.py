"""The plain reference of PoseNet ResNet50: preprocessing and forward pass in
plain PyTorch float32, written from the layer equations of tfjs-models
`posenet` (`architecture: 'ResNet50'`) and TF-slim's `resnet_v1_50`, which
its graph was exported from. The multi-pose decode is the reference
`posenet`'s (`benchmarks/references/posenet/model.py`), which this package
imports rather than copies.

It imports nothing of the program under test, and no kernel of it: the
forward is `F.conv2d`, `F.max_pool2d`, `+` and `relu` in float32, with TF32
off (`float32_convs`) so that cuDNN computes the float32 products it is
asked for. The benchmark draws one parameter pytree from the seed and
hands it to the program and to this module; whatever the program derives
from it (bf16 casts, channels_last kernels) is worked out again here from
the float32 originals.

Layers:
- input: RGB pixels plus the ImageNet mean [-123.15, -115.90, -103.06],
  as tfjs's `resnet.ts` adds it; no scaling.
- stem: `conv1` 7x7 stride 2 to 64 channels, bias, ReLU; a 3x3 stride-2
  max pool.
- four blocks of bottleneck units, 3, 4, 6 and 3 units, bottleneck widths
  64, 128, 256, 512 and outputs 4x those. A unit: 1x1 conv, 3x3 conv,
  1x1 conv, each with a bias, ReLU after the first two, then
  relu(shortcut + residual). The shortcut is a 1x1 projection conv (with
  a bias, no ReLU) where the channel count changes, the first unit of each
  block; elsewhere the identity, or `x[:, :, ::s, ::s]` at stride s
  (slim's `subsample`, a 1x1 max pool).
- strides: slim puts each block's stride (2, 2, 2, 1) on the 3x3 conv of
  its last unit. The stem's stride is 4; once the running stride reaches
  the output stride, each later stride becomes 1 and multiplies the
  dilation rate of the 3x3 convs after it (slim's `stack_blocks_dense`).
  At stride 16, block 3's last unit runs at stride 1 and block 4's three
  3x3 convs at rate 2; at stride 32 nothing is dilated.
- four 1x1 heads on the 2048 features: heatmap (17, sigmoid), offsets
  (34 = 17 y then 17 x), forward and backward displacements (32 = 16 y
  then 16 x), as the MobileNetV1 model's.

Departures from slim, each exact at the sizes PoseNet takes or assumed:
- Padding is torch-style symmetric: (stride - 1 + rate * (k - 1)) // 2 on
  every side. At the input sizes PoseNet takes (output_stride * n + 1)
  TF's `SAME` padding of every strided conv and of the pool is symmetric
  too, and slim's `conv2d_same` pads explicitly and symmetrically, so the
  two agree there.
- Batch norm is taken as folded into each conv's bias, as a converted
  graph holds it: there is no batch-norm layer.
- slim's classifier (global pool and logits) is not part of PoseNet's
  graph and is left out.

`quantize` lets the control (`control_build` in this package) run the same
forward in a lower precision: each conv's input and kernel pass through it
before the float32 product.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmarks.references.posenet.model import HEADS

IMAGENET_MEAN = (-123.15, -115.90, -103.06)
STEM = dict(c_out=64, k=7, stride=2)
# (bottleneck width, units, stride of the last unit) of each block.
BLOCKS = ((64, 3, 2), (128, 4, 2), (256, 6, 2), (512, 3, 1))
EXPANSION = 4
FEATURES = BLOCKS[-1][0] * EXPANSION


def unit_plan(output_stride: int) -> List[dict]:
    """Each bottleneck unit: its block (1-4), channels in, bottleneck width,
    channels out, the stride and dilation rate of its 3x3 conv, and whether
    its shortcut is a projection."""
    if output_stride not in (16, 32):
        raise ValueError(f'ResNet50 takes output stride 16 or 32, got {output_stride}')
    current, rate, c_in, plan = 4, 1, STEM['c_out'], []
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


def conv_plan(output_stride: int) -> List[dict]:
    """Every conv of the trunk in the order the forward runs them, which is
    the order of `params['backbone']`: the stem, then per unit its
    projection (where it has one), its 1x1, 3x3 and last 1x1 convs. Each
    with its role, channels, kernel size, stride and rate."""
    convs = [dict(role='stem', block=0, c_in=3, c_out=STEM['c_out'], k=STEM['k'],
                  stride=STEM['stride'], rate=1)]
    for u in unit_plan(output_stride):
        if u['project']:
            convs.append(dict(role='project', block=u['block'], c_in=u['c_in'],
                              c_out=u['c_out'], k=1, stride=u['stride'], rate=1))
        convs += [dict(role='reduce', block=u['block'], c_in=u['c_in'], c_out=u['width'],
                       k=1, stride=1, rate=1),
                  dict(role='spatial', block=u['block'], c_in=u['width'], c_out=u['width'],
                       k=3, stride=u['stride'], rate=u['rate']),
                  dict(role='expand', block=u['block'], c_in=u['width'], c_out=u['c_out'],
                       k=1, stride=1, rate=1)]
    return convs


def param_shapes(output_stride: int) -> List[Tuple[tuple, Tuple[int, ...], int, str]]:
    """(pytree path, shape, fan in, conv role) of every parameter, in drawing
    order: kernels OIHW."""
    out = []
    for i, c in enumerate(conv_plan(output_stride)):
        fan_in = c['c_in'] * c['k'] ** 2
        out += [(('backbone', i, 'w'), (c['c_out'], c['c_in'], c['k'], c['k']), fan_in,
                 c['role']),
                (('backbone', i, 'b'), (c['c_out'],), fan_in, c['role'])]
    for name, ch in HEADS:
        out += [(('heads', name, 'w'), (ch, FEATURES, 1, 1), FEATURES, 'head'),
                (('heads', name, 'b'), (ch,), FEATURES, 'head')]
    return out


def draw_params(output_stride: int, seed: int, device: torch.device | str,
                kernel_gain: float = 1.0, residual_gain: float = 1.0,
                head_gain: Optional[Dict[str, float]] = None) -> Dict:
    """Float32 parameters from `seed`, drawn on `device` in one call. Each
    tensor is uniform in +-gain/sqrt(fan in): the trunk's kernels with
    `kernel_gain` (sqrt(6) is He's uniform init), each unit's last 1x1
    kernel with `kernel_gain * residual_gain` as well (without batch norm
    the residual stream would otherwise grow with every unit), the trunk's
    biases with 1, and each head's kernel and bias with `head_gain[name]`
    (default 1), which sets the spread of its outputs."""
    head_gain = head_gain or {}
    shapes = param_shapes(output_stride)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0, generator=gen)
    params: Dict = {'backbone': [dict() for _ in conv_plan(output_stride)],
                    'heads': {name: {} for name, _ in HEADS}}
    for (path, shape, fan_in, role), chunk in zip(shapes, torch.split(flat, sizes)):
        if role == 'head':
            gain = head_gain.get(path[1], 1.0)
        elif path[2] == 'w':
            gain = kernel_gain * (residual_gain if role == 'expand' else 1.0)
        else:
            gain = 1.0
        params[path[0]][path[1]][path[2]] = (chunk * (gain * fan_in ** -0.5)).reshape(shape)
    return params


def normalize(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> float32 RGB plus the ImageNet mean."""
    return frames_u8.float() + torch.tensor(IMAGENET_MEAN, device=frames_u8.device)


@contextlib.contextmanager
def float32_convs():
    """TF32 off for the enclosed block, restored after."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _conv(x, p, c, quantize=None):
    w = p['w']
    if quantize is not None:
        x, w = quantize(x), quantize(w)
    pad = ((c['stride'] - 1) + c['rate'] * (c['k'] - 1)) // 2
    return F.conv2d(x, w, p['b'], stride=c['stride'], padding=pad, dilation=c['rate'])


def trunk(params: Dict, x_nhwc: torch.Tensor, output_stride: int,
          quantize: Optional[Callable] = None, taps: Optional[Dict[str, torch.Tensor]] = None
          ) -> torch.Tensor:
    """(B, H, W, 3) float32 input (RGB plus the mean) -> (B, 2048, R, R')
    float32 features. `taps`, where given, receives each block's output
    under 'stem' and 'block1' ... 'block4'."""
    convs = iter(zip(conv_plan(output_stride), params['backbone']))

    def conv(x):
        c, p = next(convs)
        return _conv(x, p, c, quantize)
    x = x_nhwc.permute(0, 3, 1, 2).float()
    x = F.max_pool2d(torch.relu(conv(x)), 3, stride=2, padding=1)
    if taps is not None:
        taps['stem'] = x
    for u in unit_plan(output_stride):
        s = u['stride']
        shortcut = conv(x) if u['project'] else x[:, :, ::s, ::s]
        r = torch.relu(conv(torch.relu(conv(x))))
        x = torch.relu(shortcut + conv(r))
        if taps is not None:
            taps[f"block{u['block']}"] = x
    return x


def forward(params: Dict, x_nhwc: torch.Tensor, output_stride: int,
            quantize: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) float32 input (RGB plus the mean) -> NHWC float32 heads:
    'heatmap' after its sigmoid (B, R, R', 17), 'offset' (34),
    'displacement_fwd' and 'displacement_bwd' (32); H, W of the form
    output_stride * n + 1, R = (H - 1) / output_stride + 1."""
    with float32_convs():
        feat = trunk(params, x_nhwc, output_stride, quantize)
        heads = {name: _conv(feat, params['heads'][name],
                             dict(k=1, stride=1, rate=1), quantize).permute(0, 2, 3, 1)
                 for name, _ in HEADS}
    heads['heatmap'] = torch.sigmoid(heads['heatmap'])
    return heads
