"""The trunk's fused separable block: CUDA kernel, plain version, and the
wrapper that picks between them by device.

`sepconv` replaces the TPU kernel `sepconv_pallas`
(posenet_tpu/ops/pallas/sepconv.py:228) with the hand-written CUDA kernel
in `csrc/sepconv.cu`: depthwise 3x3 + bias + ReLU6 into shared memory,
then the pointwise 1x1 on the tensor cores + bias + ReLU6, in one pass
whose intermediate never reaches device memory. It covers every separable
layer of the bfloat16 trunk:
- stride 1 at any dilation `rate`: the depthwise's taps lie `rate` pixels
  apart, (y + dy * rate, x + dx * rate) for dy, dx in -1, 0, 1, with
  `rate` zero rows and columns of padding on each side (the output keeps
  the input's size);
- stride 2 at rate 1: output pixel (y, x) reads input (2y + dy, 2x + dx),
  one zero row and column of padding on each side (the trunk's torch-style
  symmetric padding), so an (H, W) input gives ((H - 1) // 2 + 1,
  (W - 1) // 2 + 1).

    out = relu6(pw1x1(bf16(relu6(dw3x3(x) + dw_b))) + pw_b)

`sepconv_reference` is the plain PyTorch version with the same numerics:
the depthwise sums its 9 exact bf16 x bf16 products in float32 in the
kernel's (and the TPU kernel's) tap order, so the bf16 intermediate is the
kernel's bit for bit; the pointwise is a float32 product of bf16 values,
which differs from the kernel's tensor-core sum only in the order of its
float32 additions. Each float32 sum takes its bias before the one
rounding to bf16: at stride 1 the float32 bias, as the TPU kernel does; at
stride 2 the bias rounded to bf16, as the conv pair these layers ran as
before (`F.conv2d` with the bias cast to bf16) does on the CPU, so that
there the plain version is that conv pair bit for bit.

The kernel is registered as the custom op `posenet_tpu_torch::sepconv`
(CUDA only, with a fake implementation for `torch.export`), so that an
exported program keeps it.

Shapes: x (B,H,W,C_in) bf16, NHWC-contiguous (the trunk's channels_last
NCHW tensor, permuted, is that memory); dw_taps (9,C_in) bf16, tap
dy*3+dx (`pack_depthwise`); dw_b (C_in,) f32; pw_w (C_out,C_in) bf16;
pw_b (C_out,) f32. C_in a multiple of 8 and C_out of 16, both at most
1024, C_in at most 512 at stride 2 (every separable layer of the four
models); `rate` an int >= 1 (1, 2 or 4 in the four models), `stride` 1 or
2, stride 2 only at rate 1. Returns (B,H',W',C_out) bf16, NHWC-contiguous.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from posenet_tpu_torch.ops import _build

# Kernel launches in this process, counted where the custom op launches,
# so that launches from a loaded `torch.export` program count too; those
# at stride 2 are counted again in `strided_launches`.
launches = 0
strided_launches = 0

MAX_CHANNELS = 1024
MAX_STRIDED_CHANNELS = 512


def pack_depthwise(dw_w: torch.Tensor) -> torch.Tensor:
    """(C,1,3,3) OIHW depthwise kernel -> (9, C) bf16, tap-major, the
    layout whose per-tap rows the kernel reads as channel vectors."""
    c = dw_w.shape[0]
    return dw_w.reshape(c, 9).t().to(torch.bfloat16).contiguous()


def out_hw(h: int, w: int, stride: int):
    """The block's output map for an (h, w) input."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def sepconv_reference(x_nhwc, dw_taps, dw_b, pw_w, pw_b, rate: int = 1,
                      stride: int = 1) -> torch.Tensor:
    """Plain version: f32 taps `rate` apart in (dy, dx) order over a copy
    zero-padded by `rate` on each side, every `stride`-th pixel; + bias,
    clamp, bf16; then an f32 product of the bf16 values, + bias, clamp,
    bf16. The biases are float32 at stride 1, rounded to bf16 at stride 2
    (`_bias_relu6`)."""
    b, _, _, c_in = x_nhwc.shape
    h, w = out_hw(x_nhwc.shape[1], x_nhwc.shape[2], stride)
    xp = F.pad(x_nhwc.float(), (0, 0, rate, rate, rate, rate))
    taps = dw_taps.float()
    acc = torch.zeros((b, h, w, c_in), dtype=torch.float32, device=x_nhwc.device)
    for t in range(9):
        dy, dx = (rate * i for i in divmod(t, 3))
        acc = acc + xp[:, dy:dy + stride * (h - 1) + 1:stride,
                       dx:dx + stride * (w - 1) + 1:stride, :] * taps[t]
    mid = _bias_relu6(acc, dw_b, stride)
    y = mid.float().reshape(-1, c_in) @ pw_w.float().t()
    return _bias_relu6(y, pw_b, stride).reshape(b, h, w, pw_w.shape[0])


def _bias_relu6(acc, bias, stride):
    """The float32 sum `acc` plus `bias`, clamped to [0, 6], rounded once
    to bf16; at stride 2 the bias is rounded to bf16 first."""
    if stride == 2:
        bias = bias.to(torch.bfloat16).float()
    return torch.clamp(acc + bias, 0.0, 6.0).to(torch.bfloat16)


def _check_inputs(x, dw_taps, dw_b, pw_w, pw_b, rate, stride):
    if not isinstance(rate, int) or rate < 1:
        raise ValueError(f'rate must be an int >= 1, got {rate!r}')
    if not isinstance(stride, int) or stride not in (1, 2):
        raise ValueError(f'stride must be 1 or 2, got {stride!r}')
    if stride == 2 and rate > 1:
        raise ValueError(f'stride 2 runs at rate 1 only, got rate {rate}')
    if x.ndim != 4:
        raise ValueError(f'x must be (B, H, W, C_in), got {tuple(x.shape)}')
    b, h, w, c_in = x.shape
    c_out = pw_w.shape[0] if pw_w.ndim == 2 else -1
    if c_in % 8 or not 0 < c_in <= MAX_CHANNELS:
        raise ValueError(f'C_in must be a multiple of 8 in [8, {MAX_CHANNELS}], got {c_in}')
    if c_out % 16 or not 0 < c_out <= MAX_CHANNELS:
        raise ValueError(f'C_out must be a multiple of 16 in [16, {MAX_CHANNELS}], '
                         f'got pw_w {tuple(pw_w.shape)}')
    if stride == 2 and c_in > MAX_STRIDED_CHANNELS:
        raise ValueError(f'C_in must be at most {MAX_STRIDED_CHANNELS} at stride 2, got {c_in}')
    if b * h * w == 0:
        raise ValueError(f'empty input {tuple(x.shape)}')
    expected = (
        ('x', x, (b, h, w, c_in), torch.bfloat16),
        ('dw_taps', dw_taps, (9, c_in), torch.bfloat16),
        ('dw_b', dw_b, (c_in,), torch.float32),
        ('pw_w', pw_w, (c_out, c_in), torch.bfloat16),
        ('pw_b', pw_b, (c_out,), torch.float32),
    )
    for name, t, shape, dtype in expected:
        if t.device != x.device:
            raise ValueError(f'{name} is on {t.device}, x on {x.device}')
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f'{name}: expected {shape} {dtype}, got '
                             f'{tuple(t.shape)} {t.dtype}')
        # A FakeTensor's strides (under `torch.export`) are the tracer's
        # guess of a convolution's layout, which on CUDA differs from the
        # channels_last memory the card's convolution writes; the op checks
        # the real memory when it runs.
        if not t.is_contiguous() and not is_fake(t):
            raise ValueError(f'{name} must be contiguous (x: NHWC memory, as a '
                             f'channels_last NCHW tensor permuted to NHWC)')


_kernel_cache: dict = {}


def _kernel():
    """The C entry point, built and bound at first use."""
    if not _kernel_cache:
        fn = _build.load('sepconv').posenet_sepconv
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_cache['fn'] = fn
    return _kernel_cache['fn']


def sepconv(x_nhwc, dw_taps, dw_b, pw_w, pw_b, rate: int = 1, stride: int = 1) -> torch.Tensor:
    """The fused block at dilation `rate` and `stride`. CPU tensors take
    the plain version. CUDA tensors go through the custom op
    `posenet_tpu_torch::sepconv`, which launches the kernel on the current
    stream (no synchronisation) or raises; under `torch.export` the op
    stays in the graph as one node."""
    _check_inputs(x_nhwc, dw_taps, dw_b, pw_w, pw_b, rate, stride)
    device = x_nhwc.device
    if device.type == 'cpu':
        return sepconv_reference(x_nhwc, dw_taps, dw_b, pw_w, pw_b, rate, stride)
    if device.type != 'cuda':
        raise ValueError(f'no sepconv for device {device}')
    return torch.ops.posenet_tpu_torch.sepconv(x_nhwc, dw_taps, dw_b, pw_w, pw_b, rate, stride)


# `rate` and `stride` are last, with defaults, so that programs exported
# before the op took them still load and run at rate 1 and stride 1.
@torch.library.custom_op(
    'posenet_tpu_torch::sepconv', mutates_args=(), device_types='cuda',
    schema='(Tensor x_nhwc, Tensor dw_taps, Tensor dw_b, Tensor pw_w, '
           'Tensor pw_b, int rate=1, int stride=1) -> Tensor')
def _sepconv_cuda(x_nhwc, dw_taps, dw_b, pw_w, pw_b, rate=1, stride=1):
    """K2 on real CUDA tensors: one launch, counted. The wrapper checks
    shapes and dtypes; a loaded `torch.export` program calls the op
    directly, so the layout the kernel's pointers assume is checked here
    again, with the alignment, which reads pointers a FakeTensor has not,
    the rate and the stride."""
    global launches, strided_launches
    if rate < 1:
        raise ValueError(f'rate must be >= 1, got {rate}')
    c_in = x_nhwc.shape[3]
    if stride not in (1, 2) or (stride == 2 and (rate > 1 or c_in > MAX_STRIDED_CHANNELS)):
        raise ValueError(f'stride {stride} at rate {rate} and C_in {c_in}: stride must be 1, '
                         f'or 2 at rate 1 and C_in <= {MAX_STRIDED_CHANNELS}')
    for name, t in (('x', x_nhwc), ('dw_taps', dw_taps), ('dw_b', dw_b),
                    ('pw_w', pw_w), ('pw_b', pw_b)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous (x: NHWC memory)')
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')
    device = x_nhwc.device
    b, h, w, _ = x_nhwc.shape
    c_out = pw_w.shape[0]
    out = torch.empty((b, *out_hw(h, w, stride), c_out), dtype=torch.bfloat16, device=device)
    fn = _kernel()
    with torch.cuda.device(device):
        err = fn(x_nhwc.data_ptr(), dw_taps.data_ptr(), dw_b.data_ptr(),
                 pw_w.data_ptr(), pw_b.data_ptr(), out.data_ptr(),
                 b, h, w, c_in, c_out, rate, stride,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'sepconv kernel launch failed: cudaError {err}')
    launches += 1
    if stride == 2:
        strided_launches += 1
    return out


@_sepconv_cuda.register_fake
def _sepconv_fake(x_nhwc, dw_taps, dw_b, pw_w, pw_b, rate=1, stride=1):
    """The plain version's shape and dtype."""
    b, h, w, _ = x_nhwc.shape
    return x_nhwc.new_empty((b, *out_hw(h, w, stride), pw_w.shape[0]), dtype=torch.bfloat16)
