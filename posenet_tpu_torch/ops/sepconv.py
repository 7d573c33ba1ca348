"""The trunk's fused separable block: CUDA kernel, plain version, and the
wrapper that picks between them by device.

`sepconv` replaces the TPU kernel `sepconv_pallas`
(posenet_tpu/ops/pallas/sepconv.py:228) with the hand-written CUDA kernel
in `csrc/sepconv.cu`: depthwise 3x3 + bias + ReLU6 into shared memory,
then the pointwise 1x1 on the tensor cores + bias + ReLU6, in one pass
whose intermediate never reaches device memory. It covers the layers the
stride plan leaves at stride 1 and rate 1, in the bfloat16 trunk.

    out = relu6(pw1x1(bf16(relu6(dw3x3(x) + dw_b))) + pw_b)

`sepconv_reference` is the plain PyTorch version with the same numerics:
the depthwise sums its 9 exact bf16 x bf16 products in float32 in the
kernel's (and the TPU kernel's) tap order, so the bf16 intermediate is the
kernel's bit for bit; the pointwise is a float32 product of bf16 values,
which differs from the kernel's tensor-core sum only in the order of its
float32 additions.

The kernel is registered as the custom op `posenet_tpu_torch::sepconv`
(CUDA only, with a fake implementation for `torch.export`), so that an
exported program keeps it.

Shapes: x (B,H,W,C_in) bf16, NHWC-contiguous (the trunk's channels_last
NCHW tensor, permuted, is that memory); dw_taps (9,C_in) bf16, tap
dy*3+dx (`pack_depthwise`); dw_b (C_in,) f32; pw_w (C_out,C_in) bf16;
pw_b (C_out,) f32. C_in a multiple of 8 and C_out of 16, both at most
1024 (every stride-1 separable layer of the four models). Returns
(B,H,W,C_out) bf16, NHWC-contiguous.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from posenet_tpu_torch.ops import _build

# Kernel launches in this process, counted where the custom op launches,
# so that launches from a loaded `torch.export` program count too.
launches = 0

MAX_CHANNELS = 1024


def pack_depthwise(dw_w: torch.Tensor) -> torch.Tensor:
    """(C,1,3,3) OIHW depthwise kernel -> (9, C) bf16, tap-major, the
    layout whose per-tap rows the kernel reads as channel vectors."""
    c = dw_w.shape[0]
    return dw_w.reshape(c, 9).t().to(torch.bfloat16).contiguous()


def sepconv_reference(x_nhwc, dw_taps, dw_b, pw_w, pw_b) -> torch.Tensor:
    """Plain version: f32 taps in (dy, dx) order over a zero-padded copy,
    + f32 bias, clamp, bf16; then an f32 product of the bf16 values,
    + f32 bias, clamp, bf16."""
    b, h, w, c_in = x_nhwc.shape
    xp = F.pad(x_nhwc.float(), (0, 0, 1, 1, 1, 1))
    taps = dw_taps.float()
    acc = torch.zeros((b, h, w, c_in), dtype=torch.float32, device=x_nhwc.device)
    for t in range(9):
        dy, dx = divmod(t, 3)
        acc = acc + xp[:, dy:dy + h, dx:dx + w, :] * taps[t]
    mid = torch.clamp(acc + dw_b, 0.0, 6.0).to(torch.bfloat16)
    y = mid.float().reshape(-1, c_in) @ pw_w.float().t()
    y = torch.clamp(y + pw_b, 0.0, 6.0).to(torch.bfloat16)
    return y.reshape(b, h, w, pw_w.shape[0])


def _check_inputs(x, dw_taps, dw_b, pw_w, pw_b):
    if x.ndim != 4:
        raise ValueError(f'x must be (B, H, W, C_in), got {tuple(x.shape)}')
    b, h, w, c_in = x.shape
    c_out = pw_w.shape[0] if pw_w.ndim == 2 else -1
    if c_in % 8 or not 0 < c_in <= MAX_CHANNELS:
        raise ValueError(f'C_in must be a multiple of 8 in [8, {MAX_CHANNELS}], got {c_in}')
    if c_out % 16 or not 0 < c_out <= MAX_CHANNELS:
        raise ValueError(f'C_out must be a multiple of 16 in [16, {MAX_CHANNELS}], '
                         f'got pw_w {tuple(pw_w.shape)}')
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
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_cache['fn'] = fn
    return _kernel_cache['fn']


def sepconv(x_nhwc, dw_taps, dw_b, pw_w, pw_b) -> torch.Tensor:
    """The fused block. CPU tensors take the plain version. CUDA tensors go
    through the custom op `posenet_tpu_torch::sepconv`, which launches the
    kernel on the current stream (no synchronisation) or raises; under
    `torch.export` the op stays in the graph as one node."""
    _check_inputs(x_nhwc, dw_taps, dw_b, pw_w, pw_b)
    device = x_nhwc.device
    if device.type == 'cpu':
        return sepconv_reference(x_nhwc, dw_taps, dw_b, pw_w, pw_b)
    if device.type != 'cuda':
        raise ValueError(f'no sepconv for device {device}')
    return torch.ops.posenet_tpu_torch.sepconv(x_nhwc, dw_taps, dw_b, pw_w, pw_b)


@torch.library.custom_op(
    'posenet_tpu_torch::sepconv', mutates_args=(), device_types='cuda',
    schema='(Tensor x_nhwc, Tensor dw_taps, Tensor dw_b, Tensor pw_w, '
           'Tensor pw_b) -> Tensor')
def _sepconv_cuda(x_nhwc, dw_taps, dw_b, pw_w, pw_b):
    """K2 on real CUDA tensors: one launch, counted. The wrapper checks
    shapes and dtypes; a loaded `torch.export` program calls the op
    directly, so the layout the kernel's pointers assume is checked here
    again, with the alignment, which reads pointers a FakeTensor has not."""
    global launches
    for name, t in (('x', x_nhwc), ('dw_taps', dw_taps), ('dw_b', dw_b),
                    ('pw_w', pw_w), ('pw_b', pw_b)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous (x: NHWC memory)')
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')
    device = x_nhwc.device
    b, h, w, c_in = x_nhwc.shape
    c_out = pw_w.shape[0]
    out = torch.empty((b, h, w, c_out), dtype=torch.bfloat16, device=device)
    fn = _kernel()
    with torch.cuda.device(device):
        err = fn(x_nhwc.data_ptr(), dw_taps.data_ptr(), dw_b.data_ptr(),
                 pw_w.data_ptr(), pw_b.data_ptr(), out.data_ptr(),
                 b, h, w, c_in, c_out, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'sepconv kernel launch failed: cudaError {err}')
    launches += 1
    return out


@_sepconv_cuda.register_fake
def _sepconv_fake(x_nhwc, dw_taps, dw_b, pw_w, pw_b):
    """The plain version's shape and dtype."""
    b, h, w, _ = x_nhwc.shape
    return x_nhwc.new_empty((b, h, w, pw_w.shape[0]), dtype=torch.bfloat16)
