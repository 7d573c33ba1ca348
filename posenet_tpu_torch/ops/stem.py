"""PoseNet ResNet50's stem fused: CUDA kernel, plain version, and the
wrapper that picks between them by device.

    out = maxpool3x3_s2_pad1(bf16(relu(conv7x7_s2_pad3(x, w) + b)))

`stem` runs the hand-written CUDA kernel in `csrc/stem.cu`: the 7x7
stride-2 conv on the tensor cores, the bias, the ReLU and the 3x3
stride-2 max pool in one pass, so that the conv's output never reaches
device memory. It replaces no TPU kernel (ResNet50 has no JAX
counterpart); it replaces the stem's cuDNN conv-bias-ReLU call and
`F.max_pool2d`, which `models/resnet50.py` still runs for float32 and on
the CPU.

`stem_reference` is the plain PyTorch version with the same numerics: a
float32 conv of the bf16 values plus the float32 bias, the ReLU, the max
pool, one rounding to bf16 (rounding is monotone, so pooling before it
gives what pooling after it gives). The kernel differs from it only in
the order of its float32 additions.

The kernel is registered as the custom op `posenet_tpu_torch::stem` (CUDA
only, with a fake implementation for `torch.export`).

Shapes: x (B, H, W, 3) bf16, NHWC-contiguous (what `resnet50.normalize`
writes), H and W >= 7; w (64, 3, 7, 7) bf16 in channels_last memory (as
`resnet50.cast_params` keeps it); b (64,) bf16. Returns (B, 64, ceil(H/4),
ceil(W/4)) bf16, a channels_last tensor (the NHWC output, permuted), as
block 1 takes it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from posenet_tpu_torch.ops import _build

# Kernel launches in this process, counted where the custom op launches.
launches = 0

CHANNELS = 64
KERNEL = 7
MIN_SIZE = 7


def output_size(n: int) -> int:
    """Length of the pooled map along an input side of `n`: the conv
    halves it (rounding up), the pool halves that."""
    return ((n - 1) // 2) // 2 + 1


def stem_reference(x_nhwc, w, b) -> torch.Tensor:
    """Plain version: float32 conv of the bf16 values + float32 bias, ReLU,
    max pool, one rounding to bf16; channels_last (B, 64, H', W')."""
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2).float(), w.float(), b.float(), stride=2,
                 padding=KERNEL // 2)
    y = F.max_pool2d(F.relu(y), 3, stride=2, padding=1)
    return y.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def _check_inputs(x, w, b):
    if x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f'x must be (B, H, W, 3), got {tuple(x.shape)}')
    bsz, h, wd, _ = x.shape
    if bsz < 1 or h < MIN_SIZE or wd < MIN_SIZE:
        raise ValueError(f'x must have B >= 1 and H, W >= {MIN_SIZE}, got {tuple(x.shape)}')
    expected = (('x', x, tuple(x.shape)), ('w', w, (CHANNELS, 3, KERNEL, KERNEL)),
                ('b', b, (CHANNELS,)))
    for name, t, shape in expected:
        if t.device != x.device:
            raise ValueError(f'{name} is on {t.device}, x on {x.device}')
        if tuple(t.shape) != shape or t.dtype != torch.bfloat16:
            raise ValueError(f'{name}: expected {shape} torch.bfloat16, got '
                             f'{tuple(t.shape)} {t.dtype}')
    if not is_fake(x) and not x.is_contiguous():
        raise ValueError('x must be NHWC-contiguous')
    if not is_fake(w) and not w.is_contiguous(memory_format=torch.channels_last):
        raise ValueError('w must be in channels_last memory')


_kernel_cache: dict = {}


def _kernel():
    """The C entry point, built and bound at first use."""
    if not _kernel_cache:
        fn = _build.load('stem').posenet_stem
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_cache['fn'] = fn
    return _kernel_cache['fn']


def stem(x_nhwc, w, b) -> torch.Tensor:
    """The fused stem. CPU tensors take the plain version. CUDA tensors go
    through the custom op `posenet_tpu_torch::stem`, which launches the
    kernel on the current stream (no synchronisation) or raises."""
    _check_inputs(x_nhwc, w, b)
    device = x_nhwc.device
    if device.type == 'cpu':
        return stem_reference(x_nhwc, w, b)
    if device.type != 'cuda':
        raise ValueError(f'no stem for device {device}')
    # (64, 3, 7, 7) in channels_last memory is (64, 7, 7, 3) contiguous.
    return torch.ops.posenet_tpu_torch.stem(x_nhwc, w.permute(0, 2, 3, 1), b).permute(0, 3, 1, 2)


@torch.library.custom_op('posenet_tpu_torch::stem', mutates_args=(), device_types='cuda',
                         schema='(Tensor x_nhwc, Tensor w_ohwi, Tensor b) -> Tensor')
def _stem_cuda(x_nhwc, w_ohwi, b):
    """The kernel on real CUDA tensors: one launch, counted. The wrapper
    checks shapes and dtypes; the layout the kernel's pointers assume is
    checked here again, with the output's 16-byte alignment."""
    global launches
    for name, t in (('x', x_nhwc), ('w_ohwi', w_ohwi), ('b', b)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous (x: NHWC memory)')
    bsz, h, wd, _ = x_nhwc.shape
    out = torch.empty((bsz, output_size(h), output_size(wd), CHANNELS), dtype=torch.bfloat16,
                      device=x_nhwc.device)
    if out.data_ptr() % 16:
        raise ValueError('the output must be 16-byte aligned')
    fn = _kernel()
    with torch.cuda.device(x_nhwc.device):
        err = fn(x_nhwc.data_ptr(), w_ohwi.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h, wd,
                 torch.cuda.current_stream(x_nhwc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'stem kernel launch failed: cudaError {err}')
    launches += 1
    return out


@_stem_cuda.register_fake
def _stem_fake(x_nhwc, w_ohwi, b):
    """The plain version's shape and dtype, NHWC."""
    bsz, h, wd, _ = x_nhwc.shape
    return x_nhwc.new_empty((bsz, output_size(h), output_size(wd), CHANNELS),
                            dtype=torch.bfloat16)
