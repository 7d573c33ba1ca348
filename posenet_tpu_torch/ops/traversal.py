"""The decoder's K-parallel tree walk: CUDA kernel, plain version, and the
wrapper that picks between them by device.

`traverse_all_candidates` replaces the TPU kernel
`traverse_all_candidates_pallas` (posenet_tpu/ops/pallas/traversal.py:551)
with the hand-written CUDA kernel in `csrc/traversal.cu`: one thread per
candidate, its state in registers, the walk's fetches batched by tree
level. On Hopper it is bound by the latency of its 16 dependent row
fetches, not by bandwidth or arithmetic (see the kernel source).

`traverse_all_candidates_reference` is the plain PyTorch version, a port of
the JAX package's level-batched gather walk (`decode._traverse_all_candidates`).
CPU tensors go through it; the tests and `chip_smoke.py` hold the kernel
to it bit for bit. The kernel is registered as the custom op
`posenet_tpu_torch::traverse_all_candidates` (CUDA only, with a fake
implementation for `torch.export`), so that an exported program keeps it.

Shapes: cand_scores (B,K) f32, cand_kp (B,K) int32, root_coords (B,K,2)
f32; the heads as rows, each (B,H*W,C) f32: scores (C=17, the heatmap),
offsets (34 = [y || x]), dfwd and dbwd (32 = [y || x]). A row tensor may
be a view with any batch and row strides, as long as its columns are
adjacent: `decode._prepare_decode` passes the offsets and displacements
as views of the forward's one 115-channel heads tensor. Returns kp_scores
(B,K,17), kp_coords and kp_offsets (B,K,17,2), all f32.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from posenet_tpu_torch.constants import NUM_EDGES, NUM_KEYPOINTS
from posenet_tpu_torch.ops import _build

# Kernel launches in this process, counted where the custom op launches,
# so that launches from a loaded `torch.export` program count too.
launches = 0

# The columns of each row tensor, in argument order.
_ROW_COLS = {'scores': NUM_KEYPOINTS, 'offsets': 2 * NUM_KEYPOINTS,
             'dfwd': 2 * NUM_EDGES, 'dbwd': 2 * NUM_EDGES}

# What the C entry returns, launching nothing, when the hop table it is
# passed is not the one compiled into the kernel.
_HOP_TABLE_MISMATCH = -1


def hop_table() -> np.ndarray:
    """(3, 32) int32: the edge, source and target keypoint of each hop, the
    16 backward hops then the 16 forward ones, in the decoder's level order
    (`decode._tree_levels`)."""
    from posenet_tpu_torch.decode import _BWD_LEVELS, _FWD_LEVELS

    hops = [hop for levels in (_BWD_LEVELS, _FWD_LEVELS)
            for level in levels for hop in level]
    return np.ascontiguousarray(np.asarray(hops, dtype=np.int32).T)


def _gather_rows(rows: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """rows (B, HW, C), cells (B, N) -> (B, N, C)."""
    return torch.gather(rows, 1, cells[..., None].expand(-1, -1, rows.shape[-1]))


def traverse_all_candidates_reference(
        cand_scores, cand_kp, root_coords, scores, offsets, dfwd, dbwd,
        h: int, w: int, output_stride: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Level-batched walk: per dependency level, one row gather at the
    stacked source cells and one at the landing cells; state is a (B, K)
    tensor per keypoint. Every operation rounds as in the JAX version."""
    from posenet_tpu_torch.decode import _BWD_LEVELS, _FWD_LEVELS

    k = cand_scores.shape[1]
    # A device tensor, not a Python number: CUDA divides by a CPU scalar
    # as a multiply by its reciprocal, which is not IEEE division.
    stride = torch.full((), float(output_stride), device=cand_scores.device)
    zero = torch.zeros_like(cand_scores)

    is_root = [cand_kp == j for j in range(NUM_KEYPOINTS)]
    scores_k = [torch.where(r, cand_scores, zero) for r in is_root]
    coords_y = [torch.where(r, root_coords[..., 0], zero) for r in is_root]
    coords_x = [torch.where(r, root_coords[..., 1], zero) for r in is_root]
    offs_y = [zero] * NUM_KEYPOINTS
    offs_x = [zero] * NUM_KEYPOINTS

    def grid_cell(coord, n):
        return torch.clamp(torch.round(coord / stride), 0.0, n - 1.0)

    def run_level(level, disp):
        src_iy = torch.cat([grid_cell(coords_y[s], h) for _, s, _ in level], 1)
        src_ix = torch.cat([grid_cell(coords_x[s], w) for _, s, _ in level], 1)
        drows = _gather_rows(disp, (src_iy * w + src_ix).long())

        disp_y = torch.cat([drows[:, i * k:(i + 1) * k, e]
                            for i, (e, _, _) in enumerate(level)], 1)
        disp_x = torch.cat([drows[:, i * k:(i + 1) * k, NUM_EDGES + e]
                            for i, (e, _, _) in enumerate(level)], 1)
        tgt_iy = grid_cell(torch.cat([coords_y[s] for _, s, _ in level], 1) + disp_y, h)
        tgt_ix = grid_cell(torch.cat([coords_x[s] for _, s, _ in level], 1) + disp_x, w)
        cells = (tgt_iy * w + tgt_ix).long()
        srows = _gather_rows(scores, cells)
        orows = _gather_rows(offsets, cells)

        for i, (_, s, t) in enumerate(level):
            sl = slice(i * k, (i + 1) * k)
            fill = (scores_k[s] > 0.0) & (scores_k[t] == 0.0)
            oy = orows[:, sl, t]
            ox = orows[:, sl, NUM_KEYPOINTS + t]
            scores_k[t] = torch.where(fill, srows[:, sl, t], scores_k[t])
            coords_y[t] = torch.where(fill, tgt_iy[:, sl] * stride + oy, coords_y[t])
            coords_x[t] = torch.where(fill, tgt_ix[:, sl] * stride + ox, coords_x[t])
            offs_y[t] = torch.where(fill, oy, offs_y[t])
            offs_x[t] = torch.where(fill, ox, offs_x[t])

    for level in _BWD_LEVELS:
        run_level(level, dbwd)
    for level in _FWD_LEVELS:
        run_level(level, dfwd)

    kp_scores = torch.stack(scores_k, dim=-1)
    kp_coords = torch.stack([torch.stack(coords_y, -1), torch.stack(coords_x, -1)], -1)
    kp_offsets = torch.stack([torch.stack(offs_y, -1), torch.stack(offs_x, -1)], -1)
    return kp_scores, kp_coords, kp_offsets


def _check_inputs(cand_scores, cand_kp, root_coords, scores, offsets, dfwd, dbwd, h, w):
    """Shapes, dtypes and devices. The layout is the op's to check: under
    `torch.export` a FakeTensor's strides are the tracer's guess of a
    convolution's layout, which on CUDA differs from the memory the card's
    convolution writes."""
    b, k = cand_scores.shape
    tensors = {'cand_scores': cand_scores, 'cand_kp': cand_kp, 'root_coords': root_coords,
               'scores': scores, 'offsets': offsets, 'dfwd': dfwd, 'dbwd': dbwd}
    expected = [('cand_scores', (b, k), torch.float32), ('cand_kp', (b, k), torch.int32),
                ('root_coords', (b, k, 2), torch.float32)]
    expected += [(name, (b, h * w, cols), torch.float32) for name, cols in _ROW_COLS.items()]
    for name, shape, dtype in expected:
        t = tensors[name]
        if t.device != cand_scores.device:
            raise ValueError(f'{name} is on {t.device}, cand_scores on {cand_scores.device}')
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f'{name}: expected {shape} {dtype}, got '
                             f'{tuple(t.shape)} {t.dtype}')
    if b == 0 or k == 0:
        raise ValueError(f'empty candidate set: B={b}, K={k}')


_kernel_cache: dict = {}


def _kernel():
    """(C entry point, hop table), built and bound at first use."""
    if not _kernel_cache:
        fn = _build.load('traversal').posenet_traverse_all_candidates
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_cache['fn'] = fn
        _kernel_cache['hops'] = hop_table()  # kept alive: passed by pointer
    return _kernel_cache['fn'], _kernel_cache['hops']


def traverse_all_candidates(
        cand_scores, cand_kp, root_coords, scores, offsets, dfwd, dbwd,
        h: int, w: int, output_stride: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tree walk for every candidate of every image.

    CPU tensors take the plain version. CUDA tensors go through the custom
    op `posenet_tpu_torch::traverse_all_candidates`, which launches the
    kernel on the current stream (no synchronisation) or raises; under
    `torch.export` the op stays in the graph as one node."""
    device = cand_scores.device
    if device.type == 'cpu':
        return traverse_all_candidates_reference(
            cand_scores, cand_kp, root_coords, scores, offsets, dfwd, dbwd,
            h, w, output_stride)
    if device.type != 'cuda':
        raise ValueError(f'no traversal for device {device}')
    _check_inputs(cand_scores, cand_kp, root_coords, scores, offsets, dfwd, dbwd, h, w)
    return tuple(torch.ops.posenet_tpu_torch.traverse_all_candidates(
        cand_scores, cand_kp, root_coords, scores, offsets, dfwd, dbwd,
        h, w, output_stride))


@torch.library.custom_op(
    'posenet_tpu_torch::traverse_all_candidates', mutates_args=(),
    device_types='cuda',
    schema='(Tensor cand_scores, Tensor cand_kp, Tensor root_coords, '
           'Tensor scores, Tensor offsets, Tensor dfwd, Tensor dbwd, int h, '
           'int w, int output_stride) -> (Tensor, Tensor, Tensor)')
def _traverse_cuda(cand_scores, cand_kp, root_coords, scores, offsets, dfwd, dbwd,
                   h, w, output_stride):
    """K1 on real CUDA tensors: one launch, counted. The wrapper checks
    shapes and dtypes; the layout the kernel's pointers assume is checked
    here, on the real memory, whose strides go to the kernel (a loaded
    `torch.export` program calls the op directly): the candidate tensors
    contiguous; each row tensor with adjacent columns (unit column stride),
    rows that do not overlap, and 4-byte alignment. Raises ValueError."""
    global launches
    for name, t in (('cand_scores', cand_scores), ('cand_kp', cand_kp),
                    ('root_coords', root_coords)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    rows = {'scores': scores, 'offsets': offsets, 'dfwd': dfwd, 'dbwd': dbwd}
    device = cand_scores.device
    for name, t in rows.items():
        if t.device != device:
            raise ValueError(f'{name} is on {t.device}, cand_scores on {device}')
        if t.stride(2) != 1 or (t.shape[1] > 1 and t.stride(1) < t.shape[2]):
            raise ValueError(f'{name} must have unit column stride and a row stride of at '
                             f'least its {t.shape[2]} columns, got strides {t.stride()}')
        if t.data_ptr() % 4:
            raise ValueError(f'{name} must be 4-byte aligned')
    strides = np.array([s for t in rows.values() for s in (t.stride(0), t.stride(1))],
                       dtype=np.int64)
    b, k = cand_scores.shape
    kp_scores = torch.empty((b, k, NUM_KEYPOINTS), dtype=torch.float32, device=device)
    kp_coords = torch.empty((b, k, NUM_KEYPOINTS, 2), dtype=torch.float32, device=device)
    kp_offsets = torch.empty_like(kp_coords)

    fn, hops = _kernel()
    with torch.cuda.device(device):
        err = fn(cand_scores.data_ptr(), cand_kp.data_ptr(), root_coords.data_ptr(),
                 *[t.data_ptr() for t in rows.values()], strides.ctypes.data,
                 kp_scores.data_ptr(), kp_coords.data_ptr(), kp_offsets.data_ptr(),
                 b, k, h, w, float(output_stride), hops.ctypes.data,
                 torch.cuda.current_stream(device).cuda_stream)
    if err == _HOP_TABLE_MISMATCH:
        raise RuntimeError('the hop table (hop_table()) differs from the one compiled '
                           'into csrc/traversal.cu; nothing was launched')
    if err != 0:
        raise RuntimeError(f'traversal kernel launch failed: cudaError {err}')
    launches += 1
    return kp_scores, kp_coords, kp_offsets


@_traverse_cuda.register_fake
def _traverse_fake(cand_scores, cand_kp, root_coords, scores, offsets, dfwd, dbwd,
                   h, w, output_stride):
    """The plain version's shapes and dtypes."""
    b, k = cand_scores.shape
    coords = cand_scores.new_empty((b, k, NUM_KEYPOINTS, 2))
    return cand_scores.new_empty((b, k, NUM_KEYPOINTS)), coords, torch.empty_like(coords)
