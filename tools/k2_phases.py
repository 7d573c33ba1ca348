#!/usr/bin/env python3
"""Where K2's time goes on the card: the fused sepconv kernel
(posenet_tpu_torch/csrc/sepconv.cu) built as it is and with phases cut
out, each timed by CUDA events at each K2 launch of one forward of each
cell of BENCHMARK.json, at the cell's batch (`chip_smoke.cell_kernel_shapes`).

    python3 tools/k2_phases.py     # needs an NVIDIA GPU (sm_90a) and nvcc

Variants, each a text edit of the source compiled with the port's nvcc
flags into posenet_tpu_torch/_build/k2_phases/:
  kernel               the source as it is, held to its plain version
  no_depthwise         the depthwise's loads and arithmetic cut (the A tile
                       is written as zeros): products, weight copies,
                       epilogue and the block's overhead
  skeleton             no depthwise and no products: the weight copies,
                       barriers and epilogue stores
  skeleton_no_weights  the skeleton without the weight copies
The cut variants compute wrong outputs by design; only `kernel` is
checked, at rate 1, at the dilated layers' rates and at stride 2. Prints
the card's name and power limit, one line per shape of a cell's layers
(the variants timed in turns, forward then backward, mean of both, beside
the layer's bound `chip_smoke.k2_launch_bound_ms`; a shape timed once for
all the layers that have it), and the sums over each cell's launches, the
stride-2 layers' among them.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from posenet_tpu_torch.ops import _build, sepconv  # noqa: E402

SOURCE = os.path.join(REPO, 'posenet_tpu_torch', 'csrc', 'sepconv.cu')
OUT_DIR = os.path.join(str(_build.BUILD_DIR), 'k2_phases')

NO_DEPTHWISE = ('      if (m < m_total) {', '      if (false) {')
NO_PRODUCTS = ('      Wgmma<BN>::mma(acc,', '      if (false) Wgmma<BN>::mma(acc,')
NO_WEIGHTS = ('        cp_async16(dst + n * kRow', '        if (false) cp_async16(dst + n * kRow')
VARIANTS = {
    'kernel': (),
    'no_depthwise': (NO_DEPTHWISE,),
    'skeleton': (NO_DEPTHWISE, NO_PRODUCTS),
    'skeleton_no_weights': (NO_DEPTHWISE, NO_PRODUCTS, NO_WEIGHTS),
}


def build(name: str) -> str:
    """Compile the variant; returns the library's path. Raises with nvcc's
    output if it fails, or if an edit no longer matches the source."""
    src = open(SOURCE).read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f'{name}: {old!r} is not in {SOURCE} exactly once')
        src = src.replace(old, new)
    cu = os.path.join(OUT_DIR, f'{name}.cu')
    with open(cu, 'w') as f:
        f.write(src)
    lib = os.path.join(OUT_DIR, f'{name}.so')
    done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-o', lib, cu],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f'nvcc failed on {name}:\n{done.stdout}{done.stderr}')
    return lib


def bind(lib: str):
    fn = ctypes.CDLL(lib).posenet_sepconv
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, args, rate=1, stride=1):
    x, taps, dw_b, pw_w, pw_b = args
    b, h, w, c_in = x.shape
    out = torch.empty((b, *sepconv.out_hw(h, w, stride), pw_w.shape[0]), dtype=torch.bfloat16,
                      device=x.device)
    err = fn(x.data_ptr(), taps.data_ptr(), dw_b.data_ptr(), pw_w.data_ptr(),
             pw_b.data_ptr(), out.data_ptr(), b, h, w, c_in, pw_w.shape[0], rate, stride,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'launch failed: cudaError {err}')
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('k2_phases: no CUDA device', file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         check=True, capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device('cuda', 0)
    os.makedirs(OUT_DIR, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = {name: bind(lib) for name, lib in zip(VARIANTS, pool.map(build, VARIANTS))}
    layers_of = {}   # (cell, shape) -> the cell's launches of that shape
    for cell in chip_smoke.benchmark_cells():
        for s in chip_smoke.cell_kernel_shapes(cell):
            if s['kernel'] == 'K2':
                shape = tuple(s[k] for k in ('batch', 'h_in', 'w_in', 'c_in', 'c_out', 'rate',
                                             'stride'))
                layers_of.setdefault((cell, shape), []).append(s)
    for i, (_, (_, h, w, c_in, c_out, rate, stride)) in enumerate(layers_of):
        args = chip_smoke.k2_inputs(2, h, w, c_in, c_out, i, dev)
        if not chip_smoke.k2_close(launch(fns['kernel'], args, rate, stride), args, rate,
                                   stride)[0]:
            raise SystemExit(f'k2_phases: the kernel differs from its plain version at '
                             f'{h}x{w} {c_in}->{c_out} rate {rate} stride {stride}')
    totals = {}
    for i, ((cell, (b, h, w, c_in, c_out, rate, stride)), same) in enumerate(layers_of.items()):
        args = chip_smoke.k2_inputs(b, h, w, c_in, c_out, 100 + i, dev)
        runs = {}
        for name in list(fns) + list(fns)[::-1]:
            runs.setdefault(name, []).append(
                chip_smoke.cuda_ms(lambda: launch(fns[name], args, rate, stride), 20))
        ms = {name: sum(v) / len(v) for name, v in runs.items()}
        ms['bound'] = chip_smoke.k2_launch_bound_ms(same[0])
        parts = ('the K2 launches of one forward', 'its stride-2 K2 launches')
        for part in parts[:2 if stride > 1 else 1]:
            total = totals.setdefault((cell, part), dict.fromkeys(ms, 0.0))
            for name, t in ms.items():
                total[name] += len(same) * t
        layers = [s['layer'] for s in same]
        print(f'{cell} layer{"s" * (len(layers) > 1)} {", ".join(map(str, layers))} b{b} '
              f'{h}x{w} {c_in}->{c_out} rate {rate} stride {stride}: ' +
              ', '.join(f'{name} {t:.4f} ms a layer' for name, t in ms.items()), flush=True)
        del args
        torch.cuda.empty_cache()
    for (cell, part), total in totals.items():
        print(f'{cell}, {part}: ' + ', '.join(f'{name} {t:.4f} ms' for name, t in total.items()))
    return 0


if __name__ == '__main__':
    sys.exit(main())
