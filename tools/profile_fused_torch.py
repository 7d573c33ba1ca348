"""Device profile of the port's headline step (`bench_torch.fused_step`:
the bf16 forward on frames + the multi-pose decode on peaked heads, b128
513x513 m101 s16), the counterpart of `tools/profile_fused.py`.

After one warm call it traces `--iters` steps with
`posenet_tpu_torch.profiling.trace` and prints the table of device time by
kernel (`device_time_report`), then, from the same trace: the busy union
of the device's intervals (kernels, copies, memsets), the wall time of the
traced window (host clock, closed by a synchronize), the idle share
(1 - busy / wall), and device ms by kind of kernel (K2 `sepconv`, K1
`traverse`, cuDNN convs, sort / top-k, copies, the rest). Every ms is
summed over the `--iters` steps; the per-step figures divide by it. The
profiler's own host cost is inside the wall time, so the idle share is an
upper bound.

    python3 tools/profile_fused_torch.py [--iters 5] [--batch 128]
    python3 tools/profile_fused_torch.py --model 101 --output_stride 8 \\
        --height 721 --width 1281 --batch 4          # another cell, same method

On the CPU (`--device cpu`) the trace holds no device events, and the tool
says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from posenet_tpu_torch.apps import full_float32  # noqa: E402
from posenet_tpu_torch.models.model_factory import resolve_device  # noqa: E402
from posenet_tpu_torch.profiling import TRACE_FILE, device_time_report, trace  # noqa: E402

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
# (kind, substrings of the lower-cased kernel name), first match wins:
# PyTorch's elementwise kernels carry their functors' names, so they are
# matched before the convs' words.
KINDS = (
    ('K2 sepconv', ('sepconv',)),
    ('K1 traverse', ('traverse',)),
    ('copies', ('direct_copy', 'copy_kernel', 'catarray')),
    ('sort / top-k', ('sort', 'radix', 'topk')),
    ('elementwise and other', ('elementwise', 'reduce')),
    ('cuDNN convs', ('conv', 'fprop', 'cudnn', 'xmma', 'implicit_gemm', 'depthwise')),
)


def kind_of(event: dict) -> str:
    if event.get('cat') in ('gpu_memcpy', 'gpu_memset'):
        return 'copies'
    name = event['name'].lower()
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return 'elementwise and other'


def summarize(trace_dir: str, wall_ms: float, steps: int) -> dict:
    """The busy union of the trace's device intervals, the idle share
    against `wall_ms`, and device ms by kind; None for busy and idle when
    the trace holds no device event."""
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and e.get('cat') in DEVICE_CATEGORIES]
    by_kind = {kind: 0.0 for kind, _ in KINDS}
    spans = []
    for e in events:
        start, dur = float(e['ts']), float(e.get('dur', 0.0))
        by_kind[kind_of(e)] += dur / 1e3
        spans.append((start, start + dur))
    busy_us, end = 0.0, float('-inf')
    for lo, hi in sorted(spans):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    busy = busy_us / 1e3 if events else None
    return {'steps': steps, 'device_events': len(events), 'busy_ms': busy,
            'wall_ms': wall_ms, 'idle_share': None if busy is None else 1 - busy / wall_ms,
            'busy_ms_per_step': None if busy is None else busy / steps,
            'wall_ms_per_step': wall_ms / steps, 'device_ms_by_kind': by_kind}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--batch', type=int, default=128)
    ap.add_argument('--size', type=int, default=513)
    ap.add_argument('--height', type=int, default=0, help='overrides --size')
    ap.add_argument('--width', type=int, default=0, help='overrides --size')
    ap.add_argument('--model', type=int, default=101)
    ap.add_argument('--output_stride', type=int, default=16)
    ap.add_argument('--top', type=int, default=60)
    ap.add_argument('--trace_dir',
                    default=os.path.join(tempfile.gettempdir(), 'posenet_profile_fused_torch'))
    ap.add_argument('--device', default='cuda',
                    help="torch device: 'cuda' (default; raises without a CUDA device) "
                         "or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    full_float32()   # TF32 off, as bench_torch.py measures the step
    height = args.height or args.size
    width = args.width or args.size
    params, frames, peaked, cfg, dcfg = bench_torch.setup(
        args.model, args.output_stride, height, width, args.batch, device)
    sync = bench_torch.synchronizer(device)

    print('warming up...', flush=True)
    t0 = time.perf_counter()
    bench_torch.fused_step(params, frames, peaked, cfg, dcfg)
    sync()
    print(f'warm call done in {time.perf_counter() - t0:.1f}s', flush=True)

    with trace(args.trace_dir, device):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            bench_torch.fused_step(params, frames, peaked, cfg, dcfg)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3

    print(device_time_report(args.trace_dir, top=args.top))
    print(f'\n(n.b. durations are summed over {args.iters} iterations)')
    summary = summarize(args.trace_dir, wall_ms, args.iters)
    summary['device'] = bench_torch.device_name(device)
    if summary['busy_ms'] is None:
        print(f'no device events in the trace ({summary["device"]}): no busy time, '
              f'idle share or split by kind')
    else:
        kinds = ', '.join(f'{k} {v:.4f}' for k, v in summary['device_ms_by_kind'].items())
        print(f'busy {summary["busy_ms"]:.4f} ms (union of device intervals) of a '
              f'{wall_ms:.4f} ms traced window over {args.iters} steps: idle share '
              f'{summary["idle_share"]:.4f}; device ms by kind: {kinds} '
              f'({summary["device"]})')
    print('PROFILE ' + json.dumps(summary), flush=True)
    return summary


if __name__ == '__main__':
    main()
