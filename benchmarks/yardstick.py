"""The benchmark's fixed arithmetic: the chip's peaks, the operations a
forward pass needs, K2's roofline bound, and the reduction of a profiler
trace to busy time, idle gaps and device time by kind of kernel.

Copied, not imported, from the program's tools (`chip_smoke.k2_bound_ms`
and its peaks, `tools/profile_fused_torch.KINDS` and `summarize`), so that
a later change to the program cannot move the yardstick. Imports nothing
of the program.
"""

from __future__ import annotations

import heapq
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmarks.references.posenet import model as reference

# One NVIDIA H100 SXM (data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, float32 FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

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


def _out(n: int, stride: int) -> int:
    """Output length of a 3x3 conv with torch-style symmetric padding."""
    pad = reference._same_pad(stride, 1)
    return (n + 2 * pad - 3) // stride + 1


def layer_shapes(model_id: int, output_stride: int, height: int, width: int
                 ) -> List[dict]:
    """Each stride-plan layer with its output height and width."""
    out, h, w = [], height, width
    for layer in reference.stride_plan(model_id, output_stride):
        h, w = _out(h, layer['stride']), _out(w, layer['stride'])
        out.append(dict(layer, h=h, w=w))
    return out


def forward_flops(model_id: int, output_stride: int, height: int, width: int) -> float:
    """Operations (2 per multiply-add) of one image's forward pass: the 14
    trunk layers and the four 1x1 heads."""
    macs = 0
    layers = layer_shapes(model_id, output_stride, height, width)
    for layer in layers:
        m = layer['h'] * layer['w']
        if layer['kind'] == 'input':
            macs += m * layer['c_out'] * 9 * layer['c_in']
        else:
            macs += m * layer['c_in'] * 9 + m * layer['c_in'] * layer['c_out']
    last = layers[-1]
    macs += last['h'] * last['w'] * last['c_out'] * sum(ch for _, ch in reference.HEADS)
    return 2.0 * macs


def k2_layers(model_id: int, output_stride: int, height: int, width: int
              ) -> List[Tuple[int, int, int, int]]:
    """(h, w, c_in, c_out) of each layer the bf16 trunk runs as K2: every
    separable layer at stride 1, whatever its dilation rate. K2 keeps the
    layer's spatial size (its input is the previous layer's output); a
    dilated layer reads and writes the same bytes and does the same
    products as at rate 1, so its bound (`k2_bound_ms`) is the same."""
    return [(l['h'], l['w'], l['c_in'], l['c_out'])
            for l in layer_shapes(model_id, output_stride, height, width)
            if l['kind'] == 'sep' and l['stride'] == 1]


def k2_bound_ms(b: int, h: int, w: int, c_in: int, c_out: int) -> float:
    """The least time of one K2 call: each input read once and the output
    written once (bf16 activations and weights, f32 biases) at HBM speed,
    against the pointwise's products on the bf16 tensor cores and the
    depthwise's 9 taps in float32, whichever is longer."""
    m = b * h * w
    nbytes = 2 * m * (c_in + c_out) + 2 * 9 * c_in + 4 * c_in + 2 * c_in * c_out + 4 * c_out
    mem_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = max(2 * m * c_in * c_out / BF16_TENSOR_FLOPS, 2 * 9 * m * c_in / F32_FLOPS) * 1e3
    return max(mem_ms, ops_ms)


def kind_of(event: dict) -> str:
    if event.get('cat') in ('gpu_memcpy', 'gpu_memset'):
        return 'copies'
    name = event['name'].lower()
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return 'elementwise and other'


def _union(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Total length of the union of [lo, hi) spans, and the gaps between
    the merged spans."""
    busy, end, gaps = 0.0, None, []
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            if end is not None:
                gaps.append((end, lo))
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy, gaps


def _host_labels(host_spans, gaps, spans) -> List[str]:
    """For each gap, in order, what the host was doing at its midpoint: the
    benchmark's span around it and the innermost host op. One sweep over
    the host spans (sorted by start), with a heap of those still open."""
    labels, open_spans, i = [], [], 0
    for lo, hi in gaps:
        mid = (lo + hi) / 2
        while i < len(host_spans) and host_spans[i][0] <= mid:
            start, end, name = host_spans[i]
            heapq.heappush(open_spans, (end, start, name))
            i += 1
        while open_spans and open_spans[0][0] < mid:
            heapq.heappop(open_spans)
        outer = next((n for _, _, n in open_spans if n in spans), 'no benchmark span')
        inner = min(((e - st, n) for e, st, n in open_spans if n not in spans),
                    default=(0.0, 'idle host'))[1]
        labels.append(f'{outer} / {inner}')
    return labels


def summarize_trace(path: str, window_s: float, spans: Optional[List[str]] = None) -> dict:
    """From a Chrome trace of `torch.profiler`: the busy union of device
    intervals per device (seconds), device seconds by kind and by kernel
    name, and the device-idle gaps of each device, each labelled by what the
    host was doing at its midpoint: the benchmark's own span (`spans`, the
    names of its `record_function` ranges) and the innermost host op."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    device_events = [e for e in events
                     if e.get('ph') == 'X' and e.get('cat') in DEVICE_CATEGORIES]
    host = [e for e in events if e.get('ph') == 'X' and e.get('cat') in
            ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')]
    by_kind: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    per_device: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    for e in device_events:
        start, dur = float(e['ts']), float(e.get('dur', 0.0))
        by_kind[kind_of(e)] += dur / 1e6
        by_name[e['name']] += dur / 1e6
        per_device[int(e.get('args', {}).get('device', 0))].append((start, start + dur))
    busy, idle_by_label = {}, defaultdict(float)
    spans = tuple(spans or ())
    host_spans = sorted((float(e['ts']), float(e['ts']) + float(e.get('dur', 0.0)),
                         e['name']) for e in host)
    for dev, intervals in per_device.items():
        total, gaps = _union(intervals)
        busy[dev] = total / 1e6
        for (lo, hi), label in zip(gaps, _host_labels(host_spans, gaps, spans)):
            idle_by_label[label] += (hi - lo) / 1e6
    return {'busy_s': busy, 'window_s': window_s, 'by_kind_s': dict(by_kind),
            'by_name_s': dict(by_name), 'idle_by_label_s': dict(idle_by_label),
            'device_events': len(device_events)}
