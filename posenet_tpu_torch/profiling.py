"""Profiling hooks, the counterpart of `posenet_tpu.profiling`.

- `trace(logdir, device)`: a context manager around `torch.profiler` that
  records host ops, and the card's kernels and copies when `device` is a
  CUDA device, and writes a Chrome trace, `<logdir>/trace.json`.
- `StageTimer`: named wall-clock stage totals for host-side breakdowns
  (read / preprocess / forward / decode / draw), as the benchmark CLI's
  `--profile` prints them.
- `device_time_report(trace_dir)`: a top-N table of device time by
  kernel name, from such a trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile

from posenet_tpu_torch.models.model_factory import resolve_device

TRACE_FILE = 'trace.json'
# Chrome-trace categories of work on the card. `record_function` ranges
# appear there too, as 'gpu_user_annotation' spans over the kernels they
# hold, and are left out so that no kernel's time counts twice.
_DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


@contextlib.contextmanager
def trace(logdir: str, device: torch.device | str = 'cuda'):
    """Profile the enclosed block; yields `logdir`. With a CUDA `device`
    (the default; see `resolve_device`) the card's activity is recorded
    beside the host's, and the device is synchronised before the trace
    closes, so that its queued work is in it."""
    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class StageTimer:
    """Accumulate wall-clock time per named pipeline stage."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values()) or 1e-9
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:>16}: {t*1000:9.2f} ms total, "
                f"{t/max(n,1)*1000:8.3f} ms/call x{n}, {t/total*100:5.1f}%")
        return "\n".join(lines)


def device_time_report(trace_dir: str, top: int = 25) -> str:
    """Device time by kernel (and copy) name, the `top` largest, from the
    trace `trace()` wrote into `trace_dir`. Says so when the trace holds no
    device work (a CPU run)."""
    path = os.path.join(trace_dir, TRACE_FILE)
    if not os.path.exists(path):
        return f"no trace found at {path}"
    return _report(path, top)


def _report(path: str, top: int) -> str:
    with open(path) as f:
        events = json.load(f)['traceEvents']
    time_us: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') in _DEVICE_CATEGORIES:
            time_us[e['name']] += float(e.get('dur', 0.0))
            count[e['name']] += 1
    if not time_us:
        return f"no device events (kernels, copies) in {path}: a host-only trace"
    total = sum(time_us.values())
    out = [f"{'device op':<60} {'ms':>10} {'count':>7} {'%':>6}"]
    for name, us in sorted(time_us.items(), key=lambda kv: -kv[1])[:top]:
        out.append(f"{name[:60]:<60} {us/1e3:10.3f} {count[name]:7d} "
                   f"{us/total*100:6.1f}")
    out.append(f"{'TOTAL':<60} {total/1e3:10.3f}")
    return "\n".join(out)
