"""Profiling hooks, the counterpart of `posenet_tpu.profiling`.

- `trace(logdir, device)`: a context manager around `torch.profiler` that
  records host ops, and the card's kernels and copies when `device` is a
  CUDA device, and writes a Chrome trace, `<logdir>/trace.json`.
- `span(name, device)`: a named stage of the program. Off, the default, it
  does nothing. It is on while a torch profiler is active, or inside
  `recording()`: it then opens a `record_function` range of that name, so
  that the stage lies in the Chrome trace on the clock of the card's
  kernels, and appends a `Span` to a bounded in-memory registry.
- `records()`, `span_report()`, `span_table()`: the registry's spans, and
  their host and device time by name.
- `device_time_report(trace_dir)`: a top-N table of device time by
  kernel name, from a trace.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from posenet_tpu_torch.config import resolve_device

TRACE_FILE = 'trace.json'
# Chrome-trace categories of work on the card. `record_function` ranges
# appear there too, as 'gpu_user_annotation' spans over the kernels they
# hold, and are left out so that no kernel's time counts twice.
_DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
# The registry keeps the newest spans: about 13k calls of the pipeline.
REGISTRY_SIZE = 1 << 16


@contextlib.contextmanager
def trace(logdir: str, device: torch.device | str = 'cuda'):
    """Profile the enclosed block; yields `logdir`. With a CUDA `device`
    (the default; see `resolve_device`) the card's activity is recorded
    beside the host's, and the device is synchronised before the trace
    closes, so that its queued work is in it. The span registry is
    cleared on entry, so that it then holds the block's spans."""
    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    clear()
    with profile(activities=activities) as prof:
        yield logdir
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

_registry: collections.deque = collections.deque(maxlen=REGISTRY_SIZE)
_call_ids = itertools.count()
_local = threading.local()      # .open: the spans open in this thread
_recording = 0                  # depth of `recording()` blocks
_OFF = contextlib.nullcontext()


class Span:
    """One stage of one call, as the registry keeps it: `name`, host
    `start_ns` and `end_ns` (`time.perf_counter_ns`; `end_ns` is None while
    the span is open), the enclosing span `parent` (None for a root), and
    `call_id`, which a root takes anew and every span inside it shares."""

    __slots__ = ('name', 'parent', 'call_id', 'start_ns', 'end_ns',
                 '_device', '_range', '_events', '_device_ms')

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name = name
        self.parent = self.call_id = self.start_ns = self.end_ns = None
        self._device = device
        self._range = self._events = self._device_ms = None

    def __enter__(self) -> 'Span':
        stack = _open_spans()
        self.parent = stack[-1] if stack else None
        self.call_id = self.parent.call_id if self.parent is not None else next(_call_ids)
        self._range = record_function(self.name)
        self._range.__enter__()
        if self._device is not None and self._device.type == 'cuda':
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self._device))
        stack.append(self)
        _registry.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        _open_spans().pop()
        self._range.__exit__(*exc)
        self._range = None
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Device ms between the span's entry and exit on its stream, from
        its two timing events (None off the card, or while open). Read
        when first asked for, and then it waits for the exit event."""
        if self._events is not None and self.end_ns is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


def _open_spans() -> List[Span]:
    stack = getattr(_local, 'open', None)
    if stack is None:
        stack = _local.open = []
    return stack


def span(name: str, device: torch.device | str | None = None):
    """A context manager around one stage of the program, `name`; on a
    CUDA `device` it also times the stage on the device's current stream.

    Off, it is a shared null context: it allocates, records and waits for
    nothing. It is on while a torch profiler is active
    (`torch.autograd._profiler_enabled()`) or inside `recording()`, except
    while `torch.compile` or `torch.export` traces (so an exported program
    holds no profiler op) and while the current stream captures a CUDA
    graph."""
    if not (_recording or torch.autograd._profiler_enabled()):
        return _OFF
    if (torch.compiler.is_compiling() or torch.compiler.is_exporting()
            or (torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing())):
        return _OFF
    return Span(name, None if device is None else torch.device(device))


@contextlib.contextmanager
def recording():
    """Spans on without a profiler, for the enclosed block. The outermost
    block clears the registry on entry."""
    global _recording
    if not _recording:
        clear()
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def clear():
    """Empty the span registry."""
    _registry.clear()


def records() -> List[Span]:
    """The registry's spans, oldest first: at most `REGISTRY_SIZE`."""
    return list(_registry)


def span_report(spans: Optional[Iterable[Span]] = None) -> Dict[str, dict]:
    """Per span name, over the finished spans (default: the registry's):
    `count`; host `total_ms`; `self_ms`, the spans' time less what their
    child spans cover; and `device_ms`, the sum of their device times, or
    None where no span of the name timed the device."""
    done = [s for s in (records() if spans is None else spans) if s.end_ns is not None]
    covered: Dict[Span, float] = defaultdict(float)
    for s in done:
        if s.parent is not None:
            covered[s.parent] += s.host_ms
    rows: Dict[str, dict] = {}
    for s in done:
        row = rows.setdefault(s.name, {'count': 0, 'total_ms': 0.0, 'self_ms': 0.0,
                                       'device_ms': None})
        row['count'] += 1
        row['total_ms'] += s.host_ms
        row['self_ms'] += s.host_ms - covered[s]
        device_ms = s.device_ms
        if device_ms is not None:
            row['device_ms'] = (row['device_ms'] or 0.0) + device_ms
    return rows


def span_table(report: Optional[Dict[str, dict]] = None) -> str:
    """`span_report()` as a table, one line a span name, by host time."""
    report = span_report() if report is None else report
    if not report:
        return 'no spans recorded'
    out = [f"{'span':<22} {'calls':>6} {'host ms':>10} {'self ms':>10} "
           f"{'ms/call':>9} {'device ms':>10}"]
    for name, r in sorted(report.items(), key=lambda kv: -kv[1]['total_ms']):
        device = '-' if r['device_ms'] is None else f"{r['device_ms']:.3f}"
        out.append(f"{name:<22} {r['count']:6d} {r['total_ms']:10.3f} {r['self_ms']:10.3f} "
                   f"{r['total_ms'] / r['count']:9.3f} {device:>10}")
    return '\n'.join(out)


# ---------------------------------------------------------------------------
# Device time from a trace
# ---------------------------------------------------------------------------

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
