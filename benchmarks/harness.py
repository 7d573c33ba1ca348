"""One run of one cell: set-up, the measured window, the traced stretch, the
check of the window's answers, and the result line.

Everything a cell needs is found by name. `BENCHMARK.json` names the
cell's configuration (`configs/<config>.json`) and traffic mix
(`traffic/<traffic>.json`); its limits are `limits/<workload>.json`. The
configuration names the system under test (`systems/<system>.py`: `build`,
`fetch`, `read`, `counters`) and the plain reference it is judged against
(`references/<reference>`: `draw_params`, `judge`, `NAMES`); the traffic
names its loop (`loops/<loop>.py`: `run`). Each per-layer metric is a
reader of its own, `metrics/<metric>.py`, with a function `read(run)` that
returns a number or None (nothing to read in this cell). A key of a
configuration or traffic file that neither the harness nor a module it
names reads is refused.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmarks import check, yardstick

HERE = Path(__file__).resolve().parent
BENCHMARK_JSON = HERE.parent / 'BENCHMARK.json'
# Whole top-level module names that may not be loaded in a run's process.
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'posenet_tpu')
# The benchmark's own spans around the calls into the program.
SPANS = ('bench.call', 'bench.read')
# The keys of a configuration and of a traffic mix that the harness reads.
CONFIG_KEYS = frozenset({'name', 'source', 'checkpoint', 'reduced', 'assumed', 'system',
                         'reference'})
TRAFFIC_KEYS = frozenset({'loop', 'height', 'width', 'frames', 'pool_frames',
                          'warmup_calls', 'trace_calls'})


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), else since this
    module was imported."""
    try:
        with open('/proc/self/stat') as f:
            start_ticks = float(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def named(kind: str, name: str):
    """The module `<kind>/<name>` of the benchmark: a system, a loop or a
    reference."""
    if not name.isidentifier():
        raise SystemExit(f'{kind} {name!r}: not a module name')
    return importlib.import_module(f'benchmarks.{kind}.{name}')


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with what it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    def system(self):
        return named('systems', self.config['system'])

    def reference(self):
        return named('references', self.config['reference'])

    def loop(self):
        return named('loops', self.traffic['loop'])


def _applies(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def unread_keys(cell: Cell) -> List[str]:
    """The keys of the cell's configuration and traffic files that nothing
    reads: neither the harness nor the system, loop or reference they name."""
    system, ref, loop = cell.system(), cell.reference(), cell.loop()
    config_keys = CONFIG_KEYS | system.CONFIG_KEYS | ref.CONFIG_KEYS
    traffic_keys = TRAFFIC_KEYS | system.TRAFFIC_KEYS | ref.TRAFFIC_KEYS | loop.TRAFFIC_KEYS
    return ([f'config {k}' for k in sorted(set(cell.config) - config_keys)]
            + [f'traffic {k}' for k in sorted(set(cell.traffic) - traffic_keys)])


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json, its files read and its keys
    checked."""
    bench = bench if bench is not None else load_json(BENCHMARK_JSON)
    found = [w for w in bench['workloads'] if w['name'] == name]
    if not found:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
    w = found[0]
    (conf,) = [c for c in bench['configs'] if c['name'] == w['config']]
    cell = Cell(name=name, chips=int(w['chips']),
                config=load_json(HERE.parent / conf['file']),
                traffic=load_json(HERE / 'traffic' / f"{w['traffic']}.json"),
                limits=load_json(HERE / 'limits' / f'{name}.json'),
                end_to_end=[m for m in bench['end_to_end'] if _applies(m, name)],
                per_layer=[m for m in bench['per_layer'] if _applies(m, name)])
    unread = unread_keys(cell)
    if unread:
        raise SystemExit(f'{name}: read by nothing: {", ".join(unread)}')
    return cell


def reader(metric: str):
    """The module `metrics/<metric>.py`."""
    path = HERE / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(f'benchmarks.metrics.{metric}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def draw_pool(traffic: dict, seed: int, device) -> np.ndarray:
    """The traffic's pool of distinct uint8 frames, (N, H, W, 3), drawn on
    `device` from the seed in one call and kept on the host: RGB at the
    model's resolution, or BGR at the source's."""
    gen = torch.Generator(device=device).manual_seed((seed + 0x9E3779B9) % 2 ** 63)
    shape = (traffic['pool_frames'], traffic['height'], traffic['width'], 3)
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device=device).cpu().numpy()


@dataclasses.dataclass
class Call:
    frames: np.ndarray        # pool indices
    t_send: float
    t_return: float
    t_done: float = 0.0
    answer: Optional[dict] = None


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""
    cell: Cell
    calls: List[Call]
    window_s: float
    frames_done: int
    on_device: bool = True     # False: a CPU run, which reads no device metric
    trace: Optional[dict] = None
    trace_calls: int = 0
    trace_frames: int = 0


def traced(loop, send, read, pool, traffic, devices, start: int) -> dict:
    """`trace_calls` calls under `torch.profiler`, summarised; the trace
    lives in a fresh directory under TMPDIR and is deleted once read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if any(torch.device(d).type == 'cuda' for d in devices):
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix='bench-trace-')
    try:
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            loop.run(send, read, pool, traffic, calls=traffic['trace_calls'], start=start)
            _sync(devices)
            window = time.perf_counter() - t0
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        return yardstick.summarize_trace(path, window, SPANS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

def _sync(devices):
    for d in devices:
        if torch.device(d).type == 'cuda':
            torch.cuda.synchronize(d)


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            devices: List[str], system=None, log=print) -> dict:
    """One run of `cell` on `devices` (the first holds the inputs and the
    reference). Returns the result line's object. `system` replaces the
    configuration's system under test (the control, a broken program)."""
    system = system if system is not None else cell.system()
    ref, loop = cell.reference(), cell.loop()
    first = torch.device(devices[0])
    config, traffic = cell.config, cell.traffic
    t_start = process_age_s()
    params = ref.draw_params(config, seed, first)
    pool = draw_pool(traffic, seed, first)
    t_inputs = process_age_s()
    pipe = system.build(params, config, traffic, devices if first.type == 'cpu' else None)

    def send(frames):
        return system.fetch(pipe(frames))
    for d in devices:
        if torch.device(d).type == 'cuda':
            torch.cuda.reset_peak_memory_stats(d)
    t_built = process_age_s()
    loop.run(send, system.read, pool, traffic, calls=traffic['warmup_calls'])
    _sync(devices)
    setup_s = process_age_s()
    log(f'set-up: start to harness {t_start:.2f} s, inputs {t_inputs - t_start:.2f} s, '
        f'pipeline {t_built - t_inputs:.2f} s, warm-up {setup_s - t_built:.2f} s', flush=True)

    before = system.counters() if system.counters else None
    calls = loop.run(send, system.read, pool, traffic, seconds=seconds, keep=True)
    if not calls:
        raise SystemExit('no call completed inside the window')
    window_s = calls[-1].t_done - calls[0].t_send
    frames_done = sum(len(c.frames) for c in calls)
    if before is not None:
        after, sent = system.counters(), len(calls)
        log('launches per call: ' + ', '.join(
            f'{k} {(after[k] - before[k]) / sent:g}' for k in after), flush=True)
    run = Run(cell, calls, window_s, frames_done, on_device=first.type == 'cuda')
    t_trace = time.perf_counter()
    if trace:
        run.trace = traced(loop, send, system.read, pool, traffic, devices, start=len(calls))
        run.trace_calls = traffic['trace_calls']
        run.trace_frames = run.trace_calls * traffic['batch']
    t_check = time.perf_counter()
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if torch.device(d).type == 'cuda'), default=0)

    # The program's state is freed before the reference runs.
    del pipe, send
    gc.collect()
    if first.type == 'cuda':
        torch.cuda.empty_cache()
    chosen = check.sample_calls(len(calls), traffic['batch'], traffic['check_frames'], seed)
    answers = [dict(calls[i].answer, frames=calls[i].frames) for i in chosen]
    gaps = ref.judge(params, config, traffic, pool, answers, first)
    correct = check.verdict(gaps, cell.limits)
    log(f'phases: set-up {setup_s:.2f} s, window {window_s:.2f} s, trace '
        f'{t_check - t_trace:.2f} s, check {time.perf_counter() - t_check:.2f} s', flush=True)

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = reader(m['name']).read(run)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        e2e = end_to_end(run, setup_s)
        for m in cell.end_to_end:
            metrics[m['name']] = {'value': e2e[m['name']], 'unit': m['unit']}
    result = {'correct': correct, 'attempted': frames_done, 'failed': 0,
              'metrics': metrics, 'device': device_block(devices, peak, run)}
    if trace and run.trace is not None:
        result['breakdown'] = breakdown(run.trace)
    result['checks'] = {name: {'value': gaps[name], 'limit': cell.limits[name]}
                        for name in cell.limits}
    return result


def end_to_end(run: Run, setup_s: float) -> Dict[str, float]:
    """Every end-to-end metric the harness knows, from the window."""
    lat = sorted((c.t_done - c.t_send) * 1e3 for c in run.calls for _ in c.frames)
    q = statistics.quantiles(lat, n=100, method='inclusive') if len(lat) > 1 else lat * 99
    return {'img_per_s': run.frames_done / run.window_s, 'latency_p50_ms': q[49],
            'latency_p95_ms': q[94], 'setup_s': setup_s}


def device_block(devices, peak: int, run: Run) -> dict:
    first = torch.device(devices[0])
    if first.type == 'cuda':
        block = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(first),
                 'count': len(devices), 'memory_peak_bytes': int(peak)}
    else:
        block = {'platform': 'cpu', 'kind': 'cpu', 'count': len(devices),
                 'memory_peak_bytes': 0}
    if run.trace is not None and run.trace['busy_s']:
        busy = run.trace['busy_s']
        block['busy_s'] = sum(busy.values()) / len(devices)
        block['window_s'] = run.trace['window_s']
    return block


def breakdown(summary: dict) -> dict:
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {'device_ops': top(summary['by_name_s']),
            'idle_gaps': top(summary['idle_by_label_s'])}


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among `modules` (default: what this
    process has loaded), each compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN_MODULES))
