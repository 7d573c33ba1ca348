"""The per-layer metrics that read the program's own spans
(`benchmarks/spans.py`, `metrics/*_launch_ms`, `stage_ms`,
`*_device_ms`), on the CPU at a tiny size: a traced run reads the three
host metrics and, off the card, not the two device ones; the traced
stretch holds one `pipeline.call` a traced call; nothing is read from the
control, from spans before the stretch, from a stretch of another length,
or from a program without spans."""

from __future__ import annotations

import time

import pytest
import torch

from benchmarks import harness, spans
from benchmarks.references import posenet
from benchmarks.tests.cells import cpus, tiny
from posenet_tpu_torch import profiling

SEED = 2 ** 31 + 424242
HOST = ('stage_ms.offline', 'forward_launch_ms.offline', 'decode_launch_ms.offline')
DEVICE = ('forward_device_ms.offline', 'decode_device_ms.offline')


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run(cell, trace, **kw):
    return harness.execute(cell, SEED, 0.3, trace, cpus(cell), log=lambda *a, **k: None, **kw)


@pytest.mark.parametrize('name', ['m101-s16.offline-b256', 'm101-s8.offline-720p-b32'])
def test_a_traced_cpu_run_reads_the_host_spans(name):
    cell = tiny(name)
    assert {m['name'] for m in cell.per_layer} >= set(HOST + DEVICE)
    profiling.clear()
    metrics = run(cell, trace=True)['metrics']
    roots = [s for s in profiling.records() if s.parent is None]
    assert [s.name for s in roots] == ['pipeline.call'] * cell.traffic['trace_calls']
    for m in HOST:
        assert isinstance(metrics[m]['value'], float) and metrics[m]['value'] >= 0.0, m
    assert metrics['forward_launch_ms.offline']['value'] > 0.0
    assert not set(DEVICE) & set(metrics)
    profiling.clear()
    assert not set(HOST + DEVICE) & set(run(cell, trace=False)['metrics'])
    assert profiling.records() == []           # spans off outside the profiler


def test_the_control_reads_no_span():
    metrics = run(tiny('m101-s16.offline-b256'), trace=True, system=posenet.CONTROL)['metrics']
    assert not set(HOST + DEVICE) & set(metrics)


def _run_after(calls: int, trace_calls: int, on_device: bool = False) -> harness.Run:
    """A run whose window ended now, then `calls` spanned calls of the
    program's shape recorded after it."""
    cell = tiny('m101-s16.offline-b256')
    t = time.perf_counter()
    window = [harness.Call(frames=None, t_send=t, t_return=t, t_done=t)]
    with profiling.recording():
        for _ in range(calls):
            with profiling.span('pipeline.call'):
                for stage in ('pipeline.to_device', 'pipeline.forward', 'pipeline.decode'):
                    with profiling.span(stage):
                        time.sleep(0.001)
    return harness.Run(cell, window, 1.0, 2, on_device=on_device, trace={'busy_s': {}},
                       trace_calls=trace_calls, trace_frames=2 * trace_calls)


def test_spans_before_the_stretch_are_left_out():
    with profiling.recording():
        with profiling.span('pipeline.call'):   # a call of an earlier run
            pass
        run_ = _run_after(3, 3)
    assert len([s for s in profiling.records() if s.name == 'pipeline.call']) == 4
    assert len(spans.traced_calls(run_)) == 3
    assert spans.host_ms(run_, 'pipeline.forward') >= 1.0
    assert spans.host_ms(run_, 'pipeline.preprocess') is None
    assert spans.device_ms_per_image(run_, 'pipeline.forward') is None   # not on the card


def test_nothing_is_read_from_a_stretch_of_another_length():
    run_ = _run_after(2, 3, on_device=True)
    assert spans.traced_calls(run_) is None
    assert spans.host_ms(run_, 'pipeline.decode') is None
    assert spans.device_ms_per_image(run_, 'pipeline.decode') is None


def test_a_program_without_spans_reads_none(monkeypatch):
    run_ = _run_after(2, 2)
    monkeypatch.delattr(profiling, 'records')
    assert spans.host_ms(run_, 'pipeline.to_device') is None
    for name in HOST + DEVICE:
        assert harness.reader(name).read(run_) is None
