"""The harness at a tiny size on the CPU, with model 50 and the program's
plain kernels: a sound run is correct under each cell's own limits, the
reference agrees with the float32 program, and the control and a run with
the timed path broken underneath come out not correct."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

import posenet_tpu_torch.decode as decode_mod
import posenet_tpu_torch.pipeline as pipeline_mod
from benchmarks import check, harness
from benchmarks.references import posenet
from benchmarks.systems import pipeline
from benchmarks.tests.cells import cpus, tiny

SEED = 2 ** 31 + 12345
DEVICE_METRICS = ('conv_device_ms', 'elementwise_device_ms', 'k2_roofline', 'mfu',
                  'idle_share')


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run(cell, trace=False, **kw):
    return harness.execute(cell, SEED, 0.3, trace, cpus(cell), log=lambda *a, **k: None, **kw)


@pytest.mark.parametrize('name,raw', [('m101-s16.offline-b256', False), ('m101-s16.offline-b256', True),
                                      ('m101-s8.offline-720p-b32', False)])
def test_a_sound_run_is_correct_and_reads_no_device_metric(name, raw):
    cell = tiny(name, raw=raw)
    for trace in (False, True):
        result = run(cell, trace)
        assert list(result)[:5] == ['correct', 'attempted', 'failed', 'metrics', 'device']
        assert list(result)[-1] == 'checks'
        assert result['correct'] is True, result['checks']
        assert result['attempted'] > 0 and result['failed'] == 0
        assert result['device']['platform'] == 'cpu'
        assert set(result['checks']) == set(posenet.NAMES)
        assert not any(m.startswith(DEVICE_METRICS) for m in result['metrics'])
        if not trace:
            assert 'setup_s' in result['metrics']


@pytest.mark.parametrize('raw', [False, True])
def test_the_reference_agrees_with_the_float32_program(raw):
    """On RGB frames, and on raw BGR frames resized on the device."""
    cell = tiny('m101-s16.offline-b256', compute_dtype='float32', raw=raw)
    gaps = run(cell)['checks']
    assert gaps['score_gap']['value'] <= 1e-5
    assert gaps['offset_gap_px']['value'] <= 1e-4
    assert gaps['walk_gap_px']['value'] == 0.0
    assert gaps['pose_score_gap']['value'] <= 1e-6


def test_the_control_is_not_correct():
    """The reference in float8 in the program's place."""
    result = run(tiny('m101-s16.offline-b256'), system=posenet.CONTROL)
    assert result['correct'] is False, result['checks']


def _alter_one_keypoint(monkeypatch):
    real = decode_mod.traverse_all_candidates

    def walk(*args):
        scores, coords, offsets = real(*args)
        coords = coords.clone()
        coords[0, 0, 5, 0] += args[-1] / 2       # half a cell, one keypoint
        return scores, coords, offsets
    monkeypatch.setattr(decode_mod, 'traverse_all_candidates', walk)


def _leave_out_half_the_batch(monkeypatch):
    real = pipeline_mod.decode_batch

    def decode(*args):
        out = real(*args)
        half = out.pose_scores.shape[0] // 2
        return type(out)(*(t if t is None else torch.cat([t[:half], torch.zeros_like(t[half:])])
                           for t in out))
    monkeypatch.setattr(pipeline_mod, 'decode_batch', decode)


def _return_the_first_answer(monkeypatch):
    real = pipeline_mod.PoseNetPipeline.__call__
    first = {}

    def call(self, frames):
        return first.setdefault('out', real(self, frames))
    monkeypatch.setattr(pipeline_mod.PoseNetPipeline, '__call__', call)


def _skip_the_nms(monkeypatch):
    monkeypatch.setattr(decode_mod, 'local_max_mask',
                        lambda scores, threshold, radius: scores >= threshold)


def _leave_the_candidates_unsorted(monkeypatch):
    """The top K of the masked cells taken in the order of their index."""
    def top_k(scores, mask, k):
        b, n_kp, h, w = scores.shape
        flat = torch.where(mask, scores, -1.0).reshape(b, -1)
        idx = torch.sort((~mask).reshape(b, -1).to(torch.uint8), dim=1, stable=True)[1][:, :k]
        cell = idx % (h * w)
        return flat.gather(1, idx), idx // (h * w), cell // w, cell % w
    monkeypatch.setattr(decode_mod, 'top_k_candidates', top_k)


def _accept_without_the_nms_radius(monkeypatch):
    real = decode_mod._greedy_accept

    def accept(*args):
        return real(*args[:-1], dataclasses.replace(args[-1], nms_radius=0))
    monkeypatch.setattr(decode_mod, '_greedy_accept', accept)


@pytest.mark.parametrize('name,raw,fault', [
    ('m101-s16.offline-b256', False, _alter_one_keypoint),
    ('m101-s16.offline-b256', True, _alter_one_keypoint),
    ('m101-s8.offline-720p-b32', False, _alter_one_keypoint),
    ('m101-s16.offline-b256', False, _leave_out_half_the_batch),
    ('m101-s16.offline-b256', False, _return_the_first_answer),
    ('m101-s16.offline-b256', True, _return_the_first_answer),
    ('m101-s16.offline-b256', False, _accept_without_the_nms_radius),
    ('m101-s8.offline-720p-b32', False, _accept_without_the_nms_radius),
    ('m101-s8.offline-720p-b32', False, _skip_the_nms),
    ('m101-s8.offline-720p-b32', False, _leave_the_candidates_unsorted),
])
def test_a_broken_timed_path_is_not_correct(name, raw, fault, monkeypatch):
    fault(monkeypatch)
    result = run(tiny(name, raw=raw))
    assert result['correct'] is False, result['checks']


def test_the_sample_is_drawn_from_the_seed():
    a = check.sample_calls(500, 128, 256, SEED)
    assert a == check.sample_calls(500, 128, 256, SEED) and len(a) == 2
    assert check.sample_calls(500, 1, 256, SEED) != check.sample_calls(500, 1, 256, SEED + 1)


def test_a_number_without_a_limit_is_not_correct():
    assert check.verdict({'a': 0.1}, {'a': 0.2})
    assert not check.verdict({'a': 0.1, 'b': 0.0}, {'a': 0.2})


def test_a_key_that_nothing_reads_is_refused(tmp_path):
    """At the top of a configuration or traffic file by the harness, inside
    the program's groups by the program's own constructors."""
    cell = harness.load_cell('m101-s16.offline-b256')
    assert harness.unread_keys(cell) == []
    assert harness.unread_keys(dataclasses.replace(
        cell, config=dict(cell.config, quantize=True),
        traffic=dict(cell.traffic, arrivals='poisson'))) == ['config quantize',
                                                            'traffic arrivals']
    bench = json.loads(harness.BENCHMARK_JSON.read_text())
    path = tmp_path / 'config.json'
    path.write_text(json.dumps(dict(cell.config, devices=4)))
    bench['configs'][0]['file'] = str(path)
    with pytest.raises(SystemExit, match='config devices'):
        harness.load_cell('m101-s16.offline-b256', bench)
    with pytest.raises(TypeError):
        pipeline.model_config(dict(cell.config, model=dict(cell.config['model'], int8=True)))
    with pytest.raises(TypeError):
        posenet.draw_params(dict(cell.config, weights={'gain': 1.0}), 0, 'cpu')


def test_run_without_a_card_exits_with_an_error():
    proc = subprocess.run([sys.executable, str(harness.HERE / 'run.py'), '--workload',
                           'm101-s16.offline-b256', '--seed', str(SEED), '--seconds', '1'],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'CUDA' in proc.stderr
