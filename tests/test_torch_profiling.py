"""The port's spans (`posenet_tpu_torch.profiling.span`) on the CPU, at
m50 and small frames: off they record nothing; under a profiler, or
inside `recording()`, one `PoseNetPipeline` call records `pipeline.call`
around the spans of its stages, which share its call id; the Chrome trace
holds each span; the poses do not change; the registry is bounded;
`span_report()`'s self time; an export under a profiler holds no profiler
op. Marked `cuda`: the decode's device time holds K1's launch, and a
card export under a profiler launches K1 and K2 as before.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from posenet_tpu_torch import profiling
from posenet_tpu_torch.config import DecodeConfig
from posenet_tpu_torch.models.model_factory import MobileNetV1
from posenet_tpu_torch.ops import sepconv, traversal
from posenet_tpu_torch.pipeline import PoseNetPipeline
from posenet_tpu_torch.serving import load_serving_artifact, save_serving_artifact

from tests.torch_offline import offline_download  # noqa: F401 (autouse)

STAGES = {'infer': ['pipeline.to_device', 'pipeline.forward', 'pipeline.decode'],
          'infer_raw': ['pipeline.to_device', 'pipeline.preprocess', 'pipeline.forward',
                        'pipeline.decode']}


@pytest.fixture(scope='module')
def model():
    return MobileNetV1(50, 16, seed=3, device='cpu')


def _pipe(model, route, device=None):
    """The pipeline of `route` and host frames for it: RGB 65x65 for
    `infer`, BGR 60x90 resized on the device to 65x97 for `infer_raw`."""
    rng = np.random.RandomState(5)
    if route == 'infer':
        return PoseNetPipeline(model, device=device), rng.randint(0, 256, (2, 65, 65, 3), np.uint8)
    return (PoseNetPipeline(model, device=device, device_resize_to=(65, 97)),
            rng.randint(0, 256, (2, 60, 90, 3), np.uint8))


def _call_spans(spans):
    """The spans of the one `pipeline.call` among `spans`: the root, and its
    children in order."""
    (root,) = [s for s in spans if s.name == 'pipeline.call']
    return root, [s for s in spans if s is not root and s.call_id == root.call_id]


def test_spans_off_record_nothing(model):
    pipe, frames = _pipe(model, 'infer')
    profiling.clear()
    pipe(frames)
    assert profiling.records() == []
    assert profiling.span('pipeline.call') is profiling.span('x', 'cpu')


@pytest.mark.parametrize('route', ['infer', 'infer_raw'])
def test_a_call_under_the_profiler_nests_its_stages(model, route):
    pipe, frames = _pipe(model, route)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pipe(frames)
    root, children = _call_spans(profiling.records())
    assert root.parent is None
    assert [s.name for s in children] == STAGES[route]
    for s in children:
        assert s.parent is root and s.call_id == root.call_id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert all(s.device_ms is None for s in (root, *children))   # the CPU: no events
    # Calls take call ids of their own.
    with profiling.recording():
        pipe(frames)
        pipe(frames)
    roots = [s for s in profiling.records() if s.parent is None]
    assert len(roots) == 2 and roots[0].call_id != roots[1].call_id


def test_the_chrome_trace_holds_each_span(model, tmp_path):
    pipe, frames = _pipe(model, 'infer_raw')
    with profiling.trace(str(tmp_path), 'cpu'):
        pipe(frames)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'pipeline.call', *STAGES['infer_raw']} <= names
    assert len(profiling.records()) == 5       # the block's spans, nothing before


@pytest.mark.parametrize('route', ['infer', 'infer_raw'])
def test_poses_with_spans_on_are_bitwise_those_off(model, route):
    pipe, frames = _pipe(model, route)
    off = pipe(frames)
    with profiling.recording():
        on = pipe(frames)
    assert len(profiling.records()) == 1 + len(STAGES[route])
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_recording_works_without_a_profiler(model):
    assert not torch.autograd._profiler_enabled()
    pipe, frames = _pipe(model, 'infer')
    with profiling.recording():
        with profiling.recording():            # nested: the registry is kept
            pipe(frames)
        pipe(frames)
    assert len([s for s in profiling.records() if s.name == 'pipeline.call']) == 2
    report = profiling.span_report()
    assert report['pipeline.call']['count'] == 2 and report['pipeline.decode']['count'] == 2
    assert report['pipeline.forward']['total_ms'] > 0
    profiling.clear()
    pipe(frames)                               # off again
    assert profiling.records() == []


def test_the_registry_stays_bounded():
    with profiling.recording():
        for _ in range(profiling.REGISTRY_SIZE + 10):
            with profiling.span('s'):
                pass
        assert len(profiling.records()) == profiling.REGISTRY_SIZE
    with profiling.recording():                # the outermost block clears it
        assert profiling.records() == []


def test_self_time_is_the_span_less_its_children():
    with profiling.recording():
        with profiling.span('outer') as outer:
            with profiling.span('inner'):
                pass
            with profiling.span('inner'):
                pass
        with profiling.span('outer'):
            pass
    spans = profiling.records()
    inner = [s for s in spans if s.name == 'inner']
    assert all(s.parent is outer and s.call_id == outer.call_id for s in inner)
    report = profiling.span_report()
    total = sum(s.host_ms for s in spans if s.name == 'outer')
    assert report['outer']['count'] == 2 and report['inner']['count'] == 2
    assert report['outer']['total_ms'] == pytest.approx(total)
    assert report['outer']['self_ms'] == pytest.approx(total - sum(s.host_ms for s in inner))
    assert report['inner']['self_ms'] == pytest.approx(report['inner']['total_ms'])
    table = profiling.span_table(report)
    assert table.splitlines()[1].split()[0] == 'outer'


def _export(model, path, platforms, traced, batch=1, hw=(33, 33)):
    """`save_serving_artifact` of `model` at batch `batch`, under an active
    profiler where `traced`; returns the node targets of each platform's
    program."""
    dcfg = DecodeConfig(max_pose_detections=2, min_pose_score=0.0, score_threshold=0.25)
    profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with profiler if traced else contextlib.nullcontext():
        save_serving_artifact(model, path, decode_cfg=dcfg, batch_sizes=(batch,),
                              input_hw=hw, platforms=platforms)
    return [[str(n.target) for n in load_serving_artifact(path, device=p)._program(batch)
             .graph.nodes] for p in platforms]


def _no_profiler_op(targets) -> bool:
    return not any('profiler' in t or 'record_function' in t for t in targets)


def test_an_export_under_the_profiler_holds_no_profiler_op(tmp_path):
    """The CPU artifact exported under an active profiler: the same graph
    as without one, no profiler op in it, and the same poses. (On the CPU
    the graph holds K1's plain version; the custom ops are checked on the
    card.)"""
    model = MobileNetV1(50, 16, seed=4, device='cpu')
    (plain,) = _export(model, str(tmp_path / 'plain.posenet'), ('cpu',), traced=False)
    (traced,) = _export(model, str(tmp_path / 'traced.posenet'), ('cpu',), traced=True)
    assert traced == plain and len(traced) > 100
    assert _no_profiler_op(traced)
    frames = np.random.RandomState(4).randint(0, 256, (1, 33, 33, 3), np.uint8)
    outs = [load_serving_artifact(str(tmp_path / f'{n}.posenet'), device='cpu')(frames)
            for n in ('plain', 'traced')]
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the spans time the device with CUDA events')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
def test_the_decode_device_time_holds_k1(cuda, tmp_path):
    """On the card each stage's span times the device between its events:
    the decode's is above 0 and holds K1's kernel, which the trace puts
    inside the decode's range on the device."""
    model = MobileNetV1(101, 16, compute_dtype=torch.bfloat16, seed=1, device=cuda)
    pipe = PoseNetPipeline(model, DecodeConfig(min_pose_score=0.0, score_threshold=0.25))
    frames = np.random.RandomState(1).randint(0, 256, (2, 129, 129, 3), np.uint8)
    pipe.warmup((129, 129), 2)
    k1 = traversal.launches
    with profiling.trace(str(tmp_path), cuda):
        pipe(frames).pose_scores.cpu()
    assert traversal.launches - k1 == 1
    report = profiling.span_report()
    assert report['pipeline.decode']['device_ms'] > 0
    assert report['pipeline.forward']['device_ms'] > 0
    with open(os.path.join(tmp_path, profiling.TRACE_FILE)) as f:
        events = [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']
    (walk,) = [e for e in events if e.get('cat') == 'kernel' and 'traverse' in e['name']]
    (decode,) = [e for e in events if e.get('cat') == 'gpu_user_annotation'
                 and e['name'] == 'pipeline.decode']
    assert decode['ts'] <= walk['ts'] and walk['ts'] + walk['dur'] <= decode['ts'] + decode['dur']
    assert report['pipeline.decode']['device_ms'] >= walk['dur'] / 1e3


@pytest.mark.cuda
def test_a_cuda_export_under_the_profiler_launches_k1_and_k2(cuda, tmp_path):
    """A bf16 m101 s16 artifact exported on the card under an active
    profiler holds no profiler op, and its program launches K2 on the 13
    separable layers and K1 once, as the artifact does without the profiler."""
    model = MobileNetV1(101, 16, compute_dtype=torch.bfloat16, seed=1, device=cuda)
    path = str(tmp_path / 'm101.posenet')
    (targets,) = _export(model, path, ('cuda',), traced=True, batch=2, hw=(65, 65))
    assert _no_profiler_op(targets)
    assert targets.count('posenet_tpu_torch.sepconv.default') == 13
    assert targets.count('posenet_tpu_torch.traverse_all_candidates.default') == 1
    frames = np.random.RandomState(1).randint(0, 256, (2, 65, 65, 3), np.uint8)
    art = load_serving_artifact(path)
    art(frames)
    torch.cuda.synchronize()
    k1, k2 = traversal.launches, sepconv.launches
    art(frames)
    torch.cuda.synchronize()
    assert (traversal.launches - k1, sepconv.launches - k2) == (1, 13)
