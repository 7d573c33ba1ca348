"""PoseNet ResNet50 in the port (`models/resnet50.py`) against the plain
float32 reference (`benchmarks/references/posenet_resnet50/`), on the CPU
at full widths, 129x129 frames, batch 2, with the weights the benchmark's
configuration draws from a seed: the heads in float32 and bf16 at output
strides 16 and 32, the pipeline's poses, the config's refusals, the routes
that refuse ResNet50 by name, and the spans and conv counter of a call.
The JAX package has no ResNet50, so the reference is the plain one.
Marked `cuda`: the bf16 heads of the card's trunk (cuDNN's fused
conv-bias-(add-)ReLU calls, the projections' biases folded) against the
reference on the card, within the same bound.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from benchmarks.references.posenet import model as posenet_reference
from benchmarks.references.posenet_resnet50 import model as reference
from posenet_tpu_torch import profiling
from posenet_tpu_torch.config import DecodeConfig, ModelConfig
from posenet_tpu_torch.models import resnet50
from posenet_tpu_torch.models.model_factory import PoseNet, ResNet50, load_model
from posenet_tpu_torch.parallel.mesh import make_mesh
from posenet_tpu_torch.pipeline import PoseNetPipeline, infer_raw
from posenet_tpu_torch.serving import save_serving_artifact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(REPO, 'benchmarks', 'configs', 'r50-s16-bf16.json')))
DECODE = DecodeConfig(**CONFIG['decode'])
HEADS = ('heatmap', 'offset', 'displacement_fwd', 'displacement_bwd')
# bf16 keeps 8 significant bits: each stored value is off by up to 2^-9 of
# itself. The 53 convs each round their output once (and the normalize
# the input), and independent roundings add like a random walk over the
# layers, so the heads' error is about sqrt(53) * 2^-9 = 1.4% of their
# RMS; twice that leaves room for the residual adds. Measured 0.4-1.1%.
BF16_RMS_GAP = 2 * math.sqrt(53) * 2 ** -9


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def frames():
    return torch.randint(0, 256, (2, 129, 129, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(20))


def _params(output_stride, seed=2 ** 31 + 7):
    return reference.draw_params(output_stride, seed, 'cpu', **CONFIG['weights'])


def _cfg(output_stride, dtype):
    return ModelConfig(output_stride=output_stride, compute_dtype=dtype,
                       architecture='resnet50')


def _port_heads(params, frames, output_stride, dtype):
    cp = resnet50.cast_params(params, dtype, 'cpu')
    with torch.no_grad():
        x = resnet50.normalize(frames, cp, dtype)
        return resnet50.forward(cp, x, _cfg(output_stride, dtype))


def _reference_heads(params, frames, output_stride):
    with torch.no_grad():
        return reference.forward(params, reference.normalize(frames), output_stride)


@pytest.mark.parametrize('output_stride', [16, 32])
def test_float32_heads_match_the_reference(frames, output_stride):
    """Within 1e-4 (the backbone fuzz bound, PARITY.md "Validation
    depth"): on the CPU both run the same float32 convs with their biases
    on the same inputs (each projection's bias added into its unit's last
    conv's by `cast_params`, which only reorders float32 adds), so they
    differ by float32 rounding alone (measured
    1.2e-7 at most, at heads up to ~50 in magnitude, where one float32 ulp
    is 4e-6). A bf16 trunk misses the bound by far."""
    params = _params(output_stride)
    ref = _reference_heads(params, frames, output_stride)
    grid = (129 - 1) // output_stride + 1
    assert ref['heatmap'].shape == (2, grid, grid, 17)
    ours = _port_heads(params, frames, output_stride, torch.float32)
    bf16 = _port_heads(params, frames, output_stride, torch.bfloat16)
    for name in HEADS:
        assert ours[name].shape == ref[name].shape
        assert torch.allclose(ours[name], ref[name], atol=1e-4, rtol=0), name
    assert not all(torch.allclose(bf16[n], ref[n], atol=1e-4, rtol=0) for n in HEADS)


@pytest.mark.parametrize('output_stride', [16, 32])
def test_bf16_heads_within_a_bf16_bound(frames, output_stride):
    """The RMS of each head's gap within `BF16_RMS_GAP` (2.8%) of the
    head's RMS, and above 1e-4 of it: the trunk really ran in bf16."""
    params = _params(output_stride)
    ref = _reference_heads(params, frames, output_stride)
    ours = _port_heads(params, frames, output_stride, torch.bfloat16)
    for name in HEADS:
        rms = ref[name].pow(2).mean().sqrt()
        gap = (ours[name] - ref[name]).pow(2).mean().sqrt() / rms
        assert 1e-4 < gap <= BF16_RMS_GAP, (name, float(gap))


@pytest.mark.cuda
@pytest.mark.parametrize('output_stride', [16, 32])
def test_card_bf16_heads_within_a_bf16_bound(frames, output_stride):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    params = reference.draw_params(output_stride, 2 ** 31 + 7, 'cuda', **CONFIG['weights'])
    ref = _reference_heads(params, frames.cuda(), output_stride)
    pipe = PoseNetPipeline(PoseNet(params, _cfg(output_stride, torch.bfloat16)), DECODE)
    before = resnet50.convs
    with torch.no_grad():
        x = resnet50.normalize(frames.cuda(), pipe.params, torch.bfloat16)
        ours = resnet50.forward(pipe.params, x, pipe.cfg)
    assert resnet50.convs - before == 53
    for name in HEADS:
        rms = ref[name].pow(2).mean().sqrt()
        gap = (ours[name] - ref[name]).pow(2).mean().sqrt() / rms
        assert 1e-4 < gap <= BF16_RMS_GAP, (name, float(gap))
    assert pipe(frames).pose_scores.is_cuda


def test_cast_params_folds_each_projection_bias_into_the_last_conv():
    """The 4 projections keep no bias; each unit's last conv carries the
    sum, formed in float32 and rounded once to the compute dtype."""
    params = _params(16)
    cp = resnet50.cast_params(params, torch.bfloat16, 'cpu')
    folded = [i for i, p in enumerate(cp['backbone']) if 'b' not in p]
    assert folded == [1, 11, 24, 43]
    for i in folded:
        want = (params['backbone'][i + 3]['b'] + params['backbone'][i]['b']).bfloat16()
        assert torch.equal(cp['backbone'][i + 3]['b'], want)
    assert all(p['w'].dtype == torch.bfloat16 for p in cp['backbone'])


def test_the_residual_gain_keeps_the_stream_within_4x():
    """With the configuration's weights, block 4's output RMS lies within
    4x of block 1's (without batch norm the stream would otherwise grow
    with every unit)."""
    frames = torch.randint(0, 256, (1, 129, 129, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    taps = {}
    with torch.no_grad():
        reference.trunk(_params(16), reference.normalize(frames), 16, taps=taps)
    rms = {k: float(v.pow(2).mean().sqrt()) for k, v in taps.items()}
    assert 1.0 <= rms['block4'] / rms['block1'] <= 4.0, rms


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_pipeline_poses_match_the_reference_decode_of_its_heads(frames, dtype):
    """`PoseNetPipeline.infer` on the port's own heads: the reference's
    decode of those heads gives the same poses."""
    params = _params(16)
    pipe = PoseNetPipeline(PoseNet(params, _cfg(16, dtype)), DECODE)
    out = pipe(frames)
    heads = _port_heads(params, frames, 16, dtype)
    dc = CONFIG['decode']
    ref = posenet_reference.decode(heads, 16, dc['score_threshold'], dc['nms_radius'],
                                   dc['min_pose_score'], dc['max_pose_detections'],
                                   dc['max_candidates'])
    assert int((out.pose_scores > 0).sum()) > 0
    assert torch.equal((out.pose_scores > 0).sum(1), ref['count'])
    torch.testing.assert_close(out.pose_scores, ref['pose_scores'], atol=1e-6, rtol=0)
    torch.testing.assert_close(out.keypoint_scores, ref['keypoint_scores'], atol=1e-6, rtol=0)
    torch.testing.assert_close(out.keypoint_coords, ref['keypoint_coords'], atol=1e-4, rtol=0)


def test_the_data_partition_matches_one_device(frames):
    params = _params(16)
    model = PoseNet(params, _cfg(16, torch.bfloat16))
    one = PoseNetPipeline(model, DECODE)(frames)
    mesh = PoseNetPipeline(model, DECODE, mesh=make_mesh(devices=['cpu'] * 2))(frames)
    for a, b in zip(one, mesh):
        assert torch.equal(a, b)


@pytest.mark.parametrize('kw,match', [
    (dict(output_stride=8), 'output stride 16 or 32'),
    (dict(quantized=True, compute_dtype=torch.bfloat16), 'no int8 trunk'),
    (dict(architecture='resnet101'), 'architecture must be one of'),
])
def test_model_config_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        ModelConfig(**{'architecture': 'resnet50', **kw})


def test_raw_frames_spatial_and_serving_refuse_resnet50_by_name(tmp_path):
    model = ResNet50(16, device='cpu')
    with pytest.raises(NotImplementedError, match='ResNet50'):
        PoseNetPipeline(model, device_resize_to=(129, 129))
    with pytest.raises(NotImplementedError, match='ResNet50'):
        infer_raw(model.params, torch.zeros((1, 60, 90, 3), dtype=torch.uint8), (129, 129),
                  model.cfg, DECODE)
    with pytest.raises(NotImplementedError, match='ResNet50 \\+ spatial'):
        PoseNetPipeline(model, mesh=make_mesh(devices=['cpu'] * 2), partition='spatial')
    with pytest.raises(NotImplementedError, match='ResNet50'):
        save_serving_artifact(model, str(tmp_path / 'a.posenet'), input_hw=(129, 129),
                              platforms=('cpu',))


def test_load_model_names_the_missing_checkpoint():
    with pytest.raises(FileNotFoundError, match='model-stride16'):
        load_model(output_stride=16, architecture='resnet50', device='cpu')
    model = load_model(output_stride=32, architecture='resnet50', allow_random_init=True,
                       device='cpu')
    assert model.cfg.architecture == 'resnet50' and len(model.backbone) == 53
    heads = model(torch.zeros((1, 65, 65, 3)))
    assert [h.shape[-1] for h in heads] == [17, 34, 32, 32] and heads[0].shape[1] == 3


def test_a_call_nests_the_resnet_spans_and_counts_53_convs(frames):
    pipe = PoseNetPipeline(ResNet50(16, compute_dtype=torch.bfloat16, device='cpu'), DECODE)
    before = resnet50.convs
    with profiling.recording():
        pipe(frames)
    assert resnet50.convs - before == 53
    spans = profiling.records()
    (forward,) = [s for s in spans if s.name == 'pipeline.forward']
    inner = [s for s in spans if s.name.startswith('resnet.')]
    assert [s.name for s in inner] == ['resnet.stem'] + [f'resnet.block{i}' for i in
                                                         range(1, 5)]
    for s in inner:
        assert s.parent is forward and s.call_id == forward.call_id
        assert forward.start_ns <= s.start_ns <= s.end_ns <= forward.end_ns
    assert [s.name for s in spans if s.parent is forward.parent] == [
        'pipeline.to_device', 'pipeline.forward', 'pipeline.decode']


def test_the_reference_imports_nothing_of_the_port():
    code = ('import sys, benchmarks.references.posenet_resnet50, benchmarks.yardstick_r50\n'
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"posenet_tpu_torch", "posenet_tpu", "jax"}))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         cwd=REPO, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == '[]'
