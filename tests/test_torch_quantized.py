"""The port's int8 trunk (`posenet_tpu_torch.models.quantized`) against the
JAX package's (`posenet_tpu.models.quantized`), on the CPU.

Weights: the fixture m50 s16 with its backbone biases drawn again as
tests/test_quantized.py draws them (uniform in [-0.8, 0.8], checkpoint
scale), so that activations reach the top of [0, 6], where one bf16 ulp
is wider than one int8 level. Inputs are drawn from numpy seeds.

Tolerances:
- `_quantize_act`, `_dequantize_act`, `quantize_params` and `_pw_int8`:
  bitwise, the last also against an integer numpy emulation.
- `forward_quantized` against JAX's eager forward: the trunk's features
  (what the heads read) bitwise, so a single int8 level that differs
  anywhere in the trunk fails; the heads within 1e-6 of each head's scale
  (max |head|, at least 1). The heads' float32 sums run in another order
  in XLA's conv than in PyTorch's: 6e-8 at 129x129, 2.4e-4 on offsets of
  magnitude 714 at 33x33, 4 ulp.
- against JAX's jitted forward: within 1e-5 at m50 s16 2x129x129. XLA
  compiles the jitted program otherwise (its float32 sums and
  multiply-adds): at m50 s8 and s32 65x65 JAX's own eager and jitted
  forwards differ by 1.1e-3 on offsets of magnitude 892, and the port,
  equal to the eager one there, by as much. At the other shapes the
  jitted gap is printed beside JAX's own, and the eager bound is the one
  that holds.
- The quantized pipeline against JAX's on a synthesized photo: run op by
  op, the same pose count, coordinates within 1e-3 px and pose scores
  within 1e-5; jitted, within the envelope of tests/test_quantized.py
  (see `test_quantized_pipeline_matches_jax`). The data partition over
  ['cpu'] * 8 bitwise equal to the unsharded pipeline.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from posenet_tpu.config import DecodeConfig as JaxDecodeConfig
from posenet_tpu.config import ModelConfig as JaxModelConfig
from posenet_tpu.converter import tfjs2jax
from posenet_tpu.models import mobilenet_v1 as jax_mobilenet_v1
from posenet_tpu.models import quantized as jax_quantized
from posenet_tpu.models.model_factory import PoseNet as JaxPoseNet
from posenet_tpu.pipeline import PoseNetPipeline as JaxPipeline

from posenet_tpu_torch.config import DecodeConfig, ModelConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.models import mobilenet_v1, quantized
from posenet_tpu_torch.models.model_factory import PoseNet
from posenet_tpu_torch.parallel.mesh import make_mesh
from posenet_tpu_torch.pipeline import PoseNetPipeline
from posenet_tpu_torch.server import LivePipelineBackend
from posenet_tpu_torch.serving import save_serving_artifact

from tests.make_fixture_checkpoint import FIXTURE_PATH

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS = ('heatmap', 'offset', 'displacement_fwd', 'displacement_bwd')


def _cfgs(model_id=50, stride=16):
    return (JaxModelConfig(model_id=model_id, output_stride=stride,
                           compute_dtype=jnp.bfloat16, quantized=True),
            ModelConfig(model_id=model_id, output_stride=stride,
                        compute_dtype=torch.bfloat16, quantized=True))


@pytest.fixture(scope='module')
def jax_params():
    """The fixture's HWIO pytree, its backbone biases drawn at checkpoint
    scale as tests/test_quantized.py draws them."""
    params = tfjs2jax.load_params_npz(FIXTURE_PATH)
    rng = np.random.RandomState(20240816)
    for layer in params['backbone']:
        for k in layer:
            if layer[k].ndim == 1:
                layer[k] = rng.uniform(-0.8, 0.8, layer[k].shape).astype(np.float32)
    return params


def _equal_trees(got, ref):
    for g, r in zip(got['backbone'], ref['backbone']):
        assert set(g) == set(r)
        for k in r:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
            assert torch.equal(g[k], r[k]), k
    for name in ref['heads']:
        for k in ('w', 'b'):
            assert torch.equal(got['heads'][name][k], ref['heads'][name][k])
            assert got['heads'][name][k].dtype == ref['heads'][name][k].dtype


def test_quantized_requires_bf16():
    with pytest.raises(ValueError, match="quantized"):
        ModelConfig(compute_dtype=torch.float32, quantized=True)
    assert ModelConfig(compute_dtype=torch.bfloat16, quantized=True).quantized
    # the new field is the last: positional calls keep their meaning
    assert ModelConfig(50, 8, torch.bfloat16) == ModelConfig(
        model_id=50, output_stride=8, compute_dtype=torch.bfloat16, quantized=False)


def _bf16_in_0_6() -> np.ndarray:
    """Every bf16 value in [0, 6], -0 included, as float32."""
    bits = np.arange(0, 0x40C1, dtype=np.uint32)   # +0 .. 6.0 (0x40C0)
    vals = np.concatenate([(bits << 16).view(np.float32), [np.float32(-0.0)]])
    assert vals.max() == 6.0 and len(vals) == 16578
    return vals


def test_quantize_act_matches_jax_on_every_bf16_value():
    vals = _bf16_in_0_6()
    ref = np.asarray(jax_quantized._quantize_act(jnp.asarray(vals).astype(jnp.bfloat16)))
    got = quantized._quantize_act(torch.from_numpy(vals).to(torch.bfloat16))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    # float32 inputs (the pointwise epilogue's): random values and every
    # level's midpoint, where round half to even decides
    levels = np.arange(-127, 128, dtype=np.float64)
    mids = ((levels[:-1] + 127.5) / quantized.QSCALE).astype(np.float32)
    f32 = np.concatenate([np.random.RandomState(0).uniform(0, 6, 100000).astype(np.float32),
                          mids, np.nextafter(mids, 7), np.nextafter(mids, -1)])
    np.testing.assert_array_equal(quantized._quantize_act(torch.from_numpy(f32)).numpy(),
                                  np.asarray(jax_quantized._quantize_act(jnp.asarray(f32))))


@pytest.mark.parametrize("dtype,jax_dtype", [(torch.bfloat16, jnp.bfloat16),
                                             (torch.float32, jnp.float32)])
def test_dequantize_act_matches_jax_on_every_level(dtype, jax_dtype):
    q = np.arange(-127, 128, dtype=np.int8)
    ref = np.asarray(jax_quantized._dequantize_act(jnp.asarray(q), jax_dtype)
                     .astype(jnp.float32))
    got = quantized._dequantize_act(torch.from_numpy(q), dtype)
    assert got.dtype == dtype and len(q) == 255
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_quantize_params_bitwise_equal_to_jax(jax_params):
    ref = weights.quantized_params_from_jax(jax_quantized.quantize_params(jax_params))
    got = quantized.quantize_params(weights.params_from_jax(jax_params))
    _equal_trees(got, ref)
    layer = got['backbone'][1]
    assert layer['pw_w8'].shape == (16, 32) and layer['pw_w8'].stride() == (1, 16)
    assert layer['pw_alpha'].dtype == torch.float32 and layer['pw_corr'].dtype == torch.int32
    assert got['backbone'][0]['w'].dtype == torch.bfloat16
    assert int(layer['pw_w8'].abs().amax()) == 127


@pytest.mark.parametrize("n,ci,co", [(9, 16, 32), (37, 64, 48), (9, 256, 256), (17, 16, 32)])
def test_pw_int8_bitwise_equal_to_jax_and_integer_emulation(n, ci, co):
    """M = 9 (a one-frame 33x33 s16 product, padded to 17 rows), K = 16
    (m50's first separable layer) and the shapes of test_quantized.py."""
    rng = np.random.RandomState(n * ci + co)
    pw_w = rng.normal(0, 0.2, size=(1, 1, ci, co)).astype(np.float32)
    layer_np = {'dw_w': np.zeros((3, 3, 1, ci), np.float32), 'dw_b': np.zeros((ci,), np.float32),
                'pw_w': pw_w, 'pw_b': rng.normal(size=(co,)).astype(np.float32)}
    jax_layer = jax_quantized.quantize_params({'backbone': [layer_np], 'heads': {}})['backbone'][0]
    layer = quantized.quantize_params(
        weights.params_from_jax({'backbone': [layer_np], 'heads': {}}))['backbone'][0]
    q = rng.randint(-127, 128, size=(1, 1, n, ci)).astype(np.int8)

    got = quantized._pw_int8(torch.from_numpy(q), layer)
    assert got.dtype == torch.float32 and got.shape == (1, 1, n, co)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_quantized._pw_int8(jnp.asarray(q), jax_layer)))

    qw = layer['pw_w8'].numpy().astype(np.int32)
    acc = q.reshape(-1, ci).astype(np.int32) @ qw
    ref = ((acc + 127 * qw.sum(axis=0)).astype(np.float32) * layer['pw_alpha'].numpy()
           + layer['pw_b'].numpy())
    np.testing.assert_array_equal(got.numpy().reshape(-1, co), ref)
    np.testing.assert_array_equal(
        quantized.int8_matmul(torch.from_numpy(q.reshape(-1, ci)), layer['pw_w8']).numpy(), acc)


def _features(monkeypatch, module, forward, *args):
    """(heads, the features `run_heads` read) of one forward, `run_heads`
    of `module` wrapped to record them."""
    seen = []
    run_heads = module.run_heads
    monkeypatch.setattr(module, 'run_heads', lambda hp, feat, *a: (
        seen.append(feat), run_heads(hp, feat, *a))[1])
    heads = forward(*args)
    monkeypatch.undo()
    return heads, seen[0]


@pytest.mark.parametrize("stride,batch,size", [(16, 2, 129), (16, 1, 33), (8, 1, 65),
                                               (32, 1, 65)])
def test_forward_quantized_matches_jax(jax_params, monkeypatch, stride, batch, size):
    jax_cfg, cfg = _cfgs(50, stride)
    x = np.random.RandomState(1).uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    jax_q = jax_quantized.quantize_params(jax_params)
    ref, ref_feat = _features(monkeypatch, jax_mobilenet_v1, jax_quantized.forward_quantized,
                              jax_q, jnp.asarray(x), jax_cfg)
    ref_jit = jax_quantized.forward_quantized_jit(jax_q, jnp.asarray(x), jax_cfg)
    got, feat = _features(monkeypatch, mobilenet_v1, quantized.forward_quantized,
                          weights.quantized_params_from_jax(jax_q), torch.from_numpy(x), cfg)
    # the trunk: every int8 level, and the last layer's bf16 features, equal
    assert feat.dtype == torch.bfloat16
    np.testing.assert_array_equal(feat.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref_feat.astype(jnp.float32)))
    for k in HEADS:
        r, rj, g = np.asarray(ref[k]), np.asarray(ref_jit[k]), got[k].numpy()
        assert g.shape == r.shape and g.dtype == np.float32
        scale = max(1.0, float(np.abs(r).max()))
        gap, gap_jit = float(np.abs(g - r).max()), float(np.abs(g - rj).max())
        jax_gap = float(np.abs(r - rj).max())
        print(f'{k} s{stride} {batch}x{size}^2: vs eager {gap:.3g} (scale {scale:.4g}), '
              f'vs jit {gap_jit:.3g}, JAX eager vs jit {jax_gap:.3g}')
        assert gap <= 1e-6 * scale, (k, gap, scale)
        if (stride, size) == (16, 129):
            assert gap_jit <= 1e-5, (k, gap_jit)


def _pose_gaps(got, ref):
    """(coordinate gaps of the live poses, max pose-score gap)."""
    live = np.asarray(ref.pose_scores) > 0
    np.testing.assert_array_equal(got.pose_scores.numpy() > 0, live)
    err = np.abs(got.keypoint_coords.numpy() - np.asarray(ref.keypoint_coords))[live]
    return err, float(np.abs(got.pose_scores.numpy() - np.asarray(ref.pose_scores)).max())


def test_quantized_pipeline_matches_jax(jax_params):
    """The quantized PoseNetPipeline against JAX's quantized pipeline
    program on test_quantized.py's synthesized photo (and its mirror
    image), the same weights: run op by op (`_infer`, eager), the same
    pose count, coordinates within 1e-3 px and pose scores within 1e-5
    (measured: 0 and 0); jitted (`PoseNetPipeline`), which XLA compiles
    otherwise and the decode's cell rounding amplifies, within the envelope
    test_quantized.py holds JAX's int8 pipeline to against its bf16 one
    (median < 0.5 px, at least half within 2 px, pose scores within 0.05;
    measured: median 0, 97.6% within 2 px, at most 9.69 px, scores 0,
    the same as JAX's own eager against jitted program)."""
    cv2 = pytest.importorskip('cv2')
    from posenet_tpu.pipeline import _infer
    from tests.tfjs_fixture import synth_photo

    jax_cfg, cfg = _cfgs(50, 16)
    frame = cv2.cvtColor(synth_photo(289, 289)[:257, :257], cv2.COLOR_BGR2RGB)[None]
    frames = np.concatenate([frame, frame[:, ::-1]])
    got = PoseNetPipeline(PoseNet(weights.params_from_jax(jax_params), cfg),
                          DecodeConfig(min_pose_score=0.0))(frames)
    eager = _infer(jax_quantized.quantize_params(jax_params), jnp.asarray(frames), jax_cfg,
                   JaxDecodeConfig(min_pose_score=0.0))
    jitted = JaxPipeline(JaxPoseNet(jax_params, jax_cfg),
                         JaxDecodeConfig(min_pose_score=0.0))(frames)

    err, score_gap = _pose_gaps(got, eager)
    print(f'vs JAX eager: poses per image {(got.pose_scores > 0).sum(1).tolist()}, coords '
          f'within {err.max():.3g} px, pose scores within {score_gap:.3g}')
    assert err.size >= 2 * 17
    assert err.max() <= 1e-3 and score_gap <= 1e-5

    err, score_gap = _pose_gaps(got, jitted)
    print(f'vs JAX jitted: coords median {np.median(err):.3g} px, {(err < 2).mean():.3f} '
          f'within 2 px, max {err.max():.3g}; pose scores within {score_gap:.3g}')
    assert np.median(err) < 0.5 and (err < 2.0).mean() >= 0.5 and score_gap <= 0.05


@pytest.fixture(scope='module')
def quantized_model(jax_params):
    return PoseNet(weights.params_from_jax(jax_params), _cfgs(50, 16)[1])


def test_quantized_data_partition_bitwise(quantized_model):
    """The data partition over 8 CPU shards (an uneven 7 frames, padded)
    against the unsharded quantized pipeline, every field bitwise."""
    frames = np.random.RandomState(3).randint(0, 255, (7, 129, 129, 3), dtype=np.uint8)
    dcfg = DecodeConfig(min_pose_score=0.0, score_threshold=0.3, max_candidates=32)
    plain = PoseNetPipeline(quantized_model, dcfg)
    assert plain.params['backbone'][1]['pw_w8'].dtype == torch.int8
    sharded = PoseNetPipeline(quantized_model, dcfg, mesh=make_mesh(devices=['cpu'] * 8))
    assert sharded.replicas[0]['backbone'][1]['pw_corr'].dtype == torch.int32
    want, out = plain(frames), sharded(frames)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert (want.pose_scores > 0).sum() >= 1


def test_quantized_refusals(quantized_model, tmp_path):
    """The spatial partition, `device_resize_to` and serving export refuse
    a quantized model, as the JAX package's do; the live backend serves it
    through the pipeline."""
    with pytest.raises(NotImplementedError, match="spatial"):
        PoseNetPipeline(quantized_model, mesh=make_mesh(devices=['cpu'] * 2),
                        partition='spatial')
    with pytest.raises(NotImplementedError, match="device_resize_to"):
        PoseNetPipeline(quantized_model, device_resize_to=(65, 65))
    out = str(tmp_path / 'q.posenet')
    with pytest.raises(NotImplementedError, match="int8"):
        save_serving_artifact(quantized_model, out, input_hw=(65, 65), platforms=('cpu',))
    assert not os.path.exists(out)

    frames = np.random.RandomState(4).randint(0, 255, (2, 65, 65, 3), dtype=np.uint8)
    backend = LivePipelineBackend(quantized_model, input_hw=(65, 65), batch_sizes=(2,))
    for a, b in zip(backend(frames), PoseNetPipeline(quantized_model)(frames)):
        assert torch.equal(a, b)


def test_new_modules_never_import_jax():
    """The int8 trunk and the converter leave jax and the JAX package
    unloaded."""
    code = ("import sys, posenet_tpu_torch.models.quantized, posenet_tpu_torch.converter, "
            "posenet_tpu_torch.converter.download, posenet_tpu_torch.converter.tfjs2torch, "
            "posenet_tpu_torch.models.model_factory, posenet_tpu_torch.pipeline; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'posenet_tpu')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, '-c', code], cwd=REPO_ROOT, check=True, timeout=120)
