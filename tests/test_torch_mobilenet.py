"""The PyTorch port's MobileNetV1 trunk and fused heads against the JAX
package's `forward`, on the same numpy weights and inputs.

Tolerances:
- float32, random init: heads within 1e-4, the JAX package's own backbone
  bound (PARITY.md "Validation depth"). The two frameworks sum each conv
  in another order, so they agree to float32 rounding, not bit for bit.
- float32, fixture weights: within 1e-4 of each head's largest magnitude.
  The fixture's offsets and displacements reach ~470 px, where 1e-4 is
  under two float32 ulps, so no change of summation order could meet an
  absolute 1e-4; measured: 2.1e-6 of scale at most.
- bfloat16: bf16 keeps 8 significant bits, so each of the 27 convs rounds
  its output by up to 2^-9 relative, and the two frameworks round bias
  adds at other places. The port's stride-1 separable layers (any rate) run
  the fused block's plain version (float32 accumulation and biases, one
  bf16 rounding a conv, `ops/sepconv.py`), where the JAX package's trunk
  runs the bf16 XLA conv pair. On random-init weights (unit-scale
  activations) the bf16 heads are held within 2e-3 absolute, about one
  bf16 rounding of a unit value, of the port's float32 heads and of the
  JAX package's bf16 heads; measured with the fused block: 5.1e-4 at most
  over 6 weight draws of m50 and m101 (6e-4 over 8 draws before it).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from posenet_tpu.config import ModelConfig as JaxModelConfig
from posenet_tpu.converter import tfjs2jax
from posenet_tpu.models import mobilenet_v1 as jax_mobilenet

from posenet_tpu_torch.config import ModelConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.models import MobileNetV1, PoseNet, mobilenet_v1

from tests.make_fixture_checkpoint import FIXTURE_PATH
from tests.test_torch_weights import numpy_params

HEADS = ('heatmap', 'heatmap_logits', 'offset', 'displacement_fwd',
         'displacement_bwd')


def _jax_heads(params, x_nhwc, model_id, stride):
    cfg = JaxModelConfig(model_id=model_id, output_stride=stride)
    out = jax_mobilenet.forward(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(x_nhwc), cfg,
                                precision=jax.lax.Precision.HIGHEST)
    return {k: np.asarray(out[k]) for k in HEADS}


def _torch_heads(params, x_nhwc, model_id, stride, dtype=torch.float32):
    cfg = ModelConfig(model_id=model_id, output_stride=stride,
                      compute_dtype=dtype)
    p = mobilenet_v1.cast_params(weights.params_from_jax(params), dtype)
    out = mobilenet_v1.forward(p, torch.from_numpy(x_nhwc), cfg)
    return {k: out[k].numpy() for k in HEADS}


@pytest.mark.parametrize("model_id", [50, 75, 100, 101])
@pytest.mark.parametrize("stride", [8, 16, 32])
def test_stride_plan_matches_jax(model_id, stride):
    assert (mobilenet_v1.stride_plan(model_id, stride)
            == jax_mobilenet.stride_plan(model_id, stride))
    for k, s, d in [(3, 1, 1), (3, 2, 1), (3, 1, 2), (3, 1, 4), (1, 1, 1)]:
        assert (mobilenet_v1.torch_same_padding(k, s, d)
                == jax_mobilenet.torch_same_padding(k, s, d))
    assert mobilenet_v1.ARCHS[model_id] == jax_mobilenet.ARCHS[model_id]
    assert mobilenet_v1.HEAD_CHANNELS == jax_mobilenet.HEAD_CHANNELS


@pytest.mark.parametrize("model_id", [50, 101])
@pytest.mark.parametrize("stride", [8, 16, 32])
def test_f32_heads_match_jax_random_init(model_id, stride):
    params = numpy_params(model_id, seed=stride)
    rng = np.random.RandomState(stride)
    x = rng.uniform(-1, 1, (2, 33, 33, 3)).astype(np.float32)
    ref = _jax_heads(params, x, model_id, stride)
    ours = _torch_heads(params, x, model_id, stride)
    for k in HEADS:
        assert ours[k].shape == ref[k].shape
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-4, rtol=0, err_msg=k)


def test_f32_heads_match_jax_fixture():
    """The fixture's trained-like weights give large, peaked activations:
    the bound must hold there too, on a non-square stride-valid input."""
    params = tfjs2jax.load_params_npz(FIXTURE_PATH)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 65, 97, 3)).astype(np.float32)
    ref = _jax_heads(params, x, 50, 16)
    ours = _torch_heads(params, x, 50, 16)
    for k in HEADS:
        scale = max(1.0, float(np.abs(ref[k]).max()))
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-4 * scale, rtol=0,
                                   err_msg=k)


def test_bf16_heads_close_to_f32_and_jax_bf16():
    """bf16 trunk + f32 heads of the flagship m101 s16, with the bound
    stated in the module docstring."""
    params = numpy_params(101, seed=5)
    x = np.random.RandomState(5).uniform(-1, 1, (2, 65, 65, 3)).astype(np.float32)
    f32 = _torch_heads(params, x, 101, 16)
    ours = _torch_heads(params, x, 101, 16, dtype=torch.bfloat16)
    cfg = JaxModelConfig(model_id=101, output_stride=16,
                         compute_dtype=jnp.bfloat16)
    ref = jax_mobilenet.forward(
        jax_mobilenet.cast_params(jax.tree.map(jnp.asarray, params),
                                  jnp.bfloat16), jnp.asarray(x), cfg)
    for k in HEADS:
        assert ours[k].dtype == np.float32
        np.testing.assert_allclose(ours[k], f32[k], atol=2e-3, rtol=0, err_msg=k)
        np.testing.assert_allclose(ours[k], np.asarray(ref[k]), atol=2e-3,
                                   rtol=0, err_msg=k)
    assert not np.array_equal(ours['offset'], f32['offset'])   # really bf16


def test_posenet_call_accepts_nchw_and_nhwc():
    model = MobileNetV1(50, 16, seed=3, device='cpu')
    assert isinstance(model, torch.nn.Module)
    x = torch.from_numpy(
        np.random.RandomState(4).uniform(-1, 1, (1, 33, 49, 3)).astype(np.float32))
    nhwc = model(x)
    nchw = model(x.permute(0, 3, 1, 2))
    single = model(x[0])
    assert [t.shape for t in nhwc] == [(1, 3, 4, c) for c in (17, 34, 32, 32)]
    for a, b, c in zip(nhwc, nchw, single):
        assert torch.equal(a.permute(0, 3, 1, 2), b)
        assert torch.equal(a, c)
    assert model.output_stride == 16 and model.model_id == 50
    assert len(model.state_dict()) == 2 + 13 * 4 + 4 * 2


def test_posenet_params_round_trip_through_module():
    """PoseNet holds the pytree as buffers; `.params` gives it back."""
    params = weights.params_from_jax(tfjs2jax.load_params_npz(FIXTURE_PATH))
    model = PoseNet(params, ModelConfig(model_id=50))
    got = model.params
    for a, b in zip(got['backbone'], params['backbone']):
        assert all(a[k] is b[k] for k in b)
    assert all(got['heads'][n]['w'] is params['heads'][n]['w'] for n in params['heads'])


@pytest.mark.parametrize("model_id,stride", [(50, 16), (101, 8)])
def test_backbone_features_match_jax(model_id, stride):
    """The trunk's features, NHWC as JAX's `backbone_features` returns
    them (the port's channels_last memory, no copy): float32 within 1e-4
    of their scale, max(1, max |feature|), as the heads are held."""
    params = numpy_params(model_id, seed=stride)
    x = np.random.RandomState(stride).uniform(-1, 1, (2, 33, 49, 3)).astype(np.float32)
    ref = np.asarray(jax_mobilenet.backbone_features(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        JaxModelConfig(model_id=model_id, output_stride=stride),
        precision=jax.lax.Precision.HIGHEST))
    ours = mobilenet_v1.backbone_features(weights.params_from_jax(params),
                                          torch.from_numpy(x),
                                          ModelConfig(model_id, stride))
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    assert ours.is_contiguous()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize('stride', [16, 8])
def test_backbone_features_bf16_match_jax(stride):
    """bf16 m101 at s16 and s8, every stride-1 layer through K2's plain
    version at its dilation rate (s16: layer 13 at rate 2; s8: layers 7-12
    at rate 2, 13 at rate 4, each map 9x9, smaller than rate 4's reach),
    against JAX's bf16 trunk: within 2e-3 of the features' scale,
    max(1, max |feature|); measured: one bf16 ulp of features below 0.5
    (2^-9)."""
    params = numpy_params(101, seed=5)
    x = np.random.RandomState(5).uniform(-1, 1, (2, 65, 65, 3)).astype(np.float32)
    jcfg = JaxModelConfig(model_id=101, output_stride=stride, compute_dtype=jnp.bfloat16)
    ref = np.asarray(jax_mobilenet.backbone_features(
        jax_mobilenet.cast_params(jax.tree.map(jnp.asarray, params), jnp.bfloat16),
        jnp.asarray(x), jcfg).astype(jnp.float32))
    cfg = ModelConfig(model_id=101, output_stride=stride, compute_dtype=torch.bfloat16)
    ours = mobilenet_v1.backbone_features(
        mobilenet_v1.cast_params(weights.params_from_jax(params), torch.bfloat16),
        torch.from_numpy(x), cfg)
    side = 64 // stride + 1
    assert ours.shape == ref.shape == (2, side, side, 1024) and ours.dtype == torch.bfloat16
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=2e-3 * scale, rtol=0)
