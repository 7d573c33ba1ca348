"""The PyTorch port's on-device preprocessing and raw-frame entry against
the JAX package's `preprocess_on_device`, `valid_resolution` and
`infer_raw_jit`.

Tolerances:
- Resize: `jax.image.resize` drops the out-of-range taps at the borders
  and renormalizes the weights, where PyTorch clamps the source index; the
  two agree in exact arithmetic and round differently. Under jit, XLA:CPU
  also contracts x * (2/255) - 1 into a fused multiply-add. So the
  normalized frames are held within 1e-5 absolute (of values in [-1, 1]);
  measured: 6.6e-6 at most (80x100 -> 33x49), 3e-7 at 720x1280 -> 513x513.
  At the source size the resize is the identity, and the port equals the
  flip and the op-by-op normalize bit for bit.
- `infer_raw` is `preprocess_on_device` -> `forward` -> `decode_batch`, and
  is held to that chain written out by hand bit for bit.
- The raw-frame slice against JAX's, float32, fixture m50 s16 weights,
  synthesized 480x640 photos processed at 353x481: the bounds of the
  float32 slice in tests/test_torch_pipeline.py (same pose count,
  coordinates within 1e-2 px, pose and keypoint scores within 1e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from posenet_tpu.config import DecodeConfig as JaxDecodeConfig
from posenet_tpu.config import ModelConfig as JaxModelConfig
from posenet_tpu.converter import tfjs2jax
from posenet_tpu.pipeline import infer_raw_jit
from posenet_tpu.preprocess import preprocess_on_device as jax_preprocess
from posenet_tpu.preprocess import valid_resolution as jax_valid_resolution

from posenet_tpu_torch import (PoseNetPipeline, infer_raw, load_model,
                               preprocess_on_device, valid_resolution)
from posenet_tpu_torch.config import DecodeConfig, ModelConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.decode import decode_batch
from posenet_tpu_torch.models import mobilenet_v1

from tests.make_fixture_checkpoint import FIXTURE_PATH
from tests.tfjs_fixture import synth_photo

RESIZE_ATOL = 1e-5


def _frames(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("width,height,stride", [
    (1280, 720, 16), (513, 513, 16), (500, 500, 16), (640, 480, 8), (641.7, 99.2, 32),
    (1920, 1080, 8)])
def test_valid_resolution_matches_jax(width, height, stride):
    assert (valid_resolution(width, height, stride)
            == jax_valid_resolution(width, height, stride))


@pytest.mark.parametrize("src,dst", [
    ((40, 50), (65, 97)),       # upscale
    ((37, 53), (97, 161)),      # upscale, non-integer ratios
    ((100, 160), (65, 65)),     # downscale, unequal ratios
    ((80, 100), (33, 49)),      # downscale, non-integer ratios
    ((64, 64), (33, 33)),       # downscale, border taps outside the image
    ((720, 1280), (129, 129)),  # a capture frame to a model resolution
])
def test_preprocess_matches_jax(src, dst):
    frames = _frames(3, (2, *src, 3))
    ref = np.asarray(jax_preprocess(jnp.asarray(frames), dst))
    ours = preprocess_on_device(torch.from_numpy(frames), dst)
    assert ours.dtype == torch.float32 and ours.is_contiguous()
    assert tuple(ours.shape) == ref.shape == (2, *dst, 3)
    np.testing.assert_allclose(ours.numpy(), ref, atol=RESIZE_ATOL, rtol=0)
    # the border rows and columns, where the two resizers treat taps apart
    for edge in (ours[:, 0], ours[:, -1], ours[:, :, 0], ours[:, :, -1]):
        assert edge.abs().max() <= 1.0


def test_preprocess_at_source_size_is_flip_and_normalize():
    frame = _frames(4, (100, 160, 3))
    ours = preprocess_on_device(torch.from_numpy(frame), (100, 160))
    expect = frame[None, ..., ::-1].astype(np.float32) * np.float32(2 / 255) - np.float32(1)
    np.testing.assert_array_equal(ours.numpy(), expect)
    ref = np.asarray(jax_preprocess(jnp.asarray(frame), (100, 160)))
    np.testing.assert_allclose(ours.numpy(), ref, atol=RESIZE_ATOL, rtol=0)


def test_preprocess_rejects_non_uint8():
    with pytest.raises(ValueError, match='uint8'):
        preprocess_on_device(torch.zeros((1, 8, 8, 3)), (9, 9))
    with pytest.raises(ValueError, match='uint8'):
        preprocess_on_device(torch.zeros((1, 8, 8, 4), dtype=torch.uint8), (9, 9))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_infer_raw_equals_hand_chain(dtype):
    """The raw-frame program, and the pipeline in raw mode, against
    preprocess -> forward -> decode chained by hand: bitwise."""
    model = load_model(50, 16, allow_random_init=True, compute_dtype=dtype, device='cpu')
    dcfg = DecodeConfig(min_pose_score=0.0, score_threshold=0.3, max_candidates=32)
    pipe = PoseNetPipeline(model, dcfg, device_resize_to=(65, 65))
    pipe.warmup((80, 100), batch=1)    # the source shape in raw mode
    frames = torch.from_numpy(_frames(11, (2, 80, 100, 3)))
    fused = infer_raw(pipe.params, frames, (65, 65), model.cfg, dcfg)
    x = preprocess_on_device(frames, (65, 65))
    heads = mobilenet_v1.forward(pipe.params, x, model.cfg)
    manual = decode_batch(heads['heatmap'], heads['offset'], heads['displacement_fwd'],
                          heads['displacement_bwd'], 16, dcfg)
    via_pipe = pipe(frames.numpy())
    for a, b, c in zip(fused, manual, via_pipe):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert fused.keypoint_coords.shape == (2, 10, 17, 2)
    default = PoseNetPipeline(model, dcfg)
    assert default.device_resize_to is None
    with pytest.raises(ValueError, match='uint8'):
        pipe(np.zeros((1, 80, 100, 3), np.float32))


def test_infer_raw_matches_jax_fixture():
    params = tfjs2jax.load_params_npz(FIXTURE_PATH)
    frames = np.stack([synth_photo(480, 640, seed=100 + i) for i in range(2)])   # BGR
    target = (353, 481)
    ref = infer_raw_jit(jax.tree.map(jnp.asarray, params), jnp.asarray(frames), target,
                        JaxModelConfig(model_id=50, output_stride=16),
                        JaxDecodeConfig(min_pose_score=0.25))
    ours = infer_raw(weights.params_from_jax(params), torch.from_numpy(frames), target,
                     ModelConfig(model_id=50, output_stride=16),
                     DecodeConfig(min_pose_score=0.25))
    ref_scores = np.asarray(ref.pose_scores)
    n_ref = (ref_scores > 0).sum(axis=1)
    assert n_ref.min() >= 1
    np.testing.assert_array_equal((ours.pose_scores.numpy() > 0).sum(axis=1), n_ref)
    np.testing.assert_allclose(ours.pose_scores.numpy(), ref_scores, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours.keypoint_scores.numpy(),
                               np.asarray(ref.keypoint_scores), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours.keypoint_coords.numpy(),
                               np.asarray(ref.keypoint_coords), atol=1e-2, rtol=0)
