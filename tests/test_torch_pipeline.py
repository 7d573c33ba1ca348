"""The whole slice of the PyTorch port, uint8 frames -> poses, against the
JAX package's fused `_infer`, plus the pipeline object and the package's
independence from jax.

Tolerances of the float32 slice (fixture m50 s16 weights, synthesized
photos): the same pose count, keypoint coordinates within 1e-2 px, pose
and keypoint scores within 1e-4. The heads differ from the JAX heads by
float32 rounding (tests/test_torch_mobilenet.py), and the fixture's sharp
peaks keep the decoder away from cell-rounding knife edges
(tests/make_fixture_checkpoint.py), so that rounding moves coordinates by
far less than 1e-2 px.
"""

import os
import shutil
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
from posenet_tpu.pipeline import infer_jit

from posenet_tpu_torch import PoseNetPipeline, decode_multiple_poses, load_model
from posenet_tpu_torch.config import DecodeConfig, ModelConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.models import MobileNetV1, mobilenet_v1
from posenet_tpu_torch.pipeline import infer, normalize

from tests.make_fixture_checkpoint import FIXTURE_PATH
from tests.tfjs_fixture import synth_photo

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_infer_matches_jax_f32_fixture():
    params = tfjs2jax.load_params_npz(FIXTURE_PATH)
    frames = np.stack([synth_photo(seed=100 + i)[..., ::-1] for i in range(3)])
    ref = infer_jit(jax.tree.map(jnp.asarray, params), jnp.asarray(frames),
                    JaxModelConfig(model_id=50, output_stride=16),
                    JaxDecodeConfig(min_pose_score=0.25))
    ours = infer(weights.params_from_jax(params), torch.from_numpy(frames),
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
    np.testing.assert_array_equal(ours.candidate_count.numpy(),
                                  np.asarray(ref.candidate_count))


@pytest.mark.parametrize("dtype,jax_dtype", [(torch.float32, jnp.float32),
                                             (torch.bfloat16, jnp.bfloat16)])
def test_normalize_matches_jax_on_every_byte(dtype, jax_dtype):
    """All 256 values, exactly, in both modes, against the JAX expression
    run op by op: bf16 must round 2/255 before it multiplies. (Inside a jit,
    XLA:CPU may skip the intermediate rounding, an FMA in float32, and its
    result then moves by one ulp of the dtype, depending on the fusion.)"""
    u = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    ref = jnp.asarray(u).astype(jax_dtype) * (2.0 / 255.0) - 1.0
    ours = normalize(torch.from_numpy(u), dtype)
    assert ours.dtype == dtype
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipeline_random_m101_shapes(dtype):
    """The flagship model (random init, m101 s16) through the pipeline at a
    CPU-sized frame."""
    model = load_model(101, 16, allow_random_init=True, compute_dtype=dtype,
                       device='cpu')
    pipe = PoseNetPipeline(model)
    assert pipe.device == torch.device('cpu')
    assert pipe.params['backbone'][5]['pw_w'].dtype == dtype
    assert pipe.params['heads']['offset']['b'].dtype == torch.float32
    pipe.warmup((65, 65), batch=1)
    out = pipe(np.random.RandomState(0).randint(0, 256, (2, 65, 65, 3), np.uint8))
    assert out.pose_scores.shape == (2, 10)
    assert out.keypoint_scores.shape == (2, 10, 17)
    assert out.keypoint_coords.shape == (2, 10, 17, 2)
    assert out.pose_offsets.shape == (2, 10, 17, 2)
    assert out.candidate_count.shape == (2,)
    for t in out:
        assert torch.isfinite(t.float()).all()
    with pytest.raises(ValueError, match="uint8"):
        pipe(np.zeros((1, 65, 65, 3), np.float32))


@pytest.mark.parametrize("build", ["load_model", "MobileNetV1", "decode_multiple_poses"])
def test_model_defaults_to_the_card(build, monkeypatch, tmp_path):
    """With no `device`, a model is built, and the reference-API decode
    runs, on the card: on a host without a CUDA device that raises, instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    heads = [np.zeros((c, 5, 5), np.float32) for c in (17, 34, 32, 32)]
    make = {'load_model': lambda: load_model(50, 16, model_dir=str(tmp_path),
                                             allow_random_init=True),
            'MobileNetV1': lambda: MobileNetV1(50, 16),
            'decode_multiple_poses': lambda: decode_multiple_poses(*heads, 16)}[build]
    with pytest.raises(RuntimeError, match="needs a CUDA device.*device='cpu'"):
        make()


def test_load_model_reads_checkpoint_or_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="allow_random_init"):
        load_model(50, 16, model_dir=str(tmp_path), device='cpu')
    shutil.copy(FIXTURE_PATH, tmp_path / 'mobilenet_v1_050.npz')
    model = load_model(50, 16, model_dir=str(tmp_path), device='cpu')
    ref = weights.params_from_jax(tfjs2jax.load_params_npz(FIXTURE_PATH))
    for a, b in zip(model.params['backbone'], ref['backbone']):
        for k in b:
            assert torch.equal(a[k], b[k])
    # random init is deterministic in the seed
    a = load_model(50, 16, model_dir=str(tmp_path / 'none'), allow_random_init=True,
                   device='cpu')
    b = load_model(50, 16, model_dir=str(tmp_path / 'none'), allow_random_init=True,
                   device='cpu')
    assert torch.equal(a.params['heads']['heatmap']['w'],
                       b.params['heads']['heatmap']['w'])
    assert isinstance(a.cfg, ModelConfig)
    assert mobilenet_v1.MOBILENET_V1_CHECKPOINTS[50] == 'mobilenet_v1_050'


def test_port_never_imports_jax():
    """Importing the port (every module of it) leaves jax unloaded."""
    code = ("import sys, posenet_tpu_torch, posenet_tpu_torch.ops._build, "
            "posenet_tpu_torch.ops.traversal, posenet_tpu_torch.ops.sepconv, "
            "posenet_tpu_torch.preprocess, posenet_tpu_torch.pipeline, "
            "posenet_tpu_torch.server, posenet_tpu_torch.serving, "
            "posenet_tpu_torch.native_preprocess, posenet_tpu_torch.draw, "
            "posenet_tpu_torch.utils, posenet_tpu_torch.visualizers, "
            "posenet_tpu_torch.profiling, posenet_tpu_torch.apps.image_demo, "
            "posenet_tpu_torch.apps.benchmark, posenet_tpu_torch.apps.webcam_demo, "
            "posenet_tpu_torch.apps.video_demo, posenet_tpu_torch.apps.streamlit_demo, "
            "posenet_tpu_torch.parallel.mesh, posenet_tpu_torch.parallel.spatial, "
            "posenet_tpu_torch.parallel.dryrun; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    subprocess.run([sys.executable, '-c', code], cwd=REPO_ROOT, check=True,
                   timeout=120)
