"""The port's dataset, trainer, checkpoints and training CLI against the JAX
package's (`posenet_tpu.training.dataset` / `trainer`, root `train.py`), at
m50 on 65x65 inputs, on the CPU (`device='cpu'`, `--device cpu`).

Tolerances:
- ground truth files and dataset batches: equal (the same numpy code on
  the same files; the shuffle and flip RNGs are numpy's, seeded alike);
- `train()` against JAX's `train()` from the same params, 3 epochs: each
  epoch's train and test loss within 1e-4 relative (float32 sums in
  another order, compounded over 6 Adam steps);
- `evaluate`: losses within 1e-5 relative, OKS and mAP within 1e-3 (the
  decoders agree bit for bit on equal heads; the heads differ by float32
  rounding);
- metrics and pose scoring on equal inputs: equal;
- a checkpoint restores bitwise, and a `--from_checkpoint` artifact is
  bitwise equal to `PoseNetPipeline` over the restored params.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from posenet_tpu.config import ModelConfig as JaxModelConfig
from posenet_tpu.config import TrainConfig as JaxTrainConfig
from posenet_tpu.models import mobilenet_v1 as jax_mobilenet
from posenet_tpu.training import ground_truth as jax_gt
from posenet_tpu.training import metrics as jax_metrics
from posenet_tpu.training import trainer as jax_trainer
from posenet_tpu.training.dataset import PosenetDataset as JaxDataset

from posenet_tpu_torch import PoseNetPipeline
from posenet_tpu_torch.apps import train as train_cli
from posenet_tpu_torch.config import ModelConfig, TrainConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.models.model_factory import PoseNet
from posenet_tpu_torch.serving import load_serving_artifact
from posenet_tpu_torch.serving import main as export_main
from posenet_tpu_torch.training import ground_truth, metrics, trainer
from posenet_tpu_torch.training import train_step as ts
from posenet_tpu_torch.training.dataset import PosenetDataset

from tests.make_fixture_checkpoint import FIXTURE_PATH
from tests.test_trainer import make_synthetic_dataset
from tests.torch_offline import offline_download  # noqa: F401 (autouse)

JAX_CFG50 = JaxModelConfig(model_id=50, output_stride=16)


def _jax_params(seed=0):
    return jax_mobilenet.init_params(jax.random.PRNGKey(seed), JAX_CFG50)


def _port_params(jax_params):
    return weights.params_from_jax(jax.tree.map(np.asarray, jax_params))


def _tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), 'rb') as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.mark.parametrize('fmt', ['dataloop', 'roboflow'])
def test_prepare_ground_truth_matches_jax(tmp_path, fmt):
    images, _ = make_synthetic_dataset(str(tmp_path), n_images=3)
    labels = os.path.join(str(tmp_path), 'labels')
    if fmt == 'roboflow':
        rng = np.random.RandomState(1)
        for i in range(3):
            with open(os.path.join(labels, f'img{i}.txt'), 'w') as f:
                for c in (0, 4, 9, 17):
                    f.write(f'{c} {rng.uniform(0.1, 0.9):.6f} {rng.uniform(0.1, 0.9):.6f}\n')
    out = {}
    for name, prepare in (('jax', jax_gt.prepare_ground_truth_data),
                          ('port', ground_truth.prepare_ground_truth_data)):
        kpdir = os.path.join(str(tmp_path), f'kp_{name}')
        stems = prepare(images, labels, keypoints_updated_dir=kpdir,
                        annotation_format=fmt)
        out[name] = (stems, _tree_files(kpdir))
    assert out['port'][0] == out['jax'][0] == ['img0', 'img1', 'img2']
    assert out['port'][1] == out['jax'][1] and len(out['port'][1]) == 6


_DATASET_CASES = {
    # (n_images, dataset kwargs, iter_batches kwargs)
    'prefetch_cached': (5, dict(), dict(batch_size=2, shuffle=True, seed=3, prefetch=2)),
    'sync_uncached': (5, dict(cache_images=False),
                      dict(batch_size=2, shuffle=True, seed=3, prefetch=0,
                           drop_remainder=False)),
    'wrap_if_short': (3, dict(), dict(batch_size=8, shuffle=False, drop_remainder=True,
                                      wrap_if_short=True)),
    'flip': (8, dict(augment_flip=True), dict(batch_size=4, shuffle=True, seed=7)),
    'flip_overridden': (6, dict(augment_flip=True),
                        dict(batch_size=2, shuffle=False, augment=False)),
    'scale_factor': (2, dict(image_size=513, scale_factor=0.5),
                     dict(batch_size=2, shuffle=True, seed=1)),
}


@pytest.mark.parametrize('case', list(_DATASET_CASES))
def test_dataset_batches_match_jax(tmp_path, case):
    n_images, ds_kwargs, it_kwargs = _DATASET_CASES[case]
    images, kpdir = make_synthetic_dataset(str(tmp_path), n_images=n_images)
    ds_kwargs = {'image_size': 65, 'output_stride': 16, **ds_kwargs}
    ref_ds = JaxDataset(images, kpdir, **ds_kwargs)
    ds = PosenetDataset(images, kpdir, **ds_kwargs)
    assert ds.image_size == ref_ds.image_size and len(ds) == len(ref_ds)
    np.testing.assert_array_equal(ds.keypoints, ref_ds.keypoints)
    np.testing.assert_array_equal(ds.offset_vectors, ref_ds.offset_vectors)
    ref = list(ref_ds.iter_batches(**it_kwargs))
    got = list(ds.iter_batches(**it_kwargs))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a['filenames'] == b['filenames']
        np.testing.assert_array_equal(a['image'], b['image'])
        np.testing.assert_array_equal(a['keypoints'], b['keypoints'])
    if case == 'flip':   # the coin lands both ways
        plain = list(PosenetDataset(images, kpdir, image_size=65).iter_batches(
            **{**it_kwargs, 'augment': False}))
        flipped = sum(not np.array_equal(p, f) for pb, fb in zip(plain, got)
                      for p, f in zip(pb['image'], fb['image']))
        assert 0 < flipped < 8


def test_metrics_and_scoring_match_jax():
    rng = np.random.RandomState(0)
    preds = rng.uniform(0, 60, (3, 17, 2))
    gts = rng.uniform(0, 60, (2, 17, 2))
    gts[0, :4] = -1.0
    preds[1, 2] = 0.0
    assert metrics.match_poses(preds, gts) == jax_metrics.match_poses(preds, gts)
    pairs = metrics.match_poses(preds, gts)
    assert metrics.calculate_oks(pairs, preds, gts) == jax_metrics.calculate_oks(pairs, preds, gts)
    for got, ref in zip(metrics.threshold_sweep(preds, gts),
                        jax_metrics.threshold_sweep(preds, gts)):
        np.testing.assert_array_equal(got, ref)
    assert metrics.precision_recall(preds, gts) == jax_metrics.precision_recall(preds, gts)

    gt = np.full((3, 15, 17, 2), -1.0, np.float32)
    gt[0, 0] = rng.uniform(2, 30, (17, 2))
    gt[1, :2] = rng.uniform(2, 30, (2, 17, 2))
    kp_coords = rng.uniform(0, 500, (3, 10, 17, 2))
    pose_scores = np.zeros((3, 10))
    pose_scores[0, :3] = 0.9
    pose_scores[2, 0] = 0.5
    kp_coords[0, 0] = gt[0, 0] * 16
    got = trainer.score_decoded_poses(kp_coords, pose_scores, gt, 16)
    assert got == jax_trainer.score_decoded_poses(kp_coords, pose_scores, gt, 16)
    assert got[2] == 3 and 0 < got[0] < 1
    # an image with no GT and no prediction is excluded, not scored 0
    assert trainer.score_decoded_poses(np.zeros((1, 10, 17, 2)), np.zeros((1, 10)),
                                       gt[2:], 16) == (0.0, 0.0, 0)


def _trained_state(tmp_path):
    """A state one step in (Adam's moments not empty)."""
    cfg = TrainConfig(model_id=50, checkpoint_dir=str(tmp_path))
    state = ts.init_train_state(_port_params(_jax_params()), cfg, 'cpu')
    rng = np.random.RandomState(0)
    batch = {'image': rng.uniform(-1, 1, (2, 33, 33, 3)).astype(np.float32),
             'keypoints': rng.uniform(0, 2, (2, 3, 17, 2)).astype(np.float32)}
    step = ts.make_train_step(ModelConfig(model_id=50), cfg)
    state, _ = step(state, batch)
    return state, step, batch, cfg


def test_checkpoint_roundtrip_ignores_temp_files(tmp_path):
    state, step, batch, cfg = _trained_state(tmp_path)
    path = trainer.save_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == 'step_1' and not os.path.exists(path + '.tmp')
    # a cut save's leftovers never win (or crash) the restore
    with open(os.path.join(str(tmp_path), 'step_7.tmp'), 'wb') as f:
        f.write(b'cut')
    os.makedirs(os.path.join(str(tmp_path), 'step_9.orbax-checkpoint-tmp'))
    template = ts.init_train_state(_port_params(_jax_params(5)), cfg, 'cpu')
    restored = trainer.restore_checkpoint(str(tmp_path), template)
    assert restored.step == 1
    for a, b in zip(ts.trainable_tensors(state.params) + [state.params['backbone'][3]['pw_w']],
                    ts.trainable_tensors(restored.params)
                    + [restored.params['backbone'][3]['pw_w']]):
        assert torch.equal(a.detach(), b.detach()) and a.requires_grad == b.requires_grad
    # the optimizer resumes where it was: the next step is the same
    _, m1 = step(state, batch)
    _, m2 = step(restored, batch)
    assert float(m1['loss']) == float(m2['loss'])
    for a, b in zip(ts.trainable_tensors(state.params), ts.trainable_tensors(restored.params)):
        assert torch.equal(a.detach(), b.detach())
    assert trainer.restore_checkpoint(str(tmp_path / 'nope'), template) is None
    only_tmp = tmp_path / 'only_tmp'
    os.makedirs(only_tmp / 'step_3.orbax-checkpoint-tmp')
    (only_tmp / 'step_4.tmp').write_bytes(b'')
    assert trainer.restore_checkpoint(str(only_tmp), template) is None
    # a checkpoint of another model is refused
    other = ts.init_train_state(mobilenet_v1.init_params(
        torch.Generator().manual_seed(0), ModelConfig(model_id=75)), TrainConfig(model_id=75))
    with pytest.raises(ValueError, match='does not fit'):
        trainer.restore_checkpoint(str(tmp_path), other)


def test_best_val_loss_kept_across_resume_and_written_first(tmp_path, monkeypatch):
    state, _, _, _ = _trained_state(tmp_path)
    assert trainer._load_best_val_loss(str(tmp_path)) == float('inf')
    trainer.save_checkpoint(str(tmp_path), state, best_val_loss=0.125)
    assert trainer._load_best_val_loss(str(tmp_path)) == 0.125

    def boom(*a, **k):
        raise RuntimeError('simulated crash mid-save')

    monkeypatch.setattr(trainer.torch, 'save', boom)
    crashed = str(tmp_path / 'crashed')
    with pytest.raises(RuntimeError, match='simulated crash'):
        trainer.save_checkpoint(crashed, state, best_val_loss=0.25)
    assert trainer._load_best_val_loss(crashed) == 0.25
    assert os.listdir(crashed) == ['best.json']


def test_train_matches_jax_and_resumes(tmp_path):
    """3 epochs of each package's train() from the same params on the same
    dataset (2 steps an epoch, eval on the same images), then the port
    resumes from its checkpoint."""
    images, kpdir = make_synthetic_dataset(str(tmp_path))
    jp = _jax_params()
    hist = {}
    for name in ('jax', 'port'):
        ckpt = str(tmp_path / f'ckpt_{name}')
        if name == 'jax':
            ds = JaxDataset(images, kpdir, image_size=65, output_stride=16)
            logger = jax_trainer.MetricLogger(verbose=False)
            jax_trainer.train(ds, ds, JaxTrainConfig(
                model_id=50, batch_size=2, learning_rate=3e-3, num_epochs=3,
                checkpoint_dir=ckpt), logger=logger, params=jp, resume=False,
                eval_pose_metrics=False)
        else:
            ds = PosenetDataset(images, kpdir, image_size=65, output_stride=16)
            logger = trainer.MetricLogger(verbose=False)
            state = trainer.train(ds, ds, TrainConfig(
                model_id=50, batch_size=2, learning_rate=3e-3, num_epochs=3,
                checkpoint_dir=ckpt), logger=logger, params=_port_params(jp),
                resume=False, eval_pose_metrics=False, device='cpu')
        hist[name] = logger.history
    assert state.step == 6
    for got, ref in zip(hist['port'], hist['jax'], strict=True):
        for k in ('train_loss', 'train_heatmap_loss', 'train_offset_loss', 'test_loss'):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    assert hist['port'][-1]['train_loss'] < hist['port'][0]['train_loss']
    assert any(d.startswith('step_') for d in os.listdir(tmp_path / 'ckpt_port'))
    # resume: the same checkpoint dir picks up the step
    resumed = trainer.train(ds, None, TrainConfig(
        model_id=50, batch_size=2, num_epochs=1, checkpoint_dir=str(tmp_path / 'ckpt_port')),
        logger=trainer.MetricLogger(verbose=False), params=_port_params(jp), device='cpu')
    assert resumed.step > 2


def test_train_remainder_not_dropped_and_visuals(tmp_path):
    """5 images at batch 2 make 3 steps an epoch, 5 at batch 8 one; with
    visual_every=1 each epoch dumps heatmaps and overlays."""
    images, kpdir = make_synthetic_dataset(str(tmp_path), n_images=5)
    ds = PosenetDataset(images, kpdir, image_size=65, output_stride=16)
    params = _port_params(_jax_params())
    out_dir = str(tmp_path / 'out')
    state = trainer.train(ds, None, TrainConfig(
        model_id=50, batch_size=2, num_epochs=1, checkpoint_dir=str(tmp_path / 'c1'),
        output_dir=out_dir, visual_every=1), logger=trainer.MetricLogger(verbose=False),
        params=params, resume=False, device='cpu')
    assert state.step == 3
    item = os.path.join(out_dir, 'epoch_0', 'img0')
    assert os.path.exists(os.path.join(item, 'image_0', 'joint_0_heatmap.png'))
    import cv2
    overlay = cv2.imread(os.path.join(item, 'img0_keypoints.jpg'))
    assert overlay is not None and overlay.shape[:2] == (80, 80)
    state = trainer.train(ds, None, TrainConfig(
        model_id=50, batch_size=8, num_epochs=1, checkpoint_dir=str(tmp_path / 'c2')),
        logger=trainer.MetricLogger(verbose=False), params=params, resume=False,
        device='cpu')
    assert state.step == 1


def test_evaluate_matches_jax(tmp_path):
    """Fixture weights, 3 images at batch 2 (a partial last batch): the
    per-image means and OKS/mAP against JAX's evaluate."""
    images, kpdir = make_synthetic_dataset(str(tmp_path), n_images=3)
    npz = weights.load_params_npz(FIXTURE_PATH)
    ref = jax_trainer.evaluate(JaxDataset(images, kpdir, image_size=65),
                               JaxTrainConfig(model_id=50, batch_size=2),
                               jax.tree.map(np.asarray, npz))
    ds = PosenetDataset(images, kpdir, image_size=65)
    got = trainer.evaluate(ds, TrainConfig(model_id=50, batch_size=2),
                           weights.params_from_jax(npz), device='cpu')
    assert got['n_images'] == ref['n_images'] == 3
    assert got['n_scored'] == ref['n_scored']
    for k in ('loss', 'heatmap_loss', 'offset_loss'):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    for k in ('oks', 'mAP'):
        assert abs(got[k] - ref[k]) <= 1e-3, (k, got[k], ref[k])
    # the partial batch is weighted by its size: batch 1 gives the same means
    one = trainer.evaluate(ds, TrainConfig(model_id=50, batch_size=1),
                           weights.params_from_jax(npz), eval_pose_metrics=False,
                           device='cpu')
    assert 'oks' not in one
    np.testing.assert_allclose(one['loss'], got['loss'], rtol=1e-5)


def test_entry_points_default_to_the_card(tmp_path):
    """train(), evaluate() and the CLI run on the card unless asked for the
    CPU, and raise without one, data-parallel too (before any rank starts)."""
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the defaults run there')
    images, kpdir = make_synthetic_dataset(str(tmp_path), n_images=2)
    ds = PosenetDataset(images, kpdir, image_size=65)
    cfg = TrainConfig(model_id=50, checkpoint_dir=str(tmp_path / 'c'))
    params = _port_params(_jax_params())
    with pytest.raises(RuntimeError, match='CUDA'):
        trainer.train(ds, None, cfg, params=params)
    with pytest.raises(RuntimeError, match='CUDA'):
        trainer.evaluate(ds, cfg, params)
    argv = ['--model', '50', '--train_image_dir', images, '--keypoint_dir', kpdir,
            '--image_size', '65', '--allow_random_init']
    with pytest.raises(RuntimeError, match='CUDA'):
        train_cli.main(argv)
    for extra in (['--num_devices', '2'], ['--distributed']):
        with pytest.raises(RuntimeError, match='CUDA'):
            train_cli.main(argv + extra)
    with pytest.raises(RuntimeError, match='CUDA'):
        trainer.train(ds, None, TrainConfig(model_id=50, num_devices=2,
                                            checkpoint_dir=str(tmp_path / 'c')), params=params)


def test_train_cli_eval_only_and_export_from_checkpoint(tmp_path, capsys):
    """`--eval_only` prints one JSON line and writes nothing; a one-epoch
    run with `--export_artifact` writes a cpu artifact; `posenet-export-torch
    --from_checkpoint` exports the checkpoint, bitwise equal to
    PoseNetPipeline over the restored params; `--eval_only` then restores it."""
    images, kpdir = make_synthetic_dataset(str(tmp_path))
    ckpt = str(tmp_path / 'ckpt')
    argv = ['--model', '50', '--train_image_dir', images,
            '--test_image_dir', str(tmp_path / 'none'), '--keypoint_dir', kpdir,
            '--image_size', '65', '--checkpoint_dir', ckpt, '--batch_size', '2',
            '--allow_random_init', '--device', 'cpu', '--no_pose_metrics']
    train_cli.main(argv + ['--eval_only'])
    out = capsys.readouterr().out
    assert 'no checkpoint found' in out
    report = json.loads(out.strip().splitlines()[-1])
    assert np.isfinite(report['loss']) and report['n_images'] == 4
    assert not os.path.exists(ckpt)

    trained = str(tmp_path / 'trained.posenet')
    train_cli.main(argv + ['--num_epochs', '1', '--export_artifact', trained,
                           '--export_dtype', 'float32'])
    assert os.path.exists(os.path.join(ckpt, 'step_2'))
    assert 'exported serving artifact' in capsys.readouterr().out

    path = str(tmp_path / 'from_ckpt.posenet')
    export_main(['--model', '50', '--size', '65', '65', '--batch_sizes', '2',
                 '--platforms', 'cpu', '--compute_dtype', 'float32',
                 '--from_checkpoint', ckpt, '--output', path])
    cfg = TrainConfig(model_id=50)
    restored = trainer.restore_checkpoint(ckpt, ts.init_train_state(
        _port_params(_jax_params(3)), cfg, 'cpu'))
    frames = np.random.RandomState(0).randint(0, 256, (2, 65, 65, 3), dtype=np.uint8)
    pipe = PoseNetPipeline(PoseNet(ts.tree_map(torch.Tensor.detach, restored.params),
                                   ModelConfig(model_id=50)), device='cpu')
    for name, batch in ((path, frames), (trained, frames[:1])):
        got = load_serving_artifact(name, device='cpu')(batch)
        for a, b in zip(got.as_tuple(), pipe(batch).as_tuple()):
            assert torch.equal(a, b)
    with pytest.raises(SystemExit, match='no checkpoint'):
        export_main(['--model', '50', '--platforms', 'cpu', '--output', path,
                     '--from_checkpoint', str(tmp_path / 'none')])

    train_cli.main(argv + ['--eval_only'])
    assert 'restored checkpoint step 2' in capsys.readouterr().out
