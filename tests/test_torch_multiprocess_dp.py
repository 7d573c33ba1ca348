"""The port's data-parallel fine-tuning across real processes: ranks of a
gloo world on the CPU, one process each, against the JAX package's step
over a 2-device mesh and against the port's single-device step and
`train()`.

The step (tests/torch_dp_worker.py, two processes joined through
`initialize_distributed`'s explicit arguments) is held to the bars of
tests/test_torch_training.py: the loss and its parts within 1e-5 relative,
each head's gradient within 1e-5 of its max |grad| (against
`jax.value_and_grad` of the global batch's loss, the gradient JAX's mesh
step applies); the two ranks' heads bitwise equal. `train()` over 2 ranks
is held to the single-device `train()`'s logged losses within 1e-5
relative.

The heads after Adam are held by the update they make: the difference from
the reference's heads within 1e-3 (one step) or 1e-2 (`train()`'s six) of
the reference update's L2 norm, per tensor. Not element by element: Adam
divides each gradient by its own running magnitude, so where a gradient is at the level of float rounding
(a channel the batch barely reaches) rounding noise, which the ranks' sum
and one device's sum order differently, becomes up to a whole step of lr
on that one element (seen: one offset bias of 34, 7.2e-5 after 6 steps at
lr 3e-3, every other element within 1e-7).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from posenet_tpu.config import ModelConfig as JaxModelConfig
from posenet_tpu.config import TrainConfig as JaxTrainConfig
from posenet_tpu.models import mobilenet_v1 as jax_mobilenet
from posenet_tpu.parallel import mesh as jax_mesh
from posenet_tpu.training import train_step as jax_ts

from posenet_tpu_torch.config import ModelConfig, TrainConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.training import train_step as ts
from posenet_tpu_torch.training import trainer
from posenet_tpu_torch.training.dataset import PosenetDataset

from tests.test_trainer import make_synthetic_dataset
from tests.torch_offline import offline_download  # noqa: F401 (autouse)
from tests.torch_offline import write_random_checkpoint

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO_ROOT, 'tests', 'torch_dp_worker.py')
CFG50 = ModelConfig(model_id=50, output_stride=16)
JAX_CFG50 = JaxModelConfig(model_id=50, output_stride=16)
# (global batch, the size it is padded to with zero-weight items)
CASES = {'b8': (8, 8), 'b3_padded_to_4': (3, 4)}


def _update_gap(after, ref_after, before) -> float:
    """||after - ref_after|| / ||ref_after - before||, over one tensor."""
    after, ref_after, before = (np.asarray(t, np.float64) for t in (after, ref_after, before))
    return float(np.linalg.norm(after - ref_after) / np.linalg.norm(ref_after - before))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def dp_runs(tmp_path_factory):
    """Both ranks' results for every case, from one pair of processes, with
    the JAX parameters and batches they were given."""
    root = tmp_path_factory.mktemp('dp')
    jax_params = jax.tree.map(np.asarray, jax_mobilenet.init_params(jax.random.PRNGKey(1),
                                                                   JAX_CFG50))
    torch.save(weights.params_from_jax(jax_params), root / 'params.pt')
    rng = np.random.RandomState(1)
    batches = {}
    for i, (n, pad) in enumerate(CASES.values()):
        batches[f'image{i}'] = rng.uniform(-1, 1, (n, 33, 33, 3)).astype(np.float32)
        batches[f'keypoints{i}'] = rng.uniform(0, 2, (n, 3, 17, 2)).astype(np.float32)
        batches[f'pad{i}'] = pad
    np.savez(root / 'batches.npz', **batches)

    env = dict(os.environ, PYTHONPATH=REPO_ROOT, GLOO_SOCKET_IFNAME='lo')
    coord = f'127.0.0.1:{_free_port()}'
    procs = [subprocess.Popen([sys.executable, WORKER, coord, str(r), '2', str(root)],
                              env=env, cwd=REPO_ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, f'rank failed:\n{out}'
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(root / f'rank{r}.pt', weights_only=False) for r in range(2)]
    return jax_params, batches, ranks


@pytest.mark.parametrize('case', list(CASES))
def test_two_rank_step_matches_jax_mesh_step(dp_runs, case):
    jax_params, batches, ranks = dp_runs
    i = list(CASES).index(case)
    batch = ts.pad_batch_to({'image': batches[f'image{i}'],
                             'keypoints': batches[f'keypoints{i}']}, CASES[case][1])
    jcfg = JaxTrainConfig(model_id=50)
    (_, ref_metrics), ref_grads = jax.jit(
        jax.value_and_grad(jax_ts.loss_fn, has_aux=True), static_argnums=(2, 3))(
            jax_params, jax_ts._step_batch(batch), JAX_CFG50, jcfg)
    mesh = jax_mesh.make_mesh(2)
    state, tx = jax_ts.init_train_state(jax.tree.map(jnp.asarray, jax_params), jcfg)
    new_state, metrics = jax_ts.make_train_step(tx, JAX_CFG50, jcfg, mesh=mesh)(
        jax_mesh.replicate(state, mesh), jax_mesh.shard_batch(batch, mesh))

    got = ranks[0][i]
    for k, v in got['metrics'].items():
        assert ranks[1][i]['metrics'][k] == v
        np.testing.assert_allclose(v, float(metrics[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(v, float(ref_metrics[k]), rtol=1e-5, err_msg=k)
    for (name, k), g in got['grads'].items():
        ref = np.asarray(ref_grads['heads'][name][k])
        g = g.numpy().transpose(2, 3, 1, 0) if g.ndim == 4 else g.numpy()
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-5 * max(np.abs(ref).max(), 1e-30))
    for (name, k), t in got['heads'].items():
        assert torch.equal(t, ranks[1][i]['heads'][name, k])   # replicated bit for bit
        t = t.numpy().transpose(2, 3, 1, 0) if t.ndim == 4 else t.numpy()
        before = jax_params['heads'][name][k]
        if name.startswith('displacement'):   # the loss does not read them
            np.testing.assert_array_equal(t, before)
            continue
        assert _update_gap(t, new_state.params['heads'][name][k], before) <= 1e-3, (name, k)

    # against the port's own single-device step on the TRUE batch, and its
    # per-item eval vectors gathered in rank order
    port = ts.init_train_state(weights.params_from_jax(jax_params), TrainConfig(model_id=50),
                               'cpu')
    true_batch = {'image': batches[f'image{i}'], 'keypoints': batches[f'keypoints{i}']}
    port, m = ts.make_train_step(CFG50, TrainConfig(model_id=50))(port, true_batch)
    np.testing.assert_allclose(got['metrics']['loss'], float(m['loss']), rtol=1e-6)
    per_item = ts.make_eval_step(CFG50, TrainConfig(model_id=50), per_item=True)(
        port.params, batch)
    for k, v in got['per_item'].items():
        assert ranks[1][i]['per_item'][k].shape == (CASES[case][1],)
        np.testing.assert_allclose(v.numpy(), per_item[k].numpy(), rtol=1e-5, err_msg=k)


def test_train_over_two_ranks_matches_one_device(tmp_path, capfd):
    """`train()` with num_devices=2 starts two gloo ranks itself; 5 images
    in batches of 2 leave a remainder of 1, which the ranks pad to the
    batch with a zero-weight item (JAX's note printed once, by rank 0) and
    one device runs at its own size: the same losses and heads. Rank 0
    alone writes the checkpoints."""
    images, kpdir = make_synthetic_dataset(str(tmp_path), n_images=5)
    ds = PosenetDataset(images, kpdir, image_size=65, output_stride=16)
    params = mobilenet_v1.init_params(torch.Generator().manual_seed(3), CFG50)
    runs = {}
    for n in (None, 2):
        cfg = TrainConfig(model_id=50, batch_size=2, learning_rate=3e-3, num_epochs=2,
                          checkpoint_dir=str(tmp_path / f'ckpt_{n}'), num_devices=n)
        logger = trainer.MetricLogger(verbose=False)
        state = trainer.train(ds, ds, cfg, logger=logger, params=params, resume=False,
                              eval_pose_metrics=True, device='cpu')
        runs[n] = state, logger.history
    out = capfd.readouterr().out
    assert out.count('pads the 1-image epoch remainder up to batch 2') == 1
    (one, one_log), (two, two_log) = runs[None], runs[2]
    assert two.step == one.step == 6
    assert len(two_log) == len(one_log) == 2
    for got, ref in zip(two_log, one_log):
        for k in ('train_loss', 'train_heatmap_loss', 'train_offset_loss', 'test_loss',
                  'oks', 'mAP'):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    for name in ts.HEAD_NAMES[:2]:   # the loss does not read the displacements
        for k, t in two.params['heads'][name].items():
            gap = _update_gap(t.detach(), one.params['heads'][name][k].detach(),
                              params['heads'][name][k])
            assert gap <= 1e-2, (name, k, gap)
    assert sorted(os.listdir(tmp_path / 'ckpt_2')) == sorted(os.listdir(tmp_path / 'ckpt_None'))


def test_train_cli_over_two_ranks(tmp_path, capfd, monkeypatch):
    """`posenet-train-torch --num_devices 2 --device cpu` starts two ranks
    of itself; rank 0 alone prints and writes its checkpoint. Then
    `--eval_only` over two ranks (3 images in batches of 2: the remainder
    padded with a zero-weight item) prints the single-device `evaluate`'s
    report, within 1e-5 relative. The spawned ranks keep no download stub,
    so ./_models holds the seed-0 weights that allow_random_init draws."""
    import json

    from posenet_tpu_torch.apps import train as train_cli

    monkeypatch.chdir(tmp_path)
    write_random_checkpoint(tmp_path / '_models', 50)
    images, kpdir = make_synthetic_dataset(str(tmp_path), n_images=3)
    ckpt = tmp_path / 'ckpt'
    argv = ['--model', '50', '--train_image_dir', images, '--keypoint_dir', kpdir,
            '--test_image_dir', str(tmp_path / 'none'), '--image_size', '65',
            '--checkpoint_dir', str(ckpt), '--batch_size', '2', '--allow_random_init',
            '--device', 'cpu', '--num_devices', '2']
    train_cli.main(argv + ['--num_epochs', '1', '--no_pose_metrics'])
    out = capfd.readouterr().out
    assert out.count('distributed: process 0/2') == 1
    assert 'distributed: process 1/2' not in out
    assert out.count('epoch=0') == 1
    assert os.listdir(ckpt) == ['step_2']

    train_cli.main(argv + ['--eval_only'])
    lines = capfd.readouterr().out.splitlines()
    assert lines.count('eval: restored checkpoint step 2 from ' + str(ckpt)) == 1
    report = json.loads(lines[-1])
    ds = PosenetDataset(images, kpdir, image_size=65, output_stride=16)
    template = ts.init_train_state(mobilenet_v1.init_params(torch.Generator().manual_seed(0),
                                                            CFG50), TrainConfig(model_id=50))
    params = trainer.restore_checkpoint(str(ckpt), template).params
    ref = trainer.evaluate(ds, TrainConfig(model_id=50, batch_size=2), params, device='cpu')
    assert report['n_images'] == ref['n_images'] == 3
    assert report['n_scored'] == ref['n_scored']
    for k in ('loss', 'heatmap_loss', 'offset_loss', 'oks', 'mAP'):
        np.testing.assert_allclose(report[k], ref[k], rtol=1e-5, err_msg=k)
