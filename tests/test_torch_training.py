"""The port's loss and training step against the JAX package's
(`posenet_tpu.training.loss` / `train_step`), at m50 on 33x33 inputs.

Tolerances:
- keypoint validity, disk targets and offset masks: equal (integer-valued
  arithmetic);
- offset targets: within 1 ulp (XLA:CPU may contract `kp*stride - grid`
  into an FMA under jit); BCE and smooth-L1: within 1e-6;
- per-item losses and `loss_fn`: within 1e-5 relative (float32 sums in
  another order), head gradients within 1e-5 of each head's max |grad|;
- three Adam steps from the same params and optax state: head params
  within 1e-3 * lr of optax's, the trunk bitwise unchanged;
- the bf16 step (the fused sepconv block's plain version on the CPU):
  within the JAX test's own rtol=0.05 of JAX's bf16 and f32 losses.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from optax._src.wrappers import MaskedNode

from posenet_tpu.config import ModelConfig as JaxModelConfig
from posenet_tpu.config import TrainConfig as JaxTrainConfig
from posenet_tpu.models import mobilenet_v1 as jax_mobilenet
from posenet_tpu.training import loss as jax_loss
from posenet_tpu.training import train_step as jax_ts

from posenet_tpu_torch.config import ModelConfig, TrainConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.ops import sepconv
from posenet_tpu_torch.training import loss
from posenet_tpu_torch.training import train_step as ts

from tests.test_torch_decode import cuda  # noqa: F401  (fixture)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG50 = ModelConfig(model_id=50, output_stride=16)
JAX_CFG50 = JaxModelConfig(model_id=50, output_stride=16)


def _keypoints(seed, b=3, p=4, grid=17):
    """(B, P, 17, 2) y-x grid keypoints: fractional parts on both sides of
    .5, cells at the border, whole poses and single keypoints missing."""
    rng = np.random.RandomState(seed)
    kp = rng.uniform(0, grid - 1, (b, p, 17, 2)).astype(np.float32)
    kp[0, 0, 0] = [10.7, 12.5]
    kp[0, 0, 1] = [0.9, grid - 1.4]
    kp[0, 1] = -1.0
    kp[1, 0, :5] = 0.0
    kp[2, 2, 3] = [-1.0, -1.0]
    kp[2, 3] = -1.0
    return kp


def _jax_params(seed):
    return jax_mobilenet.init_params(jax.random.PRNGKey(seed), JAX_CFG50)


def _port_params(jax_params):
    return weights.params_from_jax(jax.tree.map(np.asarray, jax_params))


def _batch(seed, b, p=3):
    rng = np.random.RandomState(seed)
    return {'image': rng.uniform(-1, 1, (b, 33, 33, 3)).astype(np.float32),
            'keypoints': rng.uniform(0, 2, (b, p, 17, 2)).astype(np.float32)}


def _step_batch(batch):
    return ts._step_batch(batch, torch.device('cpu'))


def _head_grads(params):
    """{(head, key): gradient as numpy in the JAX layout (HWIO kernels)}."""
    out = {}
    for name in ts.HEAD_NAMES:
        for k, t in params['heads'][name].items():
            g = t.grad.numpy()
            out[name, k] = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
    return out


@pytest.mark.parametrize('kernel_size', [7, 11, 15])
def test_loss_targets_match_jax(kernel_size):
    kp = _keypoints(kernel_size)
    validity = jax.jit(jax.vmap(jax_loss.keypoint_validity))(kp)
    disks = jax.jit(jax.vmap(lambda k: jax_loss.binary_disk_targets(k, 17, 17)))(kp)
    off, mask = jax.jit(jax.vmap(lambda k: jax_loss.offset_targets_and_mask(
        k, 17, 17, 16, kernel_size=kernel_size)))(kp)
    t_kp = torch.from_numpy(kp)
    t_off, t_mask = loss.offset_targets_and_mask(t_kp, 17, 17, 16, kernel_size=kernel_size)
    np.testing.assert_array_equal(loss.keypoint_validity(t_kp).numpy(), np.asarray(validity))
    np.testing.assert_array_equal(loss.binary_disk_targets(t_kp, 17, 17).numpy(),
                                  np.asarray(disks))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(mask))
    np.testing.assert_array_max_ulp(t_off.numpy(), np.asarray(off), maxulp=1)
    assert t_mask.sum() > 0 and t_mask.sum() < t_mask.numel()


def test_elementwise_losses_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.normal(0, 8, (4096,)).astype(np.float32)
    targets = (rng.uniform(size=4096) < 0.3).astype(np.float32)
    pred = rng.normal(0, 2, (4096,)).astype(np.float32)
    bce = jax.jit(jax_loss.bce_with_logits)(logits, targets)
    sl1 = jax.jit(jax_loss.smooth_l1)(pred, targets)
    np.testing.assert_allclose(
        loss.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets)).numpy(),
        np.asarray(bce), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        loss.smooth_l1(torch.from_numpy(pred), torch.from_numpy(targets)).numpy(),
        np.asarray(sl1), rtol=0, atol=1e-6)


def test_loss_kernel_size_defaults_track_ground_truth():
    """The loss's Gaussian kernel size defaults are the ground truth's."""
    import inspect

    from posenet_tpu_torch.training import ground_truth

    for fn, param in [(loss.offset_targets_and_mask, 'kernel_size'),
                      (loss.heatmap_offset_loss, 'gaussian_kernel_size'),
                      (loss.batched_loss, 'gaussian_kernel_size')]:
        default = inspect.signature(fn).parameters[param].default
        assert default == ground_truth.GAUSSIAN_KERNEL_SIZE, fn.__name__


def test_per_item_losses_match_jax():
    """`batched_loss(reduce=False)` keeps each item's mean to its own item
    (the JAX package vmaps a single-item loss), and the single-item
    `heatmap_offset_loss` is its row."""
    rng = np.random.RandomState(5)
    kp = _keypoints(5)
    logits = rng.normal(0, 3, (3, 17, 17, 17)).astype(np.float32)
    offsets = rng.normal(0, 20, (3, 17, 17, 34)).astype(np.float32)
    ref = jax.jit(lambda *a: jax_loss.batched_loss(*a, 16, reduce=False))(logits, offsets, kp)
    got = loss.batched_loss(torch.from_numpy(logits), torch.from_numpy(offsets),
                            torch.from_numpy(kp), 16, reduce=False)
    for k in ('loss', 'heatmap_loss', 'offset_loss'):
        assert got[k].shape == (3,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5)
    one = loss.heatmap_offset_loss(torch.from_numpy(logits[1]), torch.from_numpy(offsets[1]),
                                   torch.from_numpy(kp[1]), 16)
    assert float(one['loss']) == float(got['loss'][1])
    mean = loss.batched_loss(torch.from_numpy(logits), torch.from_numpy(offsets),
                             torch.from_numpy(kp), 16)
    assert float(mean['loss']) == float(got['loss'].mean())


@pytest.mark.parametrize('padded', [False, True], ids=['unweighted', 'pad_batch_to'])
def test_loss_fn_and_head_grads_match_jax(padded):
    """loss_fn and the heads' gradients against jax.value_and_grad(loss_fn),
    on a plain batch and on 10 items padded to 16 with zero weights (the
    padded case must equal the true 10-item batch)."""
    jp = _jax_params(1)
    batch = _batch(2, 10)
    if padded:
        batch = ts.pad_batch_to(batch, 16)
        assert batch['image'].shape[0] == 16
        np.testing.assert_array_equal(batch['weights'], [1.0] * 10 + [0.0] * 6)
        np.testing.assert_array_equal(batch['image'][10], batch['image'][0])
    jcfg = JaxTrainConfig(model_id=50)
    (ref_loss, ref_metrics), ref_grads = jax.jit(
        jax.value_and_grad(jax_ts.loss_fn, has_aux=True), static_argnums=(2, 3))(
            jp, jax_ts._step_batch(batch), JAX_CFG50, jcfg)
    state = ts.init_train_state(_port_params(jp), TrainConfig(model_id=50), 'cpu')
    loss_t, metrics = ts.loss_fn(state.params, _step_batch(batch), CFG50,
                                 TrainConfig(model_id=50))
    loss_t.backward()
    loss_t = loss_t.detach()
    np.testing.assert_allclose(float(loss_t), float(ref_loss), rtol=1e-5)
    for k in ('heatmap_loss', 'offset_loss'):
        np.testing.assert_allclose(float(metrics[k].detach()), float(ref_metrics[k]), rtol=1e-5)
    for (name, k), g in _head_grads(state.params).items():
        ref = np.asarray(ref_grads['heads'][name][k])
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-5 * max(np.abs(ref).max(), 1e-30))
    assert all(t.grad is None and not t.requires_grad
               for layer in state.params['backbone'] for t in layer.values())
    if padded:   # the padded batch's loss is the true batch's
        true_loss, _ = ts.loss_fn(state.params, _step_batch(_batch(2, 10)), CFG50,
                                  TrainConfig(model_id=50))
        np.testing.assert_allclose(float(loss_t), float(true_loss.detach()), rtol=1e-6)
    with pytest.raises(ValueError, match='padded down'):
        ts.pad_batch_to(_batch(2, 10), 8)


def _masked_to_none(tree):
    return jax.tree.map(lambda x: None if isinstance(x, MaskedNode) else np.asarray(x),
                        tree, is_leaf=lambda x: isinstance(x, MaskedNode))


def test_adam_steps_match_optax():
    """From the same params and the same optax state (after one JAX step,
    carried across with adam_state_from_jax), three steps of each package
    on the same batches: head params within 1e-3 * lr of optax's; the trunk
    bitwise unchanged (optax.masked would pass its zero gradients through;
    the port does not touch it)."""
    lr = 1e-3
    jcfg = JaxTrainConfig(model_id=50, learning_rate=lr)
    cfg = TrainConfig(model_id=50, learning_rate=lr)
    jstate, tx = jax_ts.init_train_state(_jax_params(4), jcfg)
    jstep = jax_ts.make_train_step(tx, JAX_CFG50, jcfg)
    jstate, _ = jstep(jstate, _batch(10, 4))

    state = ts.init_train_state(_port_params(jstate.params), cfg, 'cpu')
    adam = jstate.opt_state.inner_state[0]
    weights.adam_state_from_jax(_masked_to_none(adam.mu), _masked_to_none(adam.nu),
                                int(adam.count), state.params, state.optimizer)
    trunk_before = [{k: t.clone() for k, t in layer.items()}
                    for layer in state.params['backbone']]
    step = ts.make_train_step(CFG50, cfg)
    for i in range(3):
        batch = _batch(11 + i, 4)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m['loss']), float(jm['loss']), rtol=1e-5)
    assert state.step == 3 and int(jstate.step) == 4
    for name in ts.HEAD_NAMES:
        for k, t in state.params['heads'][name].items():
            got = t.detach().numpy()
            ref = np.asarray(jstate.params['heads'][name][k])
            got = got.transpose(2, 3, 1, 0) if got.ndim == 4 else got
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * lr)
    for layer, before in zip(state.params['backbone'], trunk_before):
        for k, t in layer.items():
            assert torch.equal(t, before[k])
    # A trainable tensor without moments is refused.
    adam_mu = _masked_to_none(adam.mu)
    adam_mu['heads']['offset']['w'] = None
    with pytest.raises(ValueError, match='no Adam moments'):
        weights.adam_state_from_jax(adam_mu, _masked_to_none(adam.nu), 1,
                                    state.params, state.optimizer)


def test_bf16_step_matches_jax_within_its_own_tolerance(monkeypatch):
    """--train_dtype bfloat16: the trunk (K2's plain version here, 13
    calls of the fused block a step at m50 s16) cast once, master params float32,
    only the heads move, the loss within rtol 0.05 of JAX's bf16 and f32
    losses (the JAX package's own bar between its two dtypes)."""
    batch = _batch(2, 2, p=4)
    jp = _jax_params(3)
    jax_losses = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        jcfg = JaxTrainConfig(model_id=50, compute_dtype=dtype)
        jstate, tx = jax_ts.init_train_state(jp, jcfg)
        _, m = jax_ts.make_train_step(
            tx, JaxModelConfig(model_id=50, output_stride=16, compute_dtype=dtype), jcfg)(
                jstate, batch)
        jax_losses[dtype] = float(m['loss'])

    cfg = TrainConfig(model_id=50, compute_dtype=torch.bfloat16)
    mcfg = ModelConfig(model_id=50, output_stride=16, compute_dtype=torch.bfloat16)
    state = ts.init_train_state(_port_params(jp), cfg, 'cpu')
    heads_before = state.params['heads']['heatmap']['w'].detach().clone()
    casts, launches = [], []
    cast_params, sepconv_call = ts.mobilenet_v1.cast_params, ts.mobilenet_v1.sepconv.sepconv
    monkeypatch.setattr(ts.mobilenet_v1, 'cast_params',
                        lambda *a, **k: casts.append(1) or cast_params(*a, **k))
    monkeypatch.setattr(ts.mobilenet_v1.sepconv, 'sepconv',
                        lambda *a: launches.append(a[1].shape) or sepconv_call(*a))
    step = ts.make_train_step(mcfg, cfg)
    state, m = step(state, batch)
    state, _ = step(state, batch)
    # the trunk is cast once, and the fused block reads its packed taps
    assert len(casts) == 1 and len(launches) == 2 * 13
    for ref in jax_losses.values():
        np.testing.assert_allclose(float(m['loss']), ref, rtol=0.05)
    assert state.params['heads']['heatmap']['w'].dtype == torch.float32
    assert state.params['backbone'][1]['pw_w'].dtype == torch.float32
    assert (state.params['heads']['heatmap']['w'] - heads_before).abs().max() > 0
    np.testing.assert_array_equal(
        state.params['backbone'][0]['w'].numpy(),
        np.asarray(jp['backbone'][0]['w']).transpose(3, 2, 0, 1))


def test_bf16_full_fine_tune_raises():
    cfg = TrainConfig(model_id=50, heads_only=False, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='heads_only'):
        ts.make_train_step(ModelConfig(model_id=50, compute_dtype=torch.bfloat16), cfg)
    with pytest.raises(ValueError, match='num_devices must be None or >= 1'):
        TrainConfig(num_devices=0)


def test_full_fine_tune_updates_the_trunk_in_float32():
    """heads_only=False: every tensor trains, through the cuDNN-route convs
    (never the fused block, which is bf16 only), as JAX's full fine-tune."""
    jp = _jax_params(6)
    batch = _batch(6, 2)
    jcfg = JaxTrainConfig(model_id=50, heads_only=False)
    jstate, tx = jax_ts.init_train_state(jp, jcfg)
    jstate, jm = jax_ts.make_train_step(tx, JAX_CFG50, jcfg)(jstate, batch)
    cfg = TrainConfig(model_id=50, heads_only=False)
    state = ts.init_train_state(_port_params(jp), cfg, 'cpu')
    assert len(state.optimizer.param_groups[0]['params']) == 14 * 4 - 2 + 8
    state, m = ts.make_train_step(CFG50, cfg)(state, batch)
    np.testing.assert_allclose(float(m['loss']), float(jm['loss']), rtol=1e-5)
    got = state.params['backbone'][5]['pw_w'].detach().numpy().transpose(2, 3, 1, 0)
    ref = np.asarray(jstate.params['backbone'][5]['pw_w'])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * cfg.learning_rate)
    assert np.abs(ref - np.asarray(jp['backbone'][5]['pw_w'])).max() > 0


def test_training_modules_import_no_jax():
    """The training modules, the training CLI and chip_smoke.py import no
    jax, optax, orbax or posenet_tpu."""
    code = ("import sys, posenet_tpu_torch.training, posenet_tpu_torch.training.trainer, "
            "posenet_tpu_torch.training.dataset, posenet_tpu_torch.training.metrics, "
            "posenet_tpu_torch.training.ground_truth, posenet_tpu_torch.apps.train, "
            "chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'orbax', 'posenet_tpu')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, '-c', code], cwd=REPO_ROOT, check=True, timeout=120)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_train_step_on_card_matches_cpu(cuda, dtype):   # noqa: F811
    """One m50 step on the card against the same step on the CPU: the loss
    within 1e-5 relative (f32) or 2e-3 (bf16, K2 against its plain
    version), each head's gradient within 1e-4 (f32) or 2e-2 (bf16) of its
    max |grad|; in bf16 the trunk launches K2 13 times."""
    jp = _jax_params(7)
    batch = _batch(7, 2)
    cfg = TrainConfig(model_id=50, compute_dtype=dtype)
    mcfg = ModelConfig(model_id=50, output_stride=16, compute_dtype=dtype)
    out = {}
    for name, device in (('cpu', torch.device('cpu')), ('cuda', cuda)):
        state = ts.init_train_state(_port_params(jp), cfg, device)
        sepconv.launches = 0
        state, m = ts.make_train_step(mcfg, cfg)(state, batch)
        torch.cuda.synchronize()
        out[name] = (float(m['loss']), {(n, k): t.grad.cpu() for n in ts.HEAD_NAMES
                                        for k, t in state.params['heads'][n].items()},
                     sepconv.launches)
    f32 = dtype == torch.float32
    np.testing.assert_allclose(out['cuda'][0], out['cpu'][0], rtol=1e-5 if f32 else 2e-3)
    for k, ref in out['cpu'][1].items():
        assert float((out['cuda'][1][k] - ref).abs().max()) <= (
            (1e-4 if f32 else 2e-2) * float(ref.abs().max()))
    assert out['cuda'][2] == (0 if f32 else 13)
