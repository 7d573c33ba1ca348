"""The training step: loss -> gradients -> Adam over the trainable tensors.

The counterpart of `posenet_tpu.training.train_step`. Heads-only
fine-tuning freezes the trunk: its tensors do not require gradients, the
forward runs it under `torch.no_grad()` (`mobilenet_v1.forward(...,
stop_trunk_gradient=True)`), and Adam holds only the heads, so the trunk is
never updated at all (the JAX package's `optax.masked` passes the trunk's
zero gradients through as updates).

Mixed precision (`compute_dtype=bfloat16`) needs `heads_only`: the frozen
trunk runs in bf16, through the fused sepconv kernel on its separable
layers, cast once from the float32 master tensors
(`compute_params`); the heads, the loss and Adam's state stay float32.

Data parallelism runs one process per device (a world mesh,
`parallel.mesh.make_mesh`): every rank is handed the same global batch and
takes its slice. The step's loss is the GLOBAL batch's weighted mean, as
the JAX package's step over a mesh computes it: each rank divides its
items' weighted loss sum by the global batch's weight sum, and the
gradients and metrics are summed over the ranks (one all-reduce a step).
DistributedDataParallel would average the ranks' own means instead, which
differs wherever the zero-weight pads of `pad_batch_to` fall unevenly over
the ranks. Adam then steps identically on every rank, so the parameters
stay replicated bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from posenet_tpu_torch.config import ModelConfig, TrainConfig
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.parallel import mesh as mesh_lib
from posenet_tpu_torch.pipeline import to_device
from posenet_tpu_torch.training.loss import batched_loss

HEAD_NAMES = ('heatmap', 'offset', 'displacement_fwd', 'displacement_bwd')


class TrainState(NamedTuple):
    params: Any                        # float32 master tensors (see init_params)
    optimizer: torch.optim.Optimizer   # Adam over the trainable tensors of params
    step: int


def tree_map(fn: Callable[[torch.Tensor], Any], params) -> Dict[str, Any]:
    """`fn` over every tensor of a parameter pytree, keeping its layout."""
    return {
        'backbone': [{k: fn(v) for k, v in layer.items()} for layer in params['backbone']],
        'heads': {name: {k: fn(v) for k, v in p.items()}
                  for name, p in params['heads'].items()},
    }


def params_device(params) -> torch.device:
    return params['heads']['heatmap']['w'].device


def trainable_mask(params, heads_only: bool = True):
    """Pytree of bools: which tensors train. Heads-only freezes the trunk."""
    mask = tree_map(lambda _: True, params)
    if heads_only:
        mask['backbone'] = [{k: False for k in layer} for layer in params['backbone']]
    return mask


def trainable_tensors(params, heads_only: bool = True):
    """The tensors `trainable_mask` selects, in pytree order (the trunk's
    layers, then the heads)."""
    mask = trainable_mask(params, heads_only)
    out = []
    for layer, m in zip(params['backbone'] + list(params['heads'].values()),
                        mask['backbone'] + list(mask['heads'].values())):
        out += [t for k, t in layer.items() if m[k]]
    return out


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Adam:
    """Adam with optax.adam's defaults, over the trainable tensors only."""
    return torch.optim.Adam(trainable_tensors(params, cfg.heads_only),
                            lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def compute_params(params, model_cfg: ModelConfig):
    """The parameters the forward runs on. float32: `params` as they are.
    bfloat16: the trunk cast by `mobilenet_v1.cast_params` (bf16 kernels,
    the fused block's packed depthwise taps) beside the float32 master
    heads, whose gradients Adam reads."""
    if model_cfg.compute_dtype == torch.float32:
        return params
    with torch.no_grad():
        trunk = mobilenet_v1.cast_params({'backbone': params['backbone'], 'heads': {}},
                                         model_cfg.compute_dtype)['backbone']
    return {'backbone': trunk, 'heads': params['heads']}


def loss_fn(params, batch: Dict[str, torch.Tensor], model_cfg: ModelConfig,
            train_cfg: TrainConfig, reduce: bool = True,
            weight_total: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: {'image': (B,H,W,3) float in [-1,1], 'keypoints': (B,P,17,2),
    optionally 'weights': (B,) per-item loss weights (1 real / 0 padding,
    see pad_batch_to)}, tensors on the device of `params`.

    reduce=False returns per-item (B,) metric vectors instead of batch
    means. `weight_total`: the weighted mean's denominator, when `batch`
    is one rank's shard of a global batch (the global weight sum; default
    the batch's own). Train, eval and per-item eval all route through
    here."""
    out = mobilenet_v1.forward(params, batch['image'], model_cfg,
                               stop_trunk_gradient=train_cfg.heads_only)
    metrics = batched_loss(
        out['heatmap_logits'], out['offset'], batch['keypoints'],
        model_cfg.output_stride,
        heatmap_weight=train_cfg.heatmap_loss_weight,
        offset_weight=train_cfg.offset_loss_weight, reduce=False)
    if not reduce:
        return metrics['loss'], metrics
    w = batch.get('weights')
    if w is None:
        metrics = {k: v.mean() for k, v in metrics.items()}
    else:
        # Weighted mean over REAL items only: with {0,1} weights this is
        # the unpadded batch's mean, and so are its gradients.
        denom = w.sum() if weight_total is None else weight_total
        metrics = {k: (v * w).sum() / denom for k, v in metrics.items()}
    return metrics['loss'], metrics


def all_reduce_sum(tensors: List[torch.Tensor], group) -> None:
    """Sum each tensor over the ranks of `group`, in place, with one
    collective over their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _summed_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The metrics, detached; with `group`, summed over its ranks."""
    if group is None:
        return {k: v.detach() for k, v in metrics.items()}
    values = torch.stack([v.detach() for v in metrics.values()])
    all_reduce_sum([values], group)
    return dict(zip(metrics, values.unbind()))


def train_step(state: TrainState, batch, model_cfg: ModelConfig,
               train_cfg: TrainConfig, run_params=None,
               weight_total: Optional[torch.Tensor] = None, group=None):
    """One step on a batch of tensors (`_step_batch`). `run_params`: what
    the forward runs on, `compute_params(state.params, ...)` (default
    `state.params`). With `group`, `batch` is this rank's shard of a
    global batch whose weight sum is `weight_total`: the gradients and the
    metrics are summed over the group before Adam steps. The gradients stay
    on the trainable tensors' `.grad` until the next step. Returns the
    state, with its tensors updated in place, and the (global) batch's
    metrics as detached tensors."""
    run_params = state.params if run_params is None else run_params
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(run_params, batch, model_cfg, train_cfg,
                            weight_total=weight_total)
    loss.backward()
    if group is not None:
        trained = [t for g in state.optimizer.param_groups for t in g['params']]
        for t in trained:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        all_reduce_sum([t.grad for t in trained], group)
    metrics = _summed_metrics(metrics, group)
    state.optimizer.step()
    return TrainState(state.params, state.optimizer, state.step + 1), metrics


def eval_step(params, batch, model_cfg: ModelConfig, train_cfg: TrainConfig,
              weight_total: Optional[torch.Tensor] = None, group=None):
    with torch.no_grad():
        _, metrics = loss_fn(params, batch, model_cfg, train_cfg,
                             weight_total=weight_total)
    return _summed_metrics(metrics, group)


def eval_step_per_item(params, batch, model_cfg: ModelConfig,
                       train_cfg: TrainConfig, weight_total=None, group=None):
    """Per-item (B,) metric vectors, no batch mean: trainer.evaluate()
    slices off wrap-padding duplicates and weights partial batches by their
    true size, so that its eval loss is an exact per-image mean. With
    `group`, the ranks' shards are gathered in rank order: the global
    batch's vectors."""
    with torch.no_grad():
        _, metrics = loss_fn(params, batch, model_cfg, train_cfg, reduce=False)
    if group is None:
        return metrics
    values = torch.stack(list(metrics.values()))
    parts = [torch.empty_like(values) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, values, group=group)
    return dict(zip(metrics, torch.cat(parts, dim=1).unbind()))


def init_train_state(params, cfg: TrainConfig,
                     device: torch.device | str | None = None) -> TrainState:
    """A fresh state over float32 copies of `params` on `device` (None:
    where they are), so that training never writes the caller's tensors."""
    params = tree_map(lambda t: t.detach().to(device=device, dtype=torch.float32,
                                              copy=True), params)
    for t in trainable_tensors(params, cfg.heads_only):
        t.requires_grad_(True)
    return TrainState(params, make_optimizer(cfg, params), 0)


_STEP_KEYS = ('image', 'keypoints')


def _step_batch(batch, device: torch.device):
    """Project a dataset batch onto the keys the step consumes, as tensors
    on `device` (numpy arrays are uploaded through pinned memory); extra
    host-side entries ('filenames') are dropped. 'weights' is all-ones
    when absent, so that padded and unpadded batches take one path."""
    out = {k: to_device(batch[k], device) for k in _STEP_KEYS}
    w = batch.get('weights')
    out['weights'] = (torch.ones(out['image'].shape[0], device=device)
                      if w is None else to_device(w, device))
    return out


def _shard_step_batch(batch, device: torch.device, mesh: mesh_lib.Mesh):
    """This rank's shard of a global batch as `_step_batch` gives it,
    and the global batch's weight sum (on `device`). Only the shard's
    images are uploaded."""
    w = batch.get('weights')
    b = batch['image'].shape[0]
    weights = torch.ones(b, device=device) if w is None else to_device(w, device)
    ((lo, hi),) = mesh_lib.shard_bounds(b, mesh)
    out = {k: to_device(batch[k][lo:hi], device) for k in _STEP_KEYS}
    out['weights'] = weights[lo:hi]
    return out, weights.sum()


def pad_batch_to(batch, n: int):
    """Pad a short numpy batch up to `n` items with a 'weights' vector
    zeroing the pads, so that the step's weighted-mean loss equals the
    TRUE batch's mean. Pads WRAP real items rather than zero-filling: an
    all-sentinel zero sample could produce NaN metrics that a 0 weight
    cannot cancel (0 * nan = nan)."""
    b = int(batch['image'].shape[0])
    if b > n:
        raise ValueError(f'batch of {b} cannot be padded down to {n}')
    out = dict(batch)
    if b < n:
        idx = np.resize(np.arange(b), n)
        out['image'] = np.asarray(batch['image'])[idx]
        out['keypoints'] = np.asarray(batch['keypoints'])[idx]
    out['weights'] = (np.arange(n) < b).astype(np.float32)
    return out


class _RunParams:
    """`compute_params`, made again only when the trunk is other tensors:
    the frozen trunk is cast once, not at every step."""

    def __init__(self, model_cfg: ModelConfig):
        self.model_cfg = model_cfg
        self._trunk_of = self._trunk = None

    def __call__(self, params):
        if params['backbone'] is not self._trunk_of:
            self._trunk = compute_params(params, self.model_cfg)['backbone']
            self._trunk_of = params['backbone']
        return {'backbone': self._trunk, 'heads': params['heads']}


def _check_mesh(mesh: Optional[mesh_lib.Mesh]):
    if mesh is not None and len(mesh.devices) != 1:
        raise ValueError(f'training runs one process per device: a training mesh holds '
                         f'this rank\'s one device, got {list(mesh.devices)} (start ranks '
                         f'with TrainConfig.num_devices, posenet-train-torch --num_devices '
                         f'or torchrun)')


def _batch_on(batch, device: torch.device, mesh: Optional[mesh_lib.Mesh]):
    """(the step's tensors, the kwargs that make them one rank's shard)."""
    if mesh is None:
        return _step_batch(batch, device), {}
    shard, total = _shard_step_batch(batch, device, mesh)
    return shard, {'weight_total': total, 'group': mesh.group}


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    mesh: Optional[mesh_lib.Mesh] = None):
    """The step as a callable (state, batch) -> (state, metrics), on numpy
    or tensor batches carrying at least 'image' and 'keypoints'. With a
    world mesh, every rank calls it with the same global batch, whose size
    must divide over the mesh (`pad_batch_to` pads it with zero weights);
    each rank computes its slice and the step is the global batch's."""
    if model_cfg.compute_dtype != torch.float32 and not train_cfg.heads_only:
        raise ValueError(
            "mixed-precision training (compute_dtype=bfloat16) requires "
            "heads_only=True: full fine-tuning would differentiate through the "
            "bf16 trunk, whose fused sepconv kernel has no backward")
    _check_mesh(mesh)
    run = _RunParams(model_cfg)

    def step(state: TrainState, batch):
        tensors, shard = _batch_on(batch, params_device(state.params), mesh)
        return train_step(state, tensors, model_cfg, train_cfg,
                          run_params=run(state.params), **shard)
    return step


def make_eval_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                   mesh: Optional[mesh_lib.Mesh] = None, per_item: bool = False):
    """The eval step as a callable (params, batch) -> metrics; `per_item`
    returns (B,) metric vectors instead of batch means. With a world mesh,
    as `make_train_step`: the global batch's metrics on every rank."""
    _check_mesh(mesh)
    fn = eval_step_per_item if per_item else eval_step
    run = _RunParams(model_cfg)

    def evaluate(params, batch):
        tensors, shard = _batch_on(batch, params_device(params), mesh)
        return fn(run(params), tensors, model_cfg, train_cfg, **shard)
    return evaluate
