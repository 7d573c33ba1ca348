"""Training loop: heads-only fine-tuning with checkpoints, early stopping and
eval metrics, the counterpart of `posenet_tpu.training.trainer`.

Per epoch: a train pass of the heatmap+offset loss, then (with a test set)
an eval pass of the loss and of OKS / mAP over decoded poses, early
stopping with patience on the eval loss, and a checkpoint of the best
model. Checkpoints are this package's own `torch.save` files (float32
master params, the optimizer's `state_dict`, the step); the JAX package's
orbax checkpoints are not read.

Everything runs on the card unless the caller names the CPU
(`device='cpu'`); without a card the default raises. The eval decode is
`decode_batch`, whose tree walk is the CUDA kernel on the card.

Data parallelism (`TrainConfig.num_devices`) runs one process per device:
`train()` outside a `torch.distributed` world starts the ranks itself
(`parallel.mesh.launch`) and returns rank 0's final state; inside a world
(torchrun, `posenet-train-torch --distributed`) it runs as one rank. Every
rank iterates the same seeded batches and takes its slice of each; epoch
remainders are padded to the batch size with zero-weight items. Only rank
0 writes checkpoints, logs and visual dumps.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from posenet_tpu_torch.apps import full_float32
from posenet_tpu_torch.config import DecodeConfig, ModelConfig, TrainConfig
from posenet_tpu_torch.decode import decode_batch
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.models.model_factory import resolve_device
from posenet_tpu_torch.parallel import mesh as mesh_lib
from posenet_tpu_torch.pipeline import to_device
from posenet_tpu_torch.training import metrics as metrics_lib
from posenet_tpu_torch.training import train_step as ts
from posenet_tpu_torch.training.dataset import PosenetDataset

_CHECKPOINT = re.compile(r'step_\d+')


class MetricLogger:
    """Quiet-by-default structured metric sink with an optional wandb
    backend."""

    def __init__(self, use_wandb: bool = False, project: str = 'posenet',
                 verbose: bool = True):
        self.verbose = verbose
        self.wandb = None
        if use_wandb:
            try:
                import wandb
                wandb.init(project=project)
                self.wandb = wandb
            except ImportError:
                print('wandb not available; logging to stdout only')
        self.history = []

    def log(self, data: Dict, step: Optional[int] = None):
        self.history.append(dict(data))
        if self.wandb is not None:
            self.wandb.log(data, step=step)
        if self.verbose:
            parts = ' '.join(f'{k}={v:.4f}' if isinstance(v, float) else f'{k}={v}'
                             for k, v in data.items())
            print(parts)


def save_checkpoint(ckpt_dir: str, state: ts.TrainState,
                    best_val_loss: Optional[float] = None) -> str:
    """Write `<ckpt_dir>/step_<N>`: the float32 master params (on the
    host), the optimizer's `state_dict` and the step. The file is written
    under a temporary name and renamed, so that a cut save leaves no file
    that `restore_checkpoint` would take."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f'step_{int(state.step)}'))
    if best_val_loss is not None:
        # Sidecar so that a resumed run does not overwrite the best model
        # with a worse one at a higher step. Written BEFORE the checkpoint:
        # restore_checkpoint picks the latest step, so a crash between the
        # two must leave the STRICTER bound (the new loss with no matching
        # checkpoint: a resumed run then saves nothing worse than the lost
        # model, rather than letting a worse later step win the restore).
        with open(os.path.join(ckpt_dir, 'best.json'), 'w') as f:
            json.dump({'step': int(state.step),
                       'val_loss': float(best_val_loss)}, f)
    tmp = path + '.tmp'
    try:
        torch.save({'params': ts.tree_map(lambda t: t.detach().cpu(), state.params),
                    'optimizer': state.optimizer.state_dict(),
                    'step': int(state.step)}, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load_best_val_loss(ckpt_dir: str) -> float:
    try:
        with open(os.path.join(ckpt_dir, 'best.json')) as f:
            return float(json.load(f)['val_loss'])
    except (OSError, ValueError, KeyError):
        return float('inf')


def _params_like(template, loaded, path: str):
    """`loaded` (host tensors) laid out, shaped and placed as `template`,
    each tensor requiring gradients where the template's does."""
    try:
        out = ts.tree_map(lambda t: t, template)
        for layer, src in zip(out['backbone'] + list(out['heads'].values()),
                              loaded['backbone'] + [loaded['heads'][n] for n in out['heads']]):
            if set(layer) != set(src):
                raise KeyError(f'keys {sorted(src)}, expected {sorted(layer)}')
            for k, t in layer.items():
                if src[k].shape != t.shape:
                    raise ValueError(f'{k}: {tuple(src[k].shape)}, expected {tuple(t.shape)}')
                layer[k] = src[k].to(device=t.device, dtype=torch.float32
                                     ).requires_grad_(t.requires_grad)
        if len(loaded['backbone']) != len(template['backbone']):
            raise ValueError(f"{len(loaded['backbone'])} trunk layers, expected "
                             f"{len(template['backbone'])}")
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f'checkpoint {path} does not fit this model: {e}') from e
    return out


def restore_checkpoint(ckpt_dir: str, template: ts.TrainState) -> Optional[ts.TrainState]:
    """The latest `step_<N>` checkpoint in `ckpt_dir` as a new state laid
    out and placed as `template` (whose optimizer's class and settings it
    takes), or None when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    # Only completed checkpoints: a cut save's temporary file must not
    # crash (or win) the resume that exists to recover from it.
    steps = [d for d in os.listdir(ckpt_dir) if _CHECKPOINT.fullmatch(d)]
    if not steps:
        return None
    latest = max(steps, key=lambda d: int(d.split('_')[1]))
    path = os.path.join(ckpt_dir, latest)
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    params = _params_like(template.params, ckpt['params'], path)
    trained = [t for layer in params['backbone'] + list(params['heads'].values())
               for t in layer.values() if t.requires_grad]
    optimizer = type(template.optimizer)(trained, **template.optimizer.defaults)
    optimizer.load_state_dict(ckpt['optimizer'])
    return ts.TrainState(params, optimizer, int(ckpt['step']))


def score_decoded_poses(kp_coords: np.ndarray, pose_scores: np.ndarray,
                        gt_keypoints: np.ndarray, output_stride: int):
    """Score decoded predictions against GT keypoints for one batch.

    Args:
      kp_coords: (B, P, 17, 2) decoded keypoint coords, image px.
      pose_scores: (B, P) decoded pose scores (0 = empty slot).
      gt_keypoints: (B, Pmax, 17, 2) GT grid coords, sentinel-padded.
    Returns: (mean OKS, mean mAP, n_scored): means over the n_scored
    SCOREABLE images only (an image with neither predictions nor GT is
    excluded, not scored 0). Callers aggregating across batches weight by
    n_scored, not batch size.
    """
    oks_vals, maps = [], []
    for b in range(kp_coords.shape[0]):
        n_pred = int((pose_scores[b] > 0).sum())
        gt = np.asarray(gt_keypoints[b])
        gt_present = ~np.all((gt == 0) | (gt == -1), axis=(1, 2))
        gt_poses = gt[gt_present].astype(np.float64)
        # grid -> px, but keep the (0,0)/(-1,-1) missing-keypoint
        # sentinels UNscaled, or the metrics would take every unannotated
        # keypoint for a real annotation.
        sentinel = np.all((gt_poses == 0) | (gt_poses == -1), axis=-1,
                          keepdims=True)
        gt_poses = np.where(sentinel, gt_poses,
                            gt_poses * output_stride)
        preds = kp_coords[b, :n_pred]
        if n_pred == 0 and len(gt_poses) == 0:
            continue  # nothing to score either way
        # Zero-prediction images with GT (and predictions with no GT) are
        # scored: threshold_sweep counts every keypoint of unmatched poses
        # as FN/FP, so OKS/recall/mAP drop to 0 instead of the image
        # vanishing from the average.
        pairs = metrics_lib.match_poses(preds, gt_poses)
        oks_vals.append(metrics_lib.calculate_oks(pairs, preds, gt_poses))
        _, _, ap = metrics_lib.threshold_sweep(preds, gt_poses)
        maps.append(ap)
    return (float(np.mean(oks_vals)) if oks_vals else 0.0,
            float(np.mean(maps)) if maps else 0.0,
            len(oks_vals))


def _decode(params, images, model_cfg: ModelConfig, decode_cfg: DecodeConfig):
    """Forward + `decode_batch` of a numpy image batch on the params'
    device; returns (heads, DecodedPoses)."""
    with torch.no_grad():
        out = mobilenet_v1.forward(ts.compute_params(params, model_cfg),
                                   to_device(images, ts.params_device(params)), model_cfg)
        decoded = decode_batch(out['heatmap'], out['offset'], out['displacement_fwd'],
                               out['displacement_bwd'], model_cfg.output_stride, decode_cfg)
    return out, decoded


def evaluate_poses(params, batch, model_cfg: ModelConfig,
                   decode_cfg: DecodeConfig, n_real: int = None,
                   mesh: Optional[mesh_lib.Mesh] = None):
    """Decode predictions for a batch on the params' device and score them
    against GT keypoints on the host (Hungarian matching, OKS, mAP).

    `n_real` scores only the first n images: wrap-padded batches carry
    duplicates in the trailing slots. With a world mesh each rank decodes
    and scores its slice of the batch (zero-padded to divide), and the
    scored counts and sums are added over the ranks. Returns (mean OKS,
    mean mAP, n_scored), see score_decoded_poses."""
    n_real = batch['image'].shape[0] if n_real is None else n_real
    images, keypoints, lo = batch['image'], np.asarray(batch['keypoints']), 0
    if mesh is not None:
        images = mesh_lib.pad_batch(np.asarray(images), mesh)
        ((lo, hi),) = mesh_lib.shard_bounds(images.shape[0], mesh)
        images, keypoints = images[lo:hi], keypoints[lo:hi]
    _, decoded = _decode(params, images, model_cfg, decode_cfg)
    sl = slice(max(0, n_real - lo))
    oks, ap, scored = score_decoded_poses(
        decoded.keypoint_coords.cpu().numpy()[sl],
        decoded.pose_scores.cpu().numpy()[sl],
        keypoints[sl], model_cfg.output_stride)
    if mesh is None:
        return oks, ap, scored
    sums = torch.tensor([oks * scored, ap * scored, scored], dtype=torch.float64,
                        device=mesh.devices[0])
    dist.all_reduce(sums, group=mesh.group)
    oks_sum, ap_sum, scored = sums.tolist()
    scored = int(scored)
    return (oks_sum / scored if scored else 0.0, ap_sum / scored if scored else 0.0,
            scored)


def _model_cfg(train_cfg: TrainConfig) -> ModelConfig:
    return ModelConfig(model_id=train_cfg.model_id, output_stride=train_cfg.output_stride,
                       compute_dtype=train_cfg.compute_dtype)


def train_mesh(train_cfg: TrainConfig, device: torch.device) -> Optional[mesh_lib.Mesh]:
    """The world mesh of a data-parallel run, this rank's device of
    `device`'s type on it; None on one device, outside a world. Raises for
    `num_devices` > 1 outside a world (`train()` starts the ranks itself),
    or a batch size that does not divide over the ranks."""
    n = train_cfg.num_devices
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(
                f'num_devices={n} runs {n} processes: train() starts them outside a '
                f'torch.distributed world; otherwise run under posenet-train-torch '
                f'--num_devices {n} or torchrun')
        return None
    mesh = mesh_lib.make_mesh(n, devices=[mesh_lib.local_device(device)])
    if train_cfg.batch_size % mesh.size:
        raise ValueError(f'batch_size {train_cfg.batch_size} does not divide over '
                         f'{mesh.size} data-parallel ranks')
    return mesh


def evaluate(dataset: PosenetDataset, train_cfg: TrainConfig, params,
             eval_pose_metrics: bool = True,
             device: torch.device | str = 'cuda') -> Dict[str, float]:
    """Standalone evaluation: loss + OKS/mAP over a dataset, no training.

    The eval path the training loop runs per epoch, for `--eval_only` and
    notebooks, on `device` (see `resolve_device`); inside a world, over the
    ranks (`train_mesh`), each batch padded to the batch size with zero
    weights. Returns a flat dict: loss / heatmap_loss / offset_loss
    per-image means, plus oks / mAP when eval_pose_metrics, plus n_images
    scored."""
    device = resolve_device(device)
    full_float32()   # the heads, the loss and Adam are float32: no TF32 on the card
    mesh = train_mesh(train_cfg, device)
    if mesh is not None:
        device = mesh.devices[0]
    model_cfg = _model_cfg(train_cfg)
    decode_cfg = DecodeConfig(min_pose_score=0.25, score_threshold=0.25)
    params = ts.tree_map(lambda t: t.detach().to(device=device, dtype=torch.float32), params)
    eval_fn = ts.make_eval_step(model_cfg, train_cfg, mesh=mesh, per_item=True)

    loss_sums: Dict[str, float] = {}
    oks_sum = map_sum = 0.0
    n_images = 0
    n_scored = 0
    for batch in dataset.iter_batches(train_cfg.batch_size, shuffle=False,
                                      drop_remainder=False, augment=False):
        real = batch['image'].shape[0]
        per_item = eval_fn(params, batch if mesh is None
                           else ts.pad_batch_to(batch, train_cfg.batch_size))
        for k, v in per_item.items():
            loss_sums[k] = loss_sums.get(k, 0.0) + float(v[:real].sum())
        n_images += real
        if eval_pose_metrics:
            # Weight by the number of SCOREABLE images in the batch:
            # score_decoded_poses averages over those only.
            oks, ap, scored = evaluate_poses(params, batch, model_cfg,
                                             decode_cfg, n_real=real, mesh=mesh)
            oks_sum += oks * scored
            map_sum += ap * scored
            n_scored += scored

    report = {k: v / max(n_images, 1) for k, v in loss_sums.items()}
    report['n_images'] = n_images
    if eval_pose_metrics and n_images:
        report['oks'] = oks_sum / max(n_scored, 1)
        report['mAP'] = map_sum / max(n_scored, 1)
        report['n_scored'] = n_scored
    return report


def dump_visual_diagnostics(params, batch, dataset: PosenetDataset,
                            model_cfg: ModelConfig, decode_cfg: DecodeConfig,
                            output_dir: str, epoch: int):
    """Write predicted heatmap channels + keypoint overlays for one batch
    under `<output_dir>/epoch_<epoch>/<stem>/`."""
    import cv2

    from posenet_tpu_torch import visualizers

    out, decoded = _decode(params, batch['image'], model_cfg, decode_cfg)
    heatmaps = out['heatmap'].permute(0, 3, 1, 2).cpu().numpy()  # (B,17,R,R)
    pose_scores = decoded.pose_scores.cpu().numpy()
    kp_scores = decoded.keypoint_scores.cpu().numpy()
    kp_coords = decoded.keypoint_coords.cpu().numpy()

    epoch_dir = os.path.join(output_dir, f'epoch_{epoch}')
    for b, fname in enumerate(batch['filenames']):
        stem = os.path.splitext(fname)[0]
        item_dir = os.path.join(epoch_dir, stem)
        visualizers.print_heatmap(heatmaps[b], output_dir=item_dir,
                                  use_matplotlib=False)
        image_path = os.path.join(dataset.image_dir, fname)
        # overlay on the original image: decode coords are in resized-input
        # px, so scale by original/resized per (y, x)
        orig = cv2.imread(image_path)
        if orig is None:
            continue
        scale = np.array([orig.shape[0] / batch['image'].shape[1],
                          orig.shape[1] / batch['image'].shape[2]])
        visualizers.draw_coordinates_to_image_file(
            image_path, os.path.join(item_dir, stem + '_keypoints.jpg'),
            pose_scores[b], kp_scores[b], kp_coords[b], scale,
            min_pose_score=0.25, min_part_score=0.25, image=orig)


def train(train_dataset: PosenetDataset,
          test_dataset: Optional[PosenetDataset],
          train_cfg: TrainConfig,
          logger: Optional[MetricLogger] = None,
          params=None,
          resume: bool = True,
          eval_pose_metrics: bool = True,
          device: torch.device | str = 'cuda') -> ts.TrainState:
    """Run the fine-tuning loop on `device` (see `resolve_device`); returns
    the final TrainState. `params`: the starting weights (the port's
    pytree, on any device); None draws random ones from
    `torch.Generator().manual_seed(train_cfg.seed)`.

    `train_cfg.num_devices` > 1 outside a `torch.distributed` world starts
    that many ranks on this host (NCCL on the cards, gloo on the CPU),
    each running this function, and returns rank 0's final state, placed
    on `device`; inside a world each rank runs on its own device."""
    device = resolve_device(device)
    logger = logger or MetricLogger()
    if train_cfg.num_devices not in (None, 1) and not dist.is_initialized():
        return _train_in_ranks(train_dataset, test_dataset, train_cfg, logger, params,
                               resume, eval_pose_metrics, device)
    full_float32()   # the heads, the loss and Adam are float32: no TF32 on the card
    mesh = train_mesh(train_cfg, device)
    if mesh is not None:
        device = mesh.devices[0]
    lead = mesh is None or mesh.rank == 0   # the rank that writes
    model_cfg = _model_cfg(train_cfg)
    if params is None:
        params = mobilenet_v1.init_params(
            torch.Generator().manual_seed(train_cfg.seed), model_cfg)

    state = ts.init_train_state(params, train_cfg, device)
    resumed = False
    if resume:
        restored = restore_checkpoint(train_cfg.checkpoint_dir, state)
        if restored is not None:
            state = restored
            resumed = True
            if lead:
                print(f'resumed from step {int(state.step)}')

    step_fn = ts.make_train_step(model_cfg, train_cfg, mesh=mesh)
    eval_fn = ts.make_eval_step(model_cfg, train_cfg, mesh=mesh)
    # Over a mesh every batch must divide over the ranks, so an epoch
    # remainder is padded up to the batch size with zero-weight wrap items
    # (exact gradients of the true batch, pad_batch_to).
    fit = ((lambda b: b) if mesh is None
           else (lambda b: ts.pad_batch_to(b, train_cfg.batch_size)))
    if mesh is not None and lead and len(train_dataset) % train_cfg.batch_size:
        print(f'note: mesh-sharded training pads the '
              f'{len(train_dataset) % train_cfg.batch_size}-image epoch remainder up to '
              f'batch {train_cfg.batch_size} with zero-weight items (exact gradients)')

    decode_cfg = DecodeConfig(min_pose_score=0.25, score_threshold=0.25)
    # Across restarts the best-so-far eval loss is kept next to the
    # checkpoints; the early-stop patience counter restarts.
    best_val_loss = (_load_best_val_loss(train_cfg.checkpoint_dir)
                     if resumed else float('inf'))
    no_improve = 0

    for epoch in range(train_cfg.num_epochs):
        t0 = time.time()
        train_losses = []
        # The last partial batch is kept (drop_remainder=False), at its
        # own shape.
        for batch in train_dataset.iter_batches(
                train_cfg.batch_size, shuffle=True,
                seed=train_cfg.seed + epoch, drop_remainder=False):
            state, m = step_fn(state, fit(batch))
            train_losses.append(m)

        # One host read per metric and epoch; the steps queue meanwhile.
        train_metrics = {k: float(np.mean([float(m[k]) for m in train_losses]))
                         for k in train_losses[0]} if train_losses else {}

        log = {'epoch': epoch, **{f'train_{k}': v for k, v in train_metrics.items()}}

        if test_dataset is not None:
            eval_losses = []   # (batch-mean loss, real item count) pairs
            oks_vals, map_vals = [], []
            for batch in test_dataset.iter_batches(
                    train_cfg.batch_size, shuffle=False,
                    drop_remainder=False, augment=False):
                eval_losses.append((eval_fn(state.params, fit(batch)),
                                    batch['image'].shape[0]))
                if eval_pose_metrics:
                    # scored-count weighting: see evaluate()
                    oks, ap, scored = evaluate_poses(state.params, batch,
                                                     model_cfg, decode_cfg, mesh=mesh)
                    oks_vals.append((oks, scored))
                    map_vals.append((ap, scored))
            val_loss = (sum(float(m['loss']) * n for m, n in eval_losses)
                        / sum(n for _, n in eval_losses))
            log['test_loss'] = val_loss
            n_scored = sum(s for _, s in oks_vals)
            if eval_pose_metrics and n_scored:
                log['oks'] = sum(v * s for v, s in oks_vals) / n_scored
                log['mAP'] = sum(v * s for v, s in map_vals) / n_scored

            # Early stopping, saving the best model.
            if val_loss < best_val_loss:
                best_val_loss = val_loss
                no_improve = 0
                if lead:
                    save_checkpoint(train_cfg.checkpoint_dir, state,
                                    best_val_loss=val_loss)
            else:
                no_improve += 1
        elif lead:
            save_checkpoint(train_cfg.checkpoint_dir, state)

        if (lead and train_cfg.visual_every > 0
                and epoch % train_cfg.visual_every == 0):
            vis_ds = test_dataset if test_dataset is not None else train_dataset
            vis_gen = vis_ds.iter_batches(
                min(train_cfg.batch_size, len(vis_ds)), shuffle=False,
                drop_remainder=True)
            try:
                vis_batch = next(vis_gen)
            finally:
                vis_gen.close()  # retire the prefetch producer thread
            dump_visual_diagnostics(state.params, vis_batch, vis_ds,
                                    model_cfg, decode_cfg,
                                    train_cfg.output_dir, epoch)

        log['epoch_time_s'] = time.time() - t0
        if lead:
            logger.log(log, step=int(state.step))

        if test_dataset is not None and no_improve >= train_cfg.early_stop_patience:
            if lead:
                print(f'early stop at epoch {epoch} '
                      f'(no improvement for {no_improve} epochs)')
            break

    return state


def _train_rank(result_dir: str, train_dataset, test_dataset, train_cfg: TrainConfig,
                use_wandb: bool, verbose: bool, params, resume: bool,
                eval_pose_metrics: bool, device: str):
    """One rank of `_train_in_ranks`: `train()` in the world; rank 0 writes
    its final state and its log to `result_dir`."""
    logger = MetricLogger(use_wandb=use_wandb, verbose=verbose)
    state = train(train_dataset, test_dataset, train_cfg, logger=logger, params=params,
                  resume=resume, eval_pose_metrics=eval_pose_metrics, device=device)
    if dist.get_rank() == 0:
        save_checkpoint(result_dir, state)
        with open(os.path.join(result_dir, 'history.json'), 'w') as f:
            json.dump(logger.history, f)


def _train_in_ranks(train_dataset, test_dataset, train_cfg: TrainConfig,
                    logger: MetricLogger, params, resume: bool, eval_pose_metrics: bool,
                    device: torch.device) -> ts.TrainState:
    """`train()` over `train_cfg.num_devices` ranks started on this host;
    rank 0's final state (on `device`), its log appended to `logger`."""
    if params is not None:
        params = ts.tree_map(lambda t: t.detach().cpu(), params)
    with tempfile.TemporaryDirectory() as result_dir:
        mesh_lib.launch(_train_rank, train_cfg.num_devices,
                        args=(result_dir, train_dataset, test_dataset, train_cfg,
                              logger.wandb is not None, logger.verbose, params, resume,
                              eval_pose_metrics, device.type),
                        backend='nccl' if device.type == 'cuda' else 'gloo')
        if params is None:
            params = mobilenet_v1.init_params(
                torch.Generator().manual_seed(train_cfg.seed), _model_cfg(train_cfg))
        state = restore_checkpoint(result_dir, ts.init_train_state(params, train_cfg, device))
        with open(os.path.join(result_dir, 'history.json')) as f:
            logger.history.extend(json.load(f))
    return state
