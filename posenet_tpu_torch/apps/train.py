"""Training CLI on the port: heads-only fine-tuning on Dataloop or Roboflow
ground truth.

The flags and defaults of the repository's `train.py`, with `--device`
added (default the card; `cpu` for the host). `--prepare_gt` runs the
ground-truth generator first; checkpoints (this package's own `torch.save`
format, not the JAX package's orbax ones) resume automatically;
`--eval_only` prints one JSON line of eval loss and OKS/mAP;
`--export_artifact` exports the best checkpoint as a serving artifact.
Data parallelism runs one process per device: `--num_devices N` starts N
ranks on this host (NCCL on the cards, gloo with `--device cpu`), each
running this CLI; `--distributed` joins a world from the environment
(torchrun's variables, one process per card, any number of hosts). Rank 0
writes the checkpoints, the log and the artifact.

    python -m posenet_tpu_torch.apps.train --model 50 --train_image_dir ./images_train \
        --prepare_gt ./labels --allow_random_init [--device cpu] [--num_devices 2]
    torchrun --nproc_per_node 4 -m posenet_tpu_torch.apps.train --distributed ...
"""

import argparse
import json
import os
import sys

import torch
import torch.distributed as dist

from posenet_tpu_torch.apps import add_device_flag
from posenet_tpu_torch.config import ModelConfig, TrainConfig
from posenet_tpu_torch.models import model_factory
from posenet_tpu_torch.parallel import mesh as mesh_lib
from posenet_tpu_torch.training import train_step as ts
from posenet_tpu_torch.training.dataset import PosenetDataset
from posenet_tpu_torch.training.trainer import (MetricLogger, evaluate,
                                                restore_checkpoint, train)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', type=int, default=101)
    parser.add_argument('--train_image_dir', type=str, default='./images_train')
    parser.add_argument('--test_image_dir', type=str, default='./images_test')
    parser.add_argument('--output_dir', type=str, default='./output')
    parser.add_argument('--scale_factor', type=float, default=1.0)
    parser.add_argument('--output_stride', type=int, default=16)
    parser.add_argument('--keypoint_dir', type=str, default='./keypoints_updated')
    parser.add_argument('--checkpoint_dir', type=str, default='./_train_ckpt')
    parser.add_argument('--batch_size', type=int, default=2)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--num_epochs', type=int, default=100)
    parser.add_argument('--num_devices', type=int, default=0,
                        help='data-parallel device count (0 = single device; N '
                             'starts N ranks here unless --distributed joins a '
                             'world)')
    parser.add_argument('--image_size', type=int, default=513)
    parser.add_argument('--wandb', action='store_true')
    parser.add_argument('--prepare_gt', type=str, default='',
                        help='annotation dir; if set, run the ground-truth '
                             'generator before training')
    parser.add_argument('--gt_format', type=str, default='dataloop',
                        choices=['dataloop', 'roboflow'])
    parser.add_argument('--allow_random_init', action='store_true')
    parser.add_argument('--augment_flip', action='store_true',
                        help='random horizontal-flip training augmentation '
                             '(image + keypoint x-mirror + left/right '
                             'keypoint channel swap)')
    parser.add_argument('--no_pose_metrics', action='store_true')
    parser.add_argument('--distributed', action='store_true',
                        help='join the torch.distributed world that the environment '
                             'describes (torchrun: MASTER_ADDR, MASTER_PORT, '
                             'WORLD_SIZE, RANK, LOCAL_RANK) and train as one rank')
    parser.add_argument('--visual_every', type=int, default=0,
                        help='dump predicted-heatmap pngs + keypoint '
                             'overlays under --output_dir every N epochs '
                             '(0 = off)')
    parser.add_argument('--export_artifact', type=str, default='',
                        help='after training, export the best checkpoint '
                             'as a serving artifact (posenet_tpu_torch.serving) '
                             'for the device trained on')
    parser.add_argument('--eval_only', action='store_true',
                        help='no training: restore the checkpoint (or use '
                             'the loaded weights if none exists) and print '
                             'one JSON line of eval loss + OKS/mAP over '
                             '--test_image_dir (falls back to '
                             '--train_image_dir)')
    parser.add_argument('--train_dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16'],
                        help='trunk compute dtype of the training forward. '
                             'bfloat16 is mixed precision: the frozen trunk '
                             'runs bf16 (the fused sepconv kernel on the '
                             'card), master params / heads / loss / Adam stay '
                             'float32')
    parser.add_argument('--export_dtype', type=str, default='bfloat16',
                        choices=['bfloat16', 'float32'],
                        help='compute dtype baked into the exported artifact')
    add_device_flag(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    argv = sys.argv[1:] if argv is None else list(argv)
    backend = 'nccl' if torch.device(args.device).type == 'cuda' else 'gloo'

    if args.num_devices > 1 and not args.distributed and not dist.is_initialized():
        model_factory.resolve_device(args.device)   # no card: raise here, not in N ranks
        mesh_lib.launch(main, args.num_devices, args=(argv + ['--distributed'],),
                        backend=backend)
        return
    lead = True
    if args.distributed:
        proc = mesh_lib.initialize_distributed(backend=backend)
        world = dist.get_world_size() if dist.is_initialized() else 1
        lead = proc == 0
        if lead:
            print(f'distributed: process {proc}/{world}')

    if args.prepare_gt and lead:
        from posenet_tpu_torch.training.ground_truth import prepare_ground_truth_data
        prepare_ground_truth_data(
            args.train_image_dir, args.prepare_gt,
            keypoints_updated_dir=args.keypoint_dir,
            annotation_format=args.gt_format)
        if os.path.isdir(args.test_image_dir):
            prepare_ground_truth_data(
                args.test_image_dir, args.prepare_gt,
                keypoints_updated_dir=args.keypoint_dir,
                annotation_format=args.gt_format)
    if dist.is_initialized():
        dist.barrier()   # every rank reads the ground truth rank 0 wrote

    cfg = TrainConfig(
        model_id=args.model, output_stride=args.output_stride,
        batch_size=args.batch_size, learning_rate=args.lr,
        num_epochs=args.num_epochs, checkpoint_dir=args.checkpoint_dir,
        keypoint_dir=args.keypoint_dir,
        output_dir=args.output_dir, visual_every=args.visual_every,
        num_devices=args.num_devices or None,
        compute_dtype=getattr(torch, args.train_dtype))

    model = model_factory.load_model(
        args.model, output_stride=args.output_stride,
        allow_random_init=args.allow_random_init, device=args.device)

    train_ds = PosenetDataset(args.train_image_dir, args.keypoint_dir,
                              image_size=args.image_size,
                              output_stride=args.output_stride,
                              scale_factor=args.scale_factor,
                              augment_flip=args.augment_flip)
    try:
        test_ds = PosenetDataset(args.test_image_dir, args.keypoint_dir,
                                 image_size=args.image_size,
                                 output_stride=args.output_stride,
                                 scale_factor=args.scale_factor)
    except FileNotFoundError:
        test_ds = None

    template = ts.init_train_state(model.params, cfg)

    if args.eval_only:
        params = model.params
        restored = restore_checkpoint(cfg.checkpoint_dir, template)
        if restored is not None:
            params = restored.params
            message = (f'eval: restored checkpoint step {int(restored.step)} '
                       f'from {cfg.checkpoint_dir}')
        else:
            message = 'eval: no checkpoint found, using loaded model weights'
        ds = test_ds if test_ds is not None else train_ds
        report = evaluate(ds, cfg, params, eval_pose_metrics=not args.no_pose_metrics,
                          device=args.device)
        if lead:
            print(message)
            print(json.dumps(report))
        return

    logger = MetricLogger(use_wandb=args.wandb)
    state = train(train_ds, test_ds, cfg, logger=logger, params=model.params,
                  eval_pose_metrics=not args.no_pose_metrics, device=args.device)

    if args.export_artifact and lead:
        from posenet_tpu_torch.models.model_factory import PoseNet
        from posenet_tpu_torch.serving import save_serving_artifact

        # The BEST model is the latest saved checkpoint: train() saves on
        # eval improvement (or every epoch without a test split), so the
        # final state may be later and worse. The final state is the
        # fallback for when nothing was written (num_epochs=0).
        best = restore_checkpoint(args.checkpoint_dir, template)
        params = (best or state).params
        export_cfg = ModelConfig(model_id=args.model,
                                 output_stride=args.output_stride,
                                 compute_dtype=getattr(torch, args.export_dtype))
        # Serve at the resolution the model was fine-tuned at: the
        # dataset's effective image_size (scale_factor applied).
        size = train_ds.image_size
        meta = save_serving_artifact(
            PoseNet(ts.tree_map(torch.Tensor.detach, params), export_cfg),
            args.export_artifact, input_hw=(size, size),
            platforms=(torch.device(args.device).type,))
        print(f'exported serving artifact to {args.export_artifact} '
              f'({meta["input_hw"]}, {meta["compute_dtype"]})')


if __name__ == '__main__':
    main()
