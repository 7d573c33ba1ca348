"""Benchmark CLI on the port: forward + multi-pose decode throughput.

Loads the images of --image_dir into RAM, loops --num_images forward +
decode passes and prints the average FPS, as `benchmark.py` does. Two
modes:

- default: per-frame mode, one image at a time (host preprocessing, the
  upload, the forward and the decode on the device, the poses read back);
- --batch_size N: throughput mode, one uploaded batch of uint8 frames run
  again and again through the fused `PoseNetPipeline` (normalize, forward,
  decode on the device).

--profile DIR: in the batch mode, a `torch.profiler` trace of one batch
into DIR, a table of device time by kernel and one of the pipeline's
spans (`pipeline.call`, `pipeline.to_device`, `pipeline.forward`,
`pipeline.decode`; with `--architecture resnet50` also `resnet.stem` and
`resnet.block1` ... `resnet.block4`, and the trunk's conv launches a call,
`resnet.convs`); in the per-frame mode, the host and device ms of each
frame's forward and decode (`profiling.span` under
`profiling.recording()`).

--architecture resnet50: PoseNet ResNet50 with random weights (needs
--allow_random_init: no ResNet50 checkpoint is read yet), batch mode only.

    python -m posenet_tpu_torch.apps.benchmark --image_dir ./images --allow_random_init
"""

import argparse
import contextlib
import os
import time

import posenet_tpu_torch as posenet
from posenet_tpu_torch import profiling
from posenet_tpu_torch.apps import add_device_flag, full_float32
from posenet_tpu_torch.config import ARCHITECTURES, DecodeConfig
from posenet_tpu_torch.models import resnet50
from posenet_tpu_torch.pipeline import PoseNetPipeline, to_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', type=int, default=101)
    parser.add_argument('--architecture', choices=ARCHITECTURES, default='mobilenet_v1')
    parser.add_argument('--image_dir', type=str, default='./images')
    parser.add_argument('--num_images', type=int, default=1000)
    parser.add_argument('--output_stride', type=int, default=16)
    parser.add_argument('--batch_size', type=int, default=0,
                        help='0 = per-frame loop; N>0 = batched fused '
                             'pipeline')
    parser.add_argument('--image_size', type=int, default=513)
    parser.add_argument('--allow_random_init', action='store_true')
    parser.add_argument('--profile', type=str, default='',
                        help='capture a torch.profiler trace to this '
                             'directory and print a per-kernel time report')
    add_device_flag(parser)
    args = parser.parse_args(argv)
    if args.architecture == 'resnet50' and args.batch_size <= 0:
        parser.error('--architecture resnet50 runs in the batch mode (--batch_size N): the '
                     "per-frame loop's host preprocessing scales to MobileNetV1's [-1, 1]")
    return args


def list_images(args):
    filenames = [
        f.path for f in os.scandir(args.image_dir)
        if f.is_file() and f.path.endswith(('.png', '.jpg'))]
    return filenames[:args.num_images]


def load_images(args, output_stride):
    filenames = list_images(args)
    return filenames, {
        f: posenet.read_imgfile(f, 1.0, output_stride)[0] for f in filenames}


def main(argv=None):
    args = parse_args(argv)
    full_float32()
    model = posenet.load_model(args.model, output_stride=args.output_stride,
                               allow_random_init=args.allow_random_init,
                               device=args.device, architecture=args.architecture)
    output_stride = model.output_stride
    num_images = args.num_images

    if args.batch_size > 0:
        # batch mode needs only the filename list: skip the per-image
        # float preprocessing that the per-frame mode caches
        filenames = list_images(args)
        images = None
    else:
        filenames, images = load_images(args, output_stride)
    if not filenames:
        raise SystemExit(f'no images found in {args.image_dir}')

    if args.batch_size > 0:
        # Throughput mode: uint8 RGB frames at a stride-valid resolution,
        # resized by the native library's thread pool, then normalize,
        # forward and decode on the device.
        import cv2

        from posenet_tpu_torch import native_preprocess as npp
        from posenet_tpu_torch.preprocess import valid_resolution

        raw = []
        for i in range(args.batch_size):
            path = filenames[i % len(filenames)]
            img = cv2.imread(path)
            if img is None:
                raise IOError(f'could not read image: {path}')
            raw.append(img)
        tw, th = valid_resolution(args.image_size, args.image_size,
                                  output_stride)
        frames = npp.resize_batch(raw, (th, tw), swap_rb=True)
        pipe = PoseNetPipeline(model, DecodeConfig(min_pose_score=0.25))
        pipe.warmup((th, tw), args.batch_size)
        n_batches = max(1, num_images // args.batch_size)
        # Upload once and reuse the batch on the device; the copy does not
        # wait, so read one element back to keep it out of the timed loop.
        frames = to_device(frames, pipe.device)
        frames[0, 0, 0, 0].item()

        if args.profile:
            convs = resnet50.convs
            with profiling.trace(args.profile, pipe.device):
                out = pipe(frames)
                out.pose_scores[0, 0].item()
            print(profiling.device_time_report(args.profile))
            print(profiling.span_table())
            if args.architecture == 'resnet50':
                print('resnet.convs a call:', resnet50.convs - convs)

        start = time.time()
        for _ in range(n_batches):
            out = pipe(frames)
        out.pose_scores[0, 0].item()  # waits for every batch queued before
        elapsed = time.time() - start
        n = n_batches * args.batch_size
        print('Average FPS:', n / elapsed)
        return

    # Per-frame loop; --profile times each frame's forward and decode, on
    # the host and, between the spans' events, on the device. The decode
    # reads its poses back, so its host ms hold the wait for the forward.
    start = time.time()
    with profiling.recording() if args.profile else contextlib.nullcontext():
        for i in range(num_images):
            input_image = images[filenames[i % len(filenames)]]
            with profiling.span('frame.forward', model.device):
                heatmaps, offsets, displacement_fwd, displacement_bwd = model(input_image)
            with profiling.span('frame.decode', model.device):
                posenet.decode_multiple_poses(
                    heatmaps.squeeze(0), offsets.squeeze(0),
                    displacement_fwd.squeeze(0), displacement_bwd.squeeze(0),
                    output_stride=output_stride,
                    max_pose_detections=10,
                    min_pose_score=0.25,
                    device=args.device)
    print('Average FPS:', num_images / (time.time() - start))
    if args.profile:
        print(profiling.span_table())


if __name__ == "__main__":
    main()
