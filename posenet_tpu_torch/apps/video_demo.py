"""Offline video CLI on the port: batched pose extraction + overlay rendering.

Frames are decoded on the host, resized to ONE stride-valid resolution and
sent as uint8 NHWC batches through the fused `PoseNetPipeline` (normalize,
forward, decode on the device); only the (B, P, 17, 2) pose buffers come
back. With --device_preprocess the frames go at their source resolution
and the device resizes them. The flags, defaults, printed lines and
outputs are `video_demo.py`'s, with `--device` and `--profile` added.

--profile: records the pipeline's spans (`profiling.recording()`) and
prints their host and device ms at the end (`profiling.span_table()`):
`pipeline.call` around `pipeline.to_device`, `pipeline.forward`,
`pipeline.decode`, and with --device_preprocess `pipeline.preprocess`.

Outputs: an overlay video (--output_video) and/or one JSON line per frame
(--poses_out) with every pose above --min_pose_score at SOURCE resolution.

    python -m posenet_tpu_torch.apps.video_demo --video in.mp4 --poses_out poses.jsonl
"""

import argparse
import contextlib
import json
import os
import time

import numpy as np

import posenet_tpu_torch as posenet
from posenet_tpu_torch import profiling
from posenet_tpu_torch.apps import add_device_flag, full_float32
from posenet_tpu_torch.config import DecodeConfig
from posenet_tpu_torch.pipeline import PoseNetPipeline
from posenet_tpu_torch.preprocess import valid_resolution


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--video', type=str, required=True,
                        help='input video file (anything cv2 can open)')
    parser.add_argument('--model', type=int, default=101)
    parser.add_argument('--output_stride', type=int, default=16)
    parser.add_argument('--resize', type=str, default='513x513',
                        metavar='HxW',
                        help='processing resolution; snapped down to the '
                             'nearest stride-valid size (16n+1). One size = '
                             'one input shape for the whole video')
    parser.add_argument('--batch_size', type=int, default=16,
                        help='frames per fused device batch')
    parser.add_argument('--min_pose_score', type=float, default=0.25)
    parser.add_argument('--min_part_score', type=float, default=0.25,
                        help='overlay keypoint threshold')
    parser.add_argument('--output_video', type=str, default='',
                        help='write a pose-overlay video here (mp4)')
    parser.add_argument('--poses_out', type=str, default='',
                        help='write one JSON line per frame here')
    parser.add_argument('--max_frames', type=int, default=0,
                        help='stop after N frames (0 = whole video)')
    parser.add_argument('--resize_backend', type=str, default='auto',
                        choices=('auto', 'native', 'cv2'),
                        help="host resize+BGR->RGB backend: 'cv2' = SIMD "
                             "resize + cvtColor, 'native' = the C++ "
                             'library (native/preprocess.cpp, built at first '
                             'use, for cv2-free deployments). auto picks cv2 '
                             'when importable. The two agree to +-1 LSB, '
                             'not bitwise')
    parser.add_argument('--device_preprocess', action='store_true',
                        help='resize + BGR->RGB + normalize ON THE DEVICE '
                             '(PoseNetPipeline(device_resize_to=...)): '
                             'offloads the host resize when the CPU is the '
                             'bottleneck; sends full source-resolution uint8 '
                             'frames')
    parser.add_argument('--allow_random_init', action='store_true',
                        help='use random weights when ./_models holds no '
                             'checkpoint')
    parser.add_argument('--pipeline_depth', type=int, default=2,
                        choices=(1, 2),
                        help='2 (default): dispatch batch N+1 before '
                             'fetching batch N, overlapping device compute '
                             'with host read/resize/draw; 1: synchronous '
                             'batches (A/B baseline)')
    parser.add_argument('--profile', action='store_true',
                        help="print the host and device ms of each of the "
                             "pipeline's stages (its spans) at the end")
    add_device_flag(parser)
    return parser.parse_args(argv)


def _dispatch_batch(pipe, rgb_frames, batch_size):
    """Queue one fused device batch; return (result tensors, n_real).

    The pipeline's launches return before the device has run them, and a
    host batch goes up from pinned memory without waiting, so the host only
    waits in `_drain_batch`, when it copies the results back. The main loop
    uses that: batch N computes on the device while the host reads and
    resizes batch N+1 and renders N-1's overlays.

    The final partial batch is padded by repeating its last frame, so that
    the whole video runs at one input shape; padded slots are not read."""
    n_real = len(rgb_frames)
    batch = np.stack(rgb_frames + [rgb_frames[-1]] * (batch_size - n_real))
    return pipe(batch), n_real


def _drain_batch(out, n_real, bgr_frames, frame_ids, scale,
                 args, writer, poses_fh, counters):
    """Fetch one dispatched batch's results and drain them to the writers
    (in dispatch order, so frames stay ordered)."""
    pose_scores = out.pose_scores.cpu().numpy()[:n_real]
    keypoint_scores = out.keypoint_scores.cpu().numpy()[:n_real]
    # decoded coords are y,x pixels at the PROCESSING resolution; map back
    # to source pixels with the same (2,) scale contract as process_input
    keypoint_coords = out.keypoint_coords.cpu().numpy()[:n_real] * scale

    for i in range(n_real):
        # unfilled decode slots are exactly 0.0 (DecodedPoses contract):
        # keep them out even with --min_pose_score 0
        keep = (pose_scores[i] > 0) & (pose_scores[i] >= args.min_pose_score)
        n_poses = int(keep.sum())
        counters['poses'] += n_poses
        if writer is not None:
            overlay = posenet.draw_skel_and_kp(
                bgr_frames[i], pose_scores[i], keypoint_scores[i],
                keypoint_coords[i], min_pose_score=args.min_pose_score,
                min_part_score=args.min_part_score)
            writer.write(overlay)
        if poses_fh is not None:
            record = {
                'frame': frame_ids[i],
                'poses': [
                    {'score': float(pose_scores[i][p]),
                     'keypoints': [
                         {'part': posenet.PART_NAMES[k],
                          'score': float(keypoint_scores[i][p, k]),
                          'y': float(keypoint_coords[i][p, k, 0]),
                          'x': float(keypoint_coords[i][p, k, 1])}
                         for k in range(17)]}
                    for p in range(len(pose_scores[i])) if keep[p]],
            }
            poses_fh.write(json.dumps(record) + '\n')


def main(argv=None):
    import cv2

    args = parse_args(argv)
    full_float32()
    h, w = (int(d) for d in args.resize.lower().split('x'))
    tw, th = valid_resolution(w, h, output_stride=args.output_stride)

    from posenet_tpu_torch import native_preprocess as npp
    if args.resize_backend == 'native' and not npp.native_available():
        raise SystemExit(f'--resize_backend native: the native library is not '
                         f'built: {npp.build_error}')

    model = posenet.load_model(args.model, output_stride=args.output_stride,
                               allow_random_init=args.allow_random_init,
                               device=args.device)
    pipe = PoseNetPipeline(
        model, DecodeConfig(min_pose_score=args.min_pose_score),
        device_resize_to=(th, tw) if args.device_preprocess else None)

    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        raise IOError(f"could not open video: {args.video}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0

    writer = None
    poses_fh = None
    if args.poses_out:
        os.makedirs(os.path.dirname(args.poses_out) or '.', exist_ok=True)
        poses_fh = open(args.poses_out, 'w')

    counters = {'poses': 0}
    rgb_frames, bgr_frames, frame_ids = [], [], []
    pending = None   # one in-flight batch: (out, n_real, bgr, ids)
    scale = None
    frame_count = 0
    start = time.time()
    with profiling.recording() if args.profile else contextlib.nullcontext():
        while True:
            ok, frame = cap.read()
            if not ok or (args.max_frames and frame_count >= args.max_frames):
                break
            if writer is None and args.output_video:
                os.makedirs(os.path.dirname(args.output_video) or '.',
                            exist_ok=True)
                writer = cv2.VideoWriter(
                    args.output_video, cv2.VideoWriter_fourcc(*'mp4v'),
                    src_fps, (frame.shape[1], frame.shape[0]))
            if scale is None:
                scale = np.array([frame.shape[0] / th, frame.shape[1] / tw])
            if args.device_preprocess:
                # the device does BGR->RGB + resize + normalize
                rgb_frames.append(frame)
            else:
                rgb_frames.append(npp.resize_rgb(frame, (th, tw),
                                                 backend=args.resize_backend))
            bgr_frames.append(frame)
            frame_ids.append(frame_count)
            frame_count += 1
            if len(rgb_frames) == args.batch_size:
                # dispatch N+1 BEFORE draining N: the device starts the new
                # batch without waiting for the host-side fetch + overlay
                # rendering of the previous one
                out, n_real = _dispatch_batch(pipe, rgb_frames, args.batch_size)
                if pending is not None:
                    _drain_batch(*pending, scale, args, writer, poses_fh,
                                 counters)
                pending = (out, n_real, bgr_frames, frame_ids)
                if args.pipeline_depth == 1:
                    _drain_batch(*pending, scale, args, writer, poses_fh,
                                 counters)
                    pending = None
                rgb_frames, bgr_frames, frame_ids = [], [], []
        if rgb_frames:
            out, n_real = _dispatch_batch(pipe, rgb_frames, args.batch_size)
            if pending is not None:
                _drain_batch(*pending, scale, args, writer, poses_fh, counters)
            pending = (out, n_real, bgr_frames, frame_ids)
        if pending is not None:
            _drain_batch(*pending, scale, args, writer, poses_fh, counters)

    cap.release()
    if writer is not None:
        writer.release()
    if poses_fh is not None:
        poses_fh.close()

    elapsed = time.time() - start
    print(f'Processed {frame_count} frames at {th}x{tw} '
          f'(batch {args.batch_size}): {counters["poses"]} poses, '
          f'{frame_count / max(elapsed, 1e-9):.1f} FPS')
    if args.profile:
        print(profiling.span_table())


if __name__ == '__main__':
    main()
