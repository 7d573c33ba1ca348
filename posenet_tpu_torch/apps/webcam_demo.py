"""Webcam demo CLI on the port: per-frame pose overlay of a cv2 capture.

Capture -> host preprocess -> model -> decode (min_pose_score 0.15) ->
overlay -> imshow; 'q' quits; the average FPS is printed on exit. With
--no_display the run ends when the capture does (or at --max_frames). The
flags, defaults and printed lines are `webcam_demo.py`'s, with `--device`
added.

    python -m posenet_tpu_torch.apps.webcam_demo --allow_random_init
"""

import argparse
import time

import posenet_tpu_torch as posenet
from posenet_tpu_torch.apps import add_device_flag, full_float32


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', type=int, default=101)
    parser.add_argument('--cam_id', type=int, default=0)
    parser.add_argument('--cam_width', type=int, default=1280)
    parser.add_argument('--cam_height', type=int, default=720)
    parser.add_argument('--scale_factor', type=float, default=0.7125)
    parser.add_argument('--output_stride', type=int, default=16)
    parser.add_argument('--allow_random_init', action='store_true')
    parser.add_argument('--max_frames', type=int, default=0,
                        help='stop after N frames (0 = until q); for headless testing')
    parser.add_argument('--no_display', action='store_true',
                        help='skip cv2.imshow (headless environments)')
    add_device_flag(parser)
    return parser.parse_args(argv)


def main(argv=None):
    import cv2

    args = parse_args(argv)
    full_float32()
    model = posenet.load_model(args.model, output_stride=args.output_stride,
                               allow_random_init=args.allow_random_init,
                               device=args.device)
    output_stride = model.output_stride

    cap = cv2.VideoCapture(args.cam_id)
    cap.set(3, args.cam_width)
    cap.set(4, args.cam_height)

    start = time.time()
    frame_count = 0
    while True:
        try:
            input_image, display_image, output_scale = posenet.read_cap(
                cap, scale_factor=args.scale_factor, output_stride=output_stride)
        except IOError:
            # headless (--no_display) has no 'q' to quit: end the run when
            # the capture ends, with the FPS summary (interactive mode
            # keeps the hard error)
            if args.no_display and frame_count:
                break
            raise

        heatmaps, offsets, displacements_fwd, displacements_bwd = model(input_image)
        pose_scores, keypoint_scores, keypoint_coords, pose_offsets = \
            posenet.decode_multiple_poses(
                heatmaps.squeeze(0), offsets.squeeze(0),
                displacements_fwd.squeeze(0), displacements_bwd.squeeze(0),
                output_stride=output_stride,
                max_pose_detections=10,
                min_pose_score=0.15,
                device=args.device)

        keypoint_coords *= output_scale

        overlay_image = posenet.draw_skel_and_kp(
            display_image, pose_scores, keypoint_scores, keypoint_coords,
            min_pose_score=0.15, min_part_score=0.1)

        frame_count += 1
        if not args.no_display:
            cv2.imshow('posenet', overlay_image)
            if cv2.waitKey(1) & 0xFF == ord('q'):
                break
        if args.max_frames and frame_count >= args.max_frames:
            break

    print('Average FPS: ', frame_count / (time.time() - start))


if __name__ == "__main__":
    main()
