"""Image-folder demo CLI on the port.

For each image in --image_dir: preprocess on the host, model, multi-pose
decode on the device (the tree walk is one kernel launch an image on the
card), coordinates scaled back to the source resolution, an overlay
written to --output_dir and per-keypoint text printed; then the average
FPS. The flags, defaults and printed lines are `image_demo.py`'s, with
`--device` added.

    python -m posenet_tpu_torch.apps.image_demo --image_dir ./images --allow_random_init
"""

import argparse
import os
import time

import posenet_tpu_torch as posenet
from posenet_tpu_torch.apps import add_device_flag, full_float32


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', type=int, default=101)
    parser.add_argument('--scale_factor', type=float, default=1.0)
    parser.add_argument('--notxt', action='store_true')
    parser.add_argument('--image_dir', type=str, default='./images_train')
    parser.add_argument('--output_dir', type=str, default='./output')
    parser.add_argument('--output_stride', type=int, default=16)
    parser.add_argument('--allow_random_init', action='store_true',
                        help='use random weights when ./_models holds no '
                             'checkpoint')
    parser.add_argument('--resize', type=str, default=None, metavar='HxW',
                        help='process every image at ONE fixed stride-valid '
                             'resolution (e.g. 513x513), so that folders of '
                             'mixed resolutions run at one input shape; '
                             'coordinates still come back at source '
                             'resolution')
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

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)

    filenames = [
        f.path for f in os.scandir(args.image_dir)
        if f.is_file() and f.path.endswith(('.png', '.jpg'))]

    target_hw = None
    if args.resize:
        h, w = args.resize.lower().split('x')
        target_hw = (int(h), int(w))
        if args.scale_factor != 1.0:
            print('WARNING: --resize fixes the processing resolution; '
                  '--scale_factor is ignored.')

    start = time.time()
    for f in filenames:
        input_image, draw_image, output_scale = posenet.read_imgfile(
            f, scale_factor=args.scale_factor, output_stride=output_stride,
            target_hw=target_hw)

        heatmaps, offsets, displacements_fwd, displacements_bwd = model(input_image)
        pose_scores, keypoint_scores, keypoint_coords, pose_offsets = \
            posenet.decode_multiple_poses(
                heatmaps.squeeze(0), offsets.squeeze(0),
                displacements_fwd.squeeze(0), displacements_bwd.squeeze(0),
                output_stride=output_stride,
                max_pose_detections=10,
                min_pose_score=0.25,
                device=args.device)

        keypoint_coords *= output_scale

        if args.output_dir:
            overlay = posenet.draw_skel_and_kp(
                draw_image, pose_scores, keypoint_scores, keypoint_coords,
                min_pose_score=0.25, min_part_score=0.25)
            cv2.imwrite(os.path.join(
                args.output_dir, os.path.relpath(f, args.image_dir)), overlay)

        if not args.notxt:
            print()
            print("Results for image: %s" % f)
            for pi in range(len(pose_scores)):
                if pose_scores[pi] == 0.:
                    break
                print('Pose #%d, score = %f' % (pi, pose_scores[pi]))
                for ki, (s, c) in enumerate(zip(keypoint_scores[pi, :],
                                                keypoint_coords[pi, :, :])):
                    print('Keypoint %s, score = %f, coord = %s' %
                          (posenet.PART_NAMES[ki], s, c))

    print('Average FPS:', len(filenames) / (time.time() - start))


if __name__ == "__main__":
    main()
