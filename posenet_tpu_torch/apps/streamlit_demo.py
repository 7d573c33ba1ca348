"""Streamlit UI on the port: interactive pose estimation on images and videos.

The counterpart of `streamlit_demo.py`: sidebar model settings (model
101/100/75/50, output stride, score thresholds, output directory), three
input modes (video upload -> annotated output.mp4 with a download button,
image upload, an image from a directory), one decode + overlay per frame.
`run_model`, `annotate_frame` and `annotate_video` need no streamlit.

Run with: streamlit run posenet_tpu_torch/apps/streamlit_demo.py [-- --device cpu]
(streamlit is an optional dependency; the module imports without it.)
"""

import argparse
import os
import tempfile
import time

import numpy as np

import posenet_tpu_torch as posenet
from posenet_tpu_torch.apps import add_device_flag, full_float32

try:
    import streamlit as st
except ImportError:  # pragma: no cover - optional dependency
    st = None


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_device_flag(parser)
    return parser.parse_args(argv)


def run_model(input_image, model, min_pose_score: float = 0.25):
    """One frame: forward + decode, on the model's device. input_image is
    the preprocessed NCHW array from posenet.process_input."""
    output_stride = model.output_stride
    heatmaps, offsets, dfwd, dbwd = model(input_image)
    pose_scores, keypoint_scores, keypoint_coords, _ = \
        posenet.decode_multiple_poses(
            heatmaps.squeeze(0), offsets.squeeze(0),
            dfwd.squeeze(0), dbwd.squeeze(0),
            output_stride=output_stride,
            max_pose_detections=10,
            min_pose_score=min_pose_score,
            device=model.device)
    return pose_scores, keypoint_scores, keypoint_coords


def annotate_frame(frame, model, scale_factor, min_pose_score, min_part_score):
    input_image, draw_image, output_scale = posenet.process_input(
        frame, scale_factor=scale_factor, output_stride=model.output_stride)
    pose_scores, keypoint_scores, keypoint_coords = run_model(
        input_image, model, min_pose_score)
    keypoint_coords = keypoint_coords * output_scale
    return posenet.draw_skel_and_kp(
        draw_image, pose_scores, keypoint_scores, keypoint_coords,
        min_pose_score=min_pose_score, min_part_score=min_part_score)


def annotate_video(video_path, out_path, model, scale_factor,
                   min_pose_score, min_part_score, progress_cb=None):
    """Video file -> annotated mp4 at `out_path`, one decoded overlay per
    frame. Returns the number of frames written (0 = nothing decodable:
    unsupported codec or corrupt file, in which case no output file is
    produced). `progress_cb(done_fraction)` is called after each frame when
    given."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    writer = None
    # some containers report 0 or -1 for an unknown frame count
    n_frames = max(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), 1)
    i = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            overlay = annotate_frame(frame, model, scale_factor,
                                     min_pose_score, min_part_score)
            if writer is None:
                os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
                fps = cap.get(cv2.CAP_PROP_FPS)
                writer = cv2.VideoWriter(
                    out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                    fps if fps > 0 else 15.0,
                    (overlay.shape[1], overlay.shape[0]))
            writer.write(overlay)
            i += 1
            if progress_cb is not None:
                progress_cb(min(i / n_frames, 1.0))
    finally:
        # release even if annotate_frame raises mid-video
        cap.release()
        if writer is not None:
            writer.release()
    return i


def main(argv=None):
    import cv2

    device = parse_args(argv).device
    full_float32()
    st.title("PoseNet on GPU")

    with st.sidebar:
        model_id = st.selectbox("Model", [101, 100, 75, 50], index=0)
        output_stride = st.selectbox("Output stride", [8, 16, 32], index=1)
        min_pose_score = st.slider("Min pose score", 0.0, 1.0, 0.25)
        min_part_score = st.slider("Min part score", 0.0, 1.0, 0.25)
        scale_factor = st.slider("Scale factor", 0.2, 1.0, 1.0)
        output_dir = st.text_input("Output directory", "./output")

    @st.cache_resource
    def get_model(model_id, output_stride, device):
        # Only checkpoint loads are cached: a failed load raises, so that
        # a checkpoint put in place later is picked up on the next rerun.
        return posenet.load_model(model_id, output_stride=output_stride,
                                  device=device)

    try:
        model, real_weights = get_model(model_id, output_stride, device), True
    except FileNotFoundError:
        # no checkpoint under ./_models: keep the UI usable but SAY so;
        # random weights served silently would look like a broken
        # detector. Deliberately uncached (checked again each rerun).
        model, real_weights = posenet.load_model(
            model_id, output_stride=output_stride, allow_random_init=True,
            device=device), False
    if not real_weights:
        st.warning("No checkpoint under ./_models: running with RANDOM "
                   "weights; detections are meaningless.")
    mode = st.radio("Input", ["Upload image", "Upload video", "Try existing image"])

    if mode == "Upload image":
        up = st.file_uploader("Image", type=["jpg", "jpeg", "png"])
        if up is not None:
            data = np.frombuffer(up.read(), np.uint8)
            frame = cv2.imdecode(data, cv2.IMREAD_COLOR)
            if frame is None:
                st.error("Could not decode the uploaded image.")
                return
            overlay = annotate_frame(frame, model, scale_factor,
                                     min_pose_score, min_part_score)
            st.image(cv2.cvtColor(overlay, cv2.COLOR_BGR2RGB))

    elif mode == "Upload video":
        up = st.file_uploader("Video", type=["mp4", "mov", "avi"])
        if up is not None:
            tfile = tempfile.NamedTemporaryFile(delete=False, suffix=".mp4")
            tfile.write(up.read())
            tfile.flush()
            tfile.close()  # the file's tail must be on disk before cv2 opens it
            os.makedirs(output_dir, exist_ok=True)
            out_path = os.path.join(output_dir, "output.mp4")
            progress = st.progress(0.0)
            t0 = time.time()
            try:
                n = annotate_video(tfile.name, out_path, model, scale_factor,
                                   min_pose_score, min_part_score,
                                   progress_cb=progress.progress)
            finally:
                os.unlink(tfile.name)  # never leak the upload's copy
            if n > 0:
                st.write(f"{n} frames in {time.time()-t0:.1f}s")
                with open(out_path, "rb") as f:
                    st.download_button("Download annotated video", f,
                                       file_name="output.mp4")
            else:
                st.error("Could not decode any frames from the uploaded "
                         "video (unsupported codec or corrupt file).")

    else:  # Try existing image
        image_dir = st.text_input("Image directory", "./images")
        if os.path.isdir(image_dir):
            files = sorted(f for f in os.listdir(image_dir)
                           if f.lower().endswith((".jpg", ".jpeg", ".png")))
            choice = st.selectbox("Image", files)
            if choice:
                frame = cv2.imread(os.path.join(image_dir, choice))
                if frame is None:
                    st.error(f"Could not read {choice}.")
                    return
                overlay = annotate_frame(frame, model, scale_factor,
                                         min_pose_score, min_part_score)
                st.image(cv2.cvtColor(overlay, cv2.COLOR_BGR2RGB))
        else:
            st.warning(f"directory {image_dir} not found")


if __name__ == "__main__":
    if st is None:
        raise SystemExit("streamlit is not installed; "
                         "run `pip install streamlit` to use this demo")
    main()
