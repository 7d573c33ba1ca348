"""The port's Streamlit app (`posenet_tpu_torch.apps.streamlit_demo`) driven
through tests/test_streamlit_demo.py's stand-in `st`, on the CPU
(`--device cpu`, m50) in a directory without checkpoints, where the
checkpoint download fails as offline (`tests.torch_offline`): the cases of
tests/test_streamlit_demo.py, every input mode and error path, the
random-weights warning included."""

import os

import numpy as np
import pytest

from tests.test_streamlit_demo import FakeStreamlit, _jpg_bytes, _Upload, _write_video
from tests.torch_offline import offline_download  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _no_checkpoints(tmp_path, monkeypatch):
    """Run in an empty directory: ./_models holds no checkpoint."""
    monkeypatch.chdir(tmp_path)


def _run_main(monkeypatch, answers):
    from posenet_tpu_torch.apps import streamlit_demo

    fake = FakeStreamlit({"Model": 50, "Output stride": 16, **answers})
    monkeypatch.setattr(streamlit_demo, "st", fake)
    streamlit_demo.main(['--device', 'cpu'])
    return fake


def test_image_upload_mode(monkeypatch):
    """An uploaded image -> its overlay shown; without a checkpoint or the
    network to fetch one, the app warns that it runs random weights."""
    data, frame = _jpg_bytes()
    fake = _run_main(monkeypatch, {"Input": "Upload image", "Image": _Upload(data)})
    assert len(fake.calls["image"]) == 1
    assert fake.calls["image"][0][0].shape == frame.shape
    assert not fake.calls["error"]
    assert any("RANDOM weights" in w[0] for w in fake.calls["warning"])
    assert fake.calls["title"] == [("PoseNet on GPU",)]


def test_image_upload_corrupt_bytes_errors(monkeypatch):
    fake = _run_main(monkeypatch, {"Input": "Upload image",
                                   "Image": _Upload(b"not an image")})
    assert fake.calls["error"] and not fake.calls["image"]


def test_video_upload_mode(monkeypatch, tmp_path):
    """An uploaded video -> output.mp4 written frame by frame, progress to
    1.0, a download button."""
    import cv2

    src = str(tmp_path / "in.mp4")
    _write_video(src, n_frames=4, hw=(48, 64))
    with open(src, "rb") as f:
        data = f.read()
    outdir = str(tmp_path / "out")
    fake = _run_main(monkeypatch, {"Input": "Upload video", "Video": _Upload(data),
                                   "Output directory": outdir})
    out_path = os.path.join(outdir, "output.mp4")
    cap = cv2.VideoCapture(out_path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 4
    assert fake.progress_bars and fake.progress_bars[0].values[-1] == 1.0
    assert len(fake.calls["download_button"]) == 1
    assert any("4 frames" in w[0] for w in fake.calls["write"])
    assert not fake.calls["error"]


def test_video_upload_corrupt_errors(monkeypatch, tmp_path):
    fake = _run_main(monkeypatch, {"Input": "Upload video",
                                   "Video": _Upload(b"garbage bytes"),
                                   "Output directory": str(tmp_path)})
    assert fake.calls["error"] and not fake.calls["download_button"]
    assert not os.path.exists(os.path.join(str(tmp_path), "output.mp4"))


def test_existing_image_mode(monkeypatch, tmp_path):
    import cv2

    frame = np.random.RandomState(5).randint(0, 255, (48, 64, 3), dtype=np.uint8)
    os.makedirs(tmp_path / "imgs")
    cv2.imwrite(str(tmp_path / "imgs" / "a.png"), frame)
    fake = _run_main(monkeypatch, {"Input": "Try existing image",
                                   "Image directory": str(tmp_path / "imgs")})
    assert len(fake.calls["image"]) == 1
    assert fake.calls["image"][0][0].shape == frame.shape
    assert not fake.calls["error"]


def test_existing_image_missing_dir_warns(monkeypatch, tmp_path):
    fake = _run_main(monkeypatch, {"Input": "Try existing image",
                                   "Image directory": str(tmp_path / "nope")})
    assert any("not found" in w[0] for w in fake.calls["warning"])
    assert not fake.calls["image"]


def test_checkpoint_is_used_without_warning(monkeypatch, tmp_path):
    """With the fixture under ./_models the app loads it and does not warn."""
    import shutil

    from tests.make_fixture_checkpoint import FIXTURE_PATH

    os.makedirs(tmp_path / "_models")
    shutil.copy(FIXTURE_PATH, tmp_path / "_models" / "mobilenet_v1_050.npz")
    data, frame = _jpg_bytes()
    fake = _run_main(monkeypatch, {"Input": "Upload image", "Image": _Upload(data)})
    assert len(fake.calls["image"]) == 1
    assert not fake.calls["warning"]


def test_annotate_video_standalone(tmp_path):
    """annotate_video needs no streamlit: the frame count, and 0 (with no
    file) on an undecodable input."""
    from posenet_tpu_torch import load_model
    from posenet_tpu_torch.apps import streamlit_demo

    src = str(tmp_path / "in.mp4")
    _write_video(src, n_frames=3, hw=(48, 64))
    model = load_model(50, 16, allow_random_init=True, device='cpu')
    out = str(tmp_path / "o" / "output.mp4")
    assert streamlit_demo.annotate_video(src, out, model, 1.0, 0.0, 0.0) == 3
    assert os.path.exists(out)

    bad = str(tmp_path / "bad.mp4")
    with open(bad, "wb") as f:
        f.write(b"\x00" * 64)
    out2 = str(tmp_path / "o2" / "output.mp4")
    assert streamlit_demo.annotate_video(bad, out2, model, 1.0, 0.0, 0.0) == 0
    assert not os.path.exists(out2)
