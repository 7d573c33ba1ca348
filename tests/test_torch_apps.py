"""The port's apps (`posenet_tpu_torch.apps`), drawing, visualizers and
profiling on the CPU (`--device cpu`): the cases of tests/test_apps.py,
run in-process at m50 on small images, plus

- the port's drawing pixel-equal to the JAX package's on the same poses;
- image_demo of both packages on synthesized photos with the fixture m50
  s16 weights (read by both `load_model`s from ./_models of a temporary
  directory): the same pose count an image, pose scores within 1e-4 and
  keypoint coordinates within 1e-3 px (the float32 slices agree within
  4.4e-4 px, ROADMAP Queue 3; the printed scores carry 6 decimals);
- each app's default device, the card, raising on a host without one;
- the benchmark CLI in both modes, with --profile;
- the per-stage report of `profiling.span`, `trace` and `device_time_report`.
"""

import json
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from tests.make_fixture_checkpoint import FIXTURE_PATH
from tests.test_apps import _FakeCapture, _write_images
from tests.tfjs_fixture import synth_photo
from tests.torch_offline import offline_download  # noqa: F401 (autouse)

M50 = ['--model', '50', '--allow_random_init', '--device', 'cpu']


def fixture_cwd(tmp_path, monkeypatch):
    """A working directory whose ./_models holds the fixture m50 s16
    weights, where the JAX package's and the port's `load_model(50)` both
    find them (so neither draws random weights, nor looks for a download)."""
    os.makedirs(tmp_path / '_models')
    shutil.copy(FIXTURE_PATH, tmp_path / '_models' / 'mobilenet_v1_050.npz')
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_image_demo_main(tmp_path, capsys):
    from posenet_tpu_torch.apps import image_demo

    img_dir = str(tmp_path / "in")
    out_dir = str(tmp_path / "out")
    _write_images(img_dir)
    image_demo.main(['--image_dir', img_dir, '--output_dir', out_dir, *M50])
    out = capsys.readouterr().out
    assert 'Average FPS:' in out
    assert 'Results for image' in out
    assert len(os.listdir(out_dir)) == 2  # overlay per input image


def test_image_demo_fixed_resize(tmp_path, capsys):
    """--resize runs mixed-resolution folders at one input shape while the
    overlays keep each image's source resolution."""
    import cv2

    from posenet_tpu_torch.apps import image_demo

    img_dir = str(tmp_path / "in")
    out_dir = str(tmp_path / "out")
    os.makedirs(img_dir)
    rng = np.random.RandomState(1)
    for i, hw in enumerate([(120, 160), (96, 200)]):   # two resolutions
        cv2.imwrite(os.path.join(img_dir, f"im{i}.jpg"),
                    rng.randint(0, 255, (*hw, 3), dtype=np.uint8))
    image_demo.main(['--image_dir', img_dir, '--output_dir', out_dir,
                     '--resize', '97x97', *M50])
    assert 'Average FPS:' in capsys.readouterr().out
    written = os.listdir(out_dir)
    shapes = sorted(cv2.imread(os.path.join(out_dir, f)).shape[:2] for f in written)
    assert shapes == [(96, 200), (120, 160)]


def test_process_input_fixed_contract():
    from posenet_tpu_torch.preprocess import process_input_fixed

    src = np.random.RandomState(0).randint(0, 255, (120, 160, 3), np.uint8)
    inp, source, scale = process_input_fixed(src, (97, 97), output_stride=16)
    assert inp.shape == (1, 3, 97, 97)
    assert source is src
    np.testing.assert_allclose(scale, [120 / 97, 160 / 97])


def test_image_demo_notxt(tmp_path, capsys):
    from posenet_tpu_torch.apps import image_demo

    img_dir = str(tmp_path / "in")
    _write_images(img_dir, n=1)
    image_demo.main(['--image_dir', img_dir, '--output_dir', '', '--notxt', *M50])
    out = capsys.readouterr().out
    assert 'Results for image' not in out
    assert 'Average FPS:' in out


def test_webcam_demo_main(monkeypatch, capsys):
    import cv2

    from posenet_tpu_torch.apps import webcam_demo

    monkeypatch.setattr(cv2, 'VideoCapture', lambda _id: _FakeCapture(3))
    webcam_demo.main(['--max_frames', '2', '--no_display', *M50])
    assert 'Average FPS:' in capsys.readouterr().out


def test_webcam_demo_capture_failure(monkeypatch):
    import cv2

    from posenet_tpu_torch.apps import webcam_demo

    monkeypatch.setattr(cv2, 'VideoCapture', lambda _id: _FakeCapture(0))
    with pytest.raises(IOError, match="webcam failure"):
        webcam_demo.main(['--max_frames', '1', '--no_display', *M50])


@pytest.mark.parametrize("batch_size", ['0', '3'])
def test_benchmark_main(tmp_path, capsys, batch_size):
    """The per-frame loop and the batch mode, each with --profile: the
    per-stage span report, and the trace's report (a CPU trace holds no
    device work, and says so) with the pipeline's spans."""
    from posenet_tpu_torch.apps import benchmark

    img_dir = str(tmp_path / "in")
    _write_images(img_dir, n=2, hw=(72, 96))
    trace_dir = str(tmp_path / "trace")
    benchmark.main(['--image_dir', img_dir, '--num_images', '4', '--batch_size', batch_size,
                    '--image_size', '65', '--profile', trace_dir, *M50])
    out = capsys.readouterr().out
    assert 'Average FPS:' in out
    if batch_size == '0':
        assert 'forward' in out and 'decode' in out and 'ms/call' in out
    else:
        assert 'no device events' in out
        assert 'pipeline.call' in out and 'pipeline.decode' in out
        assert os.path.exists(os.path.join(trace_dir, 'trace.json'))
    (tmp_path / 'empty').mkdir()
    with pytest.raises(SystemExit, match='no images found'):
        benchmark.main(['--image_dir', str(tmp_path / 'empty'), *M50])


APPS = ['image_demo', 'benchmark', 'webcam_demo', 'video_demo', 'streamlit_demo']


def _main_without_a_card(app, tmp_path, monkeypatch):
    """The app's `main` with its default device on a host without a CUDA
    device: it raises where it loads its model."""
    import importlib

    from tests.test_streamlit_demo import FakeStreamlit

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.chdir(tmp_path)
    module = importlib.import_module(f'posenet_tpu_torch.apps.{app}')
    argv = {'image_demo': ['--image_dir', str(tmp_path)],
            'benchmark': ['--image_dir', str(tmp_path)],
            'webcam_demo': ['--no_display'],
            'video_demo': ['--video', str(tmp_path / 'none.mp4')],
            'streamlit_demo': []}[app]
    if app == 'streamlit_demo':
        monkeypatch.setattr(module, 'st', FakeStreamlit({"Model": 50}))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        module.main(argv + ['--model', '50', '--allow_random_init']
                    if app != 'streamlit_demo' else argv)


@pytest.mark.parametrize("app", APPS)
def test_apps_default_to_the_card(app, tmp_path, monkeypatch):
    """Without --device each app loads its model on the card: on a host
    without a CUDA device that raises, instead of running on the CPU."""
    _main_without_a_card(app, tmp_path, monkeypatch)


@pytest.mark.parametrize("app", APPS)
def test_apps_turn_tf32_off(app, tmp_path, monkeypatch):
    """Each app runs the float32 model, as the JAX apps do: before it loads
    its model it turns off TF32, which PyTorch lets cuDNN use on the card."""
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    _main_without_a_card(app, tmp_path, monkeypatch)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def _poses_printed(out: str):
    """image_demo's printed results: {image: [(pose score, (17, 2) coords)]}."""
    found = {}
    image = None
    for line in out.splitlines():
        if line.startswith('Results for image: '):
            image = os.path.basename(line.split(': ', 1)[1])
            found[image] = []
        elif line.startswith('Pose #'):
            found[image].append((float(line.rsplit('= ', 1)[1]), []))
        elif line.startswith('Keypoint '):
            found[image][-1][1].append(
                [float(v) for v in re.findall(r'[-+]?\d+\.?\d*(?:e[-+]?\d+)?',
                                               line.split('coord = ', 1)[1])])
    return found


def test_image_demo_matches_jax_on_fixture(tmp_path, monkeypatch, capsys):
    """image_demo of both packages, fixture m50 s16 weights, on synthesized
    photos: equal pose counts, pose scores within 1e-4 and coordinates
    within 1e-3 px."""
    import cv2

    import image_demo as jax_image_demo
    from posenet_tpu_torch.apps import image_demo

    fixture_cwd(tmp_path, monkeypatch)
    os.makedirs('in')
    for i in range(2):
        cv2.imwrite(os.path.join('in', f'photo{i}.png'), synth_photo(seed=100 + i))
    monkeypatch.setattr(sys, 'argv', ['image_demo.py', '--model', '50', '--image_dir', 'in',
                                      '--output_dir', 'out_jax'])
    jax_image_demo.main()
    ref = _poses_printed(capsys.readouterr().out)
    image_demo.main(['--model', '50', '--image_dir', 'in', '--output_dir', 'out_torch',
                     '--device', 'cpu'])
    ours = _poses_printed(capsys.readouterr().out)
    assert sorted(ours) == sorted(ref) == ['photo0.png', 'photo1.png']
    for image in ref:
        assert len(ours[image]) == len(ref[image]) >= 1, image
        for (score, coords), (ref_score, ref_coords) in zip(ours[image], ref[image]):
            assert abs(score - ref_score) <= 1e-4
            np.testing.assert_allclose(coords, ref_coords, atol=1e-3, rtol=0)
    assert sorted(os.listdir('out_torch')) == sorted(os.listdir('out_jax'))


def _poses(seed, p=4):
    rng = np.random.RandomState(seed)
    scores = np.array([0.9, 0.6, 0.3, 0.1])[:p]
    kp_scores = rng.uniform(0, 1, (p, 17))
    coords = rng.uniform(-10, 110, (p, 17, 2))
    return scores, kp_scores, coords


@pytest.mark.parametrize("seed", range(3))
def test_drawing_is_pixel_equal_to_jax(seed):
    import cv2

    from posenet_tpu import draw as jax_draw
    from posenet_tpu_torch import draw

    scores, kp_scores, coords = _poses(seed)
    img = np.random.RandomState(seed).randint(0, 255, (100, 120, 3), np.uint8)
    for name, kw in (('draw_skel_and_kp', dict(min_pose_score=0.25, min_part_score=0.2)),
                     ('draw_keypoints', dict(min_pose_confidence=0.25,
                                             min_part_confidence=0.2)),
                     ('draw_skeleton', dict(min_pose_confidence=0.25,
                                            min_part_confidence=0.2))):
        # cv2.drawKeypoints without a colour draws each keypoint in a colour
        # from cv2's own random generator: seed it alike for both calls.
        cv2.setRNGSeed(seed)
        ours = getattr(draw, name)(img.copy(), scores, kp_scores, coords, **kw)
        cv2.setRNGSeed(seed)
        ref = getattr(jax_draw, name)(img.copy(), scores, kp_scores, coords, **kw)
        np.testing.assert_array_equal(ours, ref, err_msg=name)
        assert (ours != img).any(), name
    for a, b in zip(draw.get_adjacent_keypoints(kp_scores[0], coords[0], 0.3),
                    jax_draw.get_adjacent_keypoints(kp_scores[0], coords[0], 0.3)):
        np.testing.assert_array_equal(a, b)


def test_visualizers(tmp_path):
    import cv2

    from posenet_tpu_torch import visualizers

    hm = np.random.RandomState(0).uniform(0, 1, (2, 17, 8, 8)).astype(np.float32)
    out_dir = str(tmp_path / "dumps")
    visualizers.print_heatmap(torch.from_numpy(hm[0]), output_dir=out_dir,
                              use_matplotlib=False)
    assert os.path.exists(os.path.join(out_dir, "image_0", "joint_16_heatmap.png"))

    img_path = str(tmp_path / "img.jpg")
    cv2.imwrite(img_path, np.zeros((100, 100, 3), np.uint8))
    coords = np.random.RandomState(1).uniform(10, 90, (1, 17, 2))
    overlay = visualizers.draw_coordinates_to_image_file(
        img_path, str(tmp_path / "out.jpg"),
        np.array([0.9]), np.full((1, 17), 0.9), coords, np.array([1.0, 1.0]))
    assert os.path.exists(str(tmp_path / "out.jpg"))
    assert overlay.sum() > 0

    arrows = visualizers.draw_displacement_vectors(
        np.zeros((100, 100, 3), np.uint8), coords[0], np.full((16, 2), 5.0))
    assert arrows.sum() > 0


def test_stage_timer():
    """Per-stage host time from `profiling.span` under `recording()`: the
    counts and totals of `span_report()`, no device time off the card, and
    the table the benchmark CLI prints."""
    import time

    from posenet_tpu_torch import profiling

    with profiling.recording():
        with profiling.span('a'):
            time.sleep(0.02)
        with profiling.span('b'):
            time.sleep(0.01)
        with profiling.span('a'):
            time.sleep(0.02)
    rep = profiling.span_report()
    assert rep['a']['count'] == 2 and rep['b']['count'] == 1
    assert rep['a']['total_ms'] > rep['b']['total_ms'] >= 10.0
    assert rep['a']['self_ms'] == rep['a']['total_ms'] and rep['a']['device_ms'] is None
    table = profiling.span_table()
    assert 'a' in table and 'ms/call' in table


def test_trace_and_report(tmp_path, monkeypatch):
    """A CPU trace holds no device work and the report says so; on a trace
    with the card's events the report sums kernels and copies by name and
    leaves out the `record_function` spans over them; the default device,
    the card, raises on a host without one."""
    from posenet_tpu_torch.profiling import device_time_report, trace

    logdir = str(tmp_path / 'trace')
    x = torch.ones((64, 64))
    with trace(logdir, 'cpu'):
        (x @ x).sum()
    assert 'no device events' in device_time_report(logdir)
    assert 'no trace found' in device_time_report(str(tmp_path / 'none'))

    events = [{'ph': 'X', 'cat': 'kernel', 'name': 'k1', 'dur': 30.0},
              {'ph': 'X', 'cat': 'kernel', 'name': 'k1', 'dur': 10.0},
              {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD', 'dur': 60.0},
              {'ph': 'X', 'cat': 'gpu_user_annotation', 'name': 'range', 'dur': 500.0},
              {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mm', 'dur': 900.0}]
    card = tmp_path / 'card'
    card.mkdir()
    (card / 'trace.json').write_text(json.dumps({'traceEvents': events}))
    report = device_time_report(str(card))
    rows = {line.split()[0]: line.split()[1:] for line in report.splitlines()[1:]}
    assert rows['Memcpy'] == ['HtoD', '0.060', '1', '60.0']
    assert rows['k1'] == ['0.040', '2', '40.0']
    assert rows['TOTAL'] == ['0.100']
    assert 'range' not in rows and 'aten::mm' not in rows

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        with trace(logdir):
            pass
