"""The port's offline video CLI (`posenet_tpu_torch.apps.video_demo`) on
the CPU (`--device cpu`, m50): the cases of tests/test_video_demo.py, and
the JSONL poses of both packages' video tools on a video of synthesized
photos with the fixture m50 s16 weights, equal in pose counts, pose scores
within 1e-4 and keypoint coordinates within 1e-3 px (the float32 slices
agree within 4.4e-4 px, ROADMAP Queue 3)."""

import json
import os
import sys

import numpy as np
import pytest

from tests.test_torch_apps import M50, fixture_cwd
from tests.test_video_demo import _write_video
from tests.tfjs_fixture import synth_photo


@pytest.mark.parametrize('pipeline_depth', ['2', '1'])
def test_video_demo_end_to_end(tmp_path, capsys, pipeline_depth):
    """6 frames through batch 4 (one full and one padded partial batch):
    an overlay video at SOURCE resolution and one JSONL record per frame,
    in order, at both pipeline depths."""
    import cv2

    from posenet_tpu_torch.apps import video_demo

    src = str(tmp_path / 'in.mp4')
    out_video = str(tmp_path / 'out.mp4')
    poses_out = str(tmp_path / 'poses.jsonl')
    _write_video(src, n_frames=6, hw=(72, 96))
    video_demo.main(['--video', src, '--resize', '33x33', '--batch_size', '4',
                     '--min_pose_score', '0.0', '--output_video', out_video,
                     '--poses_out', poses_out, '--pipeline_depth', pipeline_depth, *M50])
    assert 'Processed 6 frames' in capsys.readouterr().out

    records = [json.loads(line) for line in open(poses_out)]
    assert [r['frame'] for r in records] == list(range(6))
    for r in records:
        for pose in r['poses']:
            assert pose['score'] > 0          # padded/empty slots excluded
            assert len(pose['keypoints']) == 17
            ys = [k['y'] for k in pose['keypoints']]
            xs = [k['x'] for k in pose['keypoints']]
            assert max(ys) <= 72 and max(xs) <= 96

    cap = cv2.VideoCapture(out_video)
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        assert frame.shape == (72, 96, 3)     # source resolution overlay
        n += 1
    cap.release()
    assert n == 6


def test_video_demo_max_frames_no_outputs(tmp_path, capsys):
    from posenet_tpu_torch.apps import video_demo

    src = str(tmp_path / 'in.mp4')
    _write_video(src, n_frames=5, hw=(48, 64))
    video_demo.main(['--video', src, '--resize', '17x17', '--batch_size', '3',
                     '--max_frames', '4', *M50])
    assert 'Processed 4 frames' in capsys.readouterr().out


def test_video_demo_device_preprocess(tmp_path, capsys):
    """--device_preprocess sends source-resolution frames; the resize,
    colour flip and normalize run in the pipeline on the device."""
    from posenet_tpu_torch.apps import video_demo

    src = str(tmp_path / 'in.mp4')
    poses_out = str(tmp_path / 'poses.jsonl')
    _write_video(src, n_frames=4, hw=(60, 84))
    video_demo.main(['--video', src, '--resize', '33x33', '--batch_size', '4',
                     '--min_pose_score', '0.0', '--poses_out', poses_out,
                     '--device_preprocess', *M50])
    assert 'Processed 4 frames' in capsys.readouterr().out
    records = [json.loads(line) for line in open(poses_out)]
    assert len(records) == 4
    for r in records:
        for pose in r['poses']:
            ys = [k['y'] for k in pose['keypoints']]
            xs = [k['x'] for k in pose['keypoints']]
            assert max(ys) <= 60 and max(xs) <= 84   # source-resolution coords


def test_video_demo_missing_file(tmp_path):
    from posenet_tpu_torch.apps import video_demo

    with pytest.raises(IOError, match='could not open video'):
        video_demo.main(['--video', str(tmp_path / 'nope.mp4'), *M50])


def test_video_demo_resize_backend_flag(tmp_path, capsys, monkeypatch):
    """--resize_backend: cv2 and native both run; native says why when its
    library cannot be built."""
    from posenet_tpu_torch import native_preprocess as npp
    from posenet_tpu_torch.apps import video_demo

    src = str(tmp_path / 'in.mp4')
    _write_video(src, n_frames=3, hw=(48, 64))
    for backend in ('cv2', 'native'):
        video_demo.main(['--video', src, '--resize', '33x33', '--batch_size', '3',
                         '--resize_backend', backend, *M50])
        assert 'Processed 3 frames' in capsys.readouterr().out

    monkeypatch.setattr(npp, '_lib', None)
    monkeypatch.setattr(npp, 'SOURCE', tmp_path / 'preprocess.cpp')   # no source here
    with pytest.raises(SystemExit, match='native library is not built.*preprocess.cpp not found'):
        video_demo.main(['--video', src, '--resize', '33x33', '--resize_backend', 'native',
                         *M50])


def test_native_available_builds_or_says_why(tmp_path, monkeypatch):
    from posenet_tpu_torch import native_preprocess as npp

    assert npp.native_available()
    monkeypatch.setattr(npp, '_lib', None)
    monkeypatch.setattr(npp, 'SOURCE', tmp_path / 'preprocess.cpp')
    assert not npp.native_available()
    assert 'not found' in npp.build_error


def test_video_demo_poses_match_jax_on_fixture(tmp_path, monkeypatch, capsys):
    """Both packages' video tools, fixture m50 s16 weights, on 5 frames of
    synthesized photos (batch 4, so a padded batch too): the same frames,
    pose counts, pose scores within 1e-4, coordinates within 1e-3 px."""
    import cv2

    import video_demo as jax_video_demo
    from posenet_tpu_torch.apps import video_demo

    fixture_cwd(tmp_path, monkeypatch)
    writer = cv2.VideoWriter('in.mp4', cv2.VideoWriter_fourcc(*'mp4v'), 10, (481, 353))
    assert writer.isOpened(), "cv2 mp4v writer unavailable"
    for i in range(5):
        writer.write(synth_photo(seed=100 + i % 2))
    writer.release()
    argv = ['--video', 'in.mp4', '--model', '50', '--resize', '353x481', '--batch_size', '4']
    monkeypatch.setattr(sys, 'argv', ['video_demo.py', *argv, '--poses_out', 'jax.jsonl'])
    jax_video_demo.main()
    video_demo.main([*argv, '--poses_out', 'torch.jsonl', '--device', 'cpu'])
    assert capsys.readouterr().out.count('Processed 5 frames') == 2
    ref = [json.loads(line) for line in open('jax.jsonl')]
    ours = [json.loads(line) for line in open('torch.jsonl')]
    assert [r['frame'] for r in ours] == [r['frame'] for r in ref] == list(range(5))
    assert sum(len(r['poses']) for r in ref) >= 5
    for a, b in zip(ours, ref):
        assert len(a['poses']) == len(b['poses']), a['frame']
        for pa, pb in zip(a['poses'], b['poses']):
            assert abs(pa['score'] - pb['score']) <= 1e-4
            for ka, kb in zip(pa['keypoints'], pb['keypoints']):
                assert ka['part'] == kb['part']
                assert abs(ka['score'] - kb['score']) <= 1e-4
                np.testing.assert_allclose([ka['y'], ka['x']], [kb['y'], kb['x']],
                                           atol=1e-3, rtol=0)
    assert os.path.getsize('torch.jsonl') > 0
