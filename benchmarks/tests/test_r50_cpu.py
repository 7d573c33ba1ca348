"""The cell `r50-s16.offline-b256` (PoseNet ResNet50) at a tiny size on the
CPU, 129x129 frames at full widths: a sound run is correct under the cell's
own limits and reads no device metric, the reference agrees with the
float32 program, and the control and a run with the timed path broken
underneath come out not correct. The yardstick's count of ResNet50's work
against a hand count. Marked `cuda`: the same at the cell's own size on
the card,

    python -m pytest benchmarks/tests/test_r50_cpu.py -q -m cuda
"""

from __future__ import annotations

import pytest
import torch

from benchmarks import check, control, harness, yardstick_r50
from benchmarks.references import posenet_resnet50
from benchmarks.tests.cells import cpus, tiny
from benchmarks.tests.test_harness_cpu import (_alter_one_keypoint,
                                               _leave_out_half_the_batch,
                                               _return_the_first_answer)
from posenet_tpu_torch.models import resnet50

CELL = 'r50-s16.offline-b256'
SEED = 2 ** 31 + 5050
NEW_METRICS = ('mfu_r50.offline', 'r50_conv_roofline.offline',
               'r50_block4_device_ms.offline')


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run(cell, trace=False, **kw):
    return harness.execute(cell, SEED, 0.3, trace, cpus(cell), log=lambda *a, **k: None, **kw)


def test_a_sound_run_is_correct_and_reads_no_device_metric():
    cell = tiny(CELL)       # its model_id=50 is not read for ResNet50
    assert {m['name'] for m in cell.per_layer} >= set(NEW_METRICS)
    for trace in (False, True):
        result = run(cell, trace)
        assert result['correct'] is True, result['checks']
        assert result['device']['platform'] == 'cpu'
        assert set(result['checks']) == set(posenet_resnet50.NAMES)
        assert not set(NEW_METRICS) & set(result['metrics'])
        if trace:
            assert result['metrics']['forward_launch_ms.offline']['value'] > 0.0
        else:
            assert set(result['metrics']) == {'img_per_s', 'setup_s'}


def test_the_reference_agrees_with_the_float32_program():
    gaps = run(tiny(CELL, compute_dtype='float32'))['checks']
    assert gaps['score_gap']['value'] <= 1e-5
    assert gaps['offset_gap_px']['value'] <= 1e-4
    assert gaps['walk_gap_px']['value'] == 0.0
    assert gaps['pose_score_gap']['value'] <= 1e-6


def test_the_control_is_not_correct():
    """The reference in float8 in the program's place."""
    result = run(tiny(CELL), system=posenet_resnet50.CONTROL)
    assert result['correct'] is False, result['checks']


def _block4_undilated(monkeypatch):
    """Block 4's 3x3 convs at rate 1, as if the output-stride cut were
    left out."""
    real = resnet50.unit_plan
    monkeypatch.setattr(resnet50, 'unit_plan',
                        lambda s: [dict(u, rate=1) for u in real(s)])


def _without_the_mean(monkeypatch):
    """The frames fed to the trunk without the ImageNet mean."""
    monkeypatch.setattr(resnet50, 'normalize', lambda frames, mean, dtype: frames.to(dtype))


@pytest.mark.parametrize('fault', [_alter_one_keypoint, _leave_out_half_the_batch,
                                   _return_the_first_answer, _block4_undilated,
                                   _without_the_mean])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = run(tiny(CELL))
    assert result['correct'] is False, result['checks']


def test_forward_flops_at_513_s16():
    """64.39 GFLOP an image: the 53 trunk convs and the heads, 2 a
    multiply-add; 7.1x m101's 9.07."""
    assert yardstick_r50.forward_flops(16, 513, 513) == 64391084416.0
    shapes = yardstick_r50.conv_shapes(16, 513, 513)
    assert len(shapes) == 54 and shapes[-1]['role'] == 'heads'
    stem = shapes[0]
    assert (stem['h'], stem['w']) == (257, 257)
    assert 2 * 257 * 257 * 64 * 3 * 49 == 2 * stem['h'] * stem['w'] * 64 * 3 * 49


def test_block4_conv_bound_against_a_hand_count():
    """Block 4's first 3x3 conv (512 -> 512 at rate 2 on 33x33) at b256:
    2 * 256 * 33 * 33 * 512 * 512 * 9 = 1.3154e12 operations take 1.3300 ms
    at 989 TFLOP/s, more than its 575.7 MB take at 3.35 TB/s (0.1718 ms)."""
    conv = next(c for c in yardstick_r50.conv_shapes(16, 513, 513)
                if c['block'] == 4 and c['role'] == 'spatial')
    assert (conv['h_in'], conv['h'], conv['rate'], conv['c_in']) == (33, 33, 2, 512)
    ops = 2 * 256 * 33 * 33 * 512 * 512 * 9
    nbytes = 2 * (256 * 33 * 33 * 512 * 2 + 512 * 512 * 9)
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.1718, abs=1e-4)
    assert yardstick_r50.conv_bound_ms(256, conv) == pytest.approx(ops / 989e12 * 1e3)
    assert yardstick_r50.conv_bound_ms(256, conv) == pytest.approx(1.3300, abs=1e-4)


@pytest.mark.cuda
def test_program_correct_and_control_not_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(CELL)
    line = control.readings(cell, 2 ** 31 + 99, ['cuda:0'], with_program=True)
    assert check.verdict(line['program'], cell.limits), line['program']
    assert not check.verdict(line['control'], cell.limits), line['control']
