"""The port's facade and offline tools, on the CPU at small sizes:
`tools/verify_spatial_large_torch.py`, `tools/train_accuracy_delta_torch.py`
and the three JAX-against-port sweeps (`tools/fuzz_*_parity_torch.py`);
and what `chip_smoke.py` times on the card, worked out here: each kernel
launch of the benchmark's cells (`cell_kernel_shapes`), and bounds at the
yardstick's peaks (`benchmarks/yardstick.py`), with the yardstick's
reduction of a device trace.

Every tool prints the JAX counterpart's keys, plus the device, which is
`cpu` here: no number here is a device metric. Without `--device cpu` and
without a card, every entry point raises the card's error before it does
any work.
"""

import glob
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import posenet_tpu

import chip_smoke
import posenet_tpu_torch
from benchmarks import harness, yardstick
from posenet_tpu_torch.config import ModelConfig
from posenet_tpu_torch.models import mobilenet_v1
from tools import (fuzz_backbone_parity_torch, fuzz_decode_parity_torch,
                   fuzz_ground_truth_parity_torch, train_accuracy_delta_torch,
                   verify_spatial_large_torch)

CPU = torch.device('cpu')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Each cell of BENCHMARK.json: (batch, frame (H, W), the heads' grid, K2
# launches and stem launches of one forward); a new cell fails until it
# is added here.
CELLS = {
    'm101-s16.offline-b256': (256, (513, 513), (33, 33), 13, 0),
    'm101-s8.offline-720p-b32': (32, (721, 1281), (91, 161), 13, 0),
    'r50-s16.offline-b256': (256, (513, 513), (33, 33), 0, 1),
}


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread for the scripts' small CPU runs: they are many
    small ops, and with several test workers sharing the cores, each
    worker's default pool of threads oversubscribes them and slows such a
    run by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def test_facade_matches_jax():
    """Every public non-module name of `posenet_tpu`'s facade, and every
    name of its `constants.__all__`, resolves on the port; data (lists,
    dicts, ints, arrays, `__version__`) is equal."""
    names = [n for n in dir(posenet_tpu)
             if not n.startswith('__') and not isinstance(getattr(posenet_tpu, n),
                                                          types.ModuleType)]
    missing = [n for n in names if not hasattr(posenet_tpu_torch, n)]
    assert not missing, missing
    for n in names + ['__version__']:
        value = getattr(posenet_tpu, n)
        if isinstance(value, (list, dict, tuple, int, str, np.ndarray)):
            assert _equal(getattr(posenet_tpu_torch, n), value), n
    for n in posenet_tpu.constants.__all__:
        assert n in posenet_tpu_torch.constants.__all__, n
        assert _equal(getattr(posenet_tpu_torch.constants, n),
                      getattr(posenet_tpu.constants, n)), n
    assert posenet_tpu_torch.PART_CHANNELS == posenet_tpu.PART_CHANNELS
    assert posenet_tpu_torch.TrainConfig is posenet_tpu_torch.config.TrainConfig


@pytest.mark.parametrize('cell', chip_smoke.benchmark_cells())
def test_cell_kernel_shapes(cell):
    """The launches `chip_smoke.py` times in a cell: in an m101 forward K2
    on every layer the port's bf16 trunk runs it on (`uses_sepconv`), at
    the layer's widths, input and output maps, stride and dilation rate
    (at s16 layers 2, 4 and 6 at stride 2, layer 13 at rate 2; at s8
    layers 2 and 4 at stride 2, 7-12 at rate 2 and 13 at rate 4); the stem
    once in a ResNet50 forward on the frames; K1 once on the heads' grid
    with the cell's 128 candidates; all at the cell's batch."""
    batch, (height, width), grid, n_k2, n_stem = CELLS[cell]
    launches = chip_smoke.cell_kernel_shapes(cell)
    assert {s['batch'] for s in launches} == {batch}
    k2 = [s for s in launches if s['kernel'] == 'K2']
    stems = [s for s in launches if s['kernel'] == 'stem']
    (k1,) = [s for s in launches if s['kernel'] == 'K1']
    assert len(k2) == n_k2 and len(stems) == n_stem and len(launches) == n_k2 + n_stem + 1
    assert (k1['h'], k1['w']) == grid and k1['decode'].max_candidates == 128
    if stems:
        assert (stems[0]['h'], stems[0]['w']) == (height, width)
        return
    stride = k1['stride']
    cfg = ModelConfig(101, stride, compute_dtype=torch.bfloat16)
    plan = [layer for layer in mobilenet_v1.stride_plan(101, stride)
            if mobilenet_v1.uses_sepconv(layer, cfg)]
    assert [(s['layer'], s['c_in'], s['c_out'], s['stride'], s['rate']) for s in k2] == [
        (layer['block_id'], layer['inp'], layer['outp'], layer['stride'], layer['rate'])
        for layer in plan]
    assert [(s['h'], s['w']) for s in k2] == [
        ((height - 1) // layer['cumulative_stride'] + 1,
         (width - 1) // layer['cumulative_stride'] + 1) for layer in plan]
    assert [(s['h_in'], s['w_in']) for s in k2] == [
        ((height - 1) // (layer['cumulative_stride'] // layer['stride']) + 1,
         (width - 1) // (layer['cumulative_stride'] // layer['stride']) + 1) for layer in plan]
    dilated = {s['layer']: s['rate'] for s in k2 if s['rate'] > 1}
    assert dilated == ({13: 2} if stride == 16 else {7: 2, 8: 2, 9: 2, 10: 2, 11: 2, 12: 2,
                                                     13: 4})
    strided = [s['layer'] for s in k2 if s['stride'] == 2]
    assert strided == ([2, 4, 6] if stride == 16 else [2, 4])


@pytest.mark.parametrize('cell', ['m101-s16.offline-b256', 'm101-s8.offline-720p-b32'])
def test_k2_bounds_are_the_yardsticks(cell):
    """The K2 bounds `chip_smoke.py` prints sum, over a cell's stride-1
    launches, to the bound `k2_roofline.offline` divides by."""
    assert chip_smoke.k2_bound_ms is yardstick.k2_bound_ms
    launches = [s for s in chip_smoke.cell_kernel_shapes(cell)
                if s['kernel'] == 'K2' and s['stride'] == 1]
    tool = sum(chip_smoke.k2_launch_bound_ms(s) for s in launches)
    c = harness.load_cell(cell)
    batch, height, width = (c.traffic[k] for k in ('batch', 'height', 'width'))
    want = sum(yardstick.k2_bound_ms(batch, *layer) for layer in yardstick.k2_layers(
        c.config['model']['model_id'], c.config['model']['output_stride'], height, width))
    assert tool == pytest.approx(want, rel=1e-12) and tool > 0


@pytest.mark.parametrize('cell,bounds', [
    ('m101-s16.offline-b256', {2: 0.9716, 4: 0.4909, 6: 0.2506}),
    ('m101-s8.offline-720p-b32', {2: 0.4250, 4: 0.2138})])
def test_k2_stride2_bounds_read_the_input_at_its_size(cell, bounds):
    """A stride-2 K2 launch's bound: its input (the previous layer's map,
    four times the output's pixels) read once and its output written once
    at the yardstick's HBM peak, which takes longer than its products at
    its bf16 and float32 peaks. At the output's size it would be
    `yardstick.k2_bound_ms`, which reads the input at the output's size."""
    assert chip_smoke.F32_FLOPS == yardstick.F32_FLOPS
    strided = [s for s in chip_smoke.cell_kernel_shapes(cell)
               if s['kernel'] == 'K2' and s['stride'] == 2]
    assert {s['layer']: round(chip_smoke.k2_launch_bound_ms(s), 4) for s in strided} == bounds
    for s in strided:
        b, h, w, h_in, w_in, c_in, c_out = (s[k] for k in (
            'batch', 'h', 'w', 'h_in', 'w_in', 'c_in', 'c_out'))
        extra_ms = 2 * b * (h_in * w_in - h * w) * c_in / yardstick.HBM_BYTES_S * 1e3
        assert chip_smoke.k2_launch_bound_ms(s) == pytest.approx(
            yardstick.k2_bound_ms(b, h, w, c_in, c_out) + extra_ms, rel=1e-12)
        assert chip_smoke.k2_launch_bound_ms(dict(s, h_in=h, w_in=w)) == pytest.approx(
            yardstick.k2_bound_ms(b, h, w, c_in, c_out), rel=1e-12)


def test_stem_bound_from_the_yardsticks_peaks():
    """The fused stem at b256 513x513: its products at the yardstick's bf16
    peak take longer than its bytes at its HBM peak."""
    assert (chip_smoke.HBM_BYTES_S, chip_smoke.BF16_TENSOR_FLOPS) == (
        yardstick.HBM_BYTES_S, yardstick.BF16_TENSOR_FLOPS)
    (stem,) = [s for s in chip_smoke.cell_kernel_shapes('r50-s16.offline-b256')
               if s['kernel'] == 'stem']
    bound, bound_by = chip_smoke.stem_bound_ms(stem['batch'], stem['h'], stem['w'])
    assert bound_by == 'operations' and bound == pytest.approx(0.3217, abs=1e-4)


@pytest.mark.parametrize('source', sorted(
    os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, 'posenet_tpu_torch', 'csrc',
                                                             '*.cu'))))
def test_every_hand_written_kernel_is_timed(source):
    """Each CUDA source of the port is a kernel that `chip_smoke.py` times
    (`TIMERS`) in a cell that launches it."""
    (kernel,) = [k for k, (_, src, _) in chip_smoke.KERNELS.items() if src == source]
    assert kernel in chip_smoke.TIMERS
    assert any(s['kernel'] == kernel for cell in chip_smoke.benchmark_cells()
               for s in chip_smoke.cell_kernel_shapes(cell))


def test_chip_smoke_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip('this host has a card: chip_smoke runs there')
    done = subprocess.run([sys.executable, 'chip_smoke.py', '--only', 'k1'], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and 'no CUDA device' in done.stderr, done.stderr[-2000:]
    assert '"ok": true' not in done.stdout


def test_yardstick_summary_of_a_device_trace(tmp_path):
    """The yardstick's busy union and device time by kind of a trace's
    device events (two overlapping kernels, a copy, a conv and an
    elementwise kernel; a host op left out of both), and the idle gaps
    filed under the host op around them."""
    events = [
        {'ph': 'X', 'cat': 'kernel', 'name': 'sepconv_kernel<128>', 'ts': 0.0, 'dur': 1000.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'traverse_kernel', 'ts': 500.0, 'dur': 1000.0},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD', 'ts': 3000.0, 'dur': 500.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'sm90_xmma_fprop_implicit_gemm', 'ts': 4000.0,
         'dur': 250.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'void at::native::vectorized_elementwise_kernel',
         'ts': 4250.0, 'dur': 250.0},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::conv2d', 'ts': 0.0, 'dur': 9000.0},
    ]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events}))
    s = yardstick.summarize_trace(str(path), window_s=0.01)
    assert s['device_events'] == 5 and s['window_s'] == 0.01
    assert s['busy_s'] == {0: pytest.approx(0.0025)}
    assert s['by_kind_s'] == pytest.approx({'K2 sepconv': 0.001, 'K1 traverse': 0.001,
                                            'copies': 0.0005, 'cuDNN convs': 0.00025,
                                            'elementwise and other': 0.00025})
    assert s['idle_by_label_s'] == pytest.approx(
        {'no benchmark span / aten::conv2d': 0.002})


SWEEPS = {
    'decode': (fuzz_decode_parity_torch.run_case, 910_000, 17),
    'backbone': (fuzz_backbone_parity_torch.run_case, 550_000, 13),
    'ground_truth': (fuzz_ground_truth_parity_torch.run_case, 31_000, 7),
}


@pytest.mark.parametrize('case', range(3))
@pytest.mark.parametrize('sweep', list(SWEEPS))
def test_sweep_cases_pass(sweep, case):
    """The first three cases of each JAX-against-port sweep (its own seeds)."""
    run_case, base, step = SWEEPS[sweep]
    assert run_case(base + case * step) == ''


def test_spatial_tool_at_a_small_grid():
    """The spatial partition over ['cpu'] * 3 against the unsharded
    pipeline at 65x65 s16, within the JAX tool's bounds."""
    result = verify_spatial_large_torch.compare('65x65-s16', (65, 65), 16, ['cpu'] * 3)
    assert result['ok'] and result['poses'] >= 1
    assert verify_spatial_large_torch.shard_devices(CPU, 3) == ['cpu'] * 3


def test_accuracy_delta_tool_on_the_cpu(tmp_path, capsys):
    """m50 65x65, 2 epochs on 4 + 2 synthesized images: finite numbers."""
    result = train_accuracy_delta_torch.run(
        ['--device', 'cpu', '--image_size', '65', '--epochs', '2', '--n_train', '4',
         '--n_test', '2', '--workdir', str(tmp_path / 'w')])
    out = capsys.readouterr().out
    line = json.loads(next(x for x in out.splitlines()
                           if x.startswith('ACCURACY_DELTA '))[len('ACCURACY_DELTA '):])
    assert line['device'] == 'cpu' and line['epochs'] == 2
    for part in ('before', 'after'):
        assert all(np.isfinite(line[part][k]) for k in ('loss', 'oks', 'mAP'))
    assert np.isfinite(line['delta_oks']) and np.isfinite(line['delta_map'])
    assert result['improved'] in (True, False)


def test_entry_points_default_to_the_card(tmp_path):
    """Without `--device` and without a card, each new CLI raises the
    card's error before any work (no workdir, no trace)."""
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the defaults run there')
    workdir = tmp_path / 'w'
    for main, argv in ((verify_spatial_large_torch.main, []),
                       (train_accuracy_delta_torch.main, ['--workdir', str(workdir)])):
        with pytest.raises(RuntimeError, match='CUDA'):
            main(argv)
    assert not os.path.exists(workdir)


def test_decode_sweep_case_that_found_the_sum_order():
    """The sweep's case 18 (a 91x9 grid, 1654 local maxima): pose scores
    were 3 ulp from JAX's while the port's instance score was a
    `torch.sum`; they are within 2 ulp since it adds left to right."""
    assert fuzz_decode_parity_torch.run_case(910_000 + 18 * 17) == ''
