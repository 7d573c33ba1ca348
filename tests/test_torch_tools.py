"""The port's facade, benchmark scripts and offline tools, on the CPU at
small sizes: `bench_torch.py`, `benchmark_suite_torch.py`,
`tools/profile_fused_torch.py`, `tools/verify_spatial_large_torch.py`,
`tools/train_accuracy_delta_torch.py` and the three JAX-against-port
sweeps (`tools/fuzz_*_parity_torch.py`).

Every script prints the JAX counterpart's keys, plus the device, which is
`cpu` here: no number here is a device metric. Without `--device cpu` and
without a card, every entry point raises the card's error before it does
any work.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import posenet_tpu

import bench_torch
import benchmark_suite_torch as suite
import posenet_tpu_torch
from posenet_tpu_torch.decode import decode_batch
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.pipeline import infer, normalize
from tools import (fuzz_backbone_parity_torch, fuzz_decode_parity_torch,
                   fuzz_ground_truth_parity_torch, profile_fused_torch,
                   train_accuracy_delta_torch, verify_spatial_large_torch)

CPU = torch.device('cpu')
LATENCY_KEYS = {'config', 'metric', 'p50_ms', 'p99_ms', 'p50_device_ms', 'fps_at_p50'}
THROUGHPUT_KEYS = {'config', 'metric', 'img_per_s', 'ms_per_batch', 'batch'}
DECODE_KEYS = {'config', 'metric', 'grid', 'batch', 'ms_per_batch', 'img_per_s'}
TRAIN_KEYS = {'config', 'devices', 'global_batch', 'ms_per_step', 'img_per_s', 'loss'}
CPU_KEYS = {'device': 'cpu', 'launches': {'K1': 0, 'K2': 0}}


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


def _last_json(out: str) -> dict:
    lines = [line for line in out.strip().splitlines() if line.startswith('{')]
    assert len(lines) == 1, out
    return json.loads(lines[0])


def test_bench_main_on_the_cpu(capsys):
    """One JSON line with bench.py's keys; the device is the CPU, and the
    metric says it is no device metric."""
    result = bench_torch.main(['--device', 'cpu', '--model', '50', '--size', '193',
                               '--batch', '2', '--iters', '1'])
    line = _last_json(capsys.readouterr().out)
    assert line == json.loads(json.dumps(result))
    assert set(line) == {'metric', 'value', 'unit', 'vs_baseline', 'extra'}
    assert 'CPU' in line['metric'] and 'not a device metric' in line['metric']
    extra = line['extra']
    assert extra['device'] == 'cpu' and extra['launches_per_step'] == {'K1': 0, 'K2': 0}
    assert len(extra['windows_img_per_s']) == 3 and line['value'] == max(
        extra['windows_img_per_s'])
    assert line['vs_baseline'] == line['value'] / 250.0
    assert extra['poses_per_peaked_image'] >= 1
    assert {'p50_batch_ms', 'flat_content_img_per_s'} <= set(extra)


def test_fused_step_is_forward_then_decode():
    """`fused_step` is the forward on the frames and `decode_batch` on the
    peaked heads, chained by hand; `infer` is the forward's heads decoded."""
    params, frames, peaked, cfg, dcfg = bench_torch.setup(50, 16, 193, 193, 2, CPU)
    heads, poses = bench_torch.fused_step(params, frames, peaked, cfg, dcfg)
    ref_heads = mobilenet_v1.forward(params, normalize(frames, cfg.compute_dtype), cfg)
    assert all(torch.equal(heads[k], ref_heads[k]) for k in ref_heads)
    ref = decode_batch(*peaked, 16, dcfg)
    assert all(torch.equal(a, b) for a, b in zip(poses, ref))
    assert bool(((poses.pose_scores > 0).sum(1) >= 1).all())
    own = decode_batch(heads['heatmap'], heads['offset'], heads['displacement_fwd'],
                       heads['displacement_bwd'], 16, dcfg)
    assert all(torch.equal(a, b) for a, b in zip(infer(params, frames, cfg, dcfg), own))


def test_peaked_heads_need_eleven_cells():
    heads = bench_torch.peaked_heads(2, (11, 13), 7, CPU)
    assert [tuple(t.shape) for t in heads] == [(2, 11, 13, c) for c in (17, 34, 32, 32)]
    square = bench_torch.peaked_heads(2, 13, 7, CPU)
    assert all(torch.equal(a, b) for a, b in zip(square, bench_torch.peaked_heads(2, (13, 13),
                                                                                  7, CPU)))
    with pytest.raises(ValueError, match='11x11'):
        bench_torch.peaked_heads(2, 9, 7, CPU)


@pytest.mark.parametrize('args,keys', [
    (('1: m50 s16 single 513x513', 50, 16, 65, 65, 1, 2), LATENCY_KEYS),
    (('2: m101 s16 batch16 513x513', 50, 16, 65, 65, 2, 2), THROUGHPUT_KEYS),
    (('3: m101 s8 720p high-accuracy', 50, 8, 33, 65, 2, 1), THROUGHPUT_KEYS),
    (('4: 720p streaming latency', 50, 16, 33, 65, 1, 2), LATENCY_KEYS),
])
def test_suite_inference_configs_on_the_cpu(args, keys, capsys):
    """Configs 1-4 at a tiny size: the JAX suite's keys, minus the tunnel
    RTT, plus the device; no device time on the CPU."""
    latency = keys is LATENCY_KEYS
    line = suite.run_inference_config(*args, CPU, latency_mode=latency)
    assert _last_json(capsys.readouterr().out) == line
    assert set(line) == keys | set(CPU_KEYS)
    assert {k: line[k] for k in CPU_KEYS} == CPU_KEYS
    if latency:
        assert line['p50_device_ms'] is None and line['p50_ms'] > 0
    else:
        assert line['img_per_s'] > 0


def test_suite_decode_config_on_the_cpu(capsys):
    """Config 6 through the CLI at its own 136x241 grid."""
    lines = suite.main(['--device', 'cpu', '--configs', '6', '--iters', '1'])
    line = _last_json(capsys.readouterr().out)
    assert lines == [line] and line['grid'] == '136x241' and line['batch'] == 4
    assert set(line) == DECODE_KEYS | set(CPU_KEYS)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_suite_train_configs_on_the_cpu(dtype, capsys):
    """Configs 5 and 7 at m50 65x65 in this process (world size 1)."""
    line = suite.run_train_config(1, CPU, dtype=dtype, model_id=50, size=65)
    assert _last_json(capsys.readouterr().out) == line
    assert set(line) == TRAIN_KEYS | set(CPU_KEYS)
    assert line['devices'] == 1 and line['global_batch'] == 2
    assert line['config'].startswith('5:' if dtype == torch.float32 else '7:')
    assert np.isfinite(line['loss'])


def test_suite_train_config_over_two_ranks(capfd):
    """`--num_devices 2` on the CPU: two gloo ranks, global batch 4, one
    line from rank 0."""
    assert suite.run_train_config(1, CPU, num_devices=2, model_id=50, size=65) is None
    line = _last_json(capfd.readouterr().out)
    assert line['devices'] == 2 and line['global_batch'] == 4 and line['device'] == 'cpu'


def test_profile_finds_no_device_events_on_the_cpu(tmp_path, capsys):
    summary = profile_fused_torch.main(['--device', 'cpu', '--model', '50', '--size', '193',
                                        '--batch', '2', '--iters', '1',
                                        '--trace_dir', str(tmp_path)])
    out = capsys.readouterr().out
    assert 'no device events' in out
    assert summary['busy_ms'] is None and summary['idle_share'] is None
    assert summary['device'] == 'cpu' and summary['device_events'] == 0


def test_profile_summary_of_a_device_trace(tmp_path):
    """The busy union, idle share and split by kind of a trace's device
    events (two overlapping kernels, a copy, and a host op left out)."""
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
    (tmp_path / 'trace.json').write_text(json.dumps({'traceEvents': events}))
    s = profile_fused_torch.summarize(str(tmp_path), wall_ms=10.0, steps=2)
    assert s['busy_ms'] == 2.5 and s['idle_share'] == 0.75 and s['busy_ms_per_step'] == 1.25
    assert s['device_ms_by_kind'] == {'K2 sepconv': 1.0, 'K1 traverse': 1.0, 'copies': 0.5,
                                      'sort / top-k': 0.0, 'elementwise and other': 0.25,
                                      'cuDNN convs': 0.25}


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
    for main, argv in ((bench_torch.main, []), (suite.main, []),
                       (profile_fused_torch.main, ['--trace_dir', str(workdir)]),
                       (verify_spatial_large_torch.main, []),
                       (train_accuracy_delta_torch.main, ['--workdir', str(workdir)])):
        with pytest.raises(RuntimeError, match='CUDA'):
            main(argv)
    assert not os.path.exists(workdir)


def test_decode_sweep_case_that_found_the_sum_order():
    """The sweep's case 18 (a 91x9 grid, 1654 local maxima): pose scores
    were 3 ulp from JAX's while the port's instance score was a
    `torch.sum`; they are within 2 ulp since it adds left to right."""
    assert fuzz_decode_parity_torch.run_case(910_000 + 18 * 17) == ''
