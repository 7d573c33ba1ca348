"""What a run loads, compared by whole top-level module names: no JAX and
no JAX package (`posenet_tpu`; the port's `posenet_tpu_torch` begins with
that name and is not it), and nothing of the program in the reference."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmarks import harness

ROOT = str(harness.HERE.parent)


def _top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys, json\n'
         'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))'],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    loaded = _top_level_after(
        'import torch; torch.set_num_threads(2)\n'
        'from benchmarks import harness, control, run\n'
        'from benchmarks.tests.cells import tiny, cpus\n'
        'cell = tiny("m101-s16.offline-b256")\n'
        'for m in cell.per_layer: harness.reader(m["name"])\n'
        'harness.execute(cell, 5, 0.2, True, cpus(cell))\n'
        'assert harness.forbidden_loaded() == []')
    assert 'posenet_tpu_torch' in loaded
    assert not loaded & {'jax', 'jaxlib', 'flax', 'posenet_tpu'}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_after(
        'from benchmarks import check, yardstick, readers, control\n'
        'from benchmarks.references import posenet\n'
        'from benchmarks.loops import closed')
    assert 'posenet_tpu_torch' not in loaded and 'posenet_tpu' not in loaded


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_loaded(['posenet_tpu_torch.pipeline', 'posenet_tpu_torchx',
                                     'jaxtyping', 'numpy']) == []
    assert harness.forbidden_loaded(['posenet_tpu.models', 'jax._src', 'flax']) == [
        'flax', 'jax', 'posenet_tpu']


def test_the_program_is_not_there_without_the_port(tmp_path):
    (tmp_path / 'BENCHMARK.json').write_text(harness.BENCHMARK_JSON.read_text())
    subprocess.run(['cp', '-r', str(harness.HERE), str(tmp_path / 'benchmarks')], check=True)
    out = subprocess.run([sys.executable, '-c', 'import benchmarks.systems.pipeline'],
                         capture_output=True, text=True, cwd=tmp_path, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != 'PYTHONPATH'})
    assert out.returncode != 0 and 'posenet_tpu_torch' in out.stderr
