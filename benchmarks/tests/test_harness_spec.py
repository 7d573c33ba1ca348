"""BENCHMARK.json and the files it names keep to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from benchmarks import harness

BENCH = json.loads(harness.BENCHMARK_JSON.read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys_and_command():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert 1 <= len(BENCH['command']) <= 32
    assert not any(w.startswith('/') or '..' in w for w in BENCH['command'])
    assert BENCH['paths'] == ['benchmarks']
    assert (harness.HERE.parent / BENCH['command'][1]).is_file()
    assert len(harness.BENCHMARK_JSON.read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = BENCH['run_seconds']
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize('section,keys', [
    ('configs', {'name', 'source', 'file', 'reduced', 'why'}),
    ('workloads', {'name', 'config', 'traffic', 'chips', 'why'}),
    ('end_to_end', {'name', 'unit', 'better', 'bound', 'source'}),
    ('per_layer', {'name', 'unit', 'better', 'source', 'layer', 'moves'}),
])
def test_entries_keys_names_and_units(section, keys):
    entries = BENCH[section]
    names = [e['name'] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert keys <= set(e) <= keys | {'workloads'}, e['name']
        assert NAME.match(e['name']), e['name']
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
        for text in ('why', 'layer', 'source'):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and '\n' not in e[text] and '\t' not in e[text]


def test_every_cell_resolves_to_its_files():
    for name in CELLS:
        cell = harness.load_cell(name)
        assert set(cell.limits) and cell.traffic['pool_frames'] % cell.traffic['batch'] == 0
        for m in cell.per_layer:
            assert callable(harness.reader(m['name']).read), m['name']
    for c in BENCH['configs']:
        assert any(w['config'] == c['name'] for w in BENCH['workloads'])
        assert c['file'] == f"benchmarks/configs/{c['name']}.json"
        assert c['file'].startswith('benchmarks/') and c['reduced'] == []
        assert json.loads((harness.HERE.parent / c['file']).read_text())['name'] == c['name']


def test_metrics_cover_every_cell():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and 'workloads' not in e2e['setup_s']
    assert e2e['setup_s']['bound'] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    for name in CELLS:
        cell = harness.load_cell(name)
        reported = {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in reported and len(reported) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m['moves'] in reported, (name, m['name'])
    for m in BENCH['per_layer']:
        assert m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
        assert set(m.get('workloads', CELLS)) <= set(CELLS)


def test_four_chip_cells_are_few():
    chips = [w['chips'] for w in BENCH['workloads']]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)
