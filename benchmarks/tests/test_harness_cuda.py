"""On the card, at the cell's own size: the program's answers are correct
and the control's (the reference in float8 in the program's place) are
not. Skips without a card; run on one with

    python -m pytest benchmarks/tests/test_harness_cuda.py -q -m cuda
"""

from __future__ import annotations

import pytest
import torch

from benchmarks import check, control, harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return ['cuda:0']


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['m101-s16.offline-b256', 'm101-s8.offline-720p-b32'])
def test_program_correct_and_control_not_at_the_cells_size(card, name):
    cell = harness.load_cell(name)
    line = control.readings(cell, 2 ** 31 + 99, card, with_program=True)
    assert check.verdict(line['program'], cell.limits), line['program']
    assert not check.verdict(line['control'], cell.limits), line['control']
