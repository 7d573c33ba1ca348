"""The yardstick's count of K2's work, on the CPU: `k2_layers` holds every
stride-1 separable layer the bf16 trunk runs as K2, dilated or not (the
K2 launches a call that a run prints), and the bound of the dilated ones
is the same bytes and products as at rate 1."""

from __future__ import annotations

import pytest

from benchmarks import yardstick


@pytest.mark.parametrize('output_stride,hw,indices,rates,batch,dilated_ms', [
    (16, (513, 513), [1, 3, 5, 7, 8, 9, 10, 11, 12, 13], [1] * 9 + [2], 128, 0.2956),
    (8, (721, 1281), [1, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13], [1] * 4 + [2] * 6 + [4], 4,
     0.3663),
])
def test_k2_layers_count_the_dilated_layers(output_stride, hw, indices, rates, batch,
                                            dilated_ms):
    """10 layers at m101 s16 (13 at rate 2) and 11 at s8 (7-12 at rate 2,
    13 at rate 4); the dilated layers' bound at the batch of the cells
    that ran them before: s16's layer 13 at b128, s8's 7-13 at b4."""
    shapes = yardstick.layer_shapes(101, output_stride, *hw)
    k2 = yardstick.k2_layers(101, output_stride, *hw)
    assert k2 == [(shapes[i]['h'], shapes[i]['w'], shapes[i]['c_in'], shapes[i]['c_out'])
                  for i in indices]
    assert [shapes[i]['rate'] for i in indices] == rates
    dilated = sum(yardstick.k2_bound_ms(batch, *layer) for layer, rate in zip(k2, rates)
                  if rate > 1)
    assert dilated == pytest.approx(dilated_ms, abs=1e-4)
