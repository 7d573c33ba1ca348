"""Shared arithmetic of the per-layer metric readers (`metrics/*.py`),
over a run's host clocks (`harness.Run.calls`) and its traced stretch
(`harness.Run.trace`, `yardstick.summarize_trace`). Each returns None where
the run holds nothing to read."""

from __future__ import annotations

import statistics
from typing import Optional

from benchmarks import yardstick


def dispatch_ms(run) -> float:
    """Median host ms from a call's start to its return: staging and launches."""
    return statistics.median((c.t_return - c.t_send) * 1e3 for c in run.calls)


def device_ms_per_image(run, kind: str) -> Optional[float]:
    """Device ms an image spent in kernels of `kind` (`yardstick.KINDS`),
    over the traced stretch, summed over the devices."""
    if not run.trace or not run.trace['device_events']:
        return None
    return run.trace['by_kind_s'].get(kind, 0.0) * 1e3 / run.trace_frames


def idle_share(run) -> Optional[float]:
    """% of the traced stretch in which the device ran nothing, averaged
    over the devices."""
    if not run.trace or not run.trace['busy_s']:
        return None
    busy = sum(run.trace['busy_s'].values()) / run.cell.chips
    return 100.0 * (1.0 - busy / run.trace['window_s'])


def model_hw(run):
    """The (height, width) the model runs at."""
    t = run.cell.traffic
    return tuple(t['resize_to']) if t.get('resize_to') else (t['height'], t['width'])


def k2_roofline(run) -> Optional[float]:
    """% of K2's device time that its roofline bound accounts for: the sum
    of `yardstick.k2_bound_ms` over the K2 calls the traced stretch made
    (every stride-1 separable layer, dilated or not, at its shape and the
    shard's batch), over K2's device ms."""
    if not run.trace or not run.trace['device_events']:
        return None
    k2_ms = run.trace['by_kind_s'].get('K2 sepconv', 0.0) * 1e3
    m, chips = run.cell.config['model'], run.cell.chips
    if m.get('compute_dtype') != 'bfloat16' or m.get('quantized') or k2_ms <= 0.0:
        return None
    shard = run.cell.traffic['batch'] // chips
    bound = sum(yardstick.k2_bound_ms(shard, *layer) for layer in yardstick.k2_layers(
        m['model_id'], m['output_stride'], *model_hw(run)))
    return 100.0 * bound * run.trace_calls * chips / k2_ms


def mfu(run) -> Optional[float]:
    """% of the chips' bf16 tensor-core peak that the window's forward
    passes reach: operations counted from the shapes, times images a
    second, over the peak of every chip the cell uses."""
    if not run.on_device:
        return None
    m = run.cell.config['model']
    flops = yardstick.forward_flops(m['model_id'], m['output_stride'], *model_hw(run))
    rate = run.frames_done / run.window_s
    return 100.0 * flops * rate / (yardstick.BF16_TENSOR_FLOPS * run.cell.chips)
