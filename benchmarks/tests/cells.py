"""Tiny versions of the benchmark's cells for tests on the CPU: the cell's
own files and limits, at model 50 and a few small frames."""

from __future__ import annotations

import dataclasses

from benchmarks import harness


def tiny(name: str, compute_dtype: str = 'bfloat16', raw: bool = False) -> harness.Cell:
    """`name` with model 50, 129x129 frames, batches of 2, and every window
    call judged; with `raw`, raw BGR 120x200 frames resized on the device
    to 97x161, the traffic key `resize_to` that a per-frame camera cell
    takes."""
    cell = harness.load_cell(name)
    model = dict(cell.config['model'], model_id=50, compute_dtype=compute_dtype)
    traffic = dict(cell.traffic, batch=2, height=129, width=129, pool_frames=8,
                   warmup_calls=1, trace_calls=2, check_frames=8, reference_block=2)
    if raw:
        traffic.update(height=120, width=200, resize_to=[97, 161])
    return dataclasses.replace(cell, config=dict(cell.config, model=model), traffic=traffic)


def cpus(cell: harness.Cell):
    return ['cpu'] * cell.chips
