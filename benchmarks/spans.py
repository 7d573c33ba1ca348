"""The program's own spans (`posenet_tpu_torch.profiling`) over a run's
traced stretch, for the per-layer readers that read them. The only
module of the program the readers import is `profiling`.

The spans record only under a profiler, so the stretch's spans are those
that began after the window's last read (`harness.Run.calls`): a run
before this one in the same process left its own before that. Each
reader returns None where the stretch holds nothing to read: a program
without spans (no `profiling.records`), or a number of `pipeline.call`
roots other than the traced calls (as when the control, which holds no
span, ran in the program's place).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from posenet_tpu_torch import profiling

CALL = 'pipeline.call'


def traced_calls(run) -> Optional[Dict[int, List]]:
    """The finished spans of each `pipeline.call` of the traced stretch, by
    call id; None where they are not `run.trace_calls` calls."""
    records = getattr(profiling, 'records', None)
    if records is None or not run.trace or not run.calls:
        return None
    after_ns = run.calls[-1].t_done * 1e9
    stretch = [s for s in records() if s.end_ns is not None and s.start_ns >= after_ns]
    calls = {s.call_id: [] for s in stretch if s.parent is None and s.name == CALL}
    if len(calls) != run.trace_calls:
        return None
    for s in stretch:
        if s.call_id in calls:
            calls[s.call_id].append(s)
    return calls


def host_ms(run, name: str) -> Optional[float]:
    """Median over the traced calls of the host ms a call spent in spans
    `name` (0 for a call without one); None where no call has one."""
    calls = traced_calls(run)
    if calls is None or not any(s.name == name for c in calls.values() for s in c):
        return None
    return statistics.median(sum(s.host_ms for s in c if s.name == name)
                             for c in calls.values())


def device_ms_per_image(run, name: str) -> Optional[float]:
    """Device ms between the entry and exit events of the spans `name`,
    summed over the traced calls (and devices), over the traced frames;
    None off the card. An interval on the device's clock: it counts the
    device's waits for the host inside the span as well as its work."""
    calls = traced_calls(run) if run.on_device else None
    if calls is None:
        return None
    times = [s.device_ms for c in calls.values() for s in c if s.name == name]
    if not times or None in times:
        return None
    return sum(times) / run.trace_frames
