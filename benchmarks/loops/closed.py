"""The loop `closed`: batches of the frame pool, in turn, sent `depth`
deep. A call is made while `depth` - 1 earlier ones are unread, then the
oldest is read back to the host. When the window's time is up nothing more
is sent, and every call sent is read and counted: the window ends with the
last read."""

from __future__ import annotations

import collections
import time
from typing import Callable, List

import numpy as np
import torch

from benchmarks.harness import SPANS, Call

# The traffic's keys that this loop reads.
TRAFFIC_KEYS = frozenset({'batch', 'depth'})


def run(call: Callable, read: Callable, pool: np.ndarray, traffic: dict, *,
        seconds: float = 0.0, calls: int = 0, start: int = 0,
        keep: bool = False) -> List[Call]:
    """Sends calls for `seconds`, or `calls` calls, from the pool's
    `start`-th batch (the pool's size is a multiple of the batch), and
    reads them all. `call(frames)` sends host frames, `read(out)` brings a
    call's answer to the host. Returns each call with its host times, and
    its answer where `keep`."""
    batch, depth = traffic['batch'], traffic['depth']
    n_pool = pool.shape[0]
    inflight: collections.deque = collections.deque()
    done: List[Call] = []
    t0 = time.perf_counter()
    i = start
    while True:
        if seconds and time.perf_counter() - t0 >= seconds:
            break
        if calls and i - start >= calls:
            break
        lo = (i * batch) % n_pool
        frames = pool[lo:lo + batch]          # a view: the program stages it
        t_send = time.perf_counter()
        with torch.profiler.record_function(SPANS[0]):
            out = call(frames)
        inflight.append((Call(np.arange(lo, lo + batch), t_send, time.perf_counter()), out))
        i += 1
        if len(inflight) >= depth:
            done.append(_read(read, *inflight.popleft(), keep))
    while inflight:
        done.append(_read(read, *inflight.popleft(), keep))
    return done


def _read(read: Callable, call: Call, out, keep: bool) -> Call:
    with torch.profiler.record_function(SPANS[1]):
        answer = read(out)
    call.t_done = time.perf_counter()
    call.answer = answer if keep else None
    return call
