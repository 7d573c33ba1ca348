"""Decides `correct`: which of the window's answers are judged, drawn from
the seed, and the verdict on the numbers that the cell's reference
(`references/<reference>`, its `judge`) compares with their limits.
Imports nothing of the program."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def sample_calls(n_done: int, batch: int, frames: int, seed: int) -> List[int]:
    """Which of the window's completed calls to judge: enough calls for
    `frames` frames, drawn from the seed without repeats."""
    want = min(n_done, -(-frames // batch))
    rng = np.random.default_rng([seed, 0x5eed])
    return sorted(rng.choice(n_done, size=want, replace=False).tolist())


def verdict(gaps: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number compared is within its limit, and every
    number has a limit."""
    return set(gaps) == set(limits) and all(gaps[name] <= limits[name] for name in limits)
