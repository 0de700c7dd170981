"""The measured window: whole timesteps only.

The window opens at a step boundary and closes at the first step boundary
at or after `seconds`, so a run measures at least `seconds` and at most one
step more; `step_s` is the window's seconds over its whole steps.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple


def run_window(step: Callable[[], object], seconds: float,
               clock: Callable[[], float] = time.perf_counter,
               ) -> Tuple[float, List[float], list]:
    """Run `step()` until `seconds` have passed at a step's end. Returns
    (the window's seconds, each step's seconds, each step's return value).
    `step` ends when its work on the device has ended."""
    opened = last = clock()
    walls, outs = [], []
    while True:
        outs.append(step())
        now = clock()
        walls.append(now - last)
        last = now
        if now - opened >= seconds:
            return now - opened, walls, outs


def step_seconds(window_s: float, n_steps: int) -> float:
    """Seconds per timestep: the whole window over its whole steps."""
    if n_steps < 1:
        raise ValueError("a window holds at least one whole step")
    return window_s / n_steps
