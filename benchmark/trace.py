"""Reduction of one `torch.profiler` recording to the numbers the per-layer
metrics read: the device's busy seconds (the union of its operations'
intervals), the traced window, device operations by name, and the idle
gaps between device operations by what the host was doing meanwhile."""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

# a host event spans a gap's midpoint if it starts at most this many events
# before it in start order (host events nest, so the innermost is near)
_LOOKBACK = 400


def _events(prof):
    """(device [(start_ns, end_ns, name)], host [(start_ns, end_ns,
    name)]) of a finished profiler recording."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        rec = (start, start + e.duration_ns(), e.name())
        (dev if e.device_type() == DeviceType.CUDA else host).append(rec)
    return dev, host


def reduce_events(dev: List[Tuple[int, int, str]],
                  host: List[Tuple[int, int, str]],
                  window_ns: int, top: int = 10) -> Dict:
    """The trace summary of device intervals `dev` and host intervals
    `host` (start_ns, end_ns, name) over a window of `window_ns`."""
    dev = sorted(dev)
    by_name: Dict[str, List[float]] = {}
    busy = 0
    gaps = []
    cur_s = cur_e = None
    for s, e, name in dev:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + (e - s) * 1e-9)
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s

    host = sorted(host)
    starts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        k = bisect.bisect_right(starts, mid) - 1
        label = "host idle"
        for j in range(k, max(k - _LOOKBACK, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-9

    def clean(name: str) -> str:
        return "".join(c if c.isalnum() or c in "_.-" else "_"
                       for c in name)[:64]

    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "busy_s": busy * 1e-9,
        "window_s": window_ns * 1e-9,
        "device_ops": sum(n for n, _ in by_name.values()),
        "by_name": {k: {"count": n, "seconds": t}
                    for k, (n, t) in by_name.items()},
        "breakdown": {
            "device_ops": [[clean(k), t] for k, (_, t) in ops[:top]],
            "idle_gaps": [[clean(k), t] for k, t in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]],
        },
    }


def traced(fn, device) -> Tuple[object, Dict]:
    """Run `fn()` under `torch.profiler` (host and device activity), the
    device synchronised before and after; returns (its value, the trace
    summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        out = fn()
        torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
    dev, host = _events(prof)
    return out, reduce_events(dev, host, t1 - t0)
