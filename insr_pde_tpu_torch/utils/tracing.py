"""Program spans and a host-sync counter, recorded only under
`torch.profiler`.

`span(name)` is a context manager around a piece of the program's work. It
records only while a `torch.profiler` session is active (the benchmark's
traced step, a `--profile_dir` run); otherwise it costs one attribute read
and returns a shared no-op context. A recorded span keeps its name, its
parent (the index of the enclosing span's record), its start and end in
`time.time_ns()` and the host syncs made while it was the innermost open
span. `time.time_ns()` is the clock of the profiler's events
(`start_ns()` of `kineto_results.events()`, the timestamps of
`trace.json`), so spans lie on the device trace's timeline without being
events of it: a span emits no `record_function` range, NVTX range or any
other profiler event, and adds nothing to the device trace.

The store is in memory: per name the calls, total ns, ns covered by child
spans and syncs (`snapshot()["totals"]`; self time is total less child),
and the raw records up to `MAX_RECORDS` (`snapshot()["spans"]`, later ones
counted in `dropped`). `reset()` clears both.

Host syncs: while an outermost span is open and CUDA is initialised in the
process (a model on the card), `torch.cuda.set_sync_debug_mode("warn")` is
set. Each "synchronizing CUDA operation" warning the runtime then raises is
counted against the innermost open span and not printed: pageable copies to
and from the host, `.cpu()` and `.item()`, stream and device
synchronisation, `nonzero`, and any other call the runtime flags. Not
counted: the caching allocator's `cudaMalloc`/`cudaFree` and stalls on a
full launch queue, which the runtime does not flag (PyTorch calls the mode
a prototype that does not detect every sync). The previous debug
mode and `warnings.showwarning` are restored, and the warning filter added
is taken out, when the outermost span exits, on an exception too.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_RECORDS = 200_000
_SYNC_MESSAGE = "synchronizing CUDA operation"

_OFF = contextlib.nullcontext()
_stack: List["_Span"] = []
# [name, parent index or None, start_ns, end_ns or None, syncs]
_records: List[list] = []
# name -> [calls, total_ns, child_ns, syncs]
_totals: Dict[str, List[int]] = {}
_dropped = 0
# (the previous showwarning, the filter added, the sync debug mode to
# restore or None) while an outermost span is open
_hooks: Optional[tuple] = None


def span(name: str):
    """A context manager that records `name` while the profiler is on."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def _count_syncs(show):
    """A `warnings.showwarning` that counts sync warnings on the innermost
    open span and passes every other warning on to `show`."""
    def showwarning(message, category, filename, lineno, file=None,
                    line=None):
        if _SYNC_MESSAGE in str(message):
            if _stack:
                _stack[-1].syncs += 1
        else:
            show(message, category, filename, lineno, file, line)
    return showwarning


def _install() -> None:
    global _hooks
    show = warnings.showwarning
    warnings.showwarning = _count_syncs(show)
    warnings.filterwarnings("always", message=".*" + _SYNC_MESSAGE)
    sync_filter = warnings.filters[0]
    mode = None
    if (torch.cuda.is_initialized()
            and hasattr(torch.cuda, "set_sync_debug_mode")):
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            # its notice that it is a prototype, once a process
            warnings.filterwarnings("ignore", message="Synchronization debug")
            torch.cuda.set_sync_debug_mode("warn")
    _hooks = (show, sync_filter, mode)


def _uninstall() -> None:
    global _hooks
    show, sync_filter, mode = _hooks
    _hooks = None
    try:
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
    finally:
        warnings.showwarning = show
        if sync_filter in warnings.filters:
            warnings.filters.remove(sync_filter)


class _Span:
    __slots__ = ("name", "index", "start", "child_ns", "syncs")

    def __init__(self, name: str):
        self.name = name
        self.index = None
        self.child_ns = 0
        self.syncs = 0

    def __enter__(self):
        global _dropped
        if not _stack:
            _install()
        parent = _stack[-1].index if _stack else None
        self.start = time.time_ns()
        if len(_records) < MAX_RECORDS:
            self.index = len(_records)
            _records.append([self.name, parent, self.start, None, 0])
        else:
            _dropped += 1
        _stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack.pop()  # this span: spans nest
        duration = end - self.start
        if self.index is not None:
            record = _records[self.index]
            record[3] = end
            record[4] = self.syncs
        total = _totals.setdefault(self.name, [0, 0, 0, 0])
        total[0] += 1
        total[1] += duration
        total[2] += self.child_ns
        total[3] += self.syncs
        if _stack:
            _stack[-1].child_ns += duration
        else:
            _uninstall()
        return False


def snapshot() -> dict:
    """The store: `totals` per name (calls, total_ns, child_ns, syncs),
    `spans` (name, parent, start_ns, end_ns, syncs; a parent is an index
    into `spans`, end_ns None while open), `dropped` (records past
    `MAX_RECORDS`) and `clock`."""
    return {
        "clock": "time.time_ns",
        "totals": {name: {"calls": c, "total_ns": t, "child_ns": ch,
                          "syncs": s}
                   for name, (c, t, ch, s) in _totals.items()},
        "spans": [{"name": n, "parent": p, "start_ns": s, "end_ns": e,
                   "syncs": k} for n, p, s, e, k in _records],
        "dropped": _dropped,
    }


def reset() -> None:
    """Clears the store. Spans open now are still counted in `totals` when
    they end, without a record."""
    global _dropped
    _records.clear()
    _totals.clear()
    _dropped = 0
    for open_span in _stack:
        open_span.index = None
