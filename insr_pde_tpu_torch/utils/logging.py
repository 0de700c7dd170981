"""Metrics / observability.

Copied unchanged from `insr_pde_tpu/utils/logging.py` (standard library
only), so the port imports nothing of the JAX package.

Per-timestep metrics writer mirroring the reference's tensorboardX usage (a
fresh writer per timestep named t{NNN}, scalars each iteration, figures at
vis_frequency — reference: base/baseModel.py:64-71,118,122-124). Primary sink
is JSONL (always available, cheap); tensorboard via torch.utils.tensorboard is
attached opportunistically when requested.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_path: str, overwrite: bool = True,
                 write_tb: bool = False):
        self.log_path = log_path
        if os.path.exists(log_path) and overwrite:
            shutil.rmtree(log_path, ignore_errors=True)
        os.makedirs(log_path, exist_ok=True)
        self._f = open(os.path.join(log_path, "scalars.jsonl"), "a", buffering=1)
        self._tb = None
        if write_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_path)
            except Exception:
                self._tb = None

    def add_scalars(self, tag: str, values: Dict[str, float], global_step: int):
        rec = {"tag": tag, "step": global_step, "t": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalars(tag, {k: float(v) for k, v in values.items()},
                                 global_step=global_step)

    def add_scalars_history(self, tag: str, history: Dict[str, "object"],
                            stride: int = 1):
        """Bulk per-iteration scalar dump: one JSONL line per `stride`-th
        iteration, assembled in memory and written with a single file write.
        `history` maps key -> 1D array-like of equal length. The per-call
        `add_scalars` path costs a json.dumps + line-buffered syscall per
        iteration — measured as real host time on this 1-core container when
        a solve logs thousands of iterations per phase."""
        keys = list(history)
        if not keys:
            return
        n = len(history[keys[0]])
        t = time.time()
        lines = []
        for i in range(0, n, max(1, stride)):
            rec = {"tag": tag, "step": i, "t": t}
            rec.update({k: float(history[k][i]) for k in keys})
            lines.append(json.dumps(rec))
        self._f.write("\n".join(lines) + "\n")
        if self._tb is not None:
            for i in range(0, n, max(1, stride)):
                self._tb.add_scalars(
                    tag, {k: float(history[k][i]) for k in keys},
                    global_step=i)

    def add_figure(self, tag: str, fig, global_step: int):
        fig_dir = os.path.join(self.log_path, "figures")
        os.makedirs(fig_dir, exist_ok=True)
        fig.savefig(os.path.join(fig_dir, f"{tag}_{global_step:06d}.png"),
                    dpi=100)
        if self._tb is not None:
            self._tb.add_figure(tag, fig, global_step=global_step)
        import matplotlib.pyplot as plt
        plt.close(fig)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
