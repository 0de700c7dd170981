"""`StreamVortexModel` of the vortex channel scene, built as `python -m
insr_pde_tpu_torch vortex <args>` builds it (`starterL.build_model`): one
timestep is one Picard iteration, `matrix_solver()` at `--picard_iters 1`
(assemble around the coefficients, block-whitened CGLS, warm-started from
them). The model keeps the whitener cache, the warm start and its Picard
count between calls, so the steps are the Picard iterations of one
published call of `--picard_iters N`.

A fit's parameters are the coefficients, as one (coefficients, a
one-element zero) pair, the pair form that the check compares; its
history is the CGLS phi the host read at each chunk's end
(`phi_history`). The configuration's `max_n_iters` is the CGLS iterations
of a solve (`--cgls_maxiter`). The driver gives the model the
`phase_timings` list that the harness reads of the models it drives: one
record per call (timestep: the step, which is the Picard index; tag
"picard"; n_iters: its CGLS iterations; sec: the call's seconds on the
host clock, which end with the solve's fetch of the coefficients).

The whitener is tied to the system it came from: the driver notes the step
whose solve made the model's cached whitener and the coefficients that
step started from (its system was assembled around them). A later step's
`aux` names those coefficients (`whiten_from`), from which the reference
builds that system and its own whitener, and its handoff holds the
whitener the step read beside the one that step made, which must be the
same bits."""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ._base import fit_record


class _Fit(NamedTuple):
    params: list
    n_iters: int
    history: dict


def _pairs(t: torch.Tensor) -> list:
    """A tensor as a list of one (tensor, one-element zero) pair."""
    return [(t.detach().clone(), t.new_zeros(1))]


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int,
                 work_dir: str, device: str):
        from insr_pde_tpu_torch.starterL import build_model, parse_args
        # the configuration's flags without `vortex` (and without the
        # harness's `--max_n_iters=`, which is `--cgls_maxiter` here), the
        # run's seed, device and directories
        flags = [a for a in config["args"][1:]
                 if not a.startswith("--max_n_iters=")]
        self.model = build_model(parse_args(flags + [
            "--cgls_maxiter", str(config["max_n_iters"]), "--seed", str(seed),
            "--device", device,
            "--output_path", os.path.join(work_dir, "results"),
            "--log_dir", os.path.join(work_dir, "log")]))
        self.model.phase_timings = []
        p, pts = self.model.params, self.model.pts
        self.initial_fields = {
            "coefficients": _pairs(p.u),
            "basis": [(p.A.clone(), p.tA.clone()), (p.bias.clone(),
                                                    p.u.new_zeros(1))],
            "points": [(pts.x.clone(), pts.t.clone())]}
        self.inputs = {}
        self.t = 0
        self.produced = None
        # (the whitener the model cached, the coefficients its system was
        # assembled around), once a step has made it
        self.whitener = None

    def _picard(self):
        """One `matrix_solver()` call as a fit record. After the first, the
        coefficients it started from are handed off from the last result."""
        m = self.model
        start = _pairs(m.params.u)
        handoff = ([] if self.produced is None
                   else [("coefficients", start, self.produced)])
        w_read = m._whitener
        tic = time.perf_counter()
        m.matrix_solver()
        sec = time.perf_counter() - tic
        rec = m.picard_timings[-1]
        m.phase_timings.append({"timestep": self.t, "tag": "picard",
                                "n_iters": rec["cgls_iters"], "sec": sec})
        res = _Fit(_pairs(m.params.u), rec["cgls_iters"],
                   {"phi": np.asarray(rec["phi_history"], np.float64)})
        aux = {"t": self.t, "whiten_from": None}
        if w_read is None and m._whitener is not None:
            # a host copy, so that the window's device memory is the
            # program's own
            self.whitener = (m._whitener.cpu(), start)
        elif w_read is not None:
            aux["whiten_from"] = self.whitener[1]
            made = self.whitener[0]
            handoff.append(("whitener", [(w_read, w_read.new_zeros(1))],
                            [(made, made.new_zeros(1))]))
        self.produced = res.params
        return fit_record("picard", self.t, start, aux, res, handoff)

    def initialize(self):
        """Picard 1 (t = 0), around the seed's random coefficients."""
        return [self._picard()]

    def step(self):
        """One Picard iteration."""
        self.t += 1
        return [self._picard()]
