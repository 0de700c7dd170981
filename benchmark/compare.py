"""The comparison that decides `correct`.

The reference (`reference/<config>.py`) draws from its own generator,
seeded with the run's seed, the same random numbers the run drew, in the
same order; it never sees the program's points. It checks:

* the start: the networks' initial weights drawn from the seed against the
  program's (`weights_gap`, the largest absolute difference; exact);
* the handoff: every field a step read (its start and the frozen fields of
  its fits) against what the fits before it produced for that field, in
  every step of the run, the warm-up step and the window's
  (`handoff_gap`, the largest absolute difference; exact);
* the t = 0 fit, run by the reference from its own initial weights;
* the fits of the window's compared steps (`compared_steps`): each from
  the parameters the program's fit started from and the frozen fields it
  read, which are the program's own state, since a fit of 100 or more Adam
  iterations on fresh points can only be followed from where the program
  stood; the handoff ties that state to the fits before it. Between
  compared fits the reference draws and drops the points of the fits it
  does not run.

For each compared fit, with L the per-iteration sum of the loss terms and
f a field at the check's evaluation points:

* `loss_gap` = max_i |L_program,i - L_reference,i| / max_j |L_reference,0
  - L_reference,j|, i and j over every iteration the reference ran: the
  gap of the loss curves over the most the reference's fit moved its loss.
* `field_gap` = |f_program - f_reference| / |f_reference - f_start|: the
  gap of the fitted fields over the change the reference's fit made
  (a fit that returns its start reads 1).

Where the workload gives `init_iters`, the t = 0 fit is compared by its
first `init_iters` losses alone (lucy: later in that fit, and in its
field, a start one ulp away or its points in another order read up to 4e-4
on a few seeds, where the others read 1e-6).

A fit in contact (elasticity: a point touched the plane) is chaotic some
iterations after contact begins. The reference runs it until
`contact_iters` iterations after the first in which a point touched the
plane: the penalty's energy at its onset and the Adam updates its gradient
drives. The loss gap over those iterations is `contact_loss_gap`; the
field is not compared.

Each number is the largest over the compared fits.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from .reference.common import Precision, iterations_run


def compared_steps(step_ts: List[int], seed: int, n: int,
                   named: Iterable[int] = ()) -> List[int]:
    """The timesteps of the window whose fits are compared: the first; with
    n >= 2 also the last and n - 2 more drawn from the seed among the
    others; and each timestep of `named` that the window ran."""
    if not step_ts:
        return []
    ends = {step_ts[0]} | ({step_ts[-1]} if n >= 2 else set())
    rest = step_ts[1:-1]
    picked = random.Random(seed).sample(rest, min(max(n - 2, 0), len(rest)))
    return sorted(ends | set(picked) | (set(named) & set(step_ts)))


def _total(history: Dict[str, np.ndarray]) -> np.ndarray:
    return sum(np.asarray(v, np.float64) for v in history.values())


def loss_gap(program: Dict[str, np.ndarray],
             reference: Dict[str, torch.Tensor],
             first: Optional[int] = None) -> float:
    """The loss curves' gap over the first `first` of the iterations the
    reference ran (all where None), over the most the reference moved its
    loss in all it ran."""
    lp = _total(program)
    lr = _total({k: v.numpy() for k, v in reference.items()})
    n = min(lr.shape[0], first or lr.shape[0])
    if lp.shape[0] < n:
        return math.inf
    scale = float(np.max(np.abs(lr[0] - lr)))
    gap = float(np.max(np.abs(lp[:n] - lr[:n])))
    if not math.isfinite(gap):
        return math.inf
    return gap / scale if scale > 0.0 else (0.0 if gap == 0.0 else math.inf)


def field_gap(ref, program_params, reference_params, start_params) -> float:
    judge = Precision("fp32", ref.device)
    fp = ref.field(program_params, judge).double()
    fr = ref.field(reference_params, judge).double()
    fs = ref.field(start_params, judge).double()
    gap = float(torch.linalg.norm(fp - fr))
    moved = float(torch.linalg.norm(fr - fs))
    if not math.isfinite(gap):
        return math.inf
    return gap / moved if moved > 0.0 else (0.0 if gap == 0.0 else math.inf)


def params_gap(a: list, b: list) -> float:
    """The largest absolute difference between two networks' parameters;
    inf where their shapes differ or a difference is not finite."""
    if len(a) != len(b):
        return math.inf
    worst = 0.0
    for (wa, ba), (wb, bb) in zip(a, b):
        for x, y in ((wa, wb), (ba, bb)):
            if x.shape != y.shape:
                return math.inf
            d = float((x - y.to(x.device)).abs().max())
            if not math.isfinite(d):
                return math.inf
            worst = max(worst, d)
    return worst


def weights_gap(reference: Dict[str, list], program: Dict[str, list]) -> float:
    return max(params_gap(p, program[name]) for name, p in reference.items())


def handoff_gap(fits: List[dict], log=print) -> float:
    """The largest gap between a field a step read and what the fits
    before it produced for that field, over every fit's `handoff`."""
    worst = 0.0
    for f in fits:
        for name, read, produced in f.get("handoff", ()):
            gap = params_gap(read, produced)
            if gap != 0.0:
                log(f"[check] t={f['t']} {f['tag']}: {name} read "
                    f"{gap!r} away from what the fits before produced")
            worst = max(worst, gap)
    return worst


def check(ref, initial_fields: Dict[str, list], fits: List[dict],
          compare_t: List[int], modes=("program",), log=print,
          curves: Optional[list] = None,
          contact_iters: Optional[int] = None,
          init_iters: Optional[int] = None) -> Dict[str, Dict[str, float]]:
    """The compared numbers of a run. `fits` are the run's fits in the
    order they ran; those of t = 0 and of the timesteps `compare_t` are
    compared. `modes` names what plays the program: "program" (the run's
    own fits), "control" (the reference in TF32 in the program's place),
    "half_batch" (the reference with half its interior points left out, a
    planted fault), "ulp" (the reference from a start one float32 ulp
    away) or "order" (the reference with each draw's points in reverse
    order), the last two witnesses of how far rounding alone carries a fit;
    each gets its own numbers. `curves`, where given, gains each compared
    fit's per-iteration loss sums of both sides."""
    fp32 = Precision("fp32", ref.device)
    w0 = ref.initial_weights()
    out = {m: {"weights_gap": 0.0, "handoff_gap": 0.0, "loss_gap": 0.0,
               "field_gap": 0.0} for m in modes}
    if "program" in modes:
        out["program"]["weights_gap"] = weights_gap(w0, initial_fields)
        out["program"]["handoff_gap"] = handoff_gap(fits, log)
    # the t = 0 fit trains the first network of `initial_weights`
    trained = next(iter(w0.values()))
    for f in fits:
        compared = f["t"] == 0 or f["t"] in compare_t
        if not compared:
            ref.skip(f["tag"], f["n_iters"])
            continue
        start = trained if f["t"] == 0 else f["start"]
        state = ref.gen.get_state()
        params, hist, free = ref.fit(f["tag"], start, f["aux"], f["n_iters"],
                                     fp32, contact_iters=contact_iters)
        end = ref.gen.get_state()
        n_run = iterations_run(hist)
        for m in modes:
            if m == "program":
                got, got_hist = f["result"], f["history"]
            else:
                ref.gen.set_state(state)
                prec = Precision("tf32" if m == "control" else "fp32",
                                 ref.device)
                begin = start
                if m == "ulp":
                    begin = [(w * (1.0 + 2.0 ** -23), b * (1.0 + 2.0 ** -23))
                             for w, b in start]
                got, h, _ = ref.fit(f["tag"], begin, f["aux"], f["n_iters"],
                                    prec, half_batch=(m == "half_batch"),
                                    run=n_run, reverse=(m == "order"))
                got_hist = {k: v.numpy() for k, v in h.items()}
                ref.gen.set_state(end)
            first = init_iters if f["t"] == 0 else None
            lg = loss_gap(got_hist, hist, first)
            if curves is not None:
                curves.append({"mode": m, "t": f["t"], "tag": f["tag"],
                               "got": _total(got_hist).tolist(),
                               "reference": _total({k: v.numpy() for k, v
                                                    in hist.items()}).tolist()})
            key = "loss_gap" if free else "contact_loss_gap"
            out[m][key] = max(out[m].get(key, 0.0), lg)
            if free and (f["t"] != 0 or init_iters is None):
                fg = field_gap(ref, got, params, start)
                out[m]["field_gap"] = max(out[m]["field_gap"], fg)
                log(f"[check] {m} t={f['t']} {f['tag']}: loss_gap {lg!r} "
                    f"field_gap {fg!r}")
            elif free:
                log(f"[check] {m} t={f['t']} {f['tag']}: loss_gap {lg!r} "
                    f"over its first {init_iters} iterations")
            else:
                log(f"[check] {m} t={f['t']} {f['tag']}: in contact, "
                    f"contact_loss_gap {lg!r} over {n_run} iterations")
    return out


def verdict(numbers: Dict[str, float],
            limits: Dict[str, float]) -> Optional[bool]:
    """True where every limit's number is there, finite and at most its
    limit."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= limits[k] for k in limits)
