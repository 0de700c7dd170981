"""Milliseconds of each traced timestep outside its fits: the program's
`timestep` span less its child `fit` spans
(`insr_pde_tpu_torch.utils.tracing`), averaged over the `timestep` spans
(the log writer, the history shift, the checkpoint). The program-side
counterpart of `step_overhead_ms`. None where the run recorded no
`timestep` span (no trace, or a program without the spans)."""


def read(record: dict):
    try:
        from insr_pde_tpu_torch.utils import tracing
    except ImportError:
        return None
    totals = tracing.snapshot()["totals"]
    if not record.get("trace") or "timestep" not in totals:
        return None
    step = totals["timestep"]
    return 1e-6 * (step["total_ns"] - step["child_ns"]) / step["calls"]
