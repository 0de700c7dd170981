"""Percent of the traced step's Adam iterations issued as one CUDA graph
replay: the program's `replay` spans (`insr_pde_tpu_torch.utils.tracing`,
around `graph.replay()` inside an `iter` span) over its `iter` spans. None
where the run recorded no `timestep` span (no trace, or a program without
the spans) or no `replay` span (a program that issues no graph)."""


def read(record: dict):
    try:
        from insr_pde_tpu_torch.utils import tracing
    except ImportError:
        return None
    totals = tracing.snapshot()["totals"]
    if not record.get("trace") or "timestep" not in totals \
            or "iter" not in totals or "replay" not in totals:
        return None
    return 100.0 * totals["replay"]["calls"] / totals["iter"]["calls"]
