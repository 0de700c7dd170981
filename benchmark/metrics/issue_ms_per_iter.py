"""Host milliseconds per Adam iteration of the traced step outside the
sampler: the self time of the program's `iter` spans
(`insr_pde_tpu_torch.utils.tracing`: the span less its `sample` child),
over their number. What the host spends issuing loss, gradient, Adam and
plateau; where the launch queue is full it waits there too. None where the
run recorded no `timestep` span (no trace, or a program without the
spans)."""


def read(record: dict):
    try:
        from insr_pde_tpu_torch.utils import tracing
    except ImportError:
        return None
    totals = tracing.snapshot()["totals"]
    if not record.get("trace") or "timestep" not in totals \
            or "iter" not in totals:
        return None
    it = totals["iter"]
    return 1e-6 * (it["total_ns"] - it["child_ns"]) / it["calls"]
