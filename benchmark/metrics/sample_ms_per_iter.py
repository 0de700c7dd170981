"""Host milliseconds per Adam iteration of the traced step spent in the
program's `sample` spans (`insr_pde_tpu_torch.utils.tracing`: the Solver's
call of its sampler), over the number of `iter` spans; a host sync's wait
for the device shows here. None where the run recorded no `timestep` span
(no trace, or a program without the spans)."""


def read(record: dict):
    try:
        from insr_pde_tpu_torch.utils import tracing
    except ImportError:
        return None
    totals = tracing.snapshot()["totals"]
    if not record.get("trace") or "timestep" not in totals \
            or "iter" not in totals:
        return None
    sample_ns = totals.get("sample", {}).get("total_ns", 0)
    return 1e-6 * sample_ns / totals["iter"]["calls"]
