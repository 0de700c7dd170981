"""Host milliseconds of each traced Picard iteration's assembly: the
program's `assemble` spans (`insr_pde_tpu_torch.utils.tracing`, around
`VortexModel.assemble` and a fetch of one value, so the device's work is
in it) over its `picard` spans. None where the run recorded no `picard`
span (no trace, or a program without the spans)."""


def read(record: dict):
    try:
        from insr_pde_tpu_torch.utils import tracing
    except ImportError:
        return None
    totals = tracing.snapshot()["totals"]
    if not record.get("trace") or "picard" not in totals \
            or "assemble" not in totals:
        return None
    return 1e-6 * totals["assemble"]["total_ns"] / totals["picard"]["calls"]
