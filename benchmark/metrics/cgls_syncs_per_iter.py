"""Host syncs per CGLS iteration of the traced step: the syncs that the
program's counter (`insr_pde_tpu_torch.utils.tracing`) counted inside its
`cgls` spans, their `cgls_chunk` spans included (each chunk's read of the
solver's state), over the traced fits' CGLS iterations. None where the run
recorded no `cgls` span (no trace, or a program without the spans)."""


def read(record: dict):
    try:
        from insr_pde_tpu_torch.utils import tracing
    except ImportError:
        return None
    trace = record.get("trace")
    totals = tracing.snapshot()["totals"]
    if not trace or not trace["iters"] or "cgls" not in totals:
        return None
    syncs = (totals["cgls"]["syncs"]
             + totals.get("cgls_chunk", {}).get("syncs", 0))
    return syncs / trace["iters"]
