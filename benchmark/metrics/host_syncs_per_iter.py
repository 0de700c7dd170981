"""Host syncs per Adam iteration of the traced step: the syncs that the
program's counter (`insr_pde_tpu_torch.utils.tracing`) counted inside its
`iter` spans, their `sample` spans included, over the number of `iter`
spans. None where the run recorded no `timestep` span (no trace, or a
program without the spans)."""


def read(record: dict):
    try:
        from insr_pde_tpu_torch.utils import tracing
    except ImportError:
        return None
    totals = tracing.snapshot()["totals"]
    if not record.get("trace") or "timestep" not in totals \
            or "iter" not in totals:
        return None
    syncs = totals["iter"]["syncs"] + totals.get("sample", {}).get("syncs", 0)
    return syncs / totals["iter"]["calls"]
