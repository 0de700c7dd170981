"""A kernel's share of its roofline in the traced step: the least time the
chip could take for the work counted from shapes (the larger of FLOPs over
the FP32 peak and bytes over the HBM bandwidth) over the traced time of
the kernel's device operations."""

from __future__ import annotations

from typing import Optional


def roofline(record: dict, kernel: str) -> Optional[float]:
    trace = record.get("trace")
    work = record["kernel_work"].get(kernel)
    if not trace or not work:
        return None
    iters = trace["iters_by_tag"].get(work["phase"], 0)
    seconds = sum(v["seconds"] for name, v in trace["by_name"].items()
                  if any(k in name for k in work["names"]))
    if not iters or seconds <= 0.0:
        return None
    peaks = record["peaks"]
    least = iters * max(work["flops"] / peaks["fp32_flops"],
                        work["bytes"] / peaks["hbm_bytes_per_s"])
    return 100.0 * least / seconds
