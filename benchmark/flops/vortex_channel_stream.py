"""Work of `vortex_channel_stream` from its shapes: FLOPs (2 per
multiply-add) of one CGLS iteration, and the block-ELL kernels' FLOPs and
bytes per CGLS iteration.

The operator: R rows of S = 2K slots of J values (K = neighbor_k sites of
the point's own slice), over n_blocks = 2 x sites block columns. With Nc
collocation and m = boundary / 4 points a strip and T slices, its rows are
momentum 2 (T - 1) Nc (2K real slots: psi and p), walls 2 x 2 (T - 1) m
(value and derivative rows), outlet (T - 1) m, inlet 3 (T - 1) m, initial
4 (Nc + 3m), gauge T (K real slots each). `nnz` counts the real slots,
which the transpose index lists and `A^T r` reads.

A CGLS iteration: one `A x` (2 R S J), one `A^T r` (2 nnz J), the
whitener's product on each side (2 x 2 n_blocks J^2), three row-space and
six column-space vector operations of 2 FLOPs an element (n = n_blocks J).

Bytes as `chip_smoke.py` counts them: mv reads every slot's values and
column ids, x once, and writes its R outputs; rmv reads the listed slots'
values and rows, the offsets, r once and writes n outputs. A Picard solve
of `max_n_iters` iterations in `cgls_chunk` chunks also launches mv and
rmv once at its start and at each of the chunk restarts, and mv once more
for the residual, so the kernels' work per CGLS iteration counts those too:
launches / iterations times the work of one launch.
"""

from __future__ import annotations

import math
from typing import Dict


def shapes(config: dict) -> Dict[str, int]:
    """R, S, J, n_blocks and nnz of the channel system."""
    if config["stream_bc"] != "both" or config["outlet_v"] \
            or config["time_window"] != 1:
        raise ValueError("vortex_channel_stream: counts for stream_bc both, "
                         "no outlet_v, one-slice windows")
    nc, m, T = config["collocation"], config["boundary"] // 4, \
        config["time_num"]
    K, J = config["neighbor_k"], config["n_feat"]
    res = int(round(math.sqrt(config["n_spatial_basis"])))
    momentum = 2 * (T - 1) * nc
    rest = (4 * (T - 1) * m + (T - 1) * m + 3 * (T - 1) * m
            + 4 * (nc + 3 * m) + T)
    return {"R": momentum + rest, "S": 2 * K, "J": J,
            "n_blocks": 2 * res * res * T,
            "nnz": momentum * 2 * K + rest * K}


def _launches(config: dict):
    """(mv, rmv) launches of a Picard solve over its CGLS iterations."""
    iters = config["max_n_iters"]
    chunks = -(-iters // config["cgls_chunk"])
    return (iters + chunks + 1) / iters, (iters + chunks) / iters


def iter_flops(config: dict, workload: dict) -> Dict[str, float]:
    """FLOPs of one CGLS iteration, by the fit's phase tag."""
    s = shapes(config)
    R, S, J, nb = s["R"], s["S"], s["J"], s["n_blocks"]
    n = nb * J
    return {"picard": float(2 * R * S * J + 2 * s["nnz"] * J
                            + 4 * nb * J * J + 6 * R + 12 * n)}


def kernel_work(config: dict, workload: dict) -> Dict[str, dict]:
    """Per kernel: the device operations' names it runs as, the phase whose
    iterations launch it, and its FLOPs and bytes per such iteration."""
    s = shapes(config)
    R, S, J, nb, nnz = s["R"], s["S"], s["J"], s["n_blocks"], s["nnz"]
    per_mv, per_rmv = _launches(config)
    return {
        "block_ell_mv": {
            # the ring kernel at J = 16, the plain one at other shapes
            "names": ["block_ell_mv_kernel", "block_ell_mv_ring_kernel"],
            "phase": "picard",
            "flops": per_mv * 2 * R * S * J,
            "bytes": per_mv * 4 * (R * S * J + R * S + R + nb * J)},
        "block_ell_rmv": {
            "names": ["block_ell_rmv_chunk_kernel",
                      "block_ell_rmv_column_kernel"], "phase": "picard",
            "flops": per_rmv * 2 * nnz * J,
            "bytes": per_rmv * 4 * (nnz * J + nnz + (nb + 1) + R + nb * J)},
    }
