"""Row-order coherence of the block-ELL CGLS product pair (counterpart of
`tools/coherence_probe.py`).

    python -m insr_pde_tpu_torch.coherence_probe [--seed 7] [--reps 3]
        [--device cuda]

A least-squares system is invariant under a row permutation, so its rows
may be ordered for the gathers of `A x` and the pulls of `Aᵀ r`. This probe
measures what the order could recover, on synthetic operators of the
default vortex system's shape at 8 times its rows (the JAX tool's scale):
R = 8 x 35,600 = 284,800 rows x S = 48 slots x J = 16, over 12,000 block
columns (vals 875 MB f32, and as much again in `vals_t`):

  random     iid block columns (the assembly's sampling order is ~random)
  sorted0    the same columns, rows sorted by their first column
  clustered  consecutive rows share one window of 8 neighbouring columns
             (a best case)

The values, x and the random columns come from a torch generator seeded
with `--seed` on the device. The pair is timed on the port's `BlockSparse`,
that is the block-ELL kernels (`csrc/block_ell.cu`), as the chain
s <- s + eps Aᵀ(A s): `(t(k = 9) - t(k = 1)) / 8` of k-long chains, each
call ended by a host read of sum(s) and `torch.cuda.synchronize()`, eps
varied per call. Each layout builds its own transpose index and `vals_t`
first, timed apart (`transpose_build_s`) and outside the timed window. No
`torch.compile`, no CUDA graph. `--device cpu` is for the tests.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .bench import _sync, device_record, summarize

R0, S, J, NB = 35600, 48, 16, 12000
SCALE = 8
LAYOUTS = ("random", "sorted0", "clustered")


def operands(scale: int, seed: int, device: torch.device, rows0=None,
             slots=None, bdim=None, n_blocks=None):
    """(vals (R, S, J), x (NB J,), {layout: cols (R, S) int32}); the shape
    defaults to R0, S, J, NB."""
    rows0 = R0 if rows0 is None else rows0
    slots = S if slots is None else slots
    bdim = J if bdim is None else bdim
    n_blocks = NB if n_blocks is None else n_blocks
    R = scale * rows0
    gen = torch.Generator(device=device).manual_seed(seed)
    vals = torch.randn((R, slots, bdim), generator=gen, device=device)
    x = torch.randn((n_blocks * bdim,), generator=gen, device=device)
    cols = torch.randint(0, n_blocks, (R, slots), generator=gen,
                         device=device, dtype=torch.int32)
    order = torch.argsort(cols[:, 0], stable=True)
    base = (torch.arange(R, device=device, dtype=torch.int64)
            * n_blocks // R)[:, None]
    offs = (torch.arange(slots, device=device) % 8)[None, :]
    clustered = ((base + offs) % n_blocks).to(torch.int32)
    return vals, x, {"random": cols, "sorted0": cols[order].contiguous(),
                     "clustered": clustered.contiguous()}


def chain(A, x: torch.Tensor, eps: float, k: int) -> float:
    """sum(s) after k steps of s <- s + eps Aᵀ(A s) from s = x."""
    s = x
    for _ in range(k):
        s = s + eps * A.rmv(A.mv(s))
    return float(s.sum())


def pair_ms(A, x: torch.Tensor, reps: int, device: torch.device) -> dict:
    """The pair's ms from `reps` timed chains of k = 1 and k = 9 after one
    untimed each: median and min."""
    def timed(k, r):
        _sync(device)
        tic = time.perf_counter()
        chain(A, x, 1e-30 * (r + 2) * (10.0 if k == 9 else 1.0), k)
        _sync(device)
        return time.perf_counter() - tic

    for k in (1, 9):
        timed(k, -1)
    t1 = [timed(1, r) for r in range(reps)]
    t9 = [timed(9, r) for r in range(reps)]
    s1, s9 = summarize(t1), summarize(t9)
    return {"pair_scanned_ms": max(s9["median"] - s1["median"], 0.0) / 8 * 1e3,
            "pair_ms_min": max(s9["min"] - s1["min"], 0.0) / 8 * 1e3,
            "n": reps}


def build(vals, cols, device: torch.device, n_blocks=None):
    """(the layout's BlockSparse over n_blocks (NB) block columns, with its
    transpose index and vals_t built; seconds the build took)."""
    from .ops.linalg import BlockSparse
    A = BlockSparse(vals, cols, NB if n_blocks is None else n_blocks)
    _sync(device)
    tic = time.perf_counter()
    A.transpose()
    if vals.is_cuda:
        A.transposed_vals()
    _sync(device)
    return A, time.perf_counter() - tic


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("coherence_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def main(argv=None) -> list:
    """Runs the probe; returns the printed records."""
    args = parser().parse_args(argv)
    from .ops import block_ell
    from .ops.precision import resolve_device, set_full_precision
    device = resolve_device(args.device)
    set_full_precision()
    info = device_record(device)
    vals, x, layouts = operands(SCALE, args.seed, device)
    records = []
    for label in LAYOUTS:
        A, build_s = build(vals, layouts[label], device)
        mv0, rmv0 = block_ell.mv_launches, block_ell.rmv_launches
        rec = {"probe": "coherence", "layout": label,
               "rows": vals.shape[0], **pair_ms(A, x, args.reps, device),
               "transpose_build_s": build_s,
               "mv_launches": block_ell.mv_launches - mv0,
               "rmv_launches": block_ell.rmv_launches - rmv0,
               "device": info}
        del A
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
