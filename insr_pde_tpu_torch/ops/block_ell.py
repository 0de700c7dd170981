"""Block-ELL gather-matvec and its transpose: the CUDA kernels' wrappers and
their plain versions (counterpart of `tools/experiments/pallas_spmv.ell_mv`
and of `BlockSparse.mv`/`.rmv` in `insr_pde_tpu/ops/linalg.py`).

    block_ell_mv(vals, cols, x)            out[r] = sum_{s,j} vals[r,s,j] x[cols[r,s]*J + j]
    block_ell_rmv(vals, cols, r, n_blocks) out[b*J + j] = sum_{cols[r,s]=b} vals[r,s,j] r[r]

vals (R, S, J) f32, cols (R, S) int32 block ids, x (n_blocks*J,) f32. With
J = 1 this is the scalar ELL of the TPU kernel `_ell_mv_kernel`.

On CUDA tensors both launch `csrc/block_ell.cu` (built at first use); on CPU
tensors they run the plain versions. There is no fallback: a failed build or
launch raises. `rmv` pulls over a CSR transpose of the sparsity pattern
(`TransposeIndex`), built once per pattern by `transpose_index` and kept on
the device. The module counters `mv_launches` and `rmv_launches` count
kernel launches (not CPU calls).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import cuda_build

mv_launches = 0
rmv_launches = 0


class TransposeIndex(NamedTuple):
    """CSR transpose of a block-ELL pattern: `order` (nnz,) int32, the flat
    slots r*S + s sorted stably by block id; `offsets` (n_blocks + 1,)
    int32, where each block's slots begin in `order`."""
    order: torch.Tensor
    offsets: torch.Tensor


def transpose_index(cols: torch.Tensor, n_blocks: int,
                    row_slots: Optional[torch.Tensor] = None
                    ) -> TransposeIndex:
    """The CSR transpose of `cols` (R, S), on cols' device. `row_slots` (R,)
    optionally gives each row's count of real slots: slots s >= row_slots[r]
    are padding (value 0 by construction) and are left out of the index."""
    R, S = cols.shape
    flat = cols.reshape(-1).to(torch.int64)
    slots = torch.arange(R * S, device=cols.device, dtype=torch.int64)
    if row_slots is not None:
        keep = (slots % S) < torch.repeat_interleave(
            row_slots.to(torch.int64), S)
        flat, slots = flat[keep], slots[keep]
    perm = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=n_blocks)
    offsets = torch.zeros(n_blocks + 1, dtype=torch.int64, device=cols.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return TransposeIndex(slots[perm].to(torch.int32).contiguous(),
                          offsets.to(torch.int32).contiguous())


def block_ell_mv_reference(vals: torch.Tensor, cols: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """The plain version: gather the x blocks, multiply, sum per row."""
    J = vals.shape[-1]
    X = x.reshape(-1, J)
    return (vals * X[cols.long()]).sum((1, 2))


def block_ell_rmv_reference(vals: torch.Tensor, cols: torch.Tensor,
                            r: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The plain version: `index_add_` of vals * r over the block ids."""
    J = vals.shape[-1]
    out = torch.zeros((n_blocks, J), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, cols.reshape(-1).long(),
                   (vals * r[:, None, None]).reshape(-1, J))
    return out.reshape(-1)


def lanes(J: int, rows: bool) -> tuple[int, int]:
    """(G, F): lanes per group and feature lanes. F is the largest power of
    two <= min(J, 32). A row of mv takes G = F lanes from F = 16 up (two
    rows per warp at J = 16), a whole warp below that (the slots share it);
    a block column of rmv always takes a warp."""
    F = 1
    while F * 2 <= min(J, 32):
        F *= 2
    if rows and F >= 16:
        return F, F
    return 32, F


def _check(vals: torch.Tensor, cols: torch.Tensor, vec: torch.Tensor,
           n_vec: int, name: str) -> None:
    dev = vals.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if vals.dtype != torch.float32 or vals.dim() != 3 \
            or not vals.is_contiguous():
        raise ValueError(f"{name}: vals must be a contiguous (R, S, J) "
                         f"float32 tensor, got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if cols.dtype != torch.int32 or tuple(cols.shape) != tuple(vals.shape[:2]) \
            or not cols.is_contiguous() or cols.device != dev:
        raise ValueError(f"{name}: cols must be a contiguous int32 (R, S) = "
                         f"{tuple(vals.shape[:2])} tensor on {dev}, got "
                         f"{cols.dtype} {tuple(cols.shape)} on {cols.device}")
    if vec.dtype != torch.float32 or tuple(vec.shape) != (n_vec,) \
            or not vec.is_contiguous() or vec.device != dev:
        raise ValueError(f"{name}: the vector must be a contiguous float32 "
                         f"({n_vec},) tensor on {dev}, got {vec.dtype} "
                         f"{tuple(vec.shape)} on {vec.device}")


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("block_ell")
    if lib.block_ell_mv_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.block_ell_mv_f32.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.block_ell_rmv_f32.argtypes = [p] * 5 + [i] * 5 + [p]
        for fn in (lib.block_ell_mv_f32, lib.block_ell_rmv_f32):
            fn.restype = ctypes.c_int
    return lib


def launch_mv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
              out: torch.Tensor) -> None:
    """One launch of the mv kernel into `out` (R,) on the current stream.
    Shapes are checked by `block_ell_mv`; this raises on a failed launch."""
    global mv_launches
    R, S, J = vals.shape
    G, F = lanes(J, rows=True)
    with torch.cuda.device(vals.device):
        err = _library().block_ell_mv_f32(
            vals.data_ptr(), cols.data_ptr(), x.data_ptr(), out.data_ptr(),
            R, S, J, G, F, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_ell_mv kernel launch failed with CUDA "
                           f"error {err}")
    mv_launches += 1


def launch_rmv(vals: torch.Tensor, t_index: TransposeIndex, r: torch.Tensor,
               out: torch.Tensor) -> None:
    """One launch of the rmv kernel into `out` (n_blocks * J,) on the
    current stream; raises on a failed launch."""
    global rmv_launches
    R, S, J = vals.shape
    n_blocks = t_index.offsets.numel() - 1
    G, F = lanes(J, rows=False)
    with torch.cuda.device(vals.device):
        err = _library().block_ell_rmv_f32(
            vals.data_ptr(), t_index.order.data_ptr(),
            t_index.offsets.data_ptr(), r.data_ptr(), out.data_ptr(),
            n_blocks, S, J, G, F, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_ell_rmv kernel launch failed with CUDA "
                           f"error {err}")
    rmv_launches += 1


def block_ell_mv(vals: torch.Tensor, cols: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """A x, (R,): the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    R, S, J = vals.shape
    if x.numel() % J:
        raise ValueError(f"block_ell_mv: x has {x.numel()} entries, not a "
                         f"multiple of J = {J}")
    _check(vals, cols, x, x.numel(), "block_ell_mv")
    if not vals.is_cuda:
        return block_ell_mv_reference(vals, cols, x)
    out = torch.empty(R, dtype=torch.float32, device=vals.device)
    launch_mv(vals, cols, x, out)
    return out


def block_ell_rmv(vals: torch.Tensor, cols: torch.Tensor, r: torch.Tensor,
                  n_blocks: int,
                  t_index: Optional[TransposeIndex] = None) -> torch.Tensor:
    """A^T r, (n_blocks * J,): the kernel on CUDA tensors (over `t_index`,
    built here when not given), the plain version on CPU tensors."""
    R, S, J = vals.shape
    _check(vals, cols, r, R, "block_ell_rmv")
    if not vals.is_cuda:
        return block_ell_rmv_reference(vals, cols, r, n_blocks)
    if t_index is None:
        t_index = transpose_index(cols, n_blocks)
    if t_index.offsets.numel() != n_blocks + 1 \
            or t_index.order.device != vals.device:
        raise ValueError(f"block_ell_rmv: the transpose index is for "
                         f"{t_index.offsets.numel() - 1} blocks on "
                         f"{t_index.order.device}, not {n_blocks} on "
                         f"{vals.device}")
    out = torch.empty(n_blocks * J, dtype=torch.float32, device=vals.device)
    launch_rmv(vals, t_index, r, out)
    return out
