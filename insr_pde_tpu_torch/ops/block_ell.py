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
(`TransposeIndex`, with its plan of slot chunks), built once per pattern by
`transpose_index` and kept on the device, and streams `vals_t`, the values
in the transpose order (`transpose_vals`), built once per operator. The
module counters `mv_launches` and `rmv_launches` count products launched
on the card, one per `A x` and one per `A^T r` (an rmv is two device
launches), not CPU calls.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import cuda_build

mv_launches = 0
rmv_launches = 0


# Slots per chunk of the rmv plan: a block column's slot list is cut into
# ceil(n / RMV_CHUNK) even chunks, one warp each.
RMV_CHUNK = 256


class TransposeIndex(NamedTuple):
    """CSR transpose of a block-ELL pattern, and the rmv kernel's plan over
    it (all int32): `order` (nnz,), the flat slots r*S + s sorted stably by
    block id; `offsets` (n_blocks + 1,), where each block's slots begin in
    `order`; `rows` (nnz,), each listed slot's row (order // S);
    `chunk_start` (n_chunks + 1,), where each chunk of at most `RMV_CHUNK`
    consecutive slots of one block begins; `chunk_off` (n_blocks + 1,),
    each block's first chunk."""
    order: torch.Tensor
    offsets: torch.Tensor
    rows: torch.Tensor
    chunk_start: torch.Tensor
    chunk_off: torch.Tensor


def chunk_plan(offsets: torch.Tensor, chunk: int = RMV_CHUNK
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(chunk_start, chunk_off) of the CSR `offsets` (int64 or int32): block
    b's n slots are cut into ceil(n / chunk) chunks of even size (none when
    n = 0); the chunks tile the slots in order."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    offsets = offsets.to(torch.int64)
    counts = offsets[1:] - offsets[:-1]
    n_ch = (counts + chunk - 1) // chunk
    chunk_off = torch.zeros_like(offsets)
    chunk_off[1:] = torch.cumsum(n_ch, 0)
    block = torch.repeat_interleave(
        torch.arange(counts.numel(), device=offsets.device), n_ch)
    k = torch.arange(block.numel(), device=offsets.device) - chunk_off[block]
    start = offsets[block] + k * counts[block] // n_ch[block]
    chunk_start = torch.cat([start, offsets[-1:]])
    return (chunk_start.to(torch.int32).contiguous(),
            chunk_off.to(torch.int32).contiguous())


def transpose_index(cols: torch.Tensor, n_blocks: int,
                    row_slots: Optional[torch.Tensor] = None,
                    chunk: int = RMV_CHUNK) -> TransposeIndex:
    """The CSR transpose of `cols` (R, S) and its chunk plan, on cols'
    device. `row_slots` (R,) optionally gives each row's count of real
    slots: slots s >= row_slots[r] are padding (value 0 by construction)
    and are left out of the index."""
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
    order = slots[perm]
    chunk_start, chunk_off = chunk_plan(offsets, chunk)
    return TransposeIndex(order.to(torch.int32).contiguous(),
                          offsets.to(torch.int32).contiguous(),
                          (order // S).to(torch.int32).contiguous(),
                          chunk_start, chunk_off)


def transpose_vals(vals: torch.Tensor, t_index: TransposeIndex
                   ) -> torch.Tensor:
    """vals_t (nnz, J): the values of the slots in the index's order, the
    rmv kernel's streamed copy (one per operator: vals change with every
    assembly, the index does not)."""
    J = vals.shape[-1]
    return vals.reshape(-1, J)[t_index.order.long()].contiguous()


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


def lanes(J: int) -> tuple[int, int]:
    """mv's (G, F): lanes per row and feature lanes. F is the largest power
    of two <= min(J, 32). A row takes G = F lanes from F = 16 up (two rows
    per warp at J = 16), a whole warp below that (the slots share it)."""
    F = 1
    while F * 2 <= min(J, 32):
        F *= 2
    if F >= 16:
        return F, F
    return 32, F


def rmv_lanes(J: int) -> tuple[int, int]:
    """rmv's (V, F): floats per load (4 when J % 4 == 0, else 1) and vector
    lanes per slot, the largest power of two <= min(J / V, 32); the other
    32 / F lanes of the warp take slots."""
    V = 4 if J % 4 == 0 else 1
    F = 1
    while F * 2 <= min(J // V, 32):
        F *= 2
    return V, F


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
        lib.block_ell_rmv_f32.argtypes = [p] * 7 + [i] * 4 + [p]
        for fn in (lib.block_ell_mv_f32, lib.block_ell_rmv_f32):
            fn.restype = ctypes.c_int
    return lib


def launch_mv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
              out: torch.Tensor) -> None:
    """One launch of the mv kernel into `out` (R,) on the current stream.
    Shapes are checked by `block_ell_mv`; this raises on a failed launch."""
    global mv_launches
    R, S, J = vals.shape
    G, F = lanes(J)
    with torch.cuda.device(vals.device):
        err = _library().block_ell_mv_f32(
            vals.data_ptr(), cols.data_ptr(), x.data_ptr(), out.data_ptr(),
            R, S, J, G, F, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_ell_mv kernel launch failed with CUDA "
                           f"error {err}")
    mv_launches += 1


def launch_rmv(vals_t: torch.Tensor, t_index: TransposeIndex,
               r: torch.Tensor, out: torch.Tensor) -> None:
    """One rmv (two launches) into `out` (n_blocks * J,) on the current
    stream, over the streamed values `vals_t` (nnz, J); raises on a failed
    launch."""
    global rmv_launches
    J = vals_t.shape[-1]
    n_blocks = t_index.offsets.numel() - 1
    n_chunks = t_index.chunk_start.numel() - 1
    _, F = rmv_lanes(J)
    partial = torch.empty(max(n_chunks, 1) * J, dtype=torch.float32,
                          device=vals_t.device)
    with torch.cuda.device(vals_t.device):
        err = _library().block_ell_rmv_f32(
            vals_t.data_ptr(), t_index.rows.data_ptr(),
            t_index.chunk_start.data_ptr(), t_index.chunk_off.data_ptr(),
            r.data_ptr(), partial.data_ptr(), out.data_ptr(), n_chunks,
            n_blocks, J, F, torch.cuda.current_stream().cuda_stream)
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
                  t_index: Optional[TransposeIndex] = None,
                  vals_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A^T r, (n_blocks * J,): the kernel on CUDA tensors (over `t_index`
    and `vals_t`, each built here when not given; a caller that repeats
    products on one operator keeps both), the plain version on CPU
    tensors."""
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
    if vals_t is None:
        vals_t = transpose_vals(vals, t_index)
    if tuple(vals_t.shape) != (t_index.order.numel(), J) \
            or vals_t.dtype != torch.float32 or not vals_t.is_contiguous() \
            or vals_t.device != vals.device:
        raise ValueError(f"block_ell_rmv: vals_t must be a contiguous float32 "
                         f"({t_index.order.numel()}, {J}) tensor on "
                         f"{vals.device}, got {vals_t.dtype} "
                         f"{tuple(vals_t.shape)} on {vals_t.device}")
    out = torch.empty(n_blocks * J, dtype=torch.float32, device=vals.device)
    launch_rmv(vals_t, t_index, r, out)
    return out
