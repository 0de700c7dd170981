"""Fused SIREN value + Jacobian + Laplacian, forward and backward: the CUDA
kernels' wrappers and their plain versions (counterpart of
`tools/experiments/pallas_vgl.py`).

`siren_vgl(params, coords)` returns (u (N, m), J (N, d, m), L (N, m)) of a
sine MLP, as `ops/forward_laplacian.value_grad_laplacian` does. It is a
`torch.autograd.Function`:

* on a CUDA tensor its forward launches the forward kernel and its backward
  the backward kernel (`csrc/siren_vgl.cu`, built at first use);
* on a CPU tensor the forward runs `siren_vgl_reference` and the backward
  `siren_vgl_backward_reference`, the hand-derived reverse sweep in eager
  PyTorch.

There is no fallback: a kernel that fails to build or launch raises. The
function is once-differentiable and must not run under `torch.func`
transforms (`MLP.apply` and `point_fn` stay kernel-free for those).

`siren_vgl.fwd_launches` and `siren_vgl.bwd_launches` count kernel launches
(not CPU calls), so that a run can show that its path went through them.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import cuda_build
from .forward_laplacian import OMEGA_0, value_grad_laplacian
from .siren_forward import check_inputs, pack_params, pairs

MAX_DIM = 3          # csrc/siren_vgl.cu MAX_D: the kernels carry d + 2 channels

Params = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def siren_vgl_reference(params: Params, coords: torch.Tensor):
    """The plain forward: the batched forward-Laplacian chain."""
    return value_grad_laplacian(params, coords)


def siren_vgl_backward_reference(params: Params, coords: torch.Tensor,
                                 gu: torch.Tensor, gJ: torch.Tensor,
                                 gL: torch.Tensor):
    """The plain backward: the hand-derived reverse sweep of
    `pallas_vgl._vgl_bwd_kernel`, recomputing the forward. Cotangents gu
    (N, m), gJ (N, d, m), gL (N, m) give ([(gW, gb), ...], gx (N, d))."""
    omega = OMEGA_0
    w2 = omega * omega
    n, d = coords.shape
    n_layers = len(params)
    h = coords
    J = torch.eye(d, dtype=coords.dtype, device=coords.device).expand(n, d, d)
    L = coords.new_zeros((n, d))
    saved = []
    for i, (w, b) in enumerate(params):
        z = h @ w + b
        Jz = J @ w
        Lz = L @ w
        saved.append((h, J, L, z, Jz, Lz))
        if i < n_layers - 1:
            c = torch.cos(omega * z)
            s = torch.sin(omega * z)
            h = s
            J = omega * c[:, None, :] * Jz
            L = omega * c * Lz - w2 * s * torch.sum(Jz ** 2, dim=1)

    gh, gJ_, gL_ = gu, gJ, gL
    grads = [None] * n_layers
    for i in reversed(range(n_layers)):
        h, J, L, z, Jz, Lz = saved[i]
        if i < n_layers - 1:
            c = torch.cos(omega * z)
            s = torch.sin(omega * z)
            wc = omega * c
            Q = torch.sum(Jz ** 2, dim=1)
            gz = (gh * wc - w2 * s * torch.sum(gJ_ * Jz, dim=1)
                  - gL_ * (w2 * s * Lz + omega * w2 * c * Q))
            gJz = gJ_ * wc[:, None, :] - 2.0 * w2 * (s * gL_)[:, None, :] * Jz
            gLz = gL_ * wc
        else:
            gz, gJz, gLz = gh, gJ_, gL_
        w = params[i][0]
        gw = h.T @ gz + L.T @ gLz + torch.einsum("nak,naj->kj", J, gJz)
        grads[i] = (gw, gz.sum(dim=0))
        gh = gz @ w.T
        gJ_ = gJz @ w.T
        gL_ = gLz @ w.T
    # the starts of J and L are constants: only gh reaches the coords
    return grads, gh


def _check(params: Params, coords: torch.Tensor) -> None:
    check_inputs(params, coords, "siren_vgl")
    if coords.shape[1] > MAX_DIM:
        raise ValueError(f"siren_vgl: input dims up to {MAX_DIM} are "
                         f"supported, got {coords.shape[1]}")


def _library() -> ctypes.CDLL:
    return bind(cuda_build.load("siren_vgl"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a library built from
    `csrc/siren_vgl.cu` (or a copy of it)."""
    if lib.siren_vgl_forward_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        widths = ctypes.POINTER(ctypes.c_int)
        lib.siren_vgl_backward_blocks.argtypes = [i, i, i, widths]
        lib.siren_vgl_forward_f32.argtypes = [p, p, p, p, p, i, i, i, widths,
                                              ctypes.c_float, p]
        lib.siren_vgl_backward_f32.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                               widths, ctypes.c_float, p]
        for fn in (lib.siren_vgl_backward_blocks, lib.siren_vgl_forward_f32,
                   lib.siren_vgl_backward_f32):
            fn.restype = ctypes.c_int
    return lib


def _c_widths(widths: List[int]):
    return (ctypes.c_int * len(widths))(*widths)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_forward(packed: torch.Tensor, widths: List[int],
                   coords: torch.Tensor, u: torch.Tensor, J: torch.Tensor,
                   L: torch.Tensor) -> None:
    """One launch of the forward kernel on the current stream of coords'
    device. Shapes are checked by `siren_vgl`; this only raises on a failed
    launch."""
    lib = _library()
    with torch.cuda.device(coords.device):
        err = lib.siren_vgl_forward_f32(
            coords.data_ptr(), packed.data_ptr(), u.data_ptr(), J.data_ptr(),
            L.data_ptr(), coords.shape[0], widths[0], len(widths) - 1,
            _c_widths(widths), OMEGA_0, _stream(coords.device))
    if err != 0:
        raise RuntimeError(f"siren_vgl forward kernel launch failed with CUDA "
                           f"error {err}")
    siren_vgl.fwd_launches += 1


def backward_scratch(widths: List[int], coords: torch.Tensor) -> torch.Tensor:
    """The weight-gradient partials the backward kernel writes, one row per
    block of its grid."""
    blocks = _library().siren_vgl_backward_blocks(
        coords.shape[0], widths[0], len(widths) - 1, _c_widths(widths))
    if blocks <= 0:
        raise RuntimeError(f"siren_vgl backward: the kernel does not take "
                           f"widths {widths} (CUDA error {-blocks})")
    n_params = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    return torch.empty((blocks, n_params), dtype=torch.float32,
                       device=coords.device)


def launch_backward(packed: torch.Tensor, widths: List[int],
                    coords: torch.Tensor, gu: torch.Tensor, gJ: torch.Tensor,
                    gL: torch.Tensor, scratch: torch.Tensor,
                    gparams: torch.Tensor, gx: torch.Tensor) -> None:
    """One launch of the backward kernel and its fixed-order reduction:
    gparams (packed layout) and gx (N, d)."""
    lib = _library()
    with torch.cuda.device(coords.device):
        err = lib.siren_vgl_backward_f32(
            coords.data_ptr(), packed.data_ptr(), gu.data_ptr(),
            gJ.data_ptr(), gL.data_ptr(), scratch.data_ptr(),
            gparams.data_ptr(), gx.data_ptr(), coords.shape[0], widths[0],
            len(widths) - 1, _c_widths(widths), OMEGA_0,
            _stream(coords.device))
    if err != 0:
        raise RuntimeError(f"siren_vgl backward kernel launch failed with "
                           f"CUDA error {err}")
    siren_vgl.bwd_launches += 1


def _forward(params: Params, coords: torch.Tensor):
    if not coords.is_cuda:
        return siren_vgl_reference(params, coords)
    packed, widths = pack_params(params)
    n, d, m = coords.shape[0], widths[0], widths[-1]
    u = torch.empty((n, m), dtype=torch.float32, device=coords.device)
    J = torch.empty((n, d, m), dtype=torch.float32, device=coords.device)
    L = torch.empty((n, m), dtype=torch.float32, device=coords.device)
    if n > 0:
        launch_forward(packed, widths, coords, u, J, L)
    return u, J, L


def _backward(flat: Sequence[torch.Tensor], coords: torch.Tensor, gu, gJ,
              gL):
    """The gradients of the leaves [W_0, b_0, W_1, ...], and gx."""
    params = pairs(flat)
    if not coords.is_cuda:
        grads, gx = siren_vgl_backward_reference(params, coords, gu, gJ, gL)
        return [t for wb in grads for t in wb], gx
    packed, widths = pack_params(params)
    gparams = torch.zeros_like(packed)
    gx = torch.zeros_like(coords)
    if coords.shape[0] > 0:
        launch_backward(packed, widths, coords, gu, gJ, gL,
                        backward_scratch(widths, coords), gparams, gx)
    grads = torch.split(gparams, [t.numel() for t in flat])
    return [g.view(t.shape) for g, t in zip(grads, flat)], gx


class _SirenVGL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords, *flat):
        ctx.save_for_backward(coords, *flat)
        return _forward(pairs(flat), coords)

    @staticmethod
    @once_differentiable
    def backward(ctx, gu, gJ, gL):
        coords, *flat = ctx.saved_tensors
        gflat, gx = _backward(flat, coords, gu.contiguous(), gJ.contiguous(),
                              gL.contiguous())
        return ((gx if ctx.needs_input_grad[0] else None),
                *(g if need else None
                  for g, need in zip(gflat, ctx.needs_input_grad[1:])))


def siren_vgl(params: Params, coords: torch.Tensor):
    """(u (N, m), J (N, d, m), L (N, m)) of a sine MLP at (N, d) f32 coords,
    d <= 3: the CUDA kernels on a CUDA tensor, the plain versions on a CPU
    tensor."""
    _check(params, coords)
    flat = [t for wb in params for t in wb]
    return _SirenVGL.apply(coords, *flat)


siren_vgl.fwd_launches = 0
siren_vgl.bwd_launches = 0
