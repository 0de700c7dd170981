"""Fused SIREN forward: the CUDA kernel's wrapper, its plain version, and its
gradient (counterpart of `insr_pde_tpu/ops/pallas_siren.py`).

`siren_forward(params, coords)` computes h <- sin(30 (h W_i + b_i)) through
the hidden layers and a linear last layer. On a CUDA tensor it launches the
hand-written kernel of `csrc/siren_forward.cu` (built at first use); on a
CPU tensor it runs `siren_forward_reference`, the plain PyTorch version.
There is no fallback: a kernel that fails to build or launch raises.

The gradient is a `torch.autograd.Function` whose backward recomputes
through the plain version, as the JAX custom VJP recomputes through
`_forward_reference`; there is no backward kernel.

`siren_forward.launches` counts kernel launches (not CPU calls), so that a
run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import cuda_build

OMEGA_0 = 30.0
MAX_WIDTH = 128      # as the TPU kernel's 128 lanes
MAX_LAYERS = 32      # csrc/siren_forward.cu MAX_LAYERS

Params = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def siren_forward_reference(params: Params,
                            coords: torch.Tensor) -> torch.Tensor:
    """The plain version: the same math as `MLP.apply` for the sine
    nonlinearity (full f32 matmuls)."""
    h = coords
    for i, (w, b) in enumerate(params):
        h = h @ w + b
        if i < len(params) - 1:
            h = torch.sin(OMEGA_0 * h)
    return h


def check_inputs(params: Params, coords: torch.Tensor,
                 name: str = "siren_forward") -> None:
    """Raise on what the fused kernels do not take: f32 contiguous (N, d)
    coords, 1..MAX_LAYERS layers of f32 contiguous (W (in, out), b (out,))
    on the same device, every width up to MAX_WIDTH."""
    if not isinstance(coords, torch.Tensor):
        raise TypeError(f"{name}: coords must be a torch.Tensor")
    if coords.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {coords.device}")
    if coords.dtype != torch.float32:
        raise TypeError(f"{name}: coords must be float32, got "
                        f"{coords.dtype}")
    if coords.dim() != 2 or not coords.is_contiguous():
        raise ValueError(f"{name}: coords must be a contiguous (N, d) "
                         f"tensor, got shape {tuple(coords.shape)}")
    if not 1 <= len(params) <= MAX_LAYERS:
        raise ValueError(f"{name}: 1..{MAX_LAYERS} layers supported, "
                         f"got {len(params)}")
    width = coords.shape[1]
    for i, (w, b) in enumerate(params):
        for t in (w, b):
            if t.dtype != torch.float32 or t.device != coords.device:
                raise TypeError(f"{name}: layer {i} params must be "
                                f"float32 on {coords.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: layer {i} params must be "
                                 "contiguous")
        if w.dim() != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(
                f"{name}: layer {i} has W {tuple(w.shape)}, b "
                f"{tuple(b.shape)}; expected W ({width}, out), b (out,)")
        width = w.shape[1]
    widths = [coords.shape[1]] + [w.shape[1] for w, _ in params]
    if max(widths) > MAX_WIDTH:
        raise ValueError(f"{name}: widths up to {MAX_WIDTH} are "
                         f"supported, got {widths}")


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("siren_forward")
    fn = lib.siren_forward_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def pack_params(params: Params) -> Tuple[torch.Tensor, List[int]]:
    """The kernel's parameter buffer [W_0, b_0, W_1, b_1, ...] (W row-major)
    and the layer widths [in, out_0, out_1, ...]."""
    packed = torch.cat([t.reshape(-1) for wb in params for t in wb])
    return packed, [params[0][0].shape[0]] + [w.shape[1] for w, _ in params]


def launch(packed: torch.Tensor, widths: List[int], coords: torch.Tensor,
           out: torch.Tensor) -> None:
    """One launch of the CUDA kernel on the current stream of coords'
    device: out (N, widths[-1]) <- SIREN(coords (N, widths[0])). Shapes are
    checked by `siren_forward`; this only raises on a failed launch."""
    lib = _library()
    c_widths = (ctypes.c_int * len(widths))(*widths)
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream(coords.device).cuda_stream
        err = lib.siren_forward_f32(coords.data_ptr(), packed.data_ptr(),
                                    out.data_ptr(), coords.shape[0],
                                    len(widths) - 1, c_widths, OMEGA_0,
                                    stream)
    if err != 0:
        raise RuntimeError(f"siren_forward kernel launch failed with CUDA "
                           f"error {err}")
    siren_forward.launches += 1


def _launch(params: Params, coords: torch.Tensor) -> torch.Tensor:
    packed, widths = pack_params(params)
    out = torch.empty((coords.shape[0], widths[-1]), dtype=torch.float32,
                      device=coords.device)
    if coords.shape[0] > 0:
        launch(packed, widths, coords, out)
    return out


def _forward(params: Params, coords: torch.Tensor) -> torch.Tensor:
    if coords.is_cuda:
        return _launch(params, coords)
    return siren_forward_reference(params, coords)


def pairs(flat) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


class _SirenForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords, *flat):
        ctx.save_for_backward(coords, *flat)
        return _forward(pairs(flat), coords)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in saved]
            out = siren_forward_reference(pairs(leaves[1:]), leaves[0])
            grads = torch.autograd.grad(out, leaves, grad_out)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def siren_forward(params: Params, coords: torch.Tensor) -> torch.Tensor:
    """Fused SIREN forward (sine hidden layers, linear output) of (N, d)
    f32 coords; the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    check_inputs(params, coords)
    flat = [t for wb in params for t in wb]
    return _SirenForward.apply(coords, *flat)


siren_forward.launches = 0
