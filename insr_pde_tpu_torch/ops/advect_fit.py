"""The 1D advection Adam fit in one launch per chunk: the CUDA kernel's
wrapper and its plain version (counterpart of
`tools/experiments/pallas_trainer.fused_advect_fit`).

One call runs `n` Adam iterations of the advect phase of
`models/advection.py` on a sine SIREN u: R -> R. Iteration i takes the
collocation points x[i] (N,) and boundary points xb[i] (NB,) and computes

    main = mean(((u(x) - u0(x)) / dt + vel (u'(x) + u0'(x)) / 2)^2)
    bc   = mean(u(xb)^2)

with u0 the frozen previous field, then the gradient of main + bc (u0' takes
no gradient), a bias-corrected Adam step scaled by the plateau LR scale, and
ReduceLROnPlateau on `main` with the early-stop latch: the semantics of
`models/solver.Solver._step` (Adam's count advances only on written
iterations; a non-finite `main` or gradient skips the write; the latch
freezes params, moments, count and scheduler state).

The state lives in an `AdvectFitState` of tensors that the call updates in
place: the flat params [W_0, b_0, W_1, b_1, ...] (W as (in, out)), Adam's mu
and nu, `istate` int32 [count, bad, stopped] and `fstate` f32 [best, scale].
The call returns the (n, 4) history [_active, _lr, bc, main] per iteration,
the keys and order of `Solver._run_chunk`; with `debug_nan` it is (n, 5),
[_active, _lr, _nan, bc, main], `_nan` being 1 where the iteration's
gradient holds a NaN (the JAX Solver's `any(isnan(grad))`).

On a CUDA tensor `advect_fit` launches `csrc/advect_fit.cu` (built at first
use); on a CPU tensor it runs `advect_fit_reference`, the plain eager loop
with autograd. There is no fallback: a failed build or launch raises.
`advect_fit.launches` counts kernel launches (not CPU calls).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import torch

from . import cuda_build
from .forward_laplacian import OMEGA_0, value_grad

MAX_LAYERS = 16          # csrc/advect_fit.cu MAX_LAYERS
MAX_HIDDEN = 80          # units per layer: a team of 8 threads, 10 outputs each
ROW_STEP, MAX_ROWS = 8, 64    # rows per block (8 threads per row)
SMEM_LIMIT = 232448      # 227 KB of dynamic shared memory per block


class AdvectFitHyper(NamedTuple):
    dt: float
    vel: float
    lr: float
    min_scale: float          # plateau_min_lr / lr
    stop_scale: float         # early_stop_min_lr / lr
    plateau_factor: float = 0.1
    plateau_patience: int = 500
    plateau_threshold: float = 1e-4
    early_stop: bool = True
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


class AdvectFitState(NamedTuple):
    params: torch.Tensor    # (P,) f32
    mu: torch.Tensor        # (P,) f32
    nu: torch.Tensor        # (P,) f32
    istate: torch.Tensor    # (3,) int32: Adam count, plateau bad, stopped
    fstate: torch.Tensor    # (2,) f32: plateau best, LR scale


def init_state(flat: torch.Tensor) -> AdvectFitState:
    """A fresh fit from flat params (copied): zero moments, count 0, best
    inf, scale 1, not stopped."""
    dev = flat.device
    return AdvectFitState(
        flat.detach().clone(), torch.zeros_like(flat), torch.zeros_like(flat),
        torch.zeros(3, dtype=torch.int32, device=dev),
        torch.tensor([float("inf"), 1.0], dtype=torch.float32, device=dev))


def history_keys(debug_nan: bool = False) -> List[str]:
    """The history's columns, in `Solver._run_chunk`'s (sorted) order."""
    return ["_active", "_lr"] + (["_nan"] if debug_nan else []) + ["bc",
                                                                   "main"]


def n_params(widths: Sequence[int]) -> int:
    return sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))


def smem_bytes(widths: Sequence[int], rows: int) -> int:
    """Dynamic shared memory of one block of `rows` rows (as
    `csrc/advect_fit.cu` smem_bytes): params, prev, mu, nu and the
    gradient partial and loss sums; h, dh, w cos(w z) and dz of every sine
    layer per row; two two-channel ping-pong buffers (the previous net's
    activations, then the cotangents); each row's x and two loss terms. Row
    stride rows + 4."""
    rs = rows + 4
    hidden = max(widths)
    n_sine = len(widths) - 2
    floats = (5 * n_params(widths) + 4 + (4 * n_sine + 4) * hidden * rs
              + 3 * rs)
    return 4 * floats


def plan_rows(widths: Sequence[int], n_rows: int, sms: int) -> int:
    """Rows per block (as `csrc/advect_fit.cu` plan_grid): the n_rows
    points cut into one tile per SM, rounded up to ROW_STEP, within
    ROW_STEP .. MAX_ROWS, less while the buffers do not fit; 0 if they do
    not fit at ROW_STEP."""
    if smem_bytes(widths, ROW_STEP) > SMEM_LIMIT:
        return 0
    rows = -(-(-(-n_rows // sms)) // ROW_STEP) * ROW_STEP
    rows = min(max(rows, ROW_STEP), MAX_ROWS)
    while rows > ROW_STEP and smem_bytes(widths, rows) > SMEM_LIMIT:
        rows -= ROW_STEP
    return rows


def _check(state: AdvectFitState, prev: torch.Tensor, x: torch.Tensor,
           xb: torch.Tensor, widths: List[int]) -> None:
    if len(widths) < 3 or len(widths) - 1 > MAX_LAYERS:
        raise ValueError(f"advect_fit: a SIREN of 2..{MAX_LAYERS} layers "
                         f"(at least one sine layer) is supported, got "
                         f"widths {widths}")
    if widths[0] != 1 or widths[-1] != 1:
        raise ValueError(f"advect_fit: 1 input and 1 output only, got "
                         f"widths {widths}")
    if smem_bytes(widths, ROW_STEP) > SMEM_LIMIT:
        raise ValueError(
            f"advect_fit: widths {widths} do not fit the kernel's "
            f"{SMEM_LIMIT}-byte shared memory even at {ROW_STEP} rows "
            f"per block ({smem_bytes(widths, ROW_STEP)} bytes)")
    if max(widths) > MAX_HIDDEN:
        raise ValueError(f"advect_fit: at most {MAX_HIDDEN} units per layer, "
                         f"got widths {widths}")
    p = n_params(widths)
    dev = state.params.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"advect_fit: unsupported device {dev}")
    expect = [(state.params, (p,), torch.float32, "params"),
              (state.mu, (p,), torch.float32, "mu"),
              (state.nu, (p,), torch.float32, "nu"),
              (state.istate, (3,), torch.int32, "istate"),
              (state.fstate, (2,), torch.float32, "fstate"),
              (prev, (p,), torch.float32, "prev")]
    for t, shape, dtype, name in expect:
        if t.shape != shape or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"advect_fit: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for t, name in ((x, "x"), (xb, "xb")):
        if t.dim() != 2 or t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"advect_fit: {name} must be a contiguous (n, "
                             f"points) float32 tensor on {dev}")
    if x.shape[0] != xb.shape[0] or x.shape[1] < 1 or xb.shape[1] < 1:
        raise ValueError(f"advect_fit: x {tuple(x.shape)} and xb "
                         f"{tuple(xb.shape)} need the same iteration count "
                         "and at least one point each")


def unflatten(flat: torch.Tensor, widths: Sequence[int]):
    """Views of the flat [W_0, b_0, ...] vector as [(W, b), ...]."""
    out, off = [], 0
    for a, b in zip(widths[:-1], widths[1:]):
        out.append((flat[off:off + a * b].view(a, b),
                    flat[off + a * b:off + a * b + b]))
        off += a * b + b
    return out


def _u_and_dudx(params, x: torch.Tensor):
    """u(x) and du/dx of a sine SIREN at (N,) points."""
    u, J = value_grad(params, x[:, None])
    return u[:, 0], J[:, 0, 0]


def advect_fit_reference(state: AdvectFitState, prev: torch.Tensor,
                         x: torch.Tensor, xb: torch.Tensor,
                         widths: Sequence[int], hp: AdvectFitHyper,
                         debug_nan: bool = False) -> torch.Tensor:
    """The plain version: one eager iteration after another, u and du/dx
    through the batched forward chain, the gradient by autograd. Updates
    `state` in place and returns the history (columns `history_keys`)."""
    params, mu, nu = state.params, state.mu, state.nu
    count, bad = state.istate[0], state.istate[1]
    stopped = state.istate[2] != 0
    best, scale = state.fstate[0], state.fstate[1]
    q = unflatten(prev, widths)
    rows = []
    for i in range(x.shape[0]):
        flat = params.detach().requires_grad_(True)
        p = unflatten(flat, widths)
        u, du = _u_and_dudx(p, x[i])
        with torch.no_grad():
            u0, du0 = _u_and_dudx(q, x[i])
        main = torch.mean(((u - u0) / hp.dt + hp.vel * (du + du0) / 2.0) ** 2)
        bc = torch.mean(_u_and_dudx(p, xb[i])[0] ** 2)
        (g,) = torch.autograd.grad(main + bc, flat)
        main, bc = main.detach(), bc.detach()

        mu_n = (1.0 - hp.b1) * g + hp.b1 * mu
        nu_n = (1.0 - hp.b2) * (g * g) + hp.b2 * nu
        count_n = count + 1
        t = count_n.to(torch.float32)
        upd = -hp.lr * ((mu_n / (1.0 - hp.b1 ** t))
                        / (torch.sqrt(nu_n / (1.0 - hp.b2 ** t)) + hp.eps))
        new = params + upd * scale

        improved = main < best * (1.0 - hp.plateau_threshold)
        best_n = torch.where(improved, main, best)
        bad_n = torch.where(improved, torch.zeros_like(bad), bad + 1)
        trigger = bad_n > hp.plateau_patience
        scale_n = torch.where(
            trigger, torch.clamp(scale * hp.plateau_factor, min=hp.min_scale),
            scale)
        bad_n = torch.where(trigger, torch.zeros_like(bad_n), bad_n)
        stopped_n = stopped
        if hp.early_stop:
            stopped_n = stopped | (scale_n <= hp.stop_scale)

        active = ~stopped
        write = active & torch.isfinite(main) & torch.isfinite(g).all()
        nan = [torch.isnan(g).any().to(torch.float32)] if debug_nan else []
        rows.append(torch.stack([active.to(torch.float32), hp.lr * scale,
                                 *nan, bc, main]))
        params = torch.where(write, new, params.detach())
        mu = torch.where(write, mu_n, mu)
        nu = torch.where(write, nu_n, nu)
        count = torch.where(write, count_n, count)
        best = torch.where(write, best_n, best)
        bad = torch.where(write, bad_n, bad)
        scale = torch.where(write, scale_n, scale)
        stopped = torch.where(write, stopped_n, stopped)
    with torch.no_grad():
        state.params.copy_(params)
        state.mu.copy_(mu)
        state.nu.copy_(nu)
        state.istate.copy_(torch.stack([count, bad, stopped.to(torch.int32)]))
        state.fstate.copy_(torch.stack([best, scale]))
    if not rows:
        return x.new_zeros((0, len(history_keys(debug_nan))))
    return torch.stack(rows)


def _library() -> ctypes.CDLL:
    return bind(cuda_build.load("advect_fit"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a library built from
    `csrc/advect_fit.cu` (or a copy of it)."""
    if lib.advect_fit_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        widths = ctypes.POINTER(ctypes.c_int)
        lib.advect_fit_grid.argtypes = [i, i, widths]
        lib.advect_fit_f32.argtypes = [p] * 10 + [i, i, i, i, widths,
                                                  ctypes.POINTER(ctypes.c_float),
                                                  i, i, i, p]
        for fn in (lib.advect_fit_grid, lib.advect_fit_f32):
            fn.restype = ctypes.c_int
    return lib


def _hyper_floats(hp: AdvectFitHyper):
    """The kernel's f32 constants, in the order of csrc/advect_fit.cu's
    FitHyper."""
    vals = [hp.dt, hp.vel, hp.lr, hp.plateau_factor,
            1.0 - hp.plateau_threshold, hp.min_scale, hp.stop_scale, hp.b1,
            1.0 - hp.b1, hp.b2, 1.0 - hp.b2, hp.eps, OMEGA_0]
    return (ctypes.c_float * len(vals))(*vals)


def launch(state: AdvectFitState, prev: torch.Tensor, x: torch.Tensor,
           xb: torch.Tensor, widths: List[int], hp: AdvectFitHyper,
           hist: torch.Tensor) -> None:
    """One cooperative launch of the kernel on the current stream of the
    state's device, into `hist` (n, 4), or (n, 5) with the `_nan` column.
    Shapes are checked by `advect_fit`; this only raises on a refused or
    failed launch."""
    lib = _library()
    c_widths = (ctypes.c_int * len(widths))(*widths)
    n_layers = len(widths) - 1
    n_rows = x.shape[1] + xb.shape[1]
    dev = state.params.device
    with torch.cuda.device(dev):
        grid = lib.advect_fit_grid(n_rows, n_layers, c_widths)
        if grid <= 0:
            raise RuntimeError(f"advect_fit: no co-resident grid for widths "
                               f"{widths} (CUDA error {-grid})")
        partial = torch.empty((2, grid, n_params(widths) + 2),
                              dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.advect_fit_f32(
            state.params.data_ptr(), prev.data_ptr(), state.mu.data_ptr(),
            state.nu.data_ptr(), state.istate.data_ptr(),
            state.fstate.data_ptr(), x.data_ptr(), xb.data_ptr(),
            hist.data_ptr(), partial.data_ptr(), x.shape[0], x.shape[1],
            xb.shape[1], n_layers, c_widths, _hyper_floats(hp),
            int(hp.plateau_patience), int(hp.early_stop),
            int(hist.shape[1] == len(history_keys(True))), stream)
    if err != 0:
        raise RuntimeError(f"advect_fit kernel launch failed with CUDA error "
                           f"{err}")
    advect_fit.launches += 1


def advect_fit(state: AdvectFitState, prev: torch.Tensor, x: torch.Tensor,
               xb: torch.Tensor, widths: Sequence[int],
               hp: AdvectFitHyper, debug_nan: bool = False) -> torch.Tensor:
    """x.shape[0] Adam iterations of the advect phase: the CUDA kernel on
    CUDA tensors (one launch), the plain version on CPU tensors. Updates
    `state` in place; returns the history [_active, _lr, bc, main] per
    iteration, with the `_nan` flag before bc under `debug_nan`."""
    widths = list(widths)
    _check(state, prev, x, xb, widths)
    if not state.params.is_cuda:
        return advect_fit_reference(state, prev, x, xb, widths, hp,
                                    debug_nan)
    hist = torch.empty((x.shape[0], len(history_keys(debug_nan))),
                       dtype=torch.float32, device=x.device)
    if x.shape[0] > 0:
        launch(state, prev, x, xb, widths, hp, hist)
    return hist


advect_fit.launches = 0
