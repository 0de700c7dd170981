"""The per-timestep optimization engine (counterpart of
`insr_pde_tpu/models/solver.py`).

One Adam iteration = sample points -> loss -> gradient -> Adam -> plateau LR
scheduler. All of it stays on the device: the early-stop latch, the skip of
a non-finite iteration and the plateau update are `torch.where`s on device
tensors, and the host fetches the per-iteration scalars once per chunk of
`chunk_size` iterations, as one (chunk, K) array. Early stopping keeps the
JAX package's semantics (ReduceLROnPlateau factor 0.1, patience 500,
rel-threshold 1e-4, min_lr 1e-8; stop when lr <= 1.1e-8) by freezing params,
moments and scheduler state, Adam's step count included, once the LR floor
is reached.

Parameters are optimized as ONE flat f32 vector (Adam is elementwise, so the
math equals the per-layer form), with views back into the layer list for the
loss. The Adam here equals `optax.adam(lr)` (b1 0.9, b2 0.999, eps 1e-8);
`torch.optim.Adam` is not used because it advances its step count on
iterations that the latch or the non-finite skip must not count.

Sharded (`group`, `parallel/mesh.py`): each rank draws its own batch
through its own `sample_fn`, and the loss dict and the flat gradient are
averaged over the ranks by ONE `all_reduce` of one packed vector per
iteration (the JAX package's `pmean` under `shard_map`). The finiteness
test, the plateau update and the early-stop latch then read only reduced
values, so every rank takes the same branch and the params, broadcast from
rank 0 at `fit`, stay replicated.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import Group, broadcast, pmean

LossFn = Callable[[Any, Dict[str, torch.Tensor], Any], Dict[str, torch.Tensor]]
# loss_fn(params, points, aux) -> {"main": scalar, ...}; total loss = sum of
# values; the scheduler keys on "main" only. `points` comes from the
# solver's sample_fn() each iteration; `aux` carries frozen state.
SampleFn = Callable[[], Dict[str, torch.Tensor]]


class PlateauState(NamedTuple):
    """State of the ReduceLROnPlateau-equivalent scheduler (device scalars)."""
    best: torch.Tensor      # best 'main' loss seen (f32)
    bad: torch.Tensor       # consecutive non-improving steps (i32)
    scale: torch.Tensor     # multiplicative LR scale (f32), lr_now = lr * scale
    stopped: torch.Tensor   # early-stop latch (bool)


def plateau_init(device=None) -> PlateauState:
    return PlateauState(
        best=torch.tensor(float("inf"), dtype=torch.float32, device=device),
        bad=torch.tensor(0, dtype=torch.int32, device=device),
        scale=torch.tensor(1.0, dtype=torch.float32, device=device),
        stopped=torch.tensor(False, device=device),
    )


def plateau_update(state: PlateauState, loss: torch.Tensor, *,
                   factor: float, patience: int, threshold: float,
                   min_scale: float, stop_scale: float,
                   early_stop: bool) -> PlateauState:
    """One scheduler step on the 'main' loss (torch ReduceLROnPlateau
    semantics: mode=min, threshold_mode=rel, cooldown=0)."""
    improved = loss < state.best * (1.0 - threshold)
    best = torch.where(improved, loss, state.best)
    bad = torch.where(improved, torch.zeros_like(state.bad), state.bad + 1)
    trigger = bad > patience
    scale = torch.where(trigger,
                        torch.clamp(state.scale * factor, min=min_scale),
                        state.scale)
    bad = torch.where(trigger, torch.zeros_like(bad), bad)
    stopped = state.stopped
    if early_stop:
        stopped = stopped | (scale <= stop_scale)
    return PlateauState(best, bad, scale, stopped)


class AdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor     # i32 step count


def adam_init(flat: torch.Tensor) -> AdamState:
    return AdamState(torch.zeros_like(flat), torch.zeros_like(flat),
                     torch.zeros((), dtype=torch.int32, device=flat.device))


def adam_update(grad: torch.Tensor, state: AdamState, lr: float,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> Tuple[torch.Tensor, AdamState]:
    """`optax.adam(lr).update`: returns (updates, new state); the caller
    adds the updates to the params."""
    mu = (1.0 - b1) * grad + b1 * state.mu
    nu = (1.0 - b2) * (grad * grad) + b2 * state.nu
    count = state.count + 1
    t = count.to(torch.float32)
    mu_hat = mu / (1.0 - b1 ** t)
    nu_hat = nu / (1.0 - b2 ** t)
    updates = -lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return updates, AdamState(mu, nu, count)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable:
    """`optax.cosine_decay_schedule`: count -> init_value * ((1 - alpha) *
    (1 + cos(pi * min(count, decay_steps) / decay_steps)) / 2 + alpha), of
    the Adam step count before the update (an int tensor), as a float32
    tensor on the count's device."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(count, max=decay_steps).to(torch.float32)
        cosine = 0.5 * (1.0 + torch.cos(np.pi * t / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


class SolveState(NamedTuple):
    params: torch.Tensor    # flat f32 vector
    opt: AdamState
    plateau: PlateauState


@dataclasses.dataclass
class FitResult:
    params: Any
    history: Dict[str, Any]       # per-iteration loss values (host numpy)
    n_iters: int                  # iterations actually run (before stop latch)
    final_loss: float


def _spec(tree, leaves: list):
    """The structure of a parameter tree (dicts in sorted key order, lists,
    tuples) with each tensor leaf replaced by its shape, appended to
    `leaves` in that order."""
    if isinstance(tree, dict):
        return {k: _spec(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_spec(v, leaves) for v in tree)
    leaves.append(tree)
    return tree.shape


def _fill(spec, it):
    if isinstance(spec, dict):
        return {k: _fill(v, it) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)) and not isinstance(spec, torch.Size):
        return type(spec)(_fill(v, it) for v in spec)
    return next(it)


def ravel(params) -> Tuple[torch.Tensor, Any]:
    """Flatten a parameter tree (a [(W, b), ...] list, or the hash grid's
    {"tables": [...], "head": [...]}) into one new vector, plus its spec."""
    leaves: list = []
    spec = _spec(params, leaves)
    return torch.cat([t.reshape(-1) for t in leaves]), spec


def unravel(flat: torch.Tensor, spec):
    """Views of `flat` in the tree of `spec` (gradients flow to flat)."""
    shapes: List[torch.Size] = []

    def collect(s):
        if isinstance(s, dict):
            for v in s.values():
                collect(v)
        elif isinstance(s, (list, tuple)) and not isinstance(s, torch.Size):
            for v in s:
                collect(v)
        else:
            shapes.append(s)

    collect(spec)
    sizes = [int(np.prod(s)) for s in shapes]
    views = (p.view(s) for p, s in zip(torch.split(flat, sizes), shapes))
    return _fill(spec, views)


def _where(pred, new: NamedTuple, old: NamedTuple):
    return type(old)(*(torch.where(pred, n, o) for n, o in zip(new, old)))


class Solver:
    """Per-phase optimizer: build it once, then `fit()` per timestep."""

    def __init__(self, loss_fn: LossFn, sample_fn: SampleFn, *, lr: float,
                 max_n_iters: int, chunk_size: int = 250,
                 early_stop: bool = True,
                 plateau_factor: float = 0.1, plateau_patience: int = 500,
                 plateau_threshold: float = 1e-4, plateau_min_lr: float = 1e-8,
                 early_stop_min_lr: float = 1.1e-8,
                 debug_nan: bool = False, group: Optional[Group] = None):
        self.loss_fn = loss_fn
        self.group = group
        self.sample_fn = sample_fn
        self.lr = lr
        self.max_n_iters = max_n_iters
        self.chunk_size = min(chunk_size, max_n_iters)
        self.debug_nan = debug_nan
        self._plateau_kw = dict(
            factor=plateau_factor, patience=plateau_patience,
            threshold=plateau_threshold,
            min_scale=plateau_min_lr / lr,
            stop_scale=early_stop_min_lr / lr,
            early_stop=early_stop,
        )

    def value_and_grad(self, flat: torch.Tensor, shapes, points, aux):
        """(loss dict, flat gradient) of the loss at `points`, averaged over
        the group's ranks (each rank passing its own points)."""
        flat = flat.detach().requires_grad_(True)
        ld = self.loss_fn(unravel(flat, shapes), points, aux)
        total = sum(ld.values())
        (grad,) = torch.autograd.grad(total, flat)
        ld = {k: v.detach() for k, v in ld.items()}
        if self.group is not None:
            keys = list(ld)
            packed = pmean(torch.cat([torch.stack([ld[k] for k in keys]),
                                      grad]), self.group)
            ld = dict(zip(keys, packed[:len(keys)]))
            grad = packed[len(keys):]
        return ld, grad

    def _step(self, state: SolveState, shapes, aux):
        """One Adam + scheduler iteration; no host synchronisation (but the
        all_reduce of a sharded solve)."""
        ld, grad = self.value_and_grad(state.params, shapes, self.sample_fn(),
                                       aux)

        updates, opt = adam_update(grad, state.opt, self.lr)
        new_params = state.params + updates * state.plateau.scale

        # a non-finite loss/grad iteration is not written: skip the update
        # and keep optimizing
        finite = torch.isfinite(ld["main"]) & torch.isfinite(grad).all()
        # freeze everything once early-stopped (in-device 'break')
        active = ~state.plateau.stopped
        write = active & finite
        params = torch.where(write, new_params, state.params)
        opt = _where(write, opt, state.opt)
        plateau = plateau_update(state.plateau, ld["main"], **self._plateau_kw)
        plateau = _where(write, plateau, state.plateau)

        out = dict(ld)
        out["_lr"] = self.lr * state.plateau.scale
        out["_active"] = active
        if self.debug_nan:
            out["_nan"] = torch.isnan(grad).any()
        return SolveState(params, opt, plateau), out

    def _run_chunk(self, state, shapes, aux, n):
        outs = []
        for _ in range(n):
            state, out = self._step(state, shapes, aux)
            outs.append(out)
        keys = sorted(outs[0])
        stacked = torch.stack([torch.stack([o[k].to(torch.float32)
                                            for o in outs]) for k in keys],
                              dim=1)
        return state, keys, stacked

    def fit(self, params, aux=None, *, callback=None) -> FitResult:
        """Run the solve loop. callback(it, params, chunk_losses) is invoked
        after each chunk (host side)."""
        flat, shapes = ravel(params)
        # replicated params: every rank starts from rank 0's
        flat = broadcast(flat.detach(), self.group)
        state = SolveState(flat, adam_init(flat), plateau_init(flat.device))
        history: Dict[str, list] = {}
        it = 0
        stopped = False
        while it < self.max_n_iters and not stopped:
            n = min(self.chunk_size, self.max_n_iters - it)
            state, keys, stacked = self._run_chunk(state, shapes, aux, n)
            host = stacked.cpu().numpy()            # one transfer per chunk
            outs = {k: host[:, i] for i, k in enumerate(keys)}
            active = outs.pop("_active") > 0.5
            if self.debug_nan and (outs.pop("_nan") > 0.5).any():
                warnings.warn(f"NaN gradients detected in chunk ending at "
                              f"iteration {it + n}")
            n_active = int(active.sum())
            for k, v in outs.items():
                history.setdefault(k, []).append(v[:n_active])
            it += n
            if callback is not None:
                # report the last *active* loss, not the stale value logged
                # after the freeze latch
                last = max(n_active - 1, 0)
                callback(it, unravel(state.params, shapes),
                         {k: v[last] for k, v in outs.items()})
            if n_active < n:  # early-stopped inside this chunk
                it = it - n + n_active
                stopped = True
        hist = {k: np.concatenate(v) for k, v in history.items()}
        final = float(hist["main"][-1]) if hist.get("main", np.zeros(0)).size else 0.0
        return FitResult(params=unravel(state.params, shapes), history=hist,
                         n_iters=it, final_loss=final)
