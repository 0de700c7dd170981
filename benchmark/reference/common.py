"""Plain PyTorch pieces that the configurations' references share: the
SIREN and its derivative chains, Adam, the uniform samplers, and the
precision switch of the control.

A SIREN here is a list of (W (in, out), b (out,)) float32 tensors with
sin(30 z) between the layers and a linear last layer, initialised from a
`torch.Generator` with W ~ U[-1/n, 1/n] in the first layer, U[-sqrt(6/n)/30,
sqrt(6/n)/30] after it, and b ~ U[-1/sqrt(n), 1/sqrt(n)] (Sitzmann et al.,
2020, and torch.nn.Linear's bias). Every random number comes from
`torch.rand` on the generator, one call per tensor, so that a generator
seeded with the run's seed draws the same numbers as the run did.

Precision: "fp32" is float32 with TF32 off; "tf32" is the control, every
matrix product in TF32 (the card's TF32 path; on the CPU, which has none,
the products' inputs are rounded to TF32's 10-bit mantissa first).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch

OMEGA = 30.0
Params = List[Tuple[torch.Tensor, torch.Tensor]]


# ---- precision ----

def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its float32 mantissa rounded to 10 bits (to nearest, ties to
    even), as a TF32 product reads its inputs; the gradient passes
    through unrounded."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


class Precision:
    """The matrix product `mm(a, b)` of one precision, and `active()`, the
    card's TF32 switch set for it."""

    def __init__(self, mode: str, device: torch.device):
        if mode not in ("fp32", "tf32"):
            raise ValueError(f"precision {mode!r}: fp32 or tf32")
        self.mode = mode
        self.emulate = mode == "tf32" and device.type != "cuda"

    @contextlib.contextmanager
    def active(self):
        """TF32 on (the control on the card) or off, restored after."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.emulate:
            return _round_tf32(a) @ _round_tf32(b)
        return a @ b


def set_fp32() -> None:
    """TF32 off for every matrix product and convolution."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---- the SIREN ----

def widths(d_in: int, hidden: int, n_hidden_layers: int,
           d_out: int) -> List[int]:
    """[d_in, hidden x (n_hidden_layers + 1), d_out]."""
    return [d_in] + [hidden] * (n_hidden_layers + 1) + [d_out]


def init_siren(gen: torch.Generator, w: List[int]) -> Params:
    """Fresh parameters of widths `w`, drawn from `gen` layer by layer
    (W, then b)."""
    params = []
    for i, (fan_in, fan_out) in enumerate(zip(w[:-1], w[1:])):
        bound = 1.0 / fan_in if i == 0 else math.sqrt(6.0 / fan_in) / OMEGA
        u = torch.rand((fan_in, fan_out), generator=gen, device=gen.device,
                       dtype=torch.float32)
        wt = -bound + (bound - -bound) * u
        bb = 1.0 / math.sqrt(fan_in)
        u = torch.rand((fan_out,), generator=gen, device=gen.device,
                       dtype=torch.float32)
        params.append((wt, -bb + (bb - -bb) * u))
    return params


def forward(params: Params, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """u (N, m) at x (N, d)."""
    h = x
    last = len(params) - 1
    for i, (w, b) in enumerate(params):
        z = prec.mm(h, w) + b
        h = z if i == last else torch.sin(OMEGA * z)
    return h


def value_jac(params: Params, x: torch.Tensor, prec: Precision):
    """(u (N, m), J (N, d, m)) with J[:, j, i] = du_i / dx_j, by carrying
    the d tangents through every layer."""
    n, d = x.shape
    h, t = x, None
    last = len(params) - 1
    for i, (w, b) in enumerate(params):
        z = prec.mm(h, w) + b
        if i == 0:
            tz = w.unsqueeze(0).expand(n, d, w.shape[1])
        else:
            tz = prec.mm(t.reshape(n * d, -1), w).reshape(n, d, w.shape[1])
        if i == last:
            return z, tz
        c = torch.cos(OMEGA * z)
        h = torch.sin(OMEGA * z)
        t = OMEGA * c.unsqueeze(1) * tz
    raise ValueError("a SIREN has at least one layer")


def value_jac_lap(params: Params, x: torch.Tensor, prec: Precision):
    """(u (N, m), J (N, d, m), L (N, m)): value, Jacobian and Laplacian
    sum_j d2u/dx_j2, by carrying tangents and the Laplacian through every
    layer (d2 sin(30 z) = 30 cos(30 z) d2z - 900 sin(30 z) |dz|^2)."""
    n, d = x.shape
    h, t, lap = x, None, None
    last = len(params) - 1
    for i, (w, b) in enumerate(params):
        z = prec.mm(h, w) + b
        if i == 0:
            tz = w.unsqueeze(0).expand(n, d, w.shape[1])
            lz = torch.zeros_like(z)
        else:
            tz = prec.mm(t.reshape(n * d, -1), w).reshape(n, d, w.shape[1])
            lz = prec.mm(lap, w)
        if i == last:
            return z, tz, lz
        c = torch.cos(OMEGA * z)
        s = torch.sin(OMEGA * z)
        h = s
        t = OMEGA * c.unsqueeze(1) * tz
        lap = OMEGA * c * lz - OMEGA * OMEGA * s * torch.sum(tz * tz, dim=1)
    raise ValueError("a SIREN has at least one layer")


def detached(params: Params) -> Params:
    return [(w.detach(), b.detach()) for w, b in params]


def leaves(params: Params) -> List[torch.Tensor]:
    return [t for wb in params for t in wb]


# ---- Adam (Kingma and Ba, 2015: b1 0.9, b2 0.999, eps 1e-8) ----

class Adam:
    """Adam on a list of leaves, bias-corrected, the learning rate constant
    (the plateau scheduler's patience outlasts every fit of these cells)."""

    def __init__(self, params: Params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(t) for t in leaves(params)]
        self.v = [torch.zeros_like(t) for t in leaves(params)]
        self.count = 0

    def step(self, params: Params, grads: List[torch.Tensor]) -> Params:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        out = []
        for i, p in enumerate(leaves(params)):
            g = grads[i]
            self.m[i] = (1.0 - self.b1) * g + self.b1 * self.m[i]
            self.v[i] = (1.0 - self.b2) * g * g + self.b2 * self.v[i]
            upd = self.m[i] / c1 / (torch.sqrt(self.v[i] / c2) + self.eps)
            out.append(p - self.lr * upd)
        return [(out[2 * k], out[2 * k + 1]) for k in range(len(params))]


def fit(params: Params, loss_fn, draw, n_iters: int, lr: float,
        stop=None, reverse: bool = False):
    """Up to `n_iters` Adam iterations from `params`: each draws its points
    with `draw()` and evaluates `loss_fn(params, points)` -> {term: scalar},
    the sum of whose terms is minimised. `stop(done)`, where given, is asked
    after each iteration and ends the fit early where it is true. With
    `reverse` every draw's points are taken in reverse order (the sums then
    round in another order: a witness of rounding). Returns (final params,
    {term: [value at each iteration run, before its update]})."""
    params = [(w.detach().clone(), b.detach().clone()) for w, b in params]
    opt = Adam(params, lr)
    history: Dict[str, List[torch.Tensor]] = {}
    for done in range(1, n_iters + 1):
        pts = draw()
        if reverse:
            pts = {k: v.flip(0) for k, v in pts.items()}
        live = [(w.requires_grad_(True), b.requires_grad_(True))
                for w, b in params]
        terms = loss_fn(live, pts)
        total = sum(terms.values())
        # a leaf the loss does not read (the pressure's last bias) has
        # gradient zero
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(
            torch.autograd.grad(total, leaves(live), allow_unused=True),
            leaves(live))]
        for k, v in terms.items():
            history.setdefault(k, []).append(v.detach())
        params = opt.step(detached(live), [g.detach() for g in grads])
        if stop is not None and stop(done):
            break
    hist = {k: torch.stack(v).double().cpu() for k, v in history.items()}
    return params, hist


def iterations_run(hist: Dict[str, torch.Tensor]) -> int:
    """The number of iterations a history of `fit` holds."""
    return int(next(iter(hist.values())).shape[0])


# ---- uniform samplers ----

def rand(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)


def uniform_box(gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    """n points uniform in [-1, 1]^d."""
    return -1.0 + 2.0 * rand(gen, (n, d))


def cell_centres(resolution: int, d: int, device) -> torch.Tensor:
    """The (resolution^d, d) cell centres of a uniform grid on [-1, 1]^d."""
    c = (torch.arange(resolution, dtype=torch.float64) + 0.5) \
        / resolution * 2.0 - 1.0
    grid = torch.stack(torch.meshgrid(*([c] * d), indexing="ij"), dim=-1)
    return grid.reshape(-1, d).to(torch.float32).to(device)
