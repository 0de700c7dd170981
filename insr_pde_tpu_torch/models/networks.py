"""Coordinate networks as plain functions of parameter lists (counterpart of
`insr_pde_tpu/models/networks.py`).

The SIREN MLP keeps the JAX package's architecture, init distributions
(omega_0 = 30, U[±1/n] first layer, U[±sqrt(6/n)/30] elsewhere) and parameter
layout: a list of `(W (in, out), b (out,))` float32 tensors, so parameters
move between the packages without transposes. `apply(params, x)` is a pure
function of the list; the solver re-optimizes the list every timestep.
`HashGridField` is the hash-grid network, `{"tables": [...], "head":
[(W, b), ...]}`, the JAX package's tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Tuple

import torch

from ..ops.siren_forward import siren_forward
from ..ops.siren_forward import takes as siren_forward_takes
from ..ops.siren_vgl import siren_vgl
from ..ops.siren_vgl import takes as siren_vgl_takes

Params = List[Tuple[torch.Tensor, torch.Tensor]]  # [(W (in,out), b (out,)), ...]

OMEGA_0 = 30.0  # SIREN frequency factor


# (kernel, widths) of every card run routed away from a kernel, noted once
_ROUTED = set()


def _note_route(kernel: str, widths: List[int], route: str,
                coords: torch.Tensor) -> None:
    """Print once per kernel and widths that a card run takes `route`, so
    that no such run goes past its kernel silently."""
    if coords.is_cuda and (kernel, tuple(widths)) not in _ROUTED:
        _ROUTED.add((kernel, tuple(widths)))
        print(f"note: {kernel} does not take widths {widths}; {route} runs "
              "on the card instead", flush=True)


def _uniform(generator, shape, lo, hi):
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    return lo + (hi - lo) * u


@dataclass(frozen=True)
class MLP:
    """SIREN-style MLP: Linear+nl, num_hidden_layers x (Linear+nl), Linear."""
    in_features: int
    out_features: int
    num_hidden_layers: int = 3
    hidden_features: int = 64
    nonlinearity: str = "sine"
    outermost_linear: bool = True

    @property
    def layer_dims(self) -> List[Tuple[int, int]]:
        dims = [(self.in_features, self.hidden_features)]
        dims += [(self.hidden_features, self.hidden_features)] * self.num_hidden_layers
        dims += [(self.hidden_features, self.out_features)]
        return dims

    def init(self, generator: torch.Generator) -> Params:
        """Fresh parameters on the generator's device."""
        params = []
        for i, (fan_in, fan_out) in enumerate(self.layer_dims):
            if self.nonlinearity == "sine":
                # first layer U[±1/n], later layers U[±sqrt(6/n)/omega_0]
                bound = 1.0 / fan_in if i == 0 else math.sqrt(6.0 / fan_in) / OMEGA_0
                w = _uniform(generator, (fan_in, fan_out), -bound, bound)
            elif self.nonlinearity in ("relu", "elu"):
                # kaiming normal with the relu gain / the elu init
                gain2 = 2.0 if self.nonlinearity == "relu" else 1.5505188080679277
                std = math.sqrt(gain2 / fan_in)
                w = std * torch.randn((fan_in, fan_out), generator=generator,
                                      device=generator.device)
            else:
                raise NotImplementedError(self.nonlinearity)
            # torch.nn.Linear's default bias init
            bound = 1.0 / math.sqrt(fan_in)
            b = _uniform(generator, (fan_out,), -bound, bound)
            params.append((w, b))
        return params

    def apply(self, params: Params, coords: torch.Tensor) -> torch.Tensor:
        """Forward pass on (..., in_features) coords, full f32 matmuls."""
        h = coords
        n_layers = len(params)
        for i, (w, b) in enumerate(params):
            h = h @ w + b
            if i < n_layers - 1 or not self.outermost_linear:
                h = self._nl(h)
        return h

    def _nl(self, x):
        if self.nonlinearity == "sine":
            return torch.sin(OMEGA_0 * x)
        if self.nonlinearity == "relu":
            return torch.relu(x)
        if self.nonlinearity == "elu":
            return torch.nn.functional.elu(x)
        raise NotImplementedError(self.nonlinearity)

    def point_fn(self, params: Params):
        """fn mapping one point (in_features,) -> (out_features,), for the
        ops.diff transforms."""
        return lambda x: self.apply(params, x)

    @property
    def _is_siren(self) -> bool:
        return self.nonlinearity == "sine" and self.outermost_linear

    @property
    def second_order_ok(self) -> bool:
        """relu MLPs are piecewise-linear: lap(u) = 0 almost everywhere, so
        a Poisson-type loss through them degenerates."""
        return self.nonlinearity in ("sine", "elu")

    def value_grad(self, params: Params, coords: torch.Tensor):
        """(u (N, m), J (N, d, m)): the batched forward chain for the sine
        MLP, vmapped jacfwd otherwise."""
        if self._is_siren:
            from ..ops.forward_laplacian import value_grad as _vg
            return _vg(params, coords)
        return _value_grad_autodiff(self.point_fn(params),
                                    lambda x: self.apply(params, x), coords)

    def value_grad_laplacian(self, params: Params, coords: torch.Tensor):
        """(u (N, m), J (N, d, m), L (N, m)) of (N, d) coords. The sine MLP
        goes through `ops/siren_vgl.siren_vgl` where its kernels take the
        shape (`siren_vgl.takes`): the fused forward and backward kernels on
        a CUDA tensor, the plain chain and its hand-derived reverse sweep on
        a CPU tensor. Wider or deeper sine MLPs, and inputs of more than 3
        dimensions, take the forward-Laplacian chain under autograd (the
        JAX package's route at every width), counted in
        `siren_vgl.chain_routes`. Not for `torch.func` transforms; other
        networks take vmapped jacfwd/hessian."""
        if self._is_siren:
            if siren_vgl_takes(self._widths, coords.shape[-1]):
                return siren_vgl(params, coords)
            siren_vgl.chain_routes += 1
            _note_route("siren_vgl", self._widths,
                        "the forward-Laplacian chain under autograd", coords)
            from ..ops.forward_laplacian import value_grad_laplacian as _vgl
            return _vgl(params, coords)
        return _value_grad_laplacian_autodiff(
            self.point_fn(params), lambda x: self.apply(params, x), coords)

    def apply_fused(self, params: Params, coords: torch.Tensor) -> torch.Tensor:
        """Forward through the fused SIREN kernel (ops/siren_forward.py) on a
        CUDA tensor, its plain version on a CPU tensor, where the kernel
        takes the widths (`siren_forward.takes`); else `apply`, counted in
        `siren_forward.apply_routes`, as the JAX package's `apply_fused`
        runs `apply` off the TPU. Sine SIRENs only; other networks take
        `apply`."""
        if not self._is_siren:
            return self.apply(params, coords)
        if not siren_forward_takes(self._widths):
            siren_forward.apply_routes += 1
            _note_route("siren_forward", self._widths, "MLP.apply", coords)
            return self.apply(params, coords)
        flat = coords.reshape(-1, coords.shape[-1]).contiguous()
        out = siren_forward(params, flat)
        return out.reshape(*coords.shape[:-1], self.out_features)

    @property
    def _widths(self) -> List[int]:
        return [self.in_features] + [b for _, b in self.layer_dims]


def _value_grad_autodiff(point_fn, batch_fn, coords: torch.Tensor):
    """Autodiff fallback matching ops/forward_laplacian conventions:
    (u (N, m), J (N, d, m))."""
    from ..ops.diff import jacobian
    u = batch_fn(coords)
    J = jacobian(point_fn, coords)          # (N, m, d)
    return u, J.transpose(1, 2)


def _value_grad_laplacian_autodiff(point_fn, batch_fn, coords: torch.Tensor):
    """Autodiff fallback: (u (N, m), J (N, d, m), L (N, m))."""
    from ..ops.diff import hessian, jacobian
    u = batch_fn(coords)
    J = jacobian(point_fn, coords)          # (N, m, d)
    H = hessian(point_fn, coords)           # (N, m, d, d)
    L = torch.diagonal(H, dim1=2, dim2=3).sum(-1)
    return u, J.transpose(1, 2), L


@dataclass(frozen=True)
class HashGridField:
    """Multires-hash-grid-encoded field: instant-NGP tables
    (`encodings.MultiResHashGrid`) and a relu `MLP` head; coordinates are
    mapped [-1,1]^d -> [0,1]^d. Multilinear interpolation is piecewise
    linear, so second derivatives vanish almost everywhere: suited to value
    and first-order losses (advection, elasticity), not the Poisson pressure
    solve (`second_order_ok` is False, and fluid refuses it). No fused
    kernel: `apply_fused` is `apply`, and the derivatives go through
    vmapped jacfwd."""
    in_features: int
    out_features: int
    num_hidden_layers: int = 2
    hidden_features: int = 64
    n_levels: int = 8
    n_features_per_level: int = 2
    log2_hashmap_size: int = 15
    base_resolution: int = 8
    finest_resolution: int = 256

    def _encoder(self):
        from .encodings import MultiResHashGrid
        return MultiResHashGrid(
            dim=self.in_features, n_levels=self.n_levels,
            n_features_per_level=self.n_features_per_level,
            log2_hashmap_size=self.log2_hashmap_size,
            base_resolution=self.base_resolution,
            finest_resolution=self.finest_resolution)

    def _head(self) -> MLP:
        return MLP(self._encoder().output_dim, self.out_features,
                   self.num_hidden_layers, self.hidden_features,
                   nonlinearity="relu")

    def init(self, generator: torch.Generator):
        """Fresh tables, then the head, from one generator."""
        return {"tables": self._encoder().init(generator),
                "head": self._head().init(generator)}

    def apply(self, params, coords: torch.Tensor) -> torch.Tensor:
        feats = self._encoder().apply(params["tables"], (coords + 1.0) * 0.5)
        return self._head().apply(params["head"], feats)

    def apply_fused(self, params, coords: torch.Tensor) -> torch.Tensor:
        return self.apply(params, coords)

    def point_fn(self, params):
        return lambda x: self.apply(params, x)

    @property
    def _is_siren(self) -> bool:
        return False

    @property
    def second_order_ok(self) -> bool:
        return False

    def value_grad(self, params, coords: torch.Tensor):
        return _value_grad_autodiff(self.point_fn(params),
                                    lambda x: self.apply(params, x), coords)

    def value_grad_laplacian(self, params, coords: torch.Tensor):
        # zero second derivatives almost everywhere (see the class docstring)
        return _value_grad_laplacian_autodiff(
            self.point_fn(params), lambda x: self.apply(params, x), coords)


def get_network(cfg: Any, in_features: int, out_features: int):
    """Network factory: `siren` (an MLP of cfg.nonlinearity) or `hashgrid`
    (alias `grid`)."""
    if cfg.network == "siren":
        return MLP(in_features, out_features, cfg.num_hidden_layers,
                   cfg.hidden_features, nonlinearity=cfg.nonlinearity)
    if cfg.network in ("grid", "hashgrid"):
        return HashGridField(in_features, out_features,
                             num_hidden_layers=cfg.num_hidden_layers,
                             hidden_features=cfg.hidden_features)
    raise NotImplementedError(f"network={cfg.network}")
