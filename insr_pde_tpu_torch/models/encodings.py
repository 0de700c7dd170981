"""Coordinate encodings (counterpart of `insr_pde_tpu/models/encodings.py`):
NeRF frequency features and the instant-NGP multi-resolution hash grid.

Pure functions over parameter lists: `MultiResHashGrid.apply(tables, x)`
hashes the 2^dim cell corners of every level with the tiny-cuda-nn XOR-prime
hash and interpolates the corner features multilinearly; gradients reach the
tables through the gathers. The levels run together as one batch axis (an
eager loop over them would cost a launch per level and step). The hash is
uint32 arithmetic in the JAX package; torch has no full uint32 arithmetic,
so `_fast_hash` computes it in int64 with every product reduced mod 2^32,
which gives the same bits, negative corner coordinates included (they wrap
as JAX's `astype(uint32)`).
The level growth factor is the paper's eq. (3) with (n_levels - 1) in the
denominator, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

# tiny-cuda-nn grid hash primes
PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
          2165219737)

_LOW32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Frequency:
    """NeRF positional encoding; output dim = dim * n_levels * 2."""
    dim: int
    n_levels: int = 10

    @property
    def output_dim(self) -> int:
        return self.dim * self.n_levels * 2

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        freqs = 2.0 ** torch.arange(self.n_levels, dtype=x.dtype,
                                    device=x.device)
        xb = x[..., None] * freqs                    # (..., dim, L)
        out = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
        return out.reshape(*x.shape[:-1], self.output_dim)


def _mul_u32(u: torch.Tensor, prime: int) -> torch.Tensor:
    """u * prime mod 2^32 for int64 u in [0, 2^32): the prime split in 16-bit
    halves keeps every partial product under 2^48 (no int64 overflow)."""
    lo, hi = prime & 0xFFFF, prime >> 16
    return (u * lo + (((u * hi) & 0xFFFF) << 16)) & _LOW32


def _fast_hash(inds: torch.Tensor, dim: int, hashmap_size) -> torch.Tensor:
    """tiny-cuda-nn XOR-prime hash of integer corner coordinates (..., dim):
    the JAX package's uint32 hash, bit for bit, as int64 indices.
    `hashmap_size` is an int or an int64 tensor that broadcasts against
    the corners (one size per level)."""
    u = inds.to(torch.int64) & _LOW32           # astype(uint32) wrap
    acc = _mul_u32(u[..., 0], PRIMES[0])
    for i in range(1, dim):
        acc = acc ^ _mul_u32(u[..., i], PRIMES[i])
    return acc % hashmap_size


@functools.lru_cache(maxsize=None)
def _level_consts(dim: int, specs: Tuple[Tuple[int, int], ...], device,
                  dtype):
    """The corner offsets (2^dim, dim) in {0, 1}, and per level the
    resolution, the table size and the table's offset in the joined table,
    on `device`: made once, not copied to the card on every call."""
    n_corners = 1 << dim
    corners = torch.as_tensor(
        (np.arange(n_corners)[:, None] >> np.arange(dim)[None, :]) & 1,
        dtype=torch.int64, device=device)
    res = torch.tensor([r for r, _ in specs], dtype=dtype, device=device)
    sizes = torch.tensor([n for _, n in specs], dtype=torch.int64,
                         device=device)
    return corners, res, sizes, torch.cumsum(sizes, 0) - sizes


@dataclass(frozen=True)
class MultiResHashGrid:
    """Instant-NGP multi-resolution hash encoding: one (hashmap_size,
    n_features) table per level, initialized U[-1e-4, 1e-4]. Input
    coordinates are expected in [0, 1]^dim."""
    dim: int
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 15
    base_resolution: int = 16
    finest_resolution: int = 512

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def level_specs(self) -> List[Tuple[int, int]]:
        """[(resolution, hashmap_size)] per level, paper eq. (2)-(3)."""
        if self.n_levels > 1:
            b = math.exp((math.log(self.finest_resolution)
                          - math.log(self.base_resolution))
                         / (self.n_levels - 1))
        else:
            b = 1.0
        specs = []
        for lv in range(self.n_levels):
            res = int(math.floor(self.base_resolution * (b ** lv)))
            size = min(res ** self.dim, 2 ** self.log2_hashmap_size)
            specs.append((res, size))
        return specs

    def init(self, generator: torch.Generator) -> List[torch.Tensor]:
        """Fresh tables on the generator's device."""
        return [(torch.rand((size, self.n_features_per_level),
                            generator=generator, device=generator.device)
                 * 2e-4 - 1e-4) for _, size in self.level_specs]

    def apply(self, tables: List[torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        """(..., dim) in [0, 1] -> (..., n_levels * n_features_per_level).
        All levels at once: the tables are joined into one (each level's
        hashes offset by the sizes before it), so each step is one launch
        for every level instead of one per level; per level the arithmetic
        is the JAX package's loop body's."""
        corners, res, sizes, offsets = _level_consts(
            self.dim, tuple(self.level_specs), x.device, x.dtype)
        table = torch.cat(list(tables))                      # (sum, F)
        xs = x[..., None, :] * res[:, None]                  # (..., L, dim)
        xi = torch.floor(xs).to(torch.int64)
        xf = xs - torch.floor(xs).detach()
        inds = xi[..., None, :] + corners                    # (..., L, C, dim)
        # weight: prod over dims of (1 - xf) for corner bit 0, xf for 1
        w = torch.where(corners == 0, 1.0 - xf[..., None, :],
                        xf[..., None, :]).prod(dim=-1)       # (..., L, C)
        hid = (_fast_hash(inds, self.dim, sizes[:, None])
               + offsets[:, None])                           # (..., L, C)
        feats = table[hid]                                   # (..., L, C, F)
        out = torch.sum(feats * w[..., None], dim=-2)        # (..., L, F)
        return out.reshape(*x.shape[:-1], self.output_dim)
