"""Collocation-point samplers (counterpart of `insr_pde_tpu/ops/sampling.py`).

Random samplers draw from an explicit `torch.Generator`; the points land on
the generator's device. They draw other numbers than `jax.random` from the
same seed, so parity tests hand both packages the same points instead.
"""

from __future__ import annotations

import numpy as np
import torch


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """`jnp.linspace(start, stop, num, dtype=float32)` bit for bit, on the
    host. XLA compiles JAX's start*(1-s) + stop*s, s = iota/div, into
    fma(i, f32(stop*f32(1/div)), f32(start*f32(1 - f32(i*f32(1/div))))) and
    appends the exact endpoint. The fma is taken in float64, where the
    product of an integer below 2**24 and an f32 is exact, then rounded
    once to f32."""
    f32 = np.float32
    if num == 1:
        return np.asarray([start], f32)
    div = num - 1
    i = np.arange(div, dtype=f32)
    inv = f32(1.0) / f32(div)
    c_stop = f32(f32(stop) * inv)
    head = (f32(start) * (f32(1.0) - i * inv)).astype(f32)
    out = (head.astype(np.float64) + i.astype(np.float64) * np.float64(c_stop))
    return np.concatenate([out.astype(f32), np.asarray([stop], f32)])


def sample_uniform(resolution: int, sdim: int = 1, flatten: bool = True,
                   device=None) -> torch.Tensor:
    """Cell-centered uniform grid in [-1, 1]^sdim, equal bit for bit to the
    JAX function. (resolution**sdim, sdim) if flatten else
    (resolution,)*sdim + (sdim,)."""
    # on the host: PyTorch's CUDA division by a Python scalar multiplies by
    # its reciprocal, which is not the correctly rounded quotient JAX takes
    f32 = np.float32
    lin = _linspace_f32(0.5, resolution - 0.5, resolution)
    coords = torch.from_numpy(lin / f32(resolution) * f32(2.0) - f32(1.0))
    coords = coords.to(device)
    grid = torch.stack(torch.meshgrid(*([coords] * sdim), indexing="ij"),
                       dim=-1)
    if flatten:
        grid = grid.reshape(resolution ** sdim, sdim)
    return grid


def sample_random(generator: torch.Generator, n: int,
                  sdim: int = 1) -> torch.Tensor:
    """Uniform random points in [-1, 1]^sdim, shape (n, sdim)."""
    u = torch.rand((n, sdim), generator=generator, device=generator.device,
                   dtype=torch.float32)
    return -1.0 + 2.0 * u


def sample_boundary(generator: torch.Generator, n: int, sdim: int,
                    epsilon: float = 1e-4, batch: int = 0) -> torch.Tensor:
    """Random points inside epsilon-shells of the boundary of [-1, 1]^sdim.
    1D: n//2 points near -1, then n//2 near +1; 2D: n//4 per strip, in the
    strip order y=-1, y=+1, x=-1, x=+1. In 1D, `batch` > 0 draws that many
    independent sets at once, shape (batch, 2 * (n//2), 1)."""
    dev = generator.device
    if sdim == 1:
        m = n // 2
        lead = (batch,) if batch > 0 else ()
        u = torch.rand((*lead, 2, m, 1), generator=generator, device=dev,
                       dtype=torch.float32)
        left = (-1.0 + 2.0 * u[..., 0, :, :]) * epsilon - 1.0
        right = (-1.0 + 2.0 * u[..., 1, :, :]) * epsilon + 1.0
        return torch.cat([left, right], dim=-2)
    if batch:
        raise NotImplementedError("sample_boundary: batch is 1D only")
    if sdim == 2:
        ranges = torch.tensor(_strip_ranges("vertical", epsilon)
                              + _strip_ranges("horizontal", epsilon),
                              dtype=torch.float32, device=dev)
        m = n // 4
        u = torch.rand((4, m, 2), generator=generator, device=dev,
                       dtype=torch.float32)
        lo, hi = ranges[..., 0], ranges[..., 1]
        return (lo[:, None, :] + u * (hi - lo)[:, None, :]).reshape(4 * m, 2)
    raise NotImplementedError(f"sample_boundary: sdim={sdim}")


# lo/hi of each strip, (strip, axis, lo|hi). Naming follows the reference
# quirk (`insr_pde_tpu/ops/sampling.py:72-97`): 'horizontal' means the x = ±1
# strips (used for the x-velocity BC), 'vertical' the y = ±1 strips.
def _strip_ranges(side: str, epsilon: float):
    if side == "horizontal":
        return [[[-1.0 - epsilon, -1.0 + epsilon], [-1.0, 1.0]],
                [[1.0 - epsilon, 1.0 + epsilon], [-1.0, 1.0]]]
    if side == "vertical":
        return [[[-1.0, 1.0], [-1.0 - epsilon, -1.0 + epsilon]],
                [[-1.0, 1.0], [1.0 - epsilon, 1.0 + epsilon]]]
    raise RuntimeError(f"sample_boundary2D_separate: side={side}")


def sample_boundary2D_separate(generator: torch.Generator, n: int, side: str,
                               epsilon: float = 1e-4) -> torch.Tensor:
    """2D boundary strips selected by side, n//2 points per strip, shape
    (2 * (n//2), 2): the first half on the strip at -1, the second at +1."""
    ranges = torch.tensor(_strip_ranges(side, epsilon), dtype=torch.float32,
                          device=generator.device)
    m = n // 2
    u = torch.rand((2, m, 2), generator=generator, device=generator.device,
                   dtype=torch.float32)
    lo, hi = ranges[..., 0], ranges[..., 1]
    pts = lo[:, None, :] + u * (hi - lo)[:, None, :]
    return pts.reshape(2 * m, 2)
