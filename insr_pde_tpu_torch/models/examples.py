"""Initial-condition library (counterpart of `insr_pde_tpu/models/examples.py`).

All functions map (N, d) sample coords -> field values, in torch.
"""

from __future__ import annotations

import math
from functools import partial

import torch


def get_examples(src: str):
    if src == "example1":
        return partial(gaussian_like, mu=-1.5)
    if src == "taylorgreen":
        return partial(taylorgreen_velocity, rescale=True)
    if src == "taylorgreen_multi":
        return taylorgreen_multi_velocity
    raise NotImplementedError(f"init_cond={src}")


def gaussian_like(x, mu=0.0, sigma=0.1):
    """Normalized gaussian bump."""
    return torch.exp(-0.5 * (x - mu) ** 2 / (sigma ** 2))


def taylorgreen_velocity(samples, rescale=False):
    """Taylor-Green vortex velocity on [-1,1]^2: A=1, B=-1, a=b=1, optional
    1/pi rescale."""
    x = (samples[..., 0] + 1.0) * math.pi
    y = (samples[..., 1] + 1.0) * math.pi
    u = torch.sin(x) * torch.cos(y)
    v = -torch.cos(x) * torch.sin(y)
    if rescale:
        u = u / math.pi
        v = v / math.pi
    return torch.stack([u, v], dim=-1)


def taylorgreen_multi_velocity(samples, scale=8):
    """Two nested Taylor-Green patches at different scales, blended with
    distance weights near the patch borders."""
    gap = 0.05
    vel = torch.zeros_like(samples)

    # patch 1: [-1, 0] x [-1, 0], weight fades over `gap` outside the corner
    mask1 = (samples[..., 0] <= gap) & (samples[..., 1] <= gap)
    d1 = torch.linalg.norm(torch.clamp(samples, 0.0, gap), dim=-1)
    w1 = 1.0 - d1 / gap
    v1 = taylorgreen_velocity(torch.clamp(samples * 2.0 + 1.0, -1.0, 1.0))
    vel = torch.where(mask1[..., None], v1 * w1[..., None], vel)

    # patch 2: (p, 1] x (p, 1] with p = 1 - 2/scale, smaller gap
    p = 1.0 - 2.0 / scale
    gap_ = gap * 2.0 / scale
    mask2 = (samples[..., 0] > p - gap_) & (samples[..., 1] > p - gap_)
    d2 = torch.linalg.norm(torch.clamp(p - samples, 0.0, gap_), dim=-1)
    w2 = 1.0 - d2 / gap_
    v2 = taylorgreen_velocity(
        torch.clamp(samples * scale + (-scale + 1.0), -1.0, 1.0))
    vel = torch.where(mask2[..., None], v2 * w2[..., None], vel)

    return vel
