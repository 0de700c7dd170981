"""Contact and constraint energies of the elasticity model (counterpart of
`insr_pde_tpu/models/elast_losses.py`).

Every term is a sum over the points in contact, so the reference's boolean
mask gathers become `torch.where` weights on dense tensors: the same
values, with shapes that do not depend on the data (no host sync).
"""

from __future__ import annotations

import torch


def positional_constraint_loss(q_fixed, q_fixed_target, ratio_constraint):
    """ratio * sum ||q_fixed - target||^2."""
    return ratio_constraint * torch.sum((q_fixed - q_fixed_target) ** 2)


def collision_plane_loss(q, qdot, dt, ratio_collide, plane_height):
    """Penalty work for points below a plane of the last coordinate: force
    ratio * depth along the last axis, energy -dt * sum(qdot . f)."""
    depth = plane_height - q[..., -1]
    force_last = torch.where(depth > 0.0, ratio_collide * depth,
                             torch.zeros_like(depth))
    return -dt * torch.sum(qdot[..., -1] * force_last)


def collision_sphere_loss(q, qdot, dt, ratio_collide, center, radius):
    """Penalty work for points inside a sphere: radial force ratio *
    distance from the center."""
    vec = q - center
    dist = torch.sqrt(torch.sum(vec ** 2, dim=-1))
    direction = vec / torch.clamp(dist, min=1e-12)[..., None]
    force = torch.where((dist < radius)[..., None],
                        ratio_collide * dist[..., None] * direction,
                        torch.zeros_like(vec))
    return -dt * torch.sum(qdot * force)


def collision_bowl_loss(q, qdot, dt, ratio_collide, center, radius):
    """Penalty work for points outside a bowl (the half-sphere below the
    center): inward force ratio * distance for points past the shell."""
    vec = center - q
    dist = torch.sqrt(torch.sum(vec ** 2, dim=-1))
    direction = vec / torch.clamp(dist, min=1e-12)[..., None]
    outside = (dist > radius) & (q[..., 2] < center[2])
    force = torch.where(outside[..., None],
                        ratio_collide * dist[..., None] * direction,
                        torch.zeros_like(vec))
    return -dt * torch.sum(qdot * force)


def collision_bar_loss(q, qdot, dt, ratio_collide, bar_height, bar_width,
                       bar_num):
    """A stub that returns 0, as the reference's."""
    return torch.zeros((), dtype=q.dtype, device=q.device)
