"""Mesh measures, distributions, samplers and transforms (counterpart of
`insr_pde_tpu/geometry/mesh_ops.py`).

Functions of tensors on an explicit device; random samplers draw from an
explicit `torch.Generator` and stay on its device with no host sync:

  * an element index drawn with probability proportional to its area or
    volume is the inverse CDF of a uniform: `searchsorted` on the
    cumulative distribution, clamped to the last element;
  * Dirichlet(1, 1, 1, 1) barycentric weights are normalised -log(1 - U);
  * `per_vertex_areas` and `boundary_faces` run once at mesh load, on the
    host in numpy (a scatter-add on the card would round in another order
    from run to run). Like the JAX package, `per_vertex_areas` does not
    reproduce the reference's off-by-one index shift for tet meshes.

These draw other numbers than `jax.random`; parity tests hand both packages
the same points.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------- measures


def per_face_normals(V: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Unnormalised face normals (cross products), (F, 3)."""
    f = V[F]  # (F, 3, 3)
    return torch.linalg.cross(f[:, 1] - f[:, 0], f[:, 2] - f[:, 0])


def per_face_areas(V: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Triangle areas, (F,)."""
    if V.shape[-1] == 2:
        V = torch.cat([V, torch.zeros_like(V[:, :1])], dim=-1)
    return 0.5 * torch.linalg.norm(per_face_normals(V, F), dim=-1)


def per_tet_volumes(V: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Tet volumes |(a x b) . c| / 6, (T,)."""
    t = V[T]  # (T, 4, 3)
    a, b, c = t[:, 1] - t[:, 0], t[:, 2] - t[:, 0], t[:, 3] - t[:, 0]
    return torch.abs(torch.sum(torch.linalg.cross(a, b) * c, dim=-1)) / 6.0


def per_vertex_areas(V: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Barycentric-lumped area (triangles) or volume (tets) per vertex,
    (V, 1), on V's device. The element measures are computed where V lies;
    the scatter-add runs on the host (`np.add.at`, a fixed order)."""
    nv_elem = T.shape[1]
    if nv_elem == 4:
        measure = per_tet_volumes(V, T)
    elif nv_elem == 3:
        measure = per_face_areas(V, T)
    else:
        raise NotImplementedError(f"elements with {nv_elem} vertices")
    share = (measure / nv_elem).cpu().numpy()
    idx = T.cpu().numpy()
    out = np.zeros((V.shape[0],), share.dtype)
    for k in range(nv_elem):
        np.add.at(out, idx[:, k], share)
    return torch.from_numpy(out[:, None]).to(V.device)


# ------------------------------------------------------------ distributions


def area_weighted_distribution(V, F) -> torch.Tensor:
    """Face probabilities (F,), proportional to area."""
    a = per_face_areas(V, F)
    return a / torch.sum(a)


def volume_weighted_distribution(V, T) -> torch.Tensor:
    """Tet probabilities (T,), proportional to volume."""
    v = per_tet_volumes(V, T)
    return v / torch.sum(v)


def _categorical(generator: torch.Generator, probs: torch.Tensor,
                 n: int) -> torch.Tensor:
    """n indices drawn with the given probabilities: inverse CDF of a
    uniform drawn on the generator's device, on the device of `probs`.
    The CDF is summed in float64: a float32 scan's rounding depends on its
    order (the card's parallel scan differs from the CPU's and from run to
    run), and over ~1e5 elements it moves the boundaries by more than an
    element's width, so the same uniforms would pick other elements."""
    cdf = torch.cumsum(probs.double(), dim=0)
    u = _rand(generator, (n,), probs.dtype, probs.device).double() * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, max=probs.shape[0] - 1)


def random_face(generator, V, F, n, distrib=None) -> torch.Tensor:
    """n face indices drawn proportional to area."""
    if distrib is None:
        distrib = area_weighted_distribution(V, F)
    return _categorical(generator, distrib, n)


def random_tet(generator, V, T, n, distrib=None) -> torch.Tensor:
    """n tet indices drawn proportional to volume."""
    if distrib is None:
        distrib = volume_weighted_distribution(V, T)
    return _categorical(generator, distrib, n)


# ----------------------------------------------------------------- sampling


def _rand(generator, shape, dtype=torch.float32, device=None):
    """Uniforms drawn on the generator's device, then moved to `device`."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    return u if device is None else u.to(device)


def sample_surface(generator, V, F, n, distrib=None) -> torch.Tensor:
    """n area-weighted surface points (barycentric weights from sqrt(u),
    v)."""
    fidx = random_face(generator, V, F, n, distrib)
    f = V[F[fidx]]  # (n, 3, d)
    u = torch.sqrt(_rand(generator, (n, 1), V.dtype, V.device))
    v = _rand(generator, (n, 1), V.dtype, V.device)
    return (1 - u) * f[:, 0] + (u * (1 - v)) * f[:, 1] + (u * v) * f[:, 2]


def sample_volume(generator, V, T, n, distrib=None) -> torch.Tensor:
    """n volume-weighted points in the tets, with Dirichlet(1, 1, 1, 1)
    barycentric weights."""
    tidx = random_tet(generator, V, T, n, distrib)
    tet = V[T[tidx]]  # (n, 4, d)
    e = -torch.log1p(-_rand(generator, (n, 4), V.dtype, V.device))
    barys = e / torch.sum(e, dim=1, keepdim=True)
    return torch.einsum("nk,nkd->nd", barys, tet)


def sample_mesh(generator, V, F, n, distrib=None) -> torch.Tensor:
    """Triangles: surface points; tets: volume points."""
    if F.shape[1] == 3:
        return sample_surface(generator, V, F, n, distrib)
    if F.shape[1] == 4:
        return sample_volume(generator, V, F, n, distrib)
    raise NotImplementedError(f"elements with {F.shape[1]} vertices")


def sample_near_surface(generator, V, F, n, variance: float = 0.01,
                        distrib=None) -> torch.Tensor:
    """Surface points plus gaussian jitter."""
    samples = sample_surface(generator, V, F, n, distrib)
    noise = torch.randn(samples.shape, generator=generator,
                        device=generator.device, dtype=V.dtype).to(V.device)
    return samples + variance * noise


def sample_uniform_aabb(generator, n, sdim: int = 3,
                        dtype=torch.float32) -> torch.Tensor:
    """Uniform points in the [-1, 1]^sdim box."""
    return -1.0 + 2.0 * _rand(generator, (n, sdim), dtype)


def barycentric_coordinates(points, A, B, C) -> torch.Tensor:
    """Barycentric coordinates of (N, 3) points w.r.t. triangles (A, B,
    C)."""
    v0, v1 = B - A, C - A
    v2 = points - A
    d00 = torch.sum(v0 * v0, -1)
    d01 = torch.sum(v0 * v1, -1)
    d11 = torch.sum(v1 * v1, -1)
    d20 = torch.sum(v2 * v0, -1)
    d21 = torch.sum(v2 * v1, -1)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    return torch.stack([u, v, w], dim=-1)


def point_sample(generator, V, F, methods, n_per_method) -> torch.Tensor:
    """n points for each method of a list of 'rand' | 'near' | 'trace'."""
    outs = []
    for m in methods:
        if m == "rand":
            outs.append(sample_uniform_aabb(generator, n_per_method,
                                            V.shape[1], V.dtype))
        elif m == "near":
            outs.append(sample_near_surface(generator, V, F, n_per_method))
        elif m == "trace":
            outs.append(sample_surface(generator, V, F, n_per_method))
        else:
            raise NotImplementedError(f"point_sample method {m!r}")
    return torch.cat(outs, dim=0)


# --------------------------------------------------------------- transforms


def normalize(V, F):
    """Centre the bounding box and scale to unit max radius; returns
    (V', F)."""
    v_center = (torch.max(V, dim=0).values + torch.min(V, dim=0).values) / 2.0
    V = V - v_center
    max_dist = torch.sqrt(torch.max(torch.sum(V ** 2, dim=-1)))
    return V / max_dist, F


def boundary_faces(T: np.ndarray) -> np.ndarray:
    """Boundary triangles of a tet mesh: the faces that appear once among
    all tets' faces, orientation kept. Host numpy, once at mesh load."""
    T = np.asarray(T)
    assert T.shape[1] == 4
    all_f = np.vstack((T[:, [3, 1, 2]], T[:, [2, 0, 3]],
                       T[:, [1, 3, 0]], T[:, [0, 2, 1]]))
    sorted_f = np.sort(all_f, axis=1)
    _, idx, counts = np.unique(sorted_f, return_index=True,
                               return_counts=True, axis=0)
    return all_f[idx[counts == 1]]


def sample_spc(generator, corners: torch.Tensor, level: int,
               num_samples: int) -> torch.Tensor:
    """Uniform points in structured-point-cloud voxels: a jitter within
    each corner's cell at `level`, mapped to [-1, 1]^3."""
    res = 2.0 ** level
    jitter = _rand(generator, (corners.shape[0], num_samples, 3),
                   corners.dtype, corners.device)
    samples = (corners[:, None, :3] + jitter).reshape(-1, 3) / res
    return samples * 2.0 - 1.0


def sample_tex(uv: torch.Tensor, material_idx: torch.Tensor,
               textures: torch.Tensor) -> torch.Tensor:
    """RGB at (N, 2) uv coordinates, bilinear, from an (M, H, W, 3) stack
    of material images; v is flipped to image row order."""
    h, w = textures.shape[1], textures.shape[2]
    u = torch.clamp(uv[:, 0], 0.0, 1.0) * (w - 1)
    v = (1.0 - torch.clamp(uv[:, 1], 0.0, 1.0)) * (h - 1)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = torch.clamp(u0 + 1, max=w - 1)
    v1 = torch.clamp(v0 + 1, max=h - 1)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]
    m = material_idx.long()
    c00 = textures[m, v0, u0]
    c01 = textures[m, v0, u1]
    c10 = textures[m, v1, u0]
    c11 = textures[m, v1, u1]
    return ((1 - fv) * ((1 - fu) * c00 + fu * c01)
            + fv * ((1 - fu) * c10 + fu * c11))
