"""Procedural test meshes, host-side numpy (a copy of
`insr_pde_tpu/geometry/procedural.py`: the same arrays bit for bit).

The reference ships binary mesh assets (elasticity/data/{bunny,spot}.mesh);
these meshes stand in for them so that tests and runs never depend on large
binary files. Real assets load through `geometry.read_mesh`.
"""

from __future__ import annotations

import numpy as np


def box_tri_mesh(n: int = 8):
    """Regular triangulated square [-1,1]^2: returns (V (.,3), F (.,3))."""
    xs = np.linspace(-1.0, 1.0, n + 1)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    V = np.stack([xx.ravel(), yy.ravel(), np.zeros(xx.size)], axis=1)

    def vid(i, j):
        return i * (n + 1) + j

    F = []
    for i in range(n):
        for j in range(n):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            F.append([a, b, c])
            F.append([a, c, d])
    return V, np.asarray(F, np.int64)


def box_tet_mesh(n: int = 4):
    """Regular tetrahedralized cube [-1,1]^3 (5 tets per cell, alternating
    parity so faces match): returns (V (.,3), T (.,4))."""
    xs = np.linspace(-1.0, 1.0, n + 1)
    xx, yy, zz = np.meshgrid(xs, xs, xs, indexing="ij")
    V = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (n + 1) + j) * (n + 1) + k

    # 5-tet decomposition; mirrored on odd-parity cells so shared faces agree
    even = [(0, 1, 2, 4), (1, 2, 3, 7), (1, 4, 5, 7), (2, 4, 6, 7),
            (1, 2, 4, 7)]
    odd = [(0, 1, 3, 5), (0, 2, 3, 6), (0, 4, 5, 6), (3, 5, 6, 7),
           (0, 3, 5, 6)]
    T = []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                corners = [vid(i + di, j + dj, k + dk)
                           for di in (0, 1) for dj in (0, 1) for dk in (0, 1)]
                pattern = even if (i + j + k) % 2 == 0 else odd
                for tet in pattern:
                    T.append([corners[c] for c in tet])
    return V, np.asarray(T, np.int64)


def statue_tet_mesh(n: int = 32):
    """Lucy-scale structural stand-in: a tapered, gently twisted column
    (statue-like tall solid with a wide base), tetrahedralized at
    (n+1)^3 vertices / 5 n^3 tets.

    The reference's `scripts/elasticity3Dlucy.sh` drops `data/lucy.mesh`
    onto a plane, but the asset is stripped upstream
    (.MISSING_LARGE_BLOBS:1), so exact parity is impossible; this mesh
    reproduces the SCALE of the workload (n=32 -> 35,937 vertices /
    163,840 tets — larger than bunny's 18,592 / 76,854) with a
    non-axis-aligned shape so the 3x128 SIREN sees a nontrivial SDF-like
    deformation field. Coordinates span roughly [-1,1]^2 x [0,2]."""
    V, T = box_tet_mesh(n)
    # re-map the unit cube: z in [0,2], xy tapered from full width at the
    # base to 35% at the top, with a 60-degree twist along the height
    u = (V[:, 2] + 1.0) * 0.5                    # height fraction in [0,1]
    taper = 1.0 - 0.65 * u
    ang = (np.pi / 3.0) * u
    c, s = np.cos(ang), np.sin(ang)
    x = V[:, 0] * taper
    y = V[:, 1] * taper
    V = np.stack([c * x - s * y, s * x + c * y, u * 2.0], axis=1)
    return V, T


if __name__ == "__main__":
    # materialize the lucy-scale stand-in as a MEDIT file the elasticity
    # CLI can point --mesh_path at:
    #   python -m insr_pde_tpu_torch.geometry.procedural [out.mesh] [n]
    import sys

    from .mesh_io import write_medit

    out = sys.argv[1] if len(sys.argv) > 1 else "statue.mesh"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    V, T = statue_tet_mesh(n)
    write_medit(out, V, {"tetra": T})
    print(f"{out}: {len(V)} vertices, {len(T)} tets")
