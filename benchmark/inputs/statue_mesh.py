"""The lucy scene's stand-in mesh, made by the benchmark and written as an
ASCII MEDIT file that the program reads through `--mesh_path` and the
reference reads itself.

The published scene drops `lucy.mesh`, which no public copy of the repo
ships; in its place stands a tapered, twisted column tetrahedralized at
(n + 1)^3 vertices and 5 n^3 tetrahedra (n = 32: 35,937 vertices, 163,840
tetrahedra, the scale of the scene). The arithmetic is that of the
program's `geometry.procedural.statue_tet_mesh`, copied so that the input
does not come from the program under test.
"""

from __future__ import annotations

import numpy as np


def box_tet_mesh(n: int):
    """The cube [-1, 1]^3 cut into n^3 cells of 5 tetrahedra each, mirrored
    on odd cells so that faces match: (V (., 3), T (., 4))."""
    xs = np.linspace(-1.0, 1.0, n + 1)
    xx, yy, zz = np.meshgrid(xs, xs, xs, indexing="ij")
    V = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)
    even = [(0, 1, 2, 4), (1, 2, 3, 7), (1, 4, 5, 7), (2, 4, 6, 7),
            (1, 2, 4, 7)]
    odd = [(0, 1, 3, 5), (0, 2, 3, 6), (0, 4, 5, 6), (3, 5, 6, 7),
           (0, 3, 5, 6)]
    T = []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                corners = [((i + di) * (n + 1) + j + dj) * (n + 1) + k + dk
                           for di in (0, 1) for dj in (0, 1) for dk in (0, 1)]
                pattern = even if (i + j + k) % 2 == 0 else odd
                T.extend([corners[c] for c in tet] for tet in pattern)
    return V, np.asarray(T, np.int64)


def statue_tet_mesh(n: int):
    """The column: z in [0, 2], the cross-section tapered from full width at
    the base to 35% at the top and twisted by 60 degrees along the height."""
    V, T = box_tet_mesh(n)
    u = (V[:, 2] + 1.0) * 0.5
    taper = 1.0 - 0.65 * u
    ang = (np.pi / 3.0) * u
    c, s = np.cos(ang), np.sin(ang)
    x, y = V[:, 0] * taper, V[:, 1] * taper
    return np.stack([c * x - s * y, s * x + c * y, u * 2.0], axis=1), T


def write_medit(path: str, V: np.ndarray, T: np.ndarray) -> None:
    """Vertices (%.9g, exact for float32) and tetrahedra, 1-based, each row
    ending in reference tag 0."""
    with open(path, "w") as f:
        f.write(f"MeshVersionFormatted 2\nDimension\n3\nVertices\n{len(V)}\n")
        f.write("".join(f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g} 0\n" for p in V))
        f.write(f"Tetrahedra\n{len(T)}\n")
        f.write("".join(f"{a + 1} {b + 1} {c + 1} {d + 1} 0\n"
                        for a, b, c, d in T.tolist()))
        f.write("End\n")
