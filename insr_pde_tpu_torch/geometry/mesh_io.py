"""Mesh readers and writer, host-side numpy (counterpart of
`insr_pde_tpu/geometry/mesh_io.py`).

The reference loads tet and triangle meshes through `meshio.read`
(`.points` + `cells_dict['tetra'|'triangle']`). These read ASCII MEDIT
`.mesh` and Wavefront `.obj` files into the same surface; the arrays go to
the device once, when the model builds its constant buffers. The MEDIT
reader is one vectorised numpy token parser.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

# MEDIT section name -> (cell key, vertices per element)
_MEDIT_CELLS = {
    "triangles": ("triangle", 3),
    "tetrahedra": ("tetra", 4),
    "quadrilaterals": ("quad", 4),
    "edges": ("line", 2),
    "hexahedra": ("hexahedron", 8),
}


@dataclass
class MeshData:
    """The part of meshio's mesh object that the elasticity model reads."""
    points: np.ndarray                      # (V, 3) float64
    cells_dict: Dict[str, np.ndarray] = field(default_factory=dict)


def read_medit(path: str) -> MeshData:
    """Parse an ASCII MEDIT `.mesh` file (INRIA format).

    Layout: `MeshVersionFormatted`, `Dimension`, then sections (`Vertices`,
    `Triangles`, `Tetrahedra`, ...), each a count and that many rows of
    whitespace-separated values ending in a reference tag; element indices
    are 1-based in the file and 0-based here. 2D vertices get z = 0."""
    with open(path) as f:
        tokens = f.read().split()

    i = 0
    dim = 3
    points = None
    cells: Dict[str, np.ndarray] = {}
    n_tok = len(tokens)
    while i < n_tok:
        word = tokens[i].lower()
        if word == "meshversionformatted":
            i += 2
        elif word == "dimension":
            dim = int(tokens[i + 1])
            i += 2
        elif word == "vertices":
            count = int(tokens[i + 1])
            i += 2
            width = dim + 1  # coords + reference tag
            flat = np.asarray(tokens[i:i + count * width], dtype=np.float64)
            pts = flat.reshape(count, width)[:, :dim]
            if dim == 2:
                pts = np.concatenate(
                    [pts, np.zeros((count, 1), np.float64)], axis=1)
            points = pts
            i += count * width
        elif word in _MEDIT_CELLS:
            key, nv = _MEDIT_CELLS[word]
            count = int(tokens[i + 1])
            i += 2
            width = nv + 1  # indices + reference tag
            flat = np.asarray(tokens[i:i + count * width], dtype=np.int64)
            cells[key] = flat.reshape(count, width)[:, :nv] - 1
            i += count * width
        elif word == "end":
            break
        else:  # a keyword of a section this reader does not keep
            i += 1
    if points is None:
        raise ValueError(f"{path}: no Vertices section")
    return MeshData(points=points, cells_dict=cells)


def write_medit(path: str, points: np.ndarray,
                cells_dict: Dict[str, np.ndarray]) -> None:
    """Write an ASCII MEDIT `.mesh` file that `read_medit` reads back: the
    same text as the JAX package's writer (coordinates as %.9g, reference
    tags 0). Used to write the procedural stand-in meshes
    (geometry/procedural.py) as files that `--mesh_path` can name."""
    key_to_section = {v[0]: (k.capitalize(), v[1])
                      for k, v in _MEDIT_CELLS.items()}
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (V, 3), got {pts.shape}")
    with open(path, "w") as f:
        f.write("MeshVersionFormatted 2\nDimension\n3\n")
        f.write(f"Vertices\n{len(pts)}\n")
        f.write("".join(f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g} 0\n" for p in pts))
        for key, cells in cells_dict.items():
            section, nv = key_to_section[key]
            cells = np.asarray(cells, np.int64)
            if cells.shape[1] != nv:
                raise ValueError(
                    f"{key} cells must be (N, {nv}), got {cells.shape}")
            f.write(f"{section}\n{len(cells)}\n")
            f.write("".join(" ".join(str(int(v) + 1) for v in c) + " 0\n"
                            for c in cells))
        f.write("End\n")


def read_obj(path: str) -> MeshData:
    """Wavefront OBJ reader (v and f records; polygons split into fans)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return MeshData(points=np.asarray(verts, np.float64),
                    cells_dict={"triangle": np.asarray(faces, np.int64)})


def read_mesh(path: str) -> MeshData:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mesh":
        return read_medit(path)
    if ext == ".obj":
        return read_obj(path)
    raise NotImplementedError(f"mesh format {ext!r} (have: .mesh, .obj)")
