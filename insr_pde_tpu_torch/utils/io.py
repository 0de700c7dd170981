"""Point-cloud writer (counterpart of `insr_pde_tpu/utils/io.py`): an ASCII
PLY file with the same bytes as the JAX package's writer for the same
points."""

from __future__ import annotations

import numpy as np


def write_pointcloud_to_file(path: str, points, colors=None):
    """Write an (N, 2|3) point cloud to ASCII PLY; 2D points get z = 0.
    Coordinates as float32 with 6 decimals, colours (in [0, 1]) as
    uchar."""
    pts = np.asarray(points, dtype=np.float32)
    if pts.shape[1] == 2:
        pts = np.concatenate([pts, np.zeros((pts.shape[0], 1), np.float32)],
                             axis=1)
    n = pts.shape[0]
    header = ["ply", "format ascii 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    cols = None
    if colors is not None:
        cols = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    lines = [f"{x:.6f} {y:.6f} {z:.6f}" for x, y, z in pts]
    if cols is not None:
        lines = [f"{line} {r} {g} {b}" for line, (r, g, b) in zip(lines, cols)]
    with open(path, "w") as f:
        f.write("\n".join(header) + "\n")
        f.write("".join(line + "\n" for line in lines))
