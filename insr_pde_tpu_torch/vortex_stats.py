"""Accuracy of a solved vortex channel field, from its `field.npy`.

    python -m insr_pde_tpu_torch.vortex_stats FIELD.npy [FIELD.npy ...]
        [--internal_v 8]

Reads the (T, r*r, E) field that the vortex entry points of both packages
write (`python -m insr_pde_tpu_torch vortex` and the JAX package's
`starterL.py`, at their `vis_resolution` of 100) and prints, per file, one
JSON line: the inlet error, mean |u_x - v| / v along the inlet column over
the t > 0 slices (the definition of `models/vortex.inlet_error`, here on
the file's grid), and max |u| over the velocity components. Reads no model
and imports no framework, so it holds two packages' runs to one yardstick.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np


def field_stats(field: np.ndarray, internal_v: float) -> dict:
    """{"inlet_error", "max_u", "resolution"} of a (T, r*r, E) field."""
    T, n, _ = field.shape
    r = math.isqrt(n)
    if r * r != n:
        raise ValueError(f"field of {n} points per slice is not an r x r grid")
    ux = field.reshape(T, r, r, -1)[1:, 0, :, 0]
    return {"inlet_error": float(np.mean(np.abs(ux - internal_v))
                                 / max(abs(internal_v), 1e-30)),
            "max_u": float(np.abs(field[..., :2]).max()),
            "resolution": r}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("fields", nargs="+")
    ap.add_argument("--internal_v", type=float, default=8.0)
    args = ap.parse_args(argv)
    for path in args.fields:
        stats = field_stats(np.load(path), args.internal_v)
        print(json.dumps({"field": path, **stats}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
