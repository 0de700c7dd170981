"""Matrix-product work of a SIREN, counted from its widths: the
multiply-adds one point needs, each counted once (a product recomputed by
a kernel is not counted again). Sines, the elementwise chain rules and
reductions are left out, so every count is a floor of the work done.

With F the multiply-adds of one forward at one point, m0 those of its first
layer and d the input dimension:

* a frozen forward: F;
* a trained forward (backprop to the weights, not to the coordinates):
  3 F - m0;
* a frozen value+Jacobian chain (d tangents after the first layer, whose
  tangent is its weight matrix): F + d (F - m0);
* a trained value+Jacobian chain: 3 (F + d (F - m0)) - m0;
* a trained value+Jacobian+Laplacian chain (the Laplacian is one more
  channel after the first layer): 3 (F + (d + 1) (F - m0)) - m0.
"""

from __future__ import annotations

from typing import List


def macs(w: List[int]) -> int:
    """Multiply-adds of one forward at one point of widths `w`."""
    return sum(a * b for a, b in zip(w[:-1], w[1:]))


def frozen(w: List[int]) -> int:
    return macs(w)


def trained(w: List[int]) -> int:
    return 3 * macs(w) - w[0] * w[1]


def jac_frozen(w: List[int]) -> int:
    f, m0 = macs(w), w[0] * w[1]
    return f + w[0] * (f - m0)


def jac_trained(w: List[int]) -> int:
    return 3 * jac_frozen(w) - w[0] * w[1]


def lap_trained(w: List[int]) -> int:
    f, m0 = macs(w), w[0] * w[1]
    return 3 * (f + (w[0] + 1) * (f - m0)) - m0


def n_params(w: List[int]) -> int:
    return sum(a * b + b for a, b in zip(w[:-1], w[1:]))
