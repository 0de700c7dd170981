"""Work of `elasticity_lucy_3x128` from its shapes: FLOPs (2 per
multiply-add) of one Adam iteration of each fit, and the SIREN forward
kernel's FLOPs and bytes per step iteration. N = sr^3 volume points plus
the mesh's vertices:

* a step iteration: the trained value+Jacobian chain of the displacement
  at N points, and the two previous fields' frozen forwards at N points
  (the SIREN forward kernel, twice); the energies' elementwise work, the
  3x3 singular values and the polar factor are left out;
* the t = 0 fit: a trained forward at N points.

The forward kernel reads the coordinates and the weights and writes the
output once per launch: 4 bytes a number.
"""

from __future__ import annotations

from typing import Dict

from . import siren


def _widths(config: dict):
    return [3] + [config["hidden_features"]] * (config["num_hidden_layers"] + 1) + [3]


def _points(workload: dict) -> int:
    n = workload["mesh_n"] + 1
    return workload["sample_resolution"] ** 3 + n ** 3


def iter_flops(config: dict, workload: dict) -> Dict[str, float]:
    """FLOPs of one Adam iteration of each fit, by the fit's phase tag."""
    w, n = _widths(config), _points(workload)
    return {"initialize": 2.0 * n * siren.trained(w),
            "solve_deformation": 2.0 * n * (siren.jac_trained(w)
                                             + 2 * siren.frozen(w))}


def kernel_work(config: dict, workload: dict) -> Dict[str, dict]:
    """Per kernel: the device operations' names it runs as, the phase whose
    iterations launch it, and its FLOPs and bytes per such iteration."""
    w, n = _widths(config), _points(workload)
    per_launch = 4 * (n * w[0] + siren.n_params(w) + n * w[-1])
    return {"siren_forward": {
        "names": ["siren_forward_kernel"],
        "phase": "solve_deformation",
        "flops": 2.0 * 2 * n * siren.frozen(w),
        "bytes": 2.0 * per_launch}}
