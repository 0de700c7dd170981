"""Work of `fluid_tg_3x32` from its shapes: FLOPs (2 per multiply-add) of
one Adam iteration of each fit, and the vgl kernel pair's FLOPs and bytes
per pressure iteration. n interior points, nb = 2 (sr^2 // 100 // 2)
points on the |x| = 1 strips and as many on |y| = 1:

* advect: trained velocity at n and on both strip sets, frozen velocity at
  x and at the departure point;
* pressure: frozen velocity's value+Jacobian at n, the pressure's
  value+Jacobian+Laplacian at n (the vgl pair), trained pressure
  value+Jacobian on both strip sets;
* projection: frozen velocity and frozen pressure value+Jacobian at n,
  trained velocity at n and on both strip sets.

The vgl pair reads the coordinates and the weights once and the three
outputs' cotangents, and writes the three outputs, the weight gradients
and the coordinates' cotangents: 4 bytes a number.

Compared with the program's `bench.fluid_flops_per_iter`, the pair is
counted without the forward its backward recomputes, and the pressure's
strip term as a whole trained chain.
"""

from __future__ import annotations

from typing import Dict

from . import siren


def _widths(config: dict, d_out: int):
    return ([2] + [config["hidden_features"]]
            * (config["num_hidden_layers"] + 1) + [d_out])


def _points(workload: dict):
    n = workload["sample_resolution"] ** 2
    return n, 2 * (max(n // 100, 2) // 2)


def iter_flops(config: dict, workload: dict) -> Dict[str, float]:
    """FLOPs of one Adam iteration of each fit, by the fit's phase tag."""
    v, p = _widths(config, 2), _widths(config, 1)
    n, nb = _points(workload)
    macs = {
        "initialize": n * siren.trained(v),
        "advect_velocity": n * (siren.trained(v) + 2 * siren.frozen(v))
        + 2 * nb * siren.trained(v),
        "solve_pressure": n * (siren.jac_frozen(v) + siren.lap_trained(p))
        + 2 * nb * siren.jac_trained(p),
        "projection": n * (siren.frozen(v) + siren.jac_frozen(p)
                           + siren.trained(v)) + 2 * nb * siren.trained(v),
    }
    return {k: 2.0 * m for k, m in macs.items()}


def kernel_work(config: dict, workload: dict) -> Dict[str, dict]:
    """Per kernel: the device operations' names it runs as, the phase whose
    iterations launch it, and its FLOPs and bytes per such iteration."""
    p = _widths(config, 1)
    n, _ = _points(workload)
    d, m = p[0], p[-1]
    n_bytes = 4 * (2 * siren.n_params(p) + n * d            # read x, W; write dW
                   + 2 * n * (d + 2) * m                    # outputs, cotangents
                   + n * d)                                 # dx
    return {"siren_vgl": {
        "names": ["vgl_forward_kernel", "vgl_backward_kernel",
                  "vgl_reduce_kernel"],
        "phase": "solve_pressure",
        "flops": 2.0 * n * siren.lap_trained(p),
        "bytes": float(n_bytes)}}
