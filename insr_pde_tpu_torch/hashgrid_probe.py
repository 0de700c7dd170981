"""The hash-grid backbone against SIREN on paper-scale advection (counterpart
of `tools/hashgrid_probe.py`).

    python -m insr_pde_tpu_torch.hashgrid_probe [-T 20] [--iters 10000]
        [--networks hashgrid siren] [--host_rng] [--device cuda]

Trains `scripts/advect1D.sh` (-sr 5000, dt 0.05, a 2x20 network, early stop
on) with each `--network` and reports the per-step relative L2 against the
closed form, a constant-velocity advection of the gaussian bump, u(x, t) =
u0(x - vel dt t) (`models/examples.gaussian_like`), and the wall clock per
step. The advection residual is first order, so the hash grid's piecewise
linear interpolation is a fair backbone here (the fluid's Poisson phase
refuses it). SIREN's advect phase is the `advect_fit` kernel
(`csrc/advect_fit.cu`, one launch per chunk); the hash grid's runs the
generic `Solver`. With early stop on, a step's Adam iterations vary: each
record lists them per step (`iters_per_step_run`).

`--host_rng` draws on the CPU and copies the points to the device, so a
card run draws what a CPU run draws. Prints one JSON line per network.
`--device cpu` is for the tests.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from .bench import _sync, device_record


def run_one(network: str, T: int, iters: int, device: str = "cuda",
            host_rng: bool = False) -> dict:
    """T advection steps of `iters` Adam iterations at most, after the init
    fit, with `network`; its record."""
    from .config import Config
    from .models.advection import Advection1DModel
    from .models.examples import gaussian_like
    from .ops.advect_fit import advect_fit

    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(
            pde="advection", proj_dir=tmp, tag=f"hg_{network}",
            init_cond="example1", network=network,
            num_hidden_layers=2, hidden_features=20,
            sample_resolution=5000, vis_resolution=2000,
            max_n_iters=iters, chunk_size=1000, early_stop=True,
            dt=0.05, length=4.0, vel=0.25,
            vis_frequency=10 ** 9, backup_sources=False, device=device,
            host_rng=host_rng)
        cfg.setup_dirs()
        model = Advection1DModel(cfg)
        model.initialize()
        launches0 = advect_fit.launches

        rels, secs, n_iters = [], [], []
        for step in range(1, T + 1):
            _sync(model.device)
            t0 = time.perf_counter()
            res = model.step()
            _sync(model.device)
            secs.append(time.perf_counter() - t0)
            n_iters.append(int(res.n_iters))
            vals, xs = model.sample_field(cfg.vis_resolution,
                                          return_samples=True)
            ref = gaussian_like(xs - cfg.vel * cfg.dt * step, mu=-1.5)
            rels.append(float(torch.linalg.norm(vals - ref)
                              / torch.linalg.norm(ref)))
        return {
            "network": network, "T": T, "iters_per_step": iters,
            "rel_l2_first": rels[0], "rel_l2_last": rels[-1],
            "rel_l2_max": max(rels),
            "sec_per_step_median": float(np.median(secs)),
            "sec_first_step": secs[0],
            "rel_l2_per_step": rels,
            "iters_per_step_run": n_iters,
            "init_iters": model.phase_timings[0]["n_iters"],
            "route": ("advect_fit" if model.advect_solver is not None
                      else "solver"),
            "advect_fit_launches": advect_fit.launches - launches0,
        }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("hashgrid_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("-T", type=int, default=20)
    ap.add_argument("--iters", type=int, default=10000)
    ap.add_argument("--networks", nargs="+", default=["hashgrid", "siren"])
    ap.add_argument("--host_rng", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def main(argv=None) -> list:
    """Runs the probe; returns the printed records."""
    args = parser().parse_args(argv)
    from .ops.precision import resolve_device, set_full_precision
    device = resolve_device(args.device)
    set_full_precision()
    info = device_record(device)
    records = []
    for net in args.networks:
        rec = {**run_one(net, args.T, args.iters, args.device,
                         args.host_rng), "device": info}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
