"""The vortex Adam path at the reference scale, against the matrix path
(counterpart of `tools/vortex_train_probe.py`).

    python -m insr_pde_tpu_torch.vortex_train_probe [--train_iters 4000]
        [--lr 0.1] [--lr_min LR] [--segment 250] [--compare_matrix]
        [--device cuda]

The reference ships two vortex solves: the linear least-squares solve
(starterL.py, the matrix path) and a plain Adam loop on the same residuals
(`VortexModel.train`). This probe runs the Adam path at the matrix path's
scale (400 sites x 10 slices, 1,000 + 400 points a slice) and prints the
loss per segment of `--segment` iterations (a host read of the loss ends
each), the wall clock per iteration, and each residual block's RMS
(`block_residuals`). `--lr_min` decays the step from `--lr` to it along a
cosine over the iteration budget (`solver.cosine_decay_schedule`, the JAX
tool's `optax.cosine_decay_schedule`). `--compare_matrix` then runs 3
Picard iterations of the matrix path (block-ELL CGLS, `csrc/block_ell.cu`)
on a second model with the same draws and prints its block RMS and the
ratio of the two. `--device cpu` is for the tests.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

from .bench import _sync, device_record


def config(args, log_dir: str):
    from .models.vortex import VortexConfig
    return VortexConfig(
        rho=1000.0, internal_v=8.0,
        n_spatial_basis=args.n_spatial_basis, time_num=args.time_num,
        collocation_pts_num=args.collocation, boundary_num=args.boundary,
        cgls_chunk=args.cgls_chunk, cgls_restart=bool(args.cgls_chunk),
        train_lr=args.lr, log_dir=log_dir)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("vortex_train_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--train_iters", type=int, default=4000)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--lr_min", type=float, default=None,
                    help="if set, cosine-decay the lr from --lr to this "
                         "over the iteration budget")
    ap.add_argument("--segment", type=int, default=250)
    ap.add_argument("--n_spatial_basis", type=int, default=400)
    ap.add_argument("--time_num", type=int, default=10)
    ap.add_argument("--collocation", type=int, default=1000)
    ap.add_argument("--boundary", type=int, default=400)
    ap.add_argument("--compare_matrix", action="store_true")
    ap.add_argument("--cgls_chunk", type=int, default=500)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def main(argv=None) -> list:
    """Runs the probe; returns the printed records."""
    args = parser().parse_args(argv)
    from .models.solver import cosine_decay_schedule
    from .models.vortex import VortexModel
    from .ops.precision import resolve_device, set_full_precision
    device = resolve_device(args.device)
    set_full_precision()
    info = device_record(device)
    records = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        records.append(rec)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = config(args, tmp)
        model = VortexModel(cfg, log=False, device=device)
        if args.lr_min is not None:
            model.lr_schedule = cosine_decay_schedule(
                args.lr, args.train_iters, alpha=args.lr_min / args.lr)

        t_start = time.time()
        done = 0
        while done < args.train_iters:
            n = min(args.segment, args.train_iters - done)
            t0 = time.time()
            loss = model.train(n)  # returns float(loss): a host read
            done += n
            emit({"iters": done, "loss": loss,
                  "sec_per_iter": (time.time() - t0) / n})
        train_wall = time.time() - t_start
        train_blocks = {k: d["rms"]
                        for k, d in model.block_residuals().items()}
        emit({"path": "train", "iters": args.train_iters, "lr": args.lr,
              "lr_min": args.lr_min, "wall_s": train_wall,
              "block_rms": train_blocks, "device": info})

        if args.compare_matrix:
            m2 = VortexModel(cfg, log=False, device=device)
            _sync(device)
            t0 = time.time()
            for _ in range(3):
                res = m2.matrix_solver()
            _sync(device)
            matrix_wall = time.time() - t0
            matrix_blocks = {k: d["rms"]
                             for k, d in m2.block_residuals().items()}
            emit({"path": "matrix", "picard_iters": 3,
                  "lstsq_residual": float(res), "wall_s": matrix_wall,
                  "block_rms": matrix_blocks, "device": info})
            emit({"train_over_matrix_rms": {
                k: (train_blocks[k] / matrix_blocks[k]
                    if matrix_blocks[k] > 1e-9 else None)
                for k in train_blocks}})
    return records


if __name__ == "__main__":
    main()
