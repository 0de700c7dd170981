"""Vortex space-time RBF least-squares driver (counterpart of the repo's
`starterL.py`).

    python -m insr_pde_tpu_torch vortex [--preset channel] <the flags of
        starterL.py> [--device cpu]

The same flags, defaults, presets and stream/velocity defaults as
`starterL.py`; each round runs `matrix_solver` (`--mode matrix`, with
`--solver cgls|cg`) or `train(--train_iters)` (`--mode train`), saves the
coefficients and writes the sampled field. Runs on the card (`--device
cuda`, the default) unless asked for the CPU; without a card, cuda raises.
`--host_sync` takes each assembled system through host memory once before
its solve, as the JAX package does. `--seed` is a port addition (the JAX
`starterL.py` keeps `VortexConfig`'s seed, which is the default here too).
`build_model` builds the model of parsed flags as `main` does, for a
caller that runs its Picard iterations itself.

Row-sharded over ranks (`--n_devices`, a port addition: the JAX
`starterL.py` runs its model on one device): `torchrun --standalone
--nproc_per_node 2 -m insr_pde_tpu_torch vortex <flags> --n_devices 2
[--dist_backend gloo]`
assembles and solves each rank's rows of every CGLS system; only rank 0
writes the checkpoint, the field and the log.
"""

from __future__ import annotations

import argparse

from .models.vortex import (StreamVortexModel, VortexConfig, VortexModel,
                            relative_divergence)
from .ops.precision import resolve_device, set_full_precision
from .parallel.mesh import make_group

PRESETS = {
    # The channel-scene configuration (the JAX package's measured fix for
    # the scene the reference's own notebook concedes fails): stream
    # formulation, Shepard-normalized C1 space PoU + indicator time PoU with
    # per-slice windows, value + derivative BC rows, 8x the reference
    # collocation density, block-whitened chunked CGLS with restarts, the
    # whitener reused and each Picard solve warm-started.
    "channel": dict(formulation="stream", pou="smooth", pou_time="simple",
                    time_window=1, band_width=1.0, stream_bc="both",
                    w_bc=5.0, pou_normalize=True, precondition="block",
                    cgls_chunk=200, cgls_restart=True, cgls_maxiter=2000,
                    collocation=8000, boundary=3200,
                    reuse_whitener=True, warm_start=1.0),
}

def parse_args(argv=None):
    ap = argparse.ArgumentParser("insr_pde_tpu_torch vortex")
    ap.add_argument("--preset", choices=[""] + sorted(PRESETS), default="",
                    help="named configuration bundle; explicit flags "
                         "override preset values")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--output_path", type=str, default="./results/vortex")
    ap.add_argument("--log_dir", type=str, default="./log/vortex")
    ap.add_argument("--n_rounds", type=int, default=1,
                    help="outer rounds of matrix_solver + output")
    ap.add_argument("--mode", choices=["matrix", "train"], default="matrix")
    ap.add_argument("--solver", choices=["cgls", "cg"], default="cgls")
    ap.add_argument("--pou", choices=["simple", "hat", "smooth", "smooth2"],
                    default=None,
                    help="default: 'simple' for the velocity formulation, "
                         "'smooth' for stream")
    ap.add_argument("--formulation", choices=["velocity", "stream"],
                    default="velocity")
    ap.add_argument("--train_iters", type=int, default=200)
    ap.add_argument("--collocation", type=int, default=1000)
    ap.add_argument("--boundary", type=int, default=400)
    ap.add_argument("--time_num", type=int, default=10)
    ap.add_argument("--n_spatial_basis", type=int, default=400)
    ap.add_argument("--picard_iters", type=int, default=3)
    ap.add_argument("--cgls_maxiter", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=VortexConfig.seed,
                    help="seed of the CPU generator that draws the random "
                         "basis and the points")
    ap.add_argument("--cgls_chunk", type=int, default=0,
                    help=">0: CGLS in chunks of this many iterations, the "
                         "host reading the state between chunks")
    ap.add_argument("--cgls_restart", action="store_true",
                    help="with --cgls_chunk: restart each chunk from the "
                         "best iterate")
    ap.add_argument("--host_sync", action="store_true",
                    help="take each assembled system through host memory "
                         "once before its solve")
    ap.add_argument("--n_devices", type=int, default=0,
                    help="ranks to shard each system's rows over: 0 = every "
                         "rank of the launch (torchrun), else its world size")
    ap.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                    help="torch.distributed backend of a sharded run "
                         "(default: nccl on the card, gloo on the CPU)")
    ap.add_argument("--rho", type=float, default=1000.0)
    ap.add_argument("--internal_v", type=float, default=8.0)
    ap.add_argument("--stream_bc", choices=["value", "derivative", "both"],
                    default="value")
    ap.add_argument("--pou_time", type=str, default="")
    ap.add_argument("--time_window", type=int, default=2)
    ap.add_argument("--pou_normalize", action="store_true")
    ap.add_argument("--precondition", choices=["auto", "on", "off", "block"],
                    default="auto")
    ap.add_argument("--band_width", type=float, default=None,
                    help="default: 10 velocity form, 1 stream form")
    ap.add_argument("--w_bc", type=float, default=None,
                    help="default: 1 velocity form, 5 stream form")
    ap.add_argument("--cgls_damp", type=float, default=None,
                    help="default: 0.01 for a continuous-PoU velocity form, "
                         "else 0")
    ap.add_argument("--outlet_v", action="store_true")
    ap.add_argument("--reuse_whitener", action="store_true")
    ap.add_argument("--warm_start", type=float, default=None,
                    help="default 0.0 (cold start per Picard solve)")
    ap.add_argument("--rmv_gather", action="store_true")
    ap.add_argument("--packed_vals", action=argparse.BooleanOptionalAction,
                    default=None)
    ap.add_argument("--ckpt_path", type=str, default="",
                    help="default <output_path>/vortex_ckpt.npz; 'none' "
                         "disables")
    ap.add_argument("--resume", type=str, default="",
                    help="load a vortex_ckpt.npz before solving")
    # preset values become parser defaults so explicit flags override them
    pre, _ = ap.parse_known_args(argv)
    if pre.preset:
        ap.set_defaults(**PRESETS[pre.preset])
    return ap.parse_args(argv)


def build_config(args) -> VortexConfig:
    """The VortexConfig of parsed flags, with starterL.py's stream/velocity
    defaults."""
    if args.formulation == "stream":
        pou = args.pou if args.pou is not None else "smooth"
        if pou == "simple":
            print("warning: --pou simple with --formulation stream gives a "
                  "discontinuous velocity (u = grad psi across indicator-"
                  "PoU cell edges); 'smooth' is the supported default.")
        damp = args.cgls_damp if args.cgls_damp is not None else 0.0
        bw = args.band_width if args.band_width is not None else 1.0
        w_bc = args.w_bc if args.w_bc is not None else 5.0
    else:
        pou = args.pou if args.pou is not None else "simple"
        damp = (args.cgls_damp if args.cgls_damp is not None
                else 0.01 if pou in ("hat", "smooth", "smooth2") else 0.0)
        bw = args.band_width if args.band_width is not None else 10.0
        w_bc = args.w_bc if args.w_bc is not None else 1.0
    return VortexConfig(
        rho=args.rho, internal_v=args.internal_v,
        collocation_pts_num=args.collocation, boundary_num=args.boundary,
        time_num=args.time_num, n_spatial_basis=args.n_spatial_basis,
        picard_iters=args.picard_iters, cgls_maxiter=args.cgls_maxiter,
        seed=args.seed,
        cgls_chunk=args.cgls_chunk, cgls_restart=args.cgls_restart,
        pou=pou, cgls_damp=damp, band_width=bw, w_bc=w_bc,
        pou_time=args.pou_time, time_window=args.time_window,
        pou_normalize=args.pou_normalize,
        cgls_precondition=args.precondition, outlet_v=args.outlet_v,
        rmv_gather=args.rmv_gather, reuse_whitener=args.reuse_whitener,
        packed_vals=bool(args.packed_vals),
        warm_start=(args.warm_start if args.warm_start is not None else 0.0),
        stream_bc=args.stream_bc, log_dir=args.log_dir,
        host_sync=args.host_sync)


def build_model(args):
    """The model of parsed flags, as the entry point builds it: the config,
    the rank group, full precision, then the formulation's model (its basis
    and points drawn from `--seed`), loaded from `--resume` where given."""
    cfg = build_config(args)
    group = make_group(args.n_devices, args.dist_backend, args.device)
    device = resolve_device(args.device)
    set_full_precision()
    cls = StreamVortexModel if args.formulation == "stream" else VortexModel
    model = cls(cfg, device=device, group=group)
    if args.resume:
        model.load_ckpt(args.resume)
        if model.is_main:
            print(f"resumed coefficients from {args.resume}")
    return model


def main(argv=None):
    """Run the driver; returns the solved model."""
    args = parse_args(argv)
    model = build_model(args)
    main_rank = model.is_main
    ckpt_path = args.ckpt_path or f"{args.output_path}/vortex_ckpt.npz"

    for r in range(args.n_rounds):
        if main_rank:
            print(f"round: {r}")
        if args.mode == "matrix":
            res = model.matrix_solver(solver=args.solver)
            if main_rank:
                print(f"  lstsq residual: {res:.4e}")
        else:
            loss = model.train(args.train_iters)
            if main_rank:
                print(f"  train loss: {loss:.4e}")
        if not main_rank:
            continue
        if ckpt_path != "none":
            model.save_ckpt(ckpt_path)
        model.write_output(args.output_path)

    if args.formulation == "velocity" and main_rank:
        rdiv = relative_divergence(model)
        if rdiv > 0.1:
            print(f"note: relative divergence {rdiv:.2f} — the velocity "
                  "formulation (reference parity) cannot represent an "
                  "incompressible field on this scene. `--preset channel` "
                  "is the JAX package's measured fix (stream function + "
                  "normalized C1 PoU + 8x density; COMPARISON.md).")
    return model
