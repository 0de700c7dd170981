"""The f64 least-squares truth of the port's vortex solves (counterpart of
`tools/vortex_truth.py`).

    python -m insr_pde_tpu_torch.vortex_truth [--formulation stream]
        [--n_spatial_basis 100 --time_num 4 --collocation 250
         --boundary 120 --rho 1 --internal_v 2 ...] [--device cpu]
    python -m insr_pde_tpu_torch.vortex_truth --scene starterL
        --lsqr_precondition block --lsqr_start rows

Assembles one Picard system (BlockSparse A, rhs b) around the model's
init coefficients and solves the same damped least-squares problem with
scipy's LSQR in float64 at a large iteration budget: the true minimizer,
independent of the port's CGLS and CG. Then it measures each answer, the
f64 one and the f32 ones of `matrix_solver("cgls")` and
`matrix_solver("cg")`, by |A x - b| recomputed in f64 on the same system,
the inlet error and the per-block rms (`block_residuals`), and prints each
f32 answer's gap to the f64 one. No answer can have a smaller residual
than the least-squares minimizer: one that does means that the operator
or the yardstick is wrong, or that LSQR stopped short (`istop` 7: the
iteration limit).

`--lsqr_precondition none` (the default) is the JAX tool's LSQR on A.
These systems' condition numbers reach 1e8-1e9, where that LSQR stops at
the limit far from the minimum; `block` runs LSQR on A P (x = P y, the
same undamped problem) with P from the eigendecomposition of each block
column's float64 Gram, computed here, apart from the f32 solvers'
preconditioners. At starterL's defaults
(35,600 x 192,000) even the block-preconditioned LSQR stops at its
iteration limit; `--lsqr_start rows` starts it from the minimum-norm
solution of the dense float64 row Gram's Cholesky factorization (systems
with more columns than rows), and LSQR's own stop test holds that start to
its tolerance.

The products of A: on the CPU over a scipy CSR copy (`to_csr`), as the
JAX tool does; on the card the plain block-ELL versions on an f64 copy of
the values on the card (`lsq_operator`; host CSR products at starterL's
defaults take tens of ms each). This is a yardstick: the f32 kernels and
the precision policy are untouched. Systems with more columns than rows
have many minimizers, so answers are compared by residual, inlet error and
blocks, never by x.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .models.vortex import (StreamVortexModel, VortexConfig, VortexModel,
                            inlet_error)
from .ops.block_ell import block_ell_mv_reference, block_ell_rmv_reference
from .ops.precision import resolve_device, set_full_precision


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def to_csr(A, b):
    """A block-ELL operator (vals (R, S, J), block cols (R, S); a
    `PaddedSparse` is J = 1) and b -> (scipy CSR float64, b float64), the
    scalar column of slot s, feature j being cols[r, s] * J + j."""
    import scipy.sparse as sp
    vals = A.vals.detach().cpu().numpy().astype(np.float64)
    R, S, J = vals.shape
    cols = (A.cols.cpu().numpy().astype(np.int64)[:, :, None] * J
            + np.arange(J)[None, None, :])
    indptr = np.arange(R + 1) * (S * J)
    csr = sp.csr_matrix((vals.reshape(-1), cols.reshape(-1), indptr),
                        shape=(R, A.n_cols))
    return csr, b.detach().cpu().numpy().astype(np.float64)


def _products(A):
    """(A x, A^T r) on float64 tensors on A's device: over a scipy CSR copy
    on the CPU, the plain block-ELL versions on an f64 copy of the values
    on the card."""
    if not A.vals.is_cuda:
        csr = to_csr(A, torch.zeros(0))[0]
        return (lambda x: torch.from_numpy(csr @ x.numpy()),
                lambda r: torch.from_numpy(csr.T @ r.numpy()))
    vals = A.vals.double()
    return (lambda x: block_ell_mv_reference(vals, A.cols, x),
            lambda r: block_ell_rmv_reference(vals, A.cols, r, A.n_blocks))


def block_whitener64(A, slot_chunk: int = 65536):
    """Per block column k, W_k = U diag(lambda^-1/2) from the
    eigendecomposition of its float64 Gram A_k^T A_k (eigenvalues below
    1e-12 of the block's largest get 0): (n_blocks, J, J). The Grams are
    summed over `slot_chunk` slots at a time."""
    J = A.vals.shape[-1]
    V = A.vals.double().reshape(-1, J)
    ids = A.cols.reshape(-1).long()
    G = torch.zeros((A.n_blocks, J, J), dtype=torch.float64,
                    device=V.device)
    for i in range(0, V.shape[0], slot_chunk):
        v = V[i:i + slot_chunk]
        G.index_add_(0, ids[i:i + slot_chunk], v[:, :, None] * v[:, None, :])
    lam, U = torch.linalg.eigh(G)
    keep = lam > 1e-12 * lam[:, -1:].clamp_min(1e-300)
    inv = torch.where(keep, torch.where(keep, lam, 1.0).rsqrt(), 0.0)
    return U * inv[:, None, :]


def lsq_operator(A, W=None):
    """A, or A P with P the block-diagonal right preconditioner of blocks
    W (`block_whitener64`), as a scipy `LinearOperator` on float64
    vectors, with `to_x(y)` = P y (the identity without W): each vector
    crosses to A's device and back once per product. Returns (operator,
    to_x)."""
    from scipy.sparse.linalg import LinearOperator
    mv, rmv = _products(A)
    if W is None:
        P = Pt = (lambda v: v)
    else:
        nb, J = W.shape[:2]

        def P(y):
            return torch.einsum("kij,kj->ki", W, y.reshape(nb, J)).reshape(-1)

        def Pt(g):
            return torch.einsum("kij,ki->kj", W, g.reshape(nb, J)).reshape(-1)
    dev = A.vals.device

    def host_fn(fn):
        def apply(v):
            t = torch.from_numpy(np.ascontiguousarray(v, np.float64).ravel())
            return fn(t.to(dev)).cpu().numpy()
        return apply

    op = LinearOperator((A.vals.shape[0], A.n_cols),
                        matvec=host_fn(lambda y: mv(P(y))),
                        rmatvec=host_fn(lambda r: Pt(rmv(r))),
                        dtype=np.float64)
    return op, host_fn(P)


def row_gram_start(A, b, W=None, refine: int = 3):
    """y0, the minimum-norm solution of A P y = b (P of blocks W, the
    identity without), from the float64 Cholesky factorization of the
    dense row Gram G = (A P)(A P)^T on A's device, then `refine` steps of
    iterative refinement (y += (A P)^T G^-1 (b - A P y), the residual in
    float64 on the host): rows^2 floats, for systems with more columns
    than rows and at most a few 10^4 rows (10 GB at starterL's defaults).
    Raises where G is not positive definite in float64 (dependent
    rows)."""
    import scipy.sparse as sp
    csr, b64 = to_csr(A, b)
    if W is not None:
        w = W.cpu().numpy()
        nb, J, _ = w.shape
        k, i, j = np.meshgrid(np.arange(nb), np.arange(J), np.arange(J),
                              indexing="ij")
        P = sp.csr_matrix((w.ravel(), ((k * J + i).ravel(),
                                       (k * J + j).ravel())),
                          shape=(nb * J, nb * J))
        csr = (csr @ P).tocsr()
    dev = A.vals.device
    G = torch.from_numpy((csr @ csr.T).toarray()).to(dev)
    L, info = torch.linalg.cholesky_ex(G)
    del G
    if int(info):
        raise RuntimeError(f"the row Gram of the system is not positive "
                           f"definite in float64 (leading minor "
                           f"{int(info)}): its rows are dependent")
    y = np.zeros(csr.shape[1])
    r = b64
    for _ in range(refine + 1):
        z = torch.cholesky_solve(torch.from_numpy(r)[:, None].to(dev), L)
        y = y + csr.T @ z[:, 0].cpu().numpy()
        r = b64 - csr @ y
    return y


def residual64(A, b, x) -> float:
    """|A x - b| in float64 on A's device, x any float array."""
    x = torch.as_tensor(np.asarray(x, np.float64).ravel(),
                        device=A.vals.device)
    r = block_ell_mv_reference(A.vals.double(), A.cols, x) - b.double()
    return float(torch.linalg.norm(r))


def lsqr_truth(model, iters: int = 40000, damp: float = 0.0, system=None,
               precondition: str = "none", start: str = "zero"):
    """scipy LSQR (float64, atol = btol = 1e-10, at most `iters`
    iterations) on `system` (A, b), by default the model's system
    assembled around its current coefficients. `precondition` "none" is
    the JAX tool's LSQR on A; "block" (undamped only) runs it on A P, x =
    P y: the same least-squares problem, in far fewer iterations on these
    systems (condition numbers ~1e8 and more), P from float64 block Grams
    computed here, apart from the f32 solvers' preconditioners. `start` "rows" (undamped only) starts LSQR
    from `row_gram_start`'s direct solution instead of 0; LSQR's own stop
    test (istop 1: |r| <= btol |b| + atol |A| |x|) then holds that answer
    to the same standard. Returns {"x64", "istop", "itn", "r1norm",
    "sec", "start_residual64"}."""
    import scipy.sparse.linalg as spl
    A, b = system if system is not None else model.assemble(model.params.u)
    if damp != 0.0 and (precondition != "none" or start != "zero"):
        raise ValueError("a preconditioner or a start changes a damped "
                         "problem; damp must be 0")
    if start not in ("zero", "rows"):
        raise ValueError(f"start must be zero or rows, got {start!r}")
    t0 = time.perf_counter()
    if precondition not in ("none", "block"):
        raise ValueError(f"precondition must be none or block, got "
                         f"{precondition!r}")
    W = None if precondition == "none" else block_whitener64(A)
    op, to_x = lsq_operator(A, W)
    y0 = row_gram_start(A, b, W) if start == "rows" else None
    start_res = (residual64(A, b, to_x(y0)) if y0 is not None
                 else float(torch.linalg.norm(b.double())))
    t1 = time.perf_counter()
    out = spl.lsqr(op, b.double().cpu().numpy(), damp=damp, iter_lim=iters,
                   atol=1e-10, btol=1e-10, x0=y0)
    return {"x64": to_x(out[0]), "istop": int(out[1]), "itn": int(out[2]),
            "r1norm": float(out[3]), "sec": time.perf_counter() - t0,
            "start_sec": t1 - t0, "start_residual64": start_res}


def set_coefficients(model, x):
    """The model's coefficients u set to the flat answer x (as f32)."""
    u = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                        device=model.params.u.device)
    model.params = model.params._replace(u=u.reshape(model.params.u.shape))


def measure(model, x, system) -> dict:
    """An answer x of `system`: |A x - b| in f64, the inlet error and the
    per-block rms of the model at u = x."""
    set_coefficients(model, x)
    return {"residual64": residual64(*system, x),
            "inlet_error": inlet_error(model),
            "blocks": {k: v["rms"]
                       for k, v in model.block_residuals().items()}}


def f32_solve(model, u0, solver: str = "cgls", precondition=None):
    """One Picard solve from the coefficients u0 (`matrix_solver(solver)`,
    picard_iters 1) with the model's f32 path, optionally with another
    `cgls_precondition`; returns (flat x as numpy, its iterations)."""
    cfg = model.cfg
    over = {"picard_iters": 1}
    if precondition is not None:
        over["cgls_precondition"] = precondition
    model.cfg = dataclasses.replace(cfg, **over)
    try:
        model.params = model.params._replace(u=u0.clone())
        model.matrix_solver(solver=solver)
        iters = model.picard_timings[-1]["cgls_iters"]
        return model.params.u.reshape(-1).cpu().numpy(), iters
    finally:
        model.cfg = cfg


def gaps(rec, truth) -> dict:
    """Relative gaps of an answer's measures to the f64 answer's."""
    def rel(a, b):
        return (a - b) / max(abs(b), 1e-30)
    return {"residual64": rel(rec["residual64"], truth["residual64"]),
            "inlet_error": rel(rec["inlet_error"], truth["inlet_error"]),
            "blocks": max(abs(rel(rec["blocks"][k], v))
                          for k, v in truth["blocks"].items()
                          if abs(v) > 1e-6 * max(truth["blocks"].values()))}


def build_model(args):
    """The JAX tool's scene at the flags (`formulation` stream or
    velocity), or with `--scene starterL` the system of starterL.py's
    defaults (velocity formulation, indicator PoU; the other scene flags
    unused), picard_iters 1, on `args.device`."""
    device = resolve_device(args.device)
    if args.scene == "starterL":
        from .starterL import build_config, parse_args
        cfg = build_config(parse_args(["--picard_iters", "1", "--log_dir",
                                       args.log_dir]))
        return VortexModel(cfg, log=False, device=device)
    cfg = VortexConfig(
        rho=args.rho, internal_v=args.internal_v,
        n_spatial_basis=args.n_spatial_basis, time_num=args.time_num,
        collocation_pts_num=args.collocation, boundary_num=args.boundary,
        picard_iters=1, cgls_maxiter=args.cgls_maxiter, pou="smooth",
        cgls_damp=args.damp,
        cgls_precondition="on" if args.damp > 0 else "auto",
        band_width=args.band_width, w_bc=args.w_bc,
        stream_bc=args.stream_bc, log_dir=args.log_dir)
    cls = StreamVortexModel if args.formulation == "stream" else VortexModel
    return cls(cfg, log=False, device=device)


def run(model, lsqr_iters: int, damp: float, solvers=("cgls", "cg"),
        lsqr_precondition: str = "none", lsqr_start: str = "zero"):
    """Assemble around the model's coefficients, then the f64 truth
    (`lsqr_truth`) and each f32 `solvers` answer (a name, or (name,
    precondition)), each measured; returns {"system", "lsqr64", <solver>:
    {..., "gap"}}."""
    u0 = model.params.u.clone()
    system = model.assemble(u0)
    A, b = system
    rec = {"system": {"rows": int(A.vals.shape[0]), "cols": int(A.n_cols),
                      "b_norm": float(torch.linalg.norm(b.double()))}}
    log(f"system: {A.vals.shape[0]} x {A.n_cols}, |b| = "
        f"{rec['system']['b_norm']:.4e}; LSQR (float64, damp={damp}, "
        f"precondition {lsqr_precondition}, start {lsqr_start}, "
        f"iters<={lsqr_iters}) ...")
    truth = lsqr_truth(model, lsqr_iters, damp, system, lsqr_precondition,
                       lsqr_start)
    rec["lsqr64"] = {**measure(model, truth["x64"], system),
                     **{k: truth[k] for k in ("istop", "itn", "r1norm",
                                              "sec", "start_sec",
                                              "start_residual64")}}
    log(f"LSQR: start |Ax-b| {truth['start_residual64']:.6e} "
        f"({truth['start_sec']:.1f}s), istop "
        f"{truth['istop']}, {truth['itn']} iterations, "
        f"{truth['sec']:.1f}s, |Ax-b| {rec['lsqr64']['residual64']:.6e}, "
        f"inlet {rec['lsqr64']['inlet_error']:.4e}")
    for spec in solvers:
        name, precond = (spec, None) if isinstance(spec, str) else spec
        tag = name if precond is None else f"{name}_{precond}"
        t0 = time.perf_counter()
        x, iters = f32_solve(model, u0, name, precond)
        sec = time.perf_counter() - t0
        r = measure(model, x, system)
        r.update(iters=int(iters), sec=sec, gap=gaps(r, rec["lsqr64"]))
        rec[tag] = r
        log(f"{tag} (f32, {iters} iterations, {sec:.1f}s): |Ax-b| "
            f"{r['residual64']:.6e} ({r['gap']['residual64']:+.3e} of the "
            f"f64 answer's), inlet {r['inlet_error']:.4e} "
            f"({r['gap']['inlet_error']:+.3e}), largest block gap "
            f"{r['gap']['blocks']:.3e}")
    set_coefficients(model, u0.reshape(-1).cpu().numpy())
    return rec


def parser():
    ap = argparse.ArgumentParser("insr_pde_tpu_torch.vortex_truth")
    ap.add_argument("--scene", choices=["jax_tool", "starterL"],
                    default="jax_tool",
                    help="starterL: the system of starterL.py's defaults "
                         "(35,600 x 192,000), as chip_smoke.py solves it")
    ap.add_argument("--formulation", choices=["stream", "velocity"],
                    default="stream")
    ap.add_argument("--n_spatial_basis", type=int, default=100)
    ap.add_argument("--time_num", type=int, default=4)
    ap.add_argument("--collocation", type=int, default=250)
    ap.add_argument("--boundary", type=int, default=120)
    ap.add_argument("--rho", type=float, default=1.0)
    ap.add_argument("--internal_v", type=float, default=2.0)
    ap.add_argument("--damp", type=float, default=0.0)
    ap.add_argument("--w_bc", type=float, default=5.0)
    ap.add_argument("--band_width", type=float, default=1.0)
    ap.add_argument("--lsqr_iters", type=int, default=40000)
    ap.add_argument("--lsqr_precondition", default="none",
                    choices=["none", "block"],
                    help="none: the JAX tool's LSQR on A; block: on A P "
                         "(undamped), P the f64 block whitener")
    ap.add_argument("--lsqr_start", default="zero", choices=["zero", "rows"],
                    help="rows: start LSQR from the dense f64 row-Gram "
                         "solution (undamped; systems with more columns "
                         "than rows)")
    ap.add_argument("--cgls_maxiter", type=int, default=2000)
    ap.add_argument("--stream_bc", choices=["value", "derivative", "both"],
                    default="value")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--log_dir", type=str, default="./log/vortex_truth")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    set_full_precision()
    model = build_model(args)
    rec = run(model, args.lsqr_iters, args.damp,
              lsqr_precondition=args.lsqr_precondition,
              lsqr_start=args.lsqr_start)
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "x64"}
                      for k, v in rec.items()}))
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
