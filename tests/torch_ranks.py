"""Rank bodies of the port's multi-process tests (`tests/test_torch_*.py`).

`insr_pde_tpu_torch.parallel.launch` spawns each rank and imports its body
by name, so the bodies live here, in a module that imports only torch,
numpy and the port (the test files also import JAX). Each body joins the
launched group through `make_group`, as the entry points do, and returns
a dict of numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from insr_pde_tpu_torch.convert import fields_from_jax, rbf_params_from_jax
from insr_pde_tpu_torch.models import vortex as tv
from insr_pde_tpu_torch.models.solver import Solver, ravel
from insr_pde_tpu_torch.ops import linalg as tl
from insr_pde_tpu_torch.parallel import (broadcast, make_group, pmax, pmean,
                                         psum)

QUAD_TARGET = (1.0, -2.0, 3.0)


def quadratic_loss(params, points, aux):
    """The deterministic strongly convex loss of tests/test_solver.py."""
    target = torch.tensor(QUAD_TARGET)
    return {"main": torch.sum((params["p"] - target) ** 2)}


def quadratic_fit(n_iters: int):
    """A fit of `quadratic_loss` from zeros on every rank."""
    group = make_group(0, device="cpu")
    solver = Solver(quadratic_loss, lambda: {}, lr=0.1, max_n_iters=n_iters,
                    chunk_size=100, early_stop=False, group=group)
    res = solver.fit({"p": torch.zeros(3)})
    return {"params": res.params["p"].numpy(),
            "main": res.history["main"]}


def collectives(n_devices: int = 0):
    """Each collective on rank-dependent values."""
    group = make_group(n_devices, device="cpu")
    r = torch.tensor([float(group.rank + 1), -float(group.rank)])
    return {"psum": psum(r, group).numpy(), "pmean": pmean(r, group).numpy(),
            "pmax": pmax(r, group).numpy(),
            "broadcast": broadcast(r * 10, group).numpy(),
            "rank": np.asarray(group.rank), "size": np.asarray(group.size)}


def fail_on_rank_one():
    group = make_group(0, device="cpu")
    if group.rank == 1:
        raise ValueError("rank one fails on purpose")
    return {}


def sleep_past_deadline():
    import time
    make_group(0, device="cpu")
    time.sleep(120)


def loss_grad(pde: str, cfg_kw: dict, fields: dict, loss: str, field: str,
              aux_fields: dict, aux_consts: dict, points: list):
    """The reduced loss dict and flat gradient of a model's loss at `field`,
    each rank on its own `points[rank]`."""
    from insr_pde_tpu_torch.__main__ import build_model
    from insr_pde_tpu_torch.config import Config

    group = make_group(0, device="cpu")
    model = build_model(Config(device="cpu", **cfg_kw), group)
    model.fields = fields_from_jax(fields)
    aux = {k: model.fields[v] for k, v in aux_fields.items()}
    aux.update(aux_consts)
    solver = Solver(getattr(model, loss), None, lr=1e-4, max_n_iters=1,
                    group=group)
    flat, spec = ravel(model.fields[field])
    pts = {k: torch.from_numpy(v) for k, v in points[group.rank].items()}
    ld, grad = solver.value_and_grad(flat, spec, pts, aux)
    return {**{f"loss_{k}": v.numpy() for k, v in ld.items()},
            "grad": grad.numpy()}


def run_cli(argv: list):
    """The port's training entry point on this rank."""
    from insr_pde_tpu_torch.__main__ import main
    main(argv)
    return {}


def _op(vals, cols, n_blocks):
    return tl.BlockSparse(torch.from_numpy(vals), torch.from_numpy(cols),
                          n_blocks)


def shard_rows(A: tl.BlockSparse, b: torch.Tensor, rank: int, world: int):
    """Rank `rank`'s contiguous row shard of (A, b) after padding the rows
    to a multiple of `world` with zero rows (value 0, column 0, rhs 0:
    inert for least squares), as the JAX package pads a sharded solve."""
    R = A.vals.shape[0]
    per = -(-R // world)
    lo, hi = min(rank * per, R), min((rank + 1) * per, R)

    def rows(t):
        pad = t.new_zeros((per - (hi - lo),) + tuple(t.shape[1:]))
        return torch.cat([t[lo:hi], pad])

    return tl.BlockSparse(rows(A.vals), rows(A.cols), A.n_blocks), rows(b)


def sharded_cgls(vals, cols, n_blocks, b, cases: dict):
    """Each case of `cases` (name -> keyword arguments of
    `cgls_sparse_chunked`; "unchunked": True is the JAX package's
    `cgls_sparse_sharded`, one unpreconditioned loop) on this rank's row
    shard of the whole (A, b), plus the whole operator's block Gram summed
    from the shards."""
    group = make_group(0, device="cpu")
    A, b_r = shard_rows(_op(vals, cols, n_blocks), torch.from_numpy(b),
                        group.rank, group.size)
    x0 = torch.zeros(A.n_cols)
    out = {"gram": psum(tl.block_gram(A), group).numpy(),
           "rows": A.vals.numpy(), "b": b_r.numpy()}
    for name, kw in cases.items():
        kw = dict(kw)
        if kw.pop("unchunked", False):
            kw["precondition"] = False
        x, info = tl.cgls_sparse_chunked(A, b_r, x0, group=group, **kw)
        out[name] = x.numpy()
        out[f"{name}_niter"] = np.asarray(info["niter"])
    return out


def _vortex_model(kind, cfg_kw, params, points, group):
    cls = tv.StreamVortexModel if kind == "stream" else tv.VortexModel
    return cls(tv.VortexConfig(**cfg_kw), log=False, device="cpu",
               params=rbf_params_from_jax(params), points=points,
               group=group)


def vortex_assemble(kind, cfg_kw, params, points, u, x):
    """This rank's rows of the system around u (`assemble` on the group),
    and the whole system's normal-equation products A^T A x and A^T b from
    the shards."""
    group = make_group(0, device="cpu")
    m = _vortex_model(kind, cfg_kw, params, points, group)
    A, b = m.assemble(torch.from_numpy(u), group=group)
    xt = torch.from_numpy(x)
    return {"vals": A.vals.numpy(), "cols": A.cols.numpy(), "b": b.numpy(),
            "row_slots": A.row_slots.numpy(),
            "AtAx": psum(A.rmv(A.mv(xt)), group).numpy(),
            "Atb": psum(A.rmv(b), group).numpy()}


def vortex_solve(kind, cfg_kw, params, points):
    """`matrix_solver` on the group's ranks."""
    group = make_group(0, device="cpu")
    m = _vortex_model(kind, cfg_kw, params, points, group)
    res = m.matrix_solver()
    return {"u": m.params.u.numpy(), "res": np.asarray(res),
            "iters": np.asarray([t["cgls_iters"] for t in m.picard_timings])}


def run_vortex_cli(argv: list):
    """The port's vortex entry point on this rank."""
    from insr_pde_tpu_torch.starterL import main
    m = main(argv)
    return {"u": m.params.u.numpy()}

