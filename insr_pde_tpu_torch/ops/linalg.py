"""Matrix-free least squares over block-ELL operators (counterpart of the
single-device part of `insr_pde_tpu/ops/linalg.py`).

* `cg_batch`: batched preconditioned CG on (K, n, m) systems, and
  `cg_solve`, its `autograd.Function` whose backward solves with the same
  operator; the vortex model's `solver="cg"` runs it on the explicit normal
  equations.
* `cgls`: damped CGLS with the best-iterate guard, the 1e4 * best_phi
  divergence stop and an optional restart of each chunk from the best
  iterate; `cgls_sparse_chunked` runs it on a `BlockSparse` operator with
  Jacobi column scaling or the per-site-block eigen-whitener, and
  `cgls_sparse` / `cgls_block_precond` are its long-loop forms (the JAX
  package's entry points of those names).
* `PaddedSparse` (scalar ELL) and `BlockSparse` (block ELL): on CUDA
  tensors `mv` and `rmv` launch the hand-written kernels of
  `ops/block_ell.py`; on CPU tensors they run their plain versions.
* `block_gram`, `block_whitener_host` (eigendecomposition on the host in
  float64), `_block_apply`, `_prewhiten_x0`.
* Row-sharded over the ranks of a `parallel.mesh.Group`
  (`cgls_sparse_chunked(..., group=)`, the JAX package's
  `cgls_sparse_sharded` and `cgls_sparse_sharded_chunked` in one), on each
  rank's row shard of vals/cols/b: A x is local; A^T r is the local rmv
  kernel followed by a `psum`, and so are the row-space inner products;
  the column-space vectors are replicated and every rank computes them
  identically from reduced values, so the host's stop test between chunks
  takes the same branch on every rank. The whitener's Gram blocks are
  summed over the ranks, rank 0 runs the float64 eigendecomposition and
  broadcasts W.

The JAX package runs each CG and CGLS loop as a `lax.while_loop` that stops
when its condition fails. Here every iteration evaluates that condition on
the device as a flag that freezes the state (the iterates, residuals,
directions, scalars and count keep their values once it is false), and the
host reads the state once per chunk. The iterates and iteration counts are
those of the while loop; the host never waits on the card inside a chunk.
On the card without a group, `cgls_sparse_chunked` issues a chunk's CGLS
iterations as replays of one CUDA graph of `GRAPH_ITERS` iterations,
captured once per solve over static copies of the state (the operator,
preconditioner and right-hand side stay the solve's own tensors); the
replays run the kernels the op-by-op iterations run, in the same order,
and give the same bits. With a group each iteration is issued op by op
(gloo's reductions go through the host).

The JAX package's other operator layouts exist for the TPU: `BlockSparseP`
packs (R, S, J) values as (R, S*J) for its T(8,128) tile padding, which a
contiguous (R, S, J) tensor already is in memory, and
`BlockSparse.rmv_gather` pulls Aᵀ r over a transpose index instead of
XLA's scatter, which the rmv kernel always does. So neither is ported: the
vortex model's `packed_vals` and `rmv_gather` select the one layout here.
`_MATVEC_CHUNK_ELEMS`'s row chunking bounds XLA temporaries the kernels do
not make, and is not ported either.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..parallel.mesh import Group, broadcast, psum
from ..utils import tracing
from . import block_ell
from .block_ell import (TransposeIndex, block_ell_mv, block_ell_rmv,
                        transpose_index, transpose_vals)

# CGLS iterations in one CUDA graph (`cgls_sparse_chunked` on the card); 0
# issues every iteration op by op
GRAPH_ITERS = 25
# the launch counters a graph's capture advances and each replay advances
_COUNTERS = ((block_ell, "mv_launches"), (block_ell, "rmv_launches"))
# per device, the stream CGLS graphs are captured on and the last graph
# captured there: a capture on that stream shares the last graph's memory
# pool, so each solve's graph reuses the blocks of the one before (a pool
# of its own, or another stream, would leave them reserved once the graph
# is gone), and cuBLAS keeps one workspace for the stream
_capture: dict = {}


class BlockSparse:
    """Block-ELL operator: each row holds S dense J-wide coefficient blocks
    addressed by a block-column id; flat column = block * J + j.

    vals (R, S, J) f32, cols (R, S) int32 (padding: val 0, col 0), n_blocks.
    `row_slots` (R,), optional: each row's count of real slots, the rest
    being padding; the transpose index leaves the padding out. The
    transpose index is built at the first `rmv` (or `block_gram`) and kept:
    the sparsity pattern of a model's assembly never changes, so a caller
    may pass one built earlier (`t_index`). On the card the first `rmv`
    also builds `vals_t`, the values in the index's order that the rmv
    kernel streams, kept for every later product of this operator."""

    def __init__(self, vals: torch.Tensor, cols: torch.Tensor, n_blocks: int,
                 row_slots: Optional[torch.Tensor] = None,
                 t_index: Optional[TransposeIndex] = None):
        self.vals, self.cols, self.n_blocks = vals, cols, int(n_blocks)
        self.row_slots = row_slots
        self.t_index = t_index
        self.vals_t: Optional[torch.Tensor] = None

    @property
    def bdim(self) -> int:
        return self.vals.shape[-1]

    @property
    def n_cols(self) -> int:
        return self.n_blocks * self.bdim

    def transpose(self) -> TransposeIndex:
        if self.t_index is None:
            self.t_index = transpose_index(self.cols, self.n_blocks,
                                           self.row_slots)
        return self.t_index

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x, (R,)."""
        return block_ell_mv(self.vals, self.cols, x)

    def transposed_vals(self) -> torch.Tensor:
        if self.vals_t is None:
            self.vals_t = transpose_vals(self.vals, self.transpose())
        return self.vals_t

    def rmv(self, r: torch.Tensor) -> torch.Tensor:
        """A^T @ r, (n_blocks * J,)."""
        if not self.vals.is_cuda:
            return block_ell_rmv(self.vals, self.cols, r, self.n_blocks)
        return block_ell_rmv(self.vals, self.cols, r, self.n_blocks,
                             self.transpose(), self.transposed_vals())

    def col_norms(self, group: Optional[Group] = None) -> torch.Tensor:
        """Column 2-norms (exact where a row addresses a block at most
        once, as the RBF assembly does), (n_blocks * J,); of the whole
        operator when this one is a rank's row shard of it (`group`)."""
        sq = _pull_blocks(self, lambda V: (V * V).sum(1))
        return torch.sqrt(psum(sq.reshape(-1), group))


class PaddedSparse(BlockSparse):
    """ELL-style padded-row sparse matrix: vals (R, nnz) f32, cols (R, nnz)
    int32 (padding: val 0, col 0), n_cols. The block-ELL operator at J = 1,
    so its products run the same kernels."""

    def __init__(self, vals: torch.Tensor, cols: torch.Tensor, n_cols: int):
        super().__init__(vals.unsqueeze(-1), cols, n_cols)


def _pull_blocks(A: BlockSparse, fn: Callable, slot_chunk: int = 65536):
    """fn(V) for the value rows V (n, D, J) of every block column, where
    block b's D rows are the slots addressing it in the transpose index's
    order, zero-padded to the chunk's largest degree. Blocks are taken in
    runs of at most `slot_chunk` padded slots, so the gathered temporary
    stays ~slot_chunk * J floats (the JAX package's slot-chunked scan has
    the same purpose). A fixed gather order and batched products make the
    result the same on every run (`index_add_` on the card adds with
    atomics in no fixed order)."""
    J = A.bdim
    order, offsets = A.transpose()[:2]
    counts = (offsets[1:] - offsets[:-1]).tolist()
    v = torch.cat([A.vals.reshape(-1, J),
                   A.vals.new_zeros((1, J))])          # last row: padding
    pad = v.shape[0] - 1
    out, b0 = [], 0
    while b0 < A.n_blocks:
        b1, D = b0 + 1, max(counts[b0], 1)
        while b1 < A.n_blocks and (b1 + 1 - b0) * max(D, counts[b1]) \
                <= slot_chunk:
            D = max(D, counts[b1])
            b1 += 1
        k = torch.arange(D, device=order.device)
        start = offsets[b0:b1, None].to(torch.int64)
        valid = k[None, :] < (offsets[b0 + 1:b1 + 1, None] - start)
        pos = torch.clamp(start + k[None, :], max=max(order.numel() - 1, 0))
        slots = torch.where(valid, order[pos].to(torch.int64), pad)
        out.append(fn(v[slots]))
        b0 = b1
    return torch.cat(out)


def block_gram(A: BlockSparse, slot_chunk: int = 65536) -> torch.Tensor:
    """Per-block-column Gram blocks G[b] = sum over the slots addressing b
    of vals[r,s,:] vals[r,s,:]^T, (n_blocks, J, J): the diagonal blocks of
    A^T A."""
    return _pull_blocks(A, lambda V: V.transpose(1, 2) @ V, slot_chunk)


def _block_apply(W: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x = W y per block; y flat (n_blocks * J,)."""
    return torch.bmm(W, y.reshape(W.shape[0], -1, 1)).reshape(-1)


def _whiten_from_gram(G: np.ndarray, eig_floor: float = 1e-6) -> np.ndarray:
    """Host-f64 inverse-sqrt factor of per-block Gram matrices:
    W = V diag(1/sqrt(max(w, floor*wmax))) V^T, identity for zero blocks."""
    w, V = np.linalg.eigh(G)
    wmax = np.maximum(w[:, -1:], 0.0)
    denom = np.maximum(w, np.maximum(eig_floor * wmax, 1e-300))
    W = np.einsum("bij,bj,bkj->bik", V, 1.0 / np.sqrt(denom), V)
    W[wmax[:, 0] <= 0.0] = np.eye(G.shape[-1])
    return W


def block_whitener_host(A: BlockSparse, eig_floor: float = 1e-6,
                        group: Optional[Group] = None) -> torch.Tensor:
    """The per-site-block whitener W[b] = G[b]^(-1/2) (floored), f32 on
    A's device. The Gram reduce runs on the device; only the (n_blocks, J,
    J) blocks go to the host, where the eigendecomposition runs in float64
    (f32 eigh is far too inaccurate for these near-singular Grams, whose
    eigenvalues spread beyond 1e9). With a group, A is a rank's row shard:
    the Gram is summed over the ranks, rank 0 decomposes it and broadcasts
    W."""
    G = psum(block_gram(A), group)
    if group is not None and not group.is_main:
        return broadcast(torch.empty_like(G), group)
    W = _whiten_from_gram(G.cpu().numpy().astype(np.float64), eig_floor)
    return broadcast(torch.from_numpy(W.astype(np.float32)).to(
        A.vals.device), group)


def _prewhiten_x0(W_f64: np.ndarray, x0: torch.Tensor,
                  n_blocks: int) -> torch.Tensor:
    """y0 solving W y0 = x0 per block, on the host in f64 (W is
    near-singular by construction; an f32 solve can blow up a warm
    start)."""
    x0np = x0.detach().cpu().numpy()
    if not np.any(x0np):
        return torch.zeros_like(x0)
    y0 = np.linalg.solve(
        W_f64, x0np.astype(np.float64).reshape(n_blocks, -1)[..., None]
    )[..., 0].reshape(-1).astype(np.float32)
    return torch.from_numpy(y0).to(x0.device)


# -------------------------------------------------------------- cg_batch


class CGState(NamedTuple):
    X: torch.Tensor      # iterate (K, n, m)
    R: torch.Tensor      # residual B - A X
    rz: torch.Tensor     # <R, Z> per batch and column (K, 1, m)
    P: torch.Tensor      # search direction
    k: torch.Tensor      # iterations taken (int32)
    done: torch.Tensor   # every residual under its bar


def _cg_iterate(A_bmm, M_bmm, B, stop, st: CGState, n: int,
                maxiter: int) -> CGState:
    """n CG iterations. Each one takes effect only while ~done & (k <
    maxiter), the JAX while loop's condition; once it fails the state stays
    as it is. `done` is the true residual test |A X - B| <= stop of the new
    iterate, one more operator application per iteration, as in JAX."""
    X, R, rz, P, k, done = st
    for _ in range(n):
        active = (~done) & (k < maxiter)
        AP = A_bmm(P)
        denom = torch.sum(P * AP, dim=1, keepdim=True)
        denom = torch.where(denom == 0, 1e-8, denom)
        alpha = rz / denom
        X_n = X + alpha * P
        R_n = R - alpha * AP
        Z = M_bmm(R_n)
        rz_n = torch.sum(R_n * Z, dim=1, keepdim=True)
        beta = rz_n / torch.where(rz == 0, 1e-8, rz)
        P_n = Z + beta * P
        done_n = torch.all(torch.linalg.norm(A_bmm(X_n) - B, dim=1) <= stop)
        X, R, rz, P = (torch.where(active, a, b_) for a, b_ in
                       ((X_n, X), (R_n, R), (rz_n, rz), (P_n, P)))
        done = torch.where(active, done_n, done)
        k = k + active.to(torch.int32)
    return CGState(X, R, rz, P, k, done)


def cg_batch(A_bmm: Callable, B: torch.Tensor,
             M_bmm: Optional[Callable] = None,
             X0: Optional[torch.Tensor] = None, rtol: float = 1e-3,
             atol: float = 0.0, maxiter: Optional[int] = None,
             check_every: int = 200):
    """Solve a batch of SPD systems A_i X_i = B_i, B (K, n, m), by
    preconditioned CG: X0 defaults to M(B), maxiter to 5 n; each batch's
    iterates freeze once every residual norm |A X - B| (over n, per column)
    is at most max(rtol |B|, atol), and the loop ends when all have or at
    maxiter. The host reads the state every `check_every` iterations to stop
    early; the iterates do not depend on it. Returns (X, info with 'niter'
    and 'optimal')."""
    K, n, m = B.shape
    if M_bmm is None:
        def M_bmm(x):
            return x
    if X0 is None:
        X0 = M_bmm(B)
    if maxiter is None:
        maxiter = 5 * n
    stop = torch.clamp(rtol * torch.linalg.norm(B, dim=1), min=atol)
    R0 = B - A_bmm(X0)
    Z0 = M_bmm(R0)
    st = CGState(X0, R0, torch.sum(R0 * Z0, dim=1, keepdim=True), Z0,
                 torch.zeros((), dtype=torch.int32, device=B.device),
                 torch.all(torch.linalg.norm(A_bmm(X0) - B, dim=1) <= stop))
    it = 0
    while True:
        st = _cg_iterate(A_bmm, M_bmm, B, stop, st,
                         max(min(check_every, maxiter - it), 0), maxiter)
        new_it, done = torch.stack([st.k.to(torch.float64),
                                    st.done.to(torch.float64)]).tolist()
        if done or new_it >= maxiter or int(new_it) == it:
            break
        it = int(new_it)
    return st.X, {"niter": int(st.k), "optimal": bool(st.done)}


class _CGSolve(torch.autograd.Function):
    """X = A^-1 B by `cg_batch`; the backward solves A dB = dX with the same
    operator (A symmetric, treated as constant)."""

    @staticmethod
    def forward(ctx, B, A_bmm, kw):
        ctx.A_bmm, ctx.kw = A_bmm, kw
        return cg_batch(A_bmm, B, **kw)[0]

    @staticmethod
    def backward(ctx, dX):
        return cg_batch(ctx.A_bmm, dX, **ctx.kw)[0], None, None


def cg_solve(A_bmm: Callable, B: torch.Tensor, **kw) -> torch.Tensor:
    """Differentiable batched CG (the JAX package's `cg_solve`, a
    `custom_vjp`): gradients reach B through a second CG solve."""
    return _CGSolve.apply(B, A_bmm, kw)


# ------------------------------------------------------------------ CGLS


class CGLSState(NamedTuple):
    y: torch.Tensor      # iterate (in the scaled variable)
    r: torch.Tensor      # residual b - A P y
    p: torch.Tensor      # search direction
    gamma: torch.Tensor  # |s|^2, s = P A^T r - damp^2 y
    k: torch.Tensor      # iterations taken (int32)
    phi: torch.Tensor    # |r|^2 + damp^2 |y|^2
    best_y: torch.Tensor
    best_phi: torch.Tensor


def _start(mv, rmv, b, y0, d2, rows_reduce) -> CGLSState:
    r0 = b - mv(y0)
    s0 = rmv(r0) - d2 * y0
    gamma0 = torch.dot(s0, s0)
    phi0 = rows_reduce(torch.dot(r0, r0)) + d2 * torch.dot(y0, y0)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    return CGLSState(y0, r0, s0, gamma0, k, phi0, y0, phi0)


def _iterate(mv, rmv, st: CGLSState, stop2, d2, n: int,
             maxiter: int, rows_reduce) -> CGLSState:
    """n CGLS iterations of the factored normal equations. Each one takes
    effect only while (gamma > stop2) & (k < maxiter) & (phi < 1e4 *
    best_phi), the JAX while loop's condition; once it fails the state
    stays as it is."""
    y, r, p, gamma, k, phi, by, bphi = st
    for _ in range(n):
        active = (gamma > stop2) & (k < maxiter) & (phi < 1e4 * bphi)
        q = mv(p)
        denom = rows_reduce(torch.dot(q, q)) + d2 * torch.dot(p, p)
        alpha = gamma / torch.where(denom == 0, 1e-30, denom)
        y_n = y + alpha * p
        r_n = r - alpha * q
        s = rmv(r_n) - d2 * y_n
        gamma_n = torch.dot(s, s)
        beta = gamma_n / torch.where(gamma == 0, 1e-30, gamma)
        p_n = s + beta * p
        phi_n = rows_reduce(torch.dot(r_n, r_n)) + d2 * torch.dot(y_n, y_n)
        better = phi_n < bphi
        by_n = torch.where(better, y_n, by)
        bphi_n = torch.where(better, phi_n, bphi)
        y, r, p = (torch.where(active, a, b_) for a, b_ in
                   ((y_n, y), (r_n, r), (p_n, p)))
        gamma, phi = (torch.where(active, a, b_) for a, b_ in
                      ((gamma_n, gamma), (phi_n, phi)))
        by, bphi = torch.where(active, by_n, by), torch.where(active, bphi_n,
                                                              bphi)
        k = k + active.to(torch.int32)
    return CGLSState(y, r, p, gamma, k, phi, by, bphi)


class _GraphedIterations:
    """`_iterate`'s n iterations captured once as a CUDA graph over static
    copies of a state (on the device's capture stream, into the memory
    pool of its last CGLS graph, which is never replayed again); a call
    copies a state in, replays the graph on the current stream and returns
    the graph's output state, which the next call overwrites. Capture runs
    nothing on the device, so the launch counters the capture advanced are
    taken back and advanced at each replay. A synchronising iteration
    raises at capture."""

    def __init__(self, mv, rmv, st: CGLSState, stop2, d2, n: int,
                 maxiter: int, rows_reduce):
        device = st.y.device
        self.static = CGLSState(*(t.clone() for t in st))
        self.graph = torch.cuda.CUDAGraph()
        before = [getattr(owner, name) for owner, name in _COUNTERS]
        stream, last = _capture.get(device, (None, None))
        if stream is None:
            stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.graph.capture_begin(
                pool=None if last is None else last.pool())
            try:
                self.out = _iterate(mv, rmv, self.static, stop2, d2, n,
                                    maxiter, rows_reduce)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        _capture[device] = (stream, self.graph)
        self.counts = [getattr(owner, name) - b
                       for (owner, name), b in zip(_COUNTERS, before)]
        for (owner, name), b in zip(_COUNTERS, before):
            setattr(owner, name, b)

    def __call__(self, st: CGLSState) -> CGLSState:
        for dst, src in zip(self.static, st):
            dst.copy_(src)
        self.graph.replay()
        for (owner, name), count in zip(_COUNTERS, self.counts):
            setattr(owner, name, getattr(owner, name) + count)
        return self.out


def _fetch(st: CGLSState):
    """(k, gamma, phi, best_phi) on the host: one transfer."""
    k, gamma, phi, bphi = torch.stack(
        [st.k.to(torch.float64), st.gamma.double(), st.phi.double(),
         st.best_phi.double()]).tolist()
    return int(k), gamma, phi, bphi


def _final(st: CGLSState) -> torch.Tensor:
    # Healthy runs return the final iterate: near convergence phi sits at
    # the f32 noise floor and cannot rank the still-improving iterates. The
    # best iterate is the fallback when the run diverged.
    return torch.where(st.phi <= 2.0 * st.best_phi, st.y, st.best_y)


def cgls(A_mv: Callable, At_mv: Callable, b: torch.Tensor, x0: torch.Tensor,
         maxiter: int = 500, tol: float = 1e-8, damp: float = 0.0,
         check_every: int = 200, restart: bool = False,
         rows_reduce: Optional[Callable] = None, graph_iters: int = 0):
    """min_x |A x - b|^2 + damp^2 |x|^2 by CGLS (CG on the regularized
    normal equations in factored form).

    f32 CG on the normal equations loses conjugacy once cond(A^T A) nears
    1/eps and can then diverge: the best iterate of phi = |Ax-b|^2 +
    damp^2 |x|^2 is tracked and returned if the final one is worse than 2x
    it, and the loop stops once phi has grown 1e4x above the best seen. The
    host reads the state every `check_every` iterations to stop early; the
    iterates do not depend on it. restart=True instead re-enters each such
    chunk from the best iterate with an exactly recomputed residual: not
    the long loop's iterates, but it bounds the f32 conjugacy drift that
    blows up plain CGLS on the stream systems. rows_reduce: the reduction
    of a row-space inner product over the row shards (`psum` when the rows
    are sharded over ranks; At_mv then reduces too). Returns (x, info with
    'niter', 'resnorm' |A^T(Ax-b) - damp^2 x|, 'best_phi', 'phi_history':
    the phi the host read at each chunk's end). Each chunk with its read is
    a `cgls_chunk` span (`utils/tracing.py`). graph_iters > 0 (CUDA tensors,
    A_mv, At_mv and rows_reduce free of host syncs): the iterations run as
    replays of one CUDA graph of that many, captured at the first chunk,
    the rest of a chunk (its count modulo graph_iters) op by op."""
    if rows_reduce is None:
        def rows_reduce(v):
            return v
    d2 = torch.tensor(damp * damp, dtype=b.dtype, device=b.device)
    st = _start(A_mv, At_mv, b, x0, d2, rows_reduce)
    stop2 = torch.tensor((tol ** 2) * float(st.gamma), dtype=b.dtype,
                         device=b.device)
    stop2_host = float(stop2)
    phi_history = []
    graphed = None
    it = 0
    while True:
        n = max(min(check_every, maxiter - it), 0)
        with tracing.span("cgls_chunk"):
            if graph_iters > 0:
                if graphed is None and n >= graph_iters:
                    graphed = _GraphedIterations(A_mv, At_mv, st, stop2, d2,
                                                 graph_iters, maxiter,
                                                 rows_reduce)
                for _ in range(n // graph_iters):
                    st = graphed(st)
                n %= graph_iters
            st = _iterate(A_mv, At_mv, st, stop2, d2, n, maxiter,
                          rows_reduce)
            new_it, gamma, phi, bphi = _fetch(st)
        phi_history.append(phi)
        if (new_it >= maxiter or gamma <= stop2_host or new_it == it
                or phi >= 1e4 * bphi):
            break
        it = new_it
        if restart:
            # continue from the best point with an exact residual
            y = torch.where(st.phi <= st.best_phi, st.y, st.best_y)
            fresh = _start(A_mv, At_mv, b, y, d2, rows_reduce)
            better = fresh.phi < st.best_phi
            st = CGLSState(y, fresh.r, fresh.p, fresh.gamma, st.k, fresh.phi,
                           torch.where(better, y, st.best_y),
                           torch.where(better, fresh.phi, st.best_phi))
    if graphed is not None:     # off the graph's outputs
        st = CGLSState(*(t.clone() for t in st))
    return _final(st), {"niter": int(st.k), "resnorm": torch.sqrt(st.gamma),
                        "best_phi": st.best_phi, "phi_history": phi_history}


def _jacobi(A: BlockSparse, group: Optional[Group] = None) -> torch.Tensor:
    """1 / column norm, with columns under 1e-6 of the largest norm dropped
    (scale 0: their coefficients are pinned to zero). A relative cutoff:
    an absolute one lets a 1e-10 column be amplified 1e10x, which destroys
    f32 CGLS on the scaled system."""
    d = A.col_norms(group)
    return torch.where(d > 1e-6 * torch.max(d), 1.0 / d,
                       torch.zeros_like(d))


def cgls_sparse_chunked(A: BlockSparse, b: torch.Tensor, x0: torch.Tensor,
                        maxiter: int = 500, tol: float = 1e-8,
                        chunk: int = 200, precondition=True,
                        damp: float = 0.0, restart: bool = False,
                        whitener: Optional[torch.Tensor] = None,
                        group: Optional[Group] = None):
    """CGLS on a BlockSparse operator in chunks of `chunk` iterations, the
    host reading the state between chunks: without `restart` the iterates
    equal one long loop's (`cgls`). With a group, A and b are this rank's
    row shard and x0 and the returned x are replicated: A^T r and the
    row-space inner products are summed over the ranks, the Jacobi scale
    takes the whole operator's column norms and the block whitener its
    Gram (`block_whitener_host`).

    precondition: False, True (Jacobi column scaling: min |A D y - b|^2 +
    damp^2 |y|^2, x = D y, D = 1 / column norm) or "block" (the
    per-site-block eigen-whitener; the scaled variable is y with x = W y).
    whitener (block mode): a W from an earlier solve of the same pattern,
    reused instead of recomputed; the W used is returned as info["W"].
    Spans (`utils/tracing.py`): `whiten` around the whitener and the warm
    start's change of variable, `cgls` around the solve."""
    t_whiten = 0.0
    W = None
    if precondition == "block":
        tic = time.perf_counter()
        with tracing.span("whiten"):
            W = (whitener if whitener is not None
                 else block_whitener_host(A, group=group))
            # y0 solves W y0 = x0 per block, so a warm start survives the
            # change of variable (x0 = 0 gives y0 = 0)
            y0 = _prewhiten_x0(W.cpu().numpy().astype(np.float64), x0,
                               A.n_blocks)
        t_whiten = time.perf_counter() - tic

        def apply_p(v):
            return _block_apply(W, v)
    else:
        if precondition:
            P = _jacobi(A, group)
            y0 = x0 / torch.where(P == 0, 1.0, P)
        else:
            P = torch.ones(A.n_cols, dtype=b.dtype, device=b.device)
            y0 = x0

        def apply_p(v):
            return P * v

    with tracing.span("cgls"):
        y, info = cgls(lambda v: A.mv(apply_p(v)),
                       lambda r: apply_p(psum(A.rmv(r), group)),
                       b, y0, maxiter=maxiter, tol=tol, damp=damp,
                       check_every=chunk, restart=restart,
                       rows_reduce=lambda v: psum(v, group),
                       graph_iters=(GRAPH_ITERS if b.is_cuda and group is None
                                    else 0))
    return apply_p(y), {**info, "t_whiten": t_whiten, "W": W}


def cgls_sparse(A: BlockSparse, b: torch.Tensor, x0: torch.Tensor,
                maxiter: int = 500, tol: float = 1e-8,
                precondition: bool = True, damp: float = 0.0):
    """`cgls_sparse_chunked` as one long loop, Jacobi-scaled or not."""
    return cgls_sparse_chunked(A, b, x0, maxiter=maxiter, tol=tol,
                               precondition=precondition, damp=damp)


def cgls_block_precond(A: BlockSparse, b: torch.Tensor, x0: torch.Tensor,
                       maxiter: int = 500, tol: float = 1e-8,
                       damp: float = 0.0, eig_floor: float = 1e-6,
                       W: Optional[torch.Tensor] = None):
    """`cgls_sparse_chunked` as one long loop on the block-whitened system
    A W; `W` defaults to `block_whitener_host(A, eig_floor)`."""
    return cgls_sparse_chunked(
        A, b, x0, maxiter=maxiter, tol=tol, precondition="block", damp=damp,
        whitener=W if W is not None else block_whitener_host(A, eig_floor))
