"""PyTorch port, the rest of `ops/linalg.py` against the JAX package: the
batched CG (`cg_batch`, `cg_solve`), and the port's one operator layout
against the JAX package's other two, the pull-layout transpose
(`build_rmv_gather`, `BlockSparse.rmv_gather`, `block_gram_gather`) and the
packed operator (`BlockSparseP`), which the vortex model's `rmv_gather` and
`packed_vals` name; on random systems and on a tiny vortex system the JAX
package assembled, passed across as numpy. The pull's index and products
are reproduced here in plain PyTorch (`build_rmv_gather`,
`rmv_gather_reference`, `block_gram_gather`), so that the JAX algorithm
itself is pinned too.

Tolerances:
* cg_batch: the same iteration count, and X to 1e-5 relative (L2 per
  batch), on well-conditioned SPD systems (condition 20) where the stop
  is not at the bar's edge: the test checks that the JAX iterate one step
  earlier misses the bar by more than 5% and the last one meets it with 5%
  to spare, so summation-order rounding cannot move the stop;
* cg_solve's gradient against `jax.grad`: 1e-5 relative;
* the transpose index: equal; the pulled products and the Gram blocks:
  1e-5 of the largest entry (the same products, summed in another order);
* the port's default `rmv`, and its mv / col_norms / block_gram, against
  the JAX package's pulled and packed ones: 1e-5 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insr_pde_tpu.models.vortex import VortexConfig as JConfig
from insr_pde_tpu.models.vortex import VortexModel as JVortex
from insr_pde_tpu.ops import linalg as jl
from insr_pde_tpu_torch.ops import linalg

torch.set_num_threads(1)


def _spd(K=3, n=64, m=2, cond=20.0, seed=0):
    rng = np.random.default_rng(seed)
    A = np.empty((K, n, n), np.float32)
    for k in range(K):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        w = np.geomspace(1.0, cond, n)
        A[k] = (Q * w) @ Q.T
    B = rng.normal(size=(K, n, m)).astype(np.float32)
    return A, B


def _bmm_pair(A):
    JA, TA = jnp.asarray(A), torch.from_numpy(A)
    return (lambda X: jnp.einsum("kij,kjm->kim", JA, X),
            lambda X: torch.einsum("kij,kjm->kim", TA, X))


def _miss(A, B, X, rtol):
    """max over batches and columns of |A X - B| / (rtol |B|), in f64."""
    A, B, X = (np.asarray(a, np.float64) for a in (A, B, X))
    r = np.linalg.norm(np.einsum("kij,kjm->kim", A, X) - B, axis=1)
    return float((r / (rtol * np.linalg.norm(B, axis=1))).max())


@pytest.mark.parametrize("precond", [False, True])
def test_cg_batch_matches_jax(precond):
    A, B = _spd()
    rtol = 1e-4
    jmv, tmv = _bmm_pair(A)
    kw = {}
    if precond:
        d = np.einsum("kii->ki", A)[..., None]
        kw = dict(M_bmm=lambda X: X / jnp.asarray(d))
        tkw = dict(M_bmm=lambda X: X / torch.from_numpy(d))
    else:
        tkw = {}
    JX, jinfo = jl.cg_batch(jmv, jnp.asarray(B), rtol=rtol, **kw)
    X, info = linalg.cg_batch(tmv, torch.from_numpy(B), rtol=rtol, **tkw)
    n = int(jinfo["niter"])
    assert bool(jinfo["optimal"]) and info["optimal"]
    assert info["niter"] == n and 3 < n < 5 * B.shape[1]
    # the stop is not at the bar's edge
    prev = jl.cg_batch(jmv, jnp.asarray(B), rtol=rtol, maxiter=n - 1, **kw)[0]
    assert _miss(A, B, prev, rtol) > 1.05 and _miss(A, B, JX, rtol) < 0.95
    JX = np.asarray(JX)
    for k in range(B.shape[0]):
        assert (np.linalg.norm(X[k].numpy() - JX[k])
                <= 1e-5 * np.linalg.norm(JX[k]))


def test_cg_batch_maxiter_and_chunks():
    """maxiter stops the loop where JAX's stops, whatever the chunk."""
    A, B = _spd(cond=1e4, seed=1)
    jmv, tmv = _bmm_pair(A)
    JX, jinfo = jl.cg_batch(jmv, jnp.asarray(B), rtol=1e-7, maxiter=9)
    for chunk in (1, 4, 200):
        X, info = linalg.cg_batch(tmv, torch.from_numpy(B), rtol=1e-7,
                                  maxiter=9, check_every=chunk)
        assert info["niter"] == int(jinfo["niter"]) == 9
        assert not info["optimal"] and not bool(jinfo["optimal"])
        np.testing.assert_allclose(X.numpy(), np.asarray(JX), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(JX)).max())


def test_cg_solve_gradient_matches_jax():
    A, B = _spd(seed=2)
    C = np.random.default_rng(3).normal(size=B.shape).astype(np.float32)
    jmv, tmv = _bmm_pair(A)
    jg = jax.grad(lambda b: jnp.sum(jl.cg_solve(jmv, b, rtol=1e-6)
                                    * jnp.asarray(C)))(jnp.asarray(B))
    Bt = torch.from_numpy(B).requires_grad_(True)
    loss = (linalg.cg_solve(tmv, Bt, rtol=1e-6) * torch.from_numpy(C)).sum()
    loss.backward()
    jg = np.asarray(jg)
    assert np.linalg.norm(Bt.grad.numpy() - jg) <= 1e-5 * np.linalg.norm(jg)


@pytest.fixture(scope="module")
def system():
    """A tiny vortex velocity system the JAX package assembled: (JAX
    BlockSparse, port BlockSparse with row_slots)."""
    cfg = JConfig(collocation_pts_num=64, boundary_num=32, time_num=3,
                  n_spatial_basis=25, n_feat=4, neighbor_k=4, band_width=2.0,
                  internal_v=1.0, rho=1.0, seed=3)
    m = JVortex(cfg, log=False)
    A, _ = m.assemble(m.params.u)
    vals, cols = np.array(A.vals), np.array(A.cols)
    JA = jl.BlockSparse(jnp.asarray(vals), jnp.asarray(cols), int(A[-1]))
    S = cols.shape[1]
    # rows whose second half of slots is padding (zeros) have S / 2
    slots = np.where((vals[:, S // 2:] != 0).any(-1).any(-1), S, S // 2)
    TA = linalg.BlockSparse(torch.from_numpy(vals), torch.from_numpy(cols),
                            int(A[-1]),
                            row_slots=torch.from_numpy(slots.astype(np.int32)))
    return JA, TA


def build_rmv_gather(cols: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The JAX package's pull-layout transpose index: t_idx (n_blocks, D)
    int32, row b listing the flat slots r * S + s that address block b in
    ascending order, padded with R * S; D is the largest reverse degree."""
    c = cols.reshape(-1).to(torch.int64)
    n = c.numel()
    order = torch.sort(c, stable=True).indices
    sorted_c = c[order]
    counts = torch.bincount(c, minlength=n_blocks)
    starts = torch.zeros(n_blocks + 1, dtype=torch.int64)
    starts[1:] = torch.cumsum(counts, 0)
    rank = torch.arange(n) - starts[sorted_c]
    t_idx = torch.full((n_blocks, int(counts.max())), n, dtype=torch.int64)
    t_idx[sorted_c, rank] = order
    return t_idx.to(torch.int32)


def _gathered(vals, t_idx, d_chunk=64):
    """The value rows V (n_blocks, d_chunk, J) of each slice of D, padding
    slots reading a zero row, with their flat slot ids."""
    J = vals.shape[-1]
    v = torch.cat([vals.reshape(-1, J), vals.new_zeros((1, J))])
    t = t_idx.to(torch.int64)
    pad = (-t.shape[1]) % d_chunk
    t = torch.cat([t, torch.full((t.shape[0], pad), v.shape[0] - 1,
                                 dtype=torch.int64)], dim=1)
    for ti in t.reshape(t.shape[0], -1, d_chunk).transpose(0, 1):
        yield v[ti], ti


def rmv_gather_reference(vals, r, t_idx):
    """A^T r by the JAX package's pull over `build_rmv_gather`'s index, in
    slices of D, (n_blocks * J,)."""
    S = vals.shape[1]
    r_ext = torch.cat([r, r.new_zeros(1)])
    out = 0
    for g, ti in _gathered(vals, t_idx):
        rows = torch.clamp(ti // S, max=r_ext.shape[0] - 1)
        out = out + torch.einsum("bdj,bd->bj", g, r_ext[rows])
    return out.reshape(-1)


def block_gram_gather(vals, t_idx):
    """`block_gram` by the JAX package's pull, (n_blocks, J, J)."""
    return sum(torch.einsum("bdi,bdj->bij", g, g)
               for g, _ in _gathered(vals, t_idx))


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_build_rmv_gather_equals_jax(system):
    JA, TA = system
    jt = np.asarray(jl.build_rmv_gather(np.asarray(JA.cols), JA.n_blocks))
    t = build_rmv_gather(TA.cols, TA.n_blocks)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), jt)


def test_rmv_gather_matches_jax_and_the_default_operator(system):
    """The JAX package's pulled A^T r and pulled Gram, reproduced plain,
    and the port's default rmv (`--rmv_gather` selects nothing else)."""
    JA, TA = system
    r = np.random.default_rng(4).normal(size=TA.vals.shape[0]).astype(
        np.float32)
    jt = jl.build_rmv_gather(np.asarray(JA.cols), JA.n_blocks)
    ref = JA.rmv_gather(jnp.asarray(r), jt)
    t_idx = build_rmv_gather(TA.cols, TA.n_blocks)
    _close(rmv_gather_reference(TA.vals, torch.from_numpy(r), t_idx), ref)
    _close(block_gram_gather(TA.vals, t_idx),
           jl.block_gram_gather(JA.vals, jt))
    _close(TA.rmv(torch.from_numpy(r)), ref)
    _close(linalg.block_gram(TA), jl.block_gram_gather(JA.vals, jt))


def test_packed_operator_matches_jax_and_the_default_operator(system):
    """The JAX package's packed operator (R, S*J) against the port's one
    layout on the same values (`--packed_vals` selects nothing else)."""
    JA, TA = system
    rng = np.random.default_rng(5)
    x = rng.normal(size=TA.n_cols).astype(np.float32)
    r = rng.normal(size=TA.vals.shape[0]).astype(np.float32)
    JP = jl.pack_block_sparse(JA)
    R, S, J = TA.vals.shape
    assert tuple(JP.vals.shape) == (R, S * J)
    # the packed values are the port's, read row by row
    np.testing.assert_array_equal(np.asarray(JP.vals),
                                  TA.vals.reshape(R, S * J).numpy())
    assert (TA.bdim, TA.n_cols, TA.n_blocks) == (JP.bdim, JP.n_cols,
                                                 JP.n_blocks)
    xt, rt = torch.from_numpy(x), torch.from_numpy(r)
    for got, ref in ((TA.mv(xt), JP.mv(jnp.asarray(x))),
                     (TA.rmv(rt), JP.rmv(jnp.asarray(r))),
                     (TA.col_norms(), JP.col_norms())):
        _close(got, ref)
    _close(linalg.block_gram(TA),
           jl.block_gram(JP.vals, JP.cols, JP.n_blocks))
