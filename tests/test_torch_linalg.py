"""PyTorch port, the least-squares solvers (`ops/linalg.py`) against the JAX
package, on systems the JAX package assembled (tiny vortex velocity and
stream systems) and on random ones, passed across as numpy.

Tolerances: the same f32 CGLS recurrences, with dot products and matvecs
summed in another order. On these ill-conditioned systems f32 CGLS loses
conjugacy within a few dozen iterations, and from there on it amplifies
summation-order noise (measured: the two packages' solutions of the tiny
stream system differ by 1e-6 relative after 10 iterations and by 9e-3 after
40). So the solves compared here stop before that point (6 to 20
iterations: fewer on the unscaled and on the whitened systems, or a
tolerance reached on a well-conditioned system): the residual norms agree
to 1e-5 of |b| and the solutions to 1e-4 relative (L2), and the iteration
counts are equal. Whitened solves hold x = W y to 1e-3: W scales the
directions at its eigenvalue floor by up to 1e3 (1/sqrt(1e-6)), which
amplifies the iterates' rounding differences there; and the two packages'
solves share one whitener, since W = G^(-1/2) of near-singular Gram blocks
moves by ~1e-2 relative under the f32 rounding of G alone. The host-f64
whitener helpers are the same numpy code and agree to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insr_pde_tpu.models.vortex import (StreamVortexModel as JStream,
                                        VortexConfig as JConfig,
                                        VortexModel as JVortex)
from insr_pde_tpu.ops import linalg as jl
from insr_pde_tpu_torch.ops import linalg

torch.set_num_threads(1)

RES_RTOL = 1e-5
X_RTOL = 1e-4
X_RTOL_WHITENED = 1e-3
# iterations compared on each system: before f32 conjugacy loss sets in
ITERS = {"velocity": 20, "stream": 12, "whitened": 8}


def _vel_cfg():
    return JConfig(collocation_pts_num=64, boundary_num=32, time_num=3,
                   n_spatial_basis=25, n_feat=4, neighbor_k=4,
                   band_width=2.0, internal_v=1.0, rho=1.0, seed=3)


def _stream_cfg():
    return JConfig(collocation_pts_num=64, boundary_num=32, time_num=3,
                   n_spatial_basis=25, n_feat=4, neighbor_k=4,
                   band_width=1.0, internal_v=1.0, rho=1.0, seed=3,
                   pou="smooth", pou_time="simple", time_window=1,
                   stream_bc="both", w_bc=5.0, pou_normalize=True)


@pytest.fixture(scope="module")
def systems():
    """name -> (JAX BlockSparse, jax b, port BlockSparse, torch b)."""
    out = {}
    for name, cls, cfg in (("velocity", JVortex, _vel_cfg()),
                           ("stream", JStream, _stream_cfg())):
        m = cls(cfg, log=False)
        A, b = m.assemble(m.params.u)
        vals, cols, b = (np.array(a) for a in (A.vals, A.cols, b))
        out[name] = (jl.BlockSparse(jnp.asarray(vals), jnp.asarray(cols),
                                    int(A[-1])), jnp.asarray(b),
                     linalg.BlockSparse(torch.from_numpy(vals),
                                        torch.from_numpy(cols), int(A[-1])),
                     torch.from_numpy(b))
    return out


def _res(A, x, b):
    return float(np.linalg.norm(np.asarray(A.mv(x)) - np.asarray(b)))


def _check(x, info, jx, jinfo, A, b, JA, jb, x_rtol=X_RTOL):
    assert int(info["niter"]) == int(jinfo["niter"])
    jres, res = _res(JA, jx, jb), float(torch.linalg.norm(A.mv(x) - b))
    assert abs(res - jres) <= RES_RTOL * float(torch.linalg.norm(b))
    jx = np.asarray(jx)
    assert np.linalg.norm(x.numpy() - jx) <= x_rtol * np.linalg.norm(jx)


@pytest.mark.parametrize("name", ["velocity", "stream"])
@pytest.mark.parametrize("precondition,damp", [(True, 0.0), (False, 0.01)])
def test_cgls_sparse_matches_jax(systems, name, precondition, damp):
    """Jacobi-scaled CGLS, and plain damped `cgls` (precondition off, whose
    unscaled systems lose conjugacy sooner: 6 iterations)."""
    JA, jb, A, b = systems[name]
    x0 = np.zeros(A.n_cols, np.float32)
    kw = dict(maxiter=ITERS[name] if precondition else 6, tol=1e-10,
              precondition=precondition, damp=damp)
    jx, jinfo = jl.cgls_sparse(JA, jb, jnp.asarray(x0), **kw)
    x, info = linalg.cgls_sparse(A, b, torch.from_numpy(x0), **kw)
    _check(x, info, jx, jinfo, A, b, JA, jb)


def _random_system(R=120, C=40, nnz=4, seed=0):
    rng = np.random.default_rng(seed)
    cols = np.stack([rng.choice(C, nnz, replace=False)
                     for _ in range(R)]).astype(np.int32)
    vals = rng.normal(size=(R, nnz)).astype(np.float32)
    x_true = rng.normal(size=C).astype(np.float32)
    JA = jl.PaddedSparse(jnp.asarray(vals), jnp.asarray(cols), C)
    A = linalg.PaddedSparse(torch.from_numpy(vals), torch.from_numpy(cols), C)
    jb = JA.mv(jnp.asarray(x_true))
    return JA, jb, A, torch.from_numpy(np.asarray(jb))


@pytest.mark.parametrize("damp", [0.0, 0.1])
def test_cgls_stops_where_jax_stops(damp):
    """A well-conditioned system solved to tol 1e-4: the loop stops on
    gamma <= tol^2 gamma0 at the same iteration as the JAX while loop."""
    JA, jb, A, b = _random_system()
    x0 = np.zeros(40, np.float32)
    jx, jinfo = jl.cgls(JA.mv, JA.rmv, jb, jnp.asarray(x0), maxiter=500,
                        tol=1e-4, damp=damp)
    x, info = linalg.cgls(A.mv, A.rmv, b, torch.from_numpy(x0), maxiter=500,
                          tol=1e-4, damp=damp, check_every=7)
    assert 5 < int(jinfo["niter"]) < 500
    _check(x, info, jx, jinfo, A, b, JA, jb)
    # best_phi ends at ~2e-8 of phi0 = |b|^2, where the two packages' f32
    # iterates differ by rounding in the order of the products (phi 7.33e-6
    # against 7.26e-6 at damp 0): hold sqrt(best_phi), a residual norm, to
    # the residual bar of _check ...
    bnorm = float(torch.linalg.norm(b))
    assert abs(np.sqrt(float(info["best_phi"]))
               - np.sqrt(float(jinfo["best_phi"]))) <= RES_RTOL * bnorm
    # ... and each package's best_phi to the f64 phi of its own iterate
    vals = A.vals.numpy().reshape(A.cols.shape).astype(np.float64)
    dense = np.zeros((vals.shape[0], A.n_cols))
    np.add.at(dense, (np.arange(vals.shape[0])[:, None], A.cols.numpy()),
              vals)
    b64 = b.numpy().astype(np.float64)
    for xs, phi in ((x.numpy(), info["best_phi"]),
                    (np.asarray(jx), jinfo["best_phi"])):
        xs = xs.astype(np.float64)
        phi64 = np.sum((dense @ xs - b64) ** 2) + damp ** 2 * np.sum(xs ** 2)
        np.testing.assert_allclose(float(phi), phi64, rtol=1e-3)


@pytest.mark.parametrize("name", ["velocity", "stream"])
@pytest.mark.parametrize("restart", [False, True])
def test_cgls_sparse_chunked_matches_jax(systems, name, restart):
    JA, jb, A, b = systems[name]
    x0 = np.zeros(A.n_cols, np.float32)
    kw = dict(maxiter=ITERS[name], tol=1e-10, chunk=5, precondition=True,
              restart=restart)
    jx, jinfo = jl.cgls_sparse_chunked(JA, jb, jnp.asarray(x0), **kw)
    x, info = linalg.cgls_sparse_chunked(A, b, torch.from_numpy(x0), **kw)
    _check(x, info, jx, jinfo, A, b, JA, jb)
    if not restart:
        # chunking does not change the iterates
        x1, _ = linalg.cgls_sparse(A, b, torch.from_numpy(x0),
                                   maxiter=ITERS[name], tol=1e-10)
        torch.testing.assert_close(x, x1, rtol=0, atol=0)


@pytest.mark.parametrize("restart", [False, True])
def test_cgls_chunked_block_whitener_matches_jax(systems, restart):
    """precondition='block' from a warm start: the whitener computed here
    equals a given one (reuse_whitener); given to both packages, the solves
    agree."""
    JA, jb, A, b = systems["stream"]
    rng = np.random.default_rng(1)
    x0 = (0.1 * rng.normal(size=A.n_cols)).astype(np.float32)
    kw = dict(maxiter=ITERS["whitened"], tol=1e-10, chunk=3,
              precondition="block", restart=restart)
    x, info = linalg.cgls_sparse_chunked(A, b, torch.from_numpy(x0), **kw)
    W = info["W"]
    torch.testing.assert_close(W, linalg.block_whitener_host(A), rtol=0,
                               atol=0)
    x2, info2 = linalg.cgls_sparse_chunked(A, b, torch.from_numpy(x0),
                                           whitener=W, **kw)
    assert info2["W"] is W
    torch.testing.assert_close(x2, x, rtol=0, atol=0)
    jx, jinfo = jl.cgls_sparse_chunked(JA, jb, jnp.asarray(x0),
                                       whitener=jnp.asarray(W.numpy()), **kw)
    _check(x, info, jx, jinfo, A, b, JA, jb, X_RTOL_WHITENED)


def test_cgls_block_precond_matches_jax(systems):
    JA, jb, A, b = systems["velocity"]
    W = linalg.block_whitener_host(A)
    x0 = np.zeros(A.n_cols, np.float32)
    jx, jinfo = jl.cgls_block_precond(JA, jb, jnp.asarray(x0),
                                      maxiter=ITERS["whitened"], tol=1e-10,
                                      W=jnp.asarray(W.numpy()))
    x, info = linalg.cgls_block_precond(A, b, torch.from_numpy(x0),
                                        maxiter=ITERS["whitened"], tol=1e-10,
                                        W=W)
    _check(x, info, jx, jinfo, A, b, JA, jb, X_RTOL_WHITENED)


def test_whitener_helpers_match_jax(systems):
    JA, _, A, _ = systems["stream"]
    G = linalg.block_gram(A).numpy().astype(np.float64)
    Gj = np.asarray(jl.block_gram(JA.vals, JA.cols, JA.n_blocks),
                    np.float64)
    np.testing.assert_allclose(G, Gj, rtol=1e-5, atol=1e-5 * np.abs(Gj).max())
    np.testing.assert_allclose(linalg._whiten_from_gram(Gj),
                               jl._whiten_from_gram(Gj), rtol=1e-12,
                               atol=1e-12)
    W64 = jl._whiten_from_gram(Gj)
    x0 = np.random.default_rng(2).normal(size=A.n_cols).astype(np.float32)
    np.testing.assert_array_equal(
        linalg._prewhiten_x0(W64, torch.from_numpy(x0), A.n_blocks).numpy(),
        np.asarray(jl._prewhiten_x0(W64, jnp.asarray(x0), A.n_blocks)))
    assert not linalg._prewhiten_x0(W64, torch.zeros(A.n_cols),
                                    A.n_blocks).any()
    # the f64 factor whitens: W G W has nothing above 1 on its diagonal
    # (directions below the eigenvalue floor are left partly unwhitened)
    diag = np.einsum("bii->bi", np.einsum("bij,bjk,bkl->bil", W64, Gj, W64))
    assert diag.max() < 1.0 + 1e-6
    np.testing.assert_array_equal(
        linalg.block_whitener_host(A).numpy(),
        linalg._whiten_from_gram(G).astype(np.float32))


def test_block_apply_matches_jax():
    rng = np.random.default_rng(3)
    W = rng.normal(size=(7, 5, 5)).astype(np.float32)
    y = rng.normal(size=35).astype(np.float32)
    np.testing.assert_allclose(
        linalg._block_apply(torch.from_numpy(W), torch.from_numpy(y)).numpy(),
        np.asarray(jl._block_apply(jnp.asarray(W), jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)
