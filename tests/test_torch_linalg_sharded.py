"""PyTorch port, the row-sharded CGLS of `ops/linalg.py`
(`cgls_sparse_chunked` on a group) against the JAX package's
(`cgls_sparse_sharded`, `cgls_sparse_sharded_chunked`,
`_sharded_block_gram`), on a random block-ELL system made with numpy.

The port's ranks are spawned over gloo on the CPU (tests/torch_ranks.py),
each with its row shard of the padded system (`torch_ranks.shard_rows`);
JAX runs the same solves on a mesh of as many virtual CPU devices. Worlds
2 and 3: 100 rows split evenly over 2 ranks and raggedly over 3.
* Damped (1e-3) so that the regularized solution is unique and both
  converge: Jacobi, block whitener and restarts, chunked, and the unchunked
  loop, against JAX at rtol 1e-3 and atol 1e-3 (tests/test_linalg.py's
  bar: two f32 CGLS runs under different reduction orders drift apart).
* 10 iterations at world k against the port's single-process solve:
  within 1e-5 relative.
* The block Gram summed over the shards equals `block_gram` (rtol 1e-5);
  each rank's rows are its slice of the system padded with zero rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from insr_pde_tpu.ops import linalg as jl
from insr_pde_tpu_torch.ops import linalg as tl
from insr_pde_tpu_torch.parallel import launch

import torch_ranks

torch.set_num_threads(1)

R, S, J, NB = 100, 4, 6, 11          # overdetermined: R > NB * J = 66
KW = dict(maxiter=400, tol=1e-12, damp=1e-3)
CASES = {
    "jacobi": dict(KW, chunk=17, precondition=True),
    "block": dict(KW, chunk=17, precondition="block"),
    "restart": dict(KW, chunk=17, precondition=True, restart=True),
    "unchunked": dict(KW, unchunked=True),
    "ten": dict(KW, chunk=17, precondition=True, maxiter=10),
}


def _system():
    rng = np.random.default_rng(7)
    vals = rng.normal(size=(R, S, J)).astype(np.float32)
    cols = np.stack([rng.permutation(NB)[:S] for _ in range(R)]).astype(
        np.int32)
    b = rng.normal(size=R).astype(np.float32)
    return vals, cols, b


@pytest.fixture(scope="module")
def runs():
    vals, cols, b = _system()
    return {k: launch(torch_ranks.sharded_cgls, k, "gloo",
                      args=(vals, cols, NB, b, CASES)) for k in (2, 3)}


def _jax(k, name):
    vals, cols, b = _system()
    A = jl.BlockSparse(vals=jnp.asarray(vals), cols=jnp.asarray(cols),
                       n_blocks=NB)
    mesh = Mesh(np.asarray(jax.devices()[:k]), ("rows",))
    x0 = jnp.zeros(NB * J)
    kw = dict(CASES[name])
    if kw.pop("unchunked", False):
        x, _ = jl.cgls_sparse_sharded(mesh, "rows", A, jnp.asarray(b), x0,
                                      **kw)
    else:
        x, _ = jl.cgls_sparse_sharded_chunked(mesh, "rows", A,
                                              jnp.asarray(b), x0, **kw)
    return np.asarray(x)


@pytest.mark.parametrize("name", ["jacobi", "block", "restart", "unchunked"])
@pytest.mark.parametrize("k", [2, 3])
def test_sharded_cgls_matches_jax_on_the_same_mesh_size(runs, k, name):
    ref = _jax(k, name)
    for res in runs[k]:
        np.testing.assert_array_equal(res[name], runs[k][0][name])
        np.testing.assert_allclose(res[name], ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("k", [2, 3])
def test_ten_iterations_match_the_single_process_solve(runs, k):
    vals, cols, b = _system()
    A = tl.BlockSparse(torch.from_numpy(vals), torch.from_numpy(cols), NB)
    kw = dict(CASES["ten"])
    x1, info = tl.cgls_sparse_chunked(A, torch.from_numpy(b),
                                      torch.zeros(NB * J), **kw)
    x1 = x1.numpy()
    assert int(info["niter"]) == 10
    for res in runs[k]:
        assert int(res["ten_niter"]) == 10
        assert np.linalg.norm(res["ten"] - x1) / np.linalg.norm(x1) < 1e-5


@pytest.mark.parametrize("k", [2, 3])
def test_sharded_gram_and_row_shards(runs, k):
    vals, cols, b = _system()
    A = tl.BlockSparse(torch.from_numpy(vals), torch.from_numpy(cols), NB)
    gram = tl.block_gram(A).numpy()
    per = -(-R // k)
    pad_vals = np.concatenate([vals, np.zeros((per * k - R, S, J),
                                              np.float32)])
    pad_b = np.concatenate([b, np.zeros(per * k - R, np.float32)])
    for r, res in enumerate(runs[k]):
        np.testing.assert_allclose(res["gram"], gram, rtol=1e-5,
                                   atol=1e-5 * np.abs(gram).max())
        np.testing.assert_array_equal(res["rows"],
                                      pad_vals[r * per:(r + 1) * per])
        np.testing.assert_array_equal(res["b"], pad_b[r * per:(r + 1) * per])
