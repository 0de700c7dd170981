"""PyTorch port, networks and derivative chains: `MLP.apply`, the batched
`value_grad`/`value_grad_laplacian` chains and the `torch.func` diff
operators against the JAX functions on the same (converted) parameters and
the same points. Tolerances: atol 1e-5 on values and Jacobians (f32 sums in
another order); the Laplacian carries omega^2 = 900, so it is compared
scaled by max|L|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insr_pde_tpu.models.networks import MLP as JMLP
from insr_pde_tpu.ops import diff as jdiff
from insr_pde_tpu_torch.config import Config
from insr_pde_tpu_torch.convert import params_from_jax, params_to_numpy
from insr_pde_tpu_torch.models.networks import MLP, get_network
from insr_pde_tpu_torch.ops import diff as tdiff

torch.set_num_threads(1)


def _pair(in_f, out_f, layers, width, nl="sine", seed=0, n=257):
    jnet = JMLP(in_f, out_f, layers, width, nonlinearity=nl,
                precision="highest")
    jparams = jnet.init(jax.random.PRNGKey(seed))
    np_params = [(np.asarray(w), np.asarray(b)) for w, b in jparams]
    tnet = MLP(in_f, out_f, layers, width, nonlinearity=nl)
    tparams = params_from_jax(np_params)
    x = np.random.default_rng(seed).uniform(-1, 1, (n, in_f)).astype(np.float32)
    return jnet, jparams, tnet, tparams, x


@pytest.mark.parametrize("in_f,out_f,layers,width",
                         [(2, 2, 3, 32), (3, 1, 2, 20), (1, 1, 2, 16)])
def test_apply_matches_jax(in_f, out_f, layers, width):
    jnet, jp, tnet, tp, x = _pair(in_f, out_f, layers, width)
    ref = np.asarray(jnet.apply(jp, jnp.asarray(x)))
    got = tnet.apply(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # apply_fused on a CPU tensor is the plain path: equal to apply
    np.testing.assert_allclose(
        tnet.apply_fused(tp, torch.from_numpy(x)).numpy(), got, atol=1e-7)


def test_params_roundtrip():
    _, jp, _, tp, _ = _pair(2, 2, 3, 16)
    for (w, b), (tw, tb) in zip(jp, params_to_numpy(tp)):
        np.testing.assert_array_equal(np.asarray(w), tw)
        np.testing.assert_array_equal(np.asarray(b), tb)


@pytest.mark.parametrize("out_f", [1, 2])
def test_derivative_chains_match_jax(out_f):
    jnet, jp, tnet, tp, x = _pair(2, out_f, 3, 32, seed=1)
    ju, jJ, jL = (np.asarray(a) for a in
                  jnet.value_grad_laplacian(jp, jnp.asarray(x)))
    tu, tJ, tL = (a.numpy() for a in
                  tnet.value_grad_laplacian(tp, torch.from_numpy(x)))
    np.testing.assert_allclose(tu, ju, atol=1e-5)
    np.testing.assert_allclose(tJ, jJ, atol=1e-5)
    scale = np.abs(jL).max()
    np.testing.assert_allclose(tL / scale, jL / scale, atol=1e-5)

    vu, vJ = (a.numpy() for a in tnet.value_grad(tp, torch.from_numpy(x)))
    np.testing.assert_allclose(vu, ju, atol=1e-5)
    np.testing.assert_allclose(vJ, jJ, atol=1e-5)


def test_chain_parameter_gradient_matches_jax():
    """First-order autograd through the chain = jax.grad through it."""
    jnet, jp, tnet, tp, x = _pair(2, 1, 2, 16, seed=2, n=64)

    def jloss(p):
        u, J, L = jnet.value_grad_laplacian(p, jnp.asarray(x))
        return jnp.mean(L ** 2) + jnp.mean(J ** 2)

    jg = jax.grad(jloss)(jp)
    leaves = [t.requires_grad_(True) for wb in tp for t in wb]
    u, J, L = tnet.value_grad_laplacian(tp, torch.from_numpy(x))
    (torch.mean(L ** 2) + torch.mean(J ** 2)).backward()
    for jl, tl in zip(jax.tree_util.tree_leaves(jg), leaves):
        jl = np.asarray(jl)
        # the last bias does not reach J or L: torch leaves its grad None
        tg = np.zeros_like(jl) if tl.grad is None else tl.grad.numpy()
        np.testing.assert_allclose(tg, jl,
                                   rtol=1e-4, atol=1e-4 * np.abs(jl).max())


def test_diff_operators_match_jax():
    jnet, jp, tnet, tp, x = _pair(2, 2, 2, 16, seed=3, n=64)
    _, jpp, _, tpp, _ = _pair(2, 1, 2, 16, seed=4, n=64)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    vj, vt = jnet.point_fn(jp), tnet.point_fn(tp)
    pj = JMLP(2, 1, 2, 16, precision="highest").point_fn(jpp)
    pt = MLP(2, 1, 2, 16).point_fn(tpp)

    def close(a, b, scaled=False):
        a, b = np.asarray(a), b.detach().numpy()
        s = np.abs(a).max() if scaled else 1.0
        np.testing.assert_allclose(b / s, a / s, atol=1e-5)

    close(jdiff.jacobian(vj, xj), tdiff.jacobian(vt, xt))
    close(jdiff.divergence(vj, xj), tdiff.divergence(vt, xt))
    close(jdiff.gradient(pj, xj), tdiff.gradient(pt, xt))
    close(jdiff.laplace(pj, xj), tdiff.laplace(pt, xt), scaled=True)
    close(jdiff.hessian(pj, xj), tdiff.hessian(pt, xt), scaled=True)
    lap, grad = tdiff.laplace(pt, xt, return_grad=True)
    close(jdiff.gradient(pj, xj), grad)
    jn = jdiff.laplace(pj, xj, normalize=True, eps=1e-6)
    close(jn, tdiff.laplace(pt, xt, normalize=True, eps=1e-6), scaled=True)


@pytest.mark.parametrize("nl", ["relu", "elu"])
def test_autodiff_dispatch_matches_jax(nl):
    """Non-sine MLPs take the torch.func path (no sine derivatives)."""
    jnet, jp, tnet, tp, x = _pair(2, 1, 2, 16, nl=nl, seed=5, n=50)
    ju, jJ, jL = (np.asarray(a) for a in
                  jnet.value_grad_laplacian(jp, jnp.asarray(x)))
    tu, tJ, tL = (a.detach().numpy() for a in
                  tnet.value_grad_laplacian(tp, torch.from_numpy(x)))
    np.testing.assert_allclose(tu, ju, atol=1e-5)
    np.testing.assert_allclose(tJ, jJ, atol=1e-5)
    np.testing.assert_allclose(tL, jL, atol=1e-4)
    assert tnet.second_order_ok == (nl == "elu")


def test_sine_init_distribution():
    """The JAX init bounds: U[±1/n] first layer, U[±sqrt(6/n)/30] later
    layers, U[±1/sqrt(n)] biases; means near 0, variances of a uniform."""
    g = torch.Generator()
    g.manual_seed(0)
    net = MLP(2, 2, 3, 128)
    params = net.init(g)
    assert [tuple(w.shape) for w, _ in params] == net.layer_dims
    for i, (w, b) in enumerate(params):
        fan_in = w.shape[0]
        bound = 1.0 / fan_in if i == 0 else np.sqrt(6.0 / fan_in) / 30.0
        w = w.numpy()
        assert w.dtype == np.float32
        assert np.abs(w).max() <= bound
        if w.size > 1000:
            np.testing.assert_allclose(w.var(), bound ** 2 / 3, rtol=0.1)
        assert np.abs(b.numpy()).max() <= 1.0 / np.sqrt(fan_in)


def test_get_network():
    """siren builds the MLP; hashgrid (alias grid) the hash-grid field with
    the flags' head (`tests/test_torch_encodings.py` holds it against
    JAX's); an unknown network raises, as in the JAX package."""
    from insr_pde_tpu_torch.models.networks import HashGridField
    cfg = Config(hidden_features=8, num_hidden_layers=1)
    net = get_network(cfg, 2, 1)
    assert isinstance(net, MLP) and net.layer_dims == [(2, 8), (8, 8), (8, 1)]
    for name in ("hashgrid", "grid"):
        grid = get_network(Config(network=name, hidden_features=8,
                                  num_hidden_layers=1), 2, 1)
        assert isinstance(grid, HashGridField)
        assert grid._head().layer_dims == [(16, 8), (8, 8), (8, 1)]
    with pytest.raises(NotImplementedError, match="network=mlp"):
        get_network(Config(network="mlp"), 2, 1)
