"""PyTorch port, `ops/svd.py` against the JAX package's `ops/svd.py`: the
closed-form singular values (2x2, 3x3; random, the identity, repeated
values), the ARAP and volume energies and their gradients against
`jax.grad` (finite at F = I and at repeated singular values), the polar
factor with its near-singular guard, and the `SingularValues` backward
against finite differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insr_pde_tpu.ops import svd as jsvd
from insr_pde_tpu_torch.ops import svd as tsvd

torch.set_num_threads(1)


def _rotation(rng, d):
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return q * np.sign(np.linalg.det(q))


def _matrices(case, d, n=24, seed=0):
    """(n, d, d) float32 matrices of one kind."""
    rng = np.random.default_rng(seed + 10 * d)
    if case == "random":
        F = rng.standard_normal((n, d, d))
    elif case == "near_identity":
        F = np.eye(d) + 0.4 * rng.standard_normal((n, d, d))
    elif case == "identity":
        F = np.broadcast_to(np.eye(d), (n, d, d))
    elif case == "repeated":
        # U diag(s) V^T with two equal singular values (all equal in 2D)
        s = np.array([1.7, 1.7, 0.6][:d])
        F = np.stack([_rotation(rng, d) @ np.diag(s) @ _rotation(rng, d).T
                      for _ in range(n)])
    else:
        raise ValueError(case)
    return np.ascontiguousarray(F, dtype=np.float32)


CASES = ["random", "near_identity", "identity", "repeated"]


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_singular_values_match_jax(d, case):
    F = _matrices(case, d)
    ts = tsvd.singular_values(torch.from_numpy(F)).numpy()
    js = np.asarray(jsvd.singular_values(jnp.asarray(F)))
    # the same closed forms in f32; they differ only in the determinant's
    # rounding (cofactors against an LU). At a double root of F^T F, Cardano
    # moves the pair by ~sqrt of that rounding (JAX: 1.70015 / 1.69985 for
    # 1.7, 1.7; the port 1.7, 1.7): atol 1e-5 (2x2), 5e-4 (3x3)
    np.testing.assert_allclose(ts, js, atol=1e-5 if d == 2 else 5e-4)
    # and both are the singular values: 2x2 to 1e-5, 3x3 to ~sqrt(eps)
    ref = np.linalg.svd(F.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(ts, ref, atol=1e-5 if d == 2 else 1e-3)


@pytest.mark.parametrize("d", [2, 3])
def test_determinant_is_closed_form(d):
    F = _matrices("random", d)
    np.testing.assert_allclose(tsvd._det(torch.from_numpy(F)).numpy(),
                               np.linalg.det(F.astype(np.float64)),
                               rtol=1e-5, atol=1e-5)


def _energy_and_grad_jax(fn, F):
    val, grad = jax.value_and_grad(fn)(jnp.asarray(F))
    return float(val), np.asarray(grad)


def _energy_and_grad_torch(fn, F):
    t = torch.from_numpy(F).requires_grad_(True)
    val = fn(t)
    val.backward()
    return val.item(), t.grad.numpy()


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("energy", ["arap_energy", "volume_energy"])
def test_energy_and_gradient_match_jax(d, case, energy):
    """Value (rtol 1e-4 plus 1e-4 absolute for energies near 0) and
    gradient (atol 1e-4 of max(1, max|grad|)) of each energy, against
    jax.grad through the JAX package's custom JVPs; every gradient finite,
    and 0 at the rest state."""
    F = _matrices(case, d)
    jv, jg = _energy_and_grad_jax(getattr(jsvd, energy), F)
    tv, tg = _energy_and_grad_torch(getattr(tsvd, energy), F)
    assert np.isfinite(tg).all()
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)
    scale = max(1.0, float(np.abs(jg).max()))
    np.testing.assert_allclose(tg, jg, atol=1e-4 * scale)
    if case == "identity":
        assert tv < 1e-10 and np.abs(tg).max() < 1e-6


@pytest.mark.parametrize("d", [2, 3])
def test_polar_rotation_matches_jax(d):
    F = _matrices("near_identity", d)
    R = tsvd.polar_rotation(torch.from_numpy(F)).numpy()
    np.testing.assert_allclose(R, np.asarray(jsvd.polar_rotation(
        jnp.asarray(F))), atol=1e-5)
    # U V^T of the SVD where F is well conditioned (6 Newton steps reach
    # f32 accuracy there; both packages take 6)
    U, s, Vt = np.linalg.svd(F.astype(np.float64))
    good = s[:, 0] / s[:, -1] < 3.0
    assert good.sum() >= 8
    np.testing.assert_allclose(R[good], (U @ Vt)[good], atol=1e-5)


@pytest.mark.parametrize("d", [2, 3])
def test_polar_rotation_guard_keeps_singular_matrices_finite(d):
    """A rank-deficient F (a collapsed element) sends X^-T past f32 range:
    the guard keeps its last finite iterate in both packages, and the other
    rows of the batch are untouched."""
    F = _matrices("near_identity", d, n=4)
    F[1] = 0.0
    F[1, 0, 0] = 1.0                        # rank 1
    F[2, :, 1] = F[2, :, 0]                 # two equal columns
    R = tsvd.polar_rotation(torch.from_numpy(F)).numpy()
    JR = np.asarray(jsvd.polar_rotation(jnp.asarray(F)))
    assert np.isfinite(R).all()
    np.testing.assert_allclose(R, JR, atol=1e-5)
    clean = tsvd.polar_rotation(torch.from_numpy(F[[0, 3]])).numpy()
    np.testing.assert_array_equal(R[[0, 3]], clean)
    # and the ARAP gradient through it stays finite
    _, tg = _energy_and_grad_torch(tsvd.arap_energy, F)
    assert np.isfinite(tg).all()


@pytest.mark.parametrize("d", [2, 3])
def test_nuclear_norm_backward_is_the_polar_factor(d):
    F = _matrices("near_identity", d)
    t = torch.from_numpy(F).requires_grad_(True)
    g = torch.linspace(0.5, 2.0, F.shape[0])
    (tsvd.nuclear_norm(t) * g).sum().backward()
    R = tsvd.polar_rotation(torch.from_numpy(F))
    np.testing.assert_allclose(t.grad.numpy(), (g[:, None, None] * R).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_singular_values_backward_against_finite_differences(d):
    """gradcheck in float64 (eps 1e-6, atol 1e-5) away from repeated
    values; d = 4 takes the library's svdvals primal."""
    F = torch.from_numpy(_matrices("near_identity", d, n=3).astype(
        np.float64)).requires_grad_(True)
    assert torch.autograd.gradcheck(tsvd.singular_values, (F,), eps=1e-6,
                                    atol=1e-5)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("case", ["repeated", "identity"])
def test_singular_values_backward_matches_jax_at_repeated_values(d, case):
    """The sigma-only rule where a full SVD pullback is infinite: the
    pullback of a cotangent that is constant over each block of equal
    singular values (then sum_i g_i u_i v_i^T does not depend on which
    singular vectors the SVD picks) against JAX's custom JVP in reverse
    mode, atol 1e-4."""
    F = _matrices(case, d, n=8)
    g = np.ones((8, d), np.float32) * np.linspace(0.5, 2.0, 8,
                                                  dtype=np.float32)[:, None]
    if case == "repeated" and d == 3:
        g[:, 2] = -0.7                      # the third value is apart
    _, vjp = jax.vjp(jsvd.singular_values, jnp.asarray(F))
    (jg,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(F).requires_grad_(True)
    (tsvd.singular_values(t) * torch.from_numpy(g)).sum().backward()
    assert np.isfinite(t.grad.numpy()).all()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-4)
