"""PyTorch port, samplers: `sample_uniform` equals the JAX function bit for
bit, the boundary strips have the JAX geometry and naming, and the random
samplers pass statistical checks (torch and JAX draw different numbers)."""

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets it)
import numpy as np
import pytest
import torch

from insr_pde_tpu.ops import sampling as jsampling
from insr_pde_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)


@pytest.mark.parametrize("resolution", [1, 2, 7, 16, 32, 100, 128, 500])
@pytest.mark.parametrize("sdim", [1, 2, 3])
def test_sample_uniform_bit_exact(resolution, sdim):
    if resolution ** sdim > 300_000:
        resolution = 64
    for flatten in (True, False):
        ref = np.asarray(jsampling.sample_uniform(resolution, sdim, flatten))
        got = tsampling.sample_uniform(resolution, sdim, flatten).numpy()
        assert got.dtype == ref.dtype == np.float32
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_sample_random_statistics():
    n = 200_000
    x = tsampling.sample_random(_gen(0), n, 2).numpy()
    assert x.shape == (n, 2) and x.dtype == np.float32
    assert x.min() >= -1.0 and x.max() <= 1.0
    # U[-1, 1]: mean 0 (std 1/sqrt(3n)), variance 1/3, flat histogram
    np.testing.assert_allclose(x.mean(0), 0.0, atol=5 / np.sqrt(3 * n))
    np.testing.assert_allclose(x.var(0), 1.0 / 3.0, rtol=1e-2)
    hist, _ = np.histogram(x[:, 0], bins=20, range=(-1, 1))
    expected = n / 20
    chi2 = float(((hist - expected) ** 2 / expected).sum())
    assert chi2 < 50.0, chi2          # 19 dof: p < 1e-4 above ~46
    # independent axes
    assert abs(np.corrcoef(x[:, 0], x[:, 1])[0, 1]) < 0.01
    # the generator drives the draw: same seed, same points; new seed, new
    np.testing.assert_array_equal(
        x[:10], tsampling.sample_random(_gen(0), n, 2).numpy()[:10])
    assert not np.array_equal(
        x[:10], tsampling.sample_random(_gen(1), n, 2).numpy()[:10])


@pytest.mark.parametrize("side", ["horizontal", "vertical"])
def test_boundary_strips_match_jax_geometry(side):
    """'horizontal' = the x = ±1 strips, 'vertical' = the y = ±1 strips
    (the reference's naming quirk), n//2 points per strip, -1 strip first;
    the port's strips cover the same boxes as the JAX strips."""
    eps = 1e-4
    n = 4001
    got = tsampling.sample_boundary2D_separate(_gen(3), n, side).numpy()
    import jax
    ref = np.asarray(jsampling.sample_boundary2D_separate(
        jax.random.PRNGKey(3), n, side))
    assert got.shape == ref.shape == (2 * (n // 2), 2)
    normal = 0 if side == "horizontal" else 1
    along = 1 - normal
    m = n // 2
    for pts in (got, ref):
        for half, centre in ((pts[:m], -1.0), (pts[m:], 1.0)):
            # f32 spacing at 1 is 1.2e-7
            assert np.all(np.abs(half[:, normal] - centre) <= eps + 2.4e-7)
            assert np.all(np.abs(half[:, along]) <= 1.0)
    # both fill their strips the same way (uniform along and across)
    for pts in (got, ref):
        np.testing.assert_allclose(pts[:, along].mean(), 0.0, atol=0.05)
        np.testing.assert_allclose(pts[:, along].var(), 1 / 3, rtol=0.05)
        across = (np.abs(pts[:, normal]) - 1.0) / eps
        np.testing.assert_allclose(across.var(), 1 / 3, rtol=0.1)


def test_boundary_rejects_unknown_side():
    with pytest.raises(RuntimeError):
        tsampling.sample_boundary2D_separate(_gen(0), 10, "diagonal")
