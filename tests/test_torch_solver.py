"""PyTorch port, solver: `plateau_update`, the flat Adam and the solve loop
against the JAX `plateau_update` and `optax.adam` on one fixed gradient
stream, with an early-stop latch trigger and non-finite iterations."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from insr_pde_tpu.models import solver as jsolver
from insr_pde_tpu_torch.models import solver as tsolver

torch.set_num_threads(1)

KW = dict(factor=0.1, patience=3, threshold=1e-4, min_scale=1e-6,
          stop_scale=0.011, early_stop=True)


def test_plateau_update_sequence_matches_jax():
    rng = np.random.default_rng(0)
    # improving, then flat (triggers reductions and the latch), then noisy
    losses = np.concatenate([np.linspace(1.0, 0.5, 6), np.full(12, 0.5),
                             rng.uniform(0.4, 0.6, 10)]).astype(np.float32)
    js = jsolver.plateau_init()
    ts = tsolver.plateau_init()
    seen_trigger = False
    for loss in losses:
        js = jsolver.plateau_update(js, jnp.float32(loss), **KW)
        ts = tsolver.plateau_update(ts, torch.tensor(loss), **KW)
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        seen_trigger |= bool(ts.stopped)
    assert seen_trigger and float(ts.scale) < 1.0


def test_flat_adam_matches_optax():
    rng = np.random.default_rng(1)
    p = rng.normal(size=50).astype(np.float32)
    opt = optax.adam(1e-3)
    js = opt.init(jnp.asarray(p))
    ts = tsolver.adam_init(torch.from_numpy(p))
    for _ in range(25):
        g = rng.normal(scale=rng.uniform(1e-3, 1e2), size=50).astype(np.float32)
        ju, js = opt.update(jnp.asarray(g), js)
        tu, ts = tsolver.adam_update(torch.from_numpy(g), ts, 1e-3)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=2e-6,
                                   atol=1e-12)
    assert int(ts.count) == 25


def _stream(n_iters, size, seed=2):
    """Per-iteration (main loss, gradient): flat losses make the plateau
    scheduler reduce the LR twice and latch; one NaN loss and one inf
    gradient must be skipped without being written."""
    rng = np.random.default_rng(seed)
    mains = np.concatenate([np.linspace(1.0, 0.8, 4),
                            np.full(n_iters - 4, 0.8)]).astype(np.float32)
    grads = rng.normal(size=(n_iters, size)).astype(np.float32)
    mains[2] = np.nan
    grads[5, 3] = np.inf
    return mains, grads


def _jax_reference(p0, mains, grads, lr):
    """The JAX solver's step (solver.py `_step`) with its plateau_update and
    optax.adam, gradient given."""
    opt = optax.adam(lr)
    p = jnp.asarray(p0)
    st = opt.init(p)
    pl = jsolver.plateau_init()
    n_active, lrs = 0, []
    for m, g in zip(mains, grads):
        g = jnp.asarray(g)
        upd, new_st = opt.update(g, st, p)
        new_p = p + upd * pl.scale
        finite = jnp.isfinite(m) & jnp.all(jnp.isfinite(g))
        active = ~pl.stopped
        write = active & finite
        lrs.append(float(lr * pl.scale))
        n_active += int(active)
        p = jnp.where(write, new_p, p)
        st = jsolver._tree_where(write, new_st, st)
        new_pl = jsolver.plateau_update(pl, jnp.float32(m), **{
            **KW, "min_scale": 1e-8 / lr, "stop_scale": 1.1e-4 / lr})
        pl = jsolver._tree_where(write, new_pl, pl)
    return np.asarray(p), n_active, np.asarray(lrs[:n_active]), st


@pytest.mark.parametrize("chunk_size", [7, 40])
def test_solver_fit_matches_jax_step_on_gradient_stream(chunk_size):
    lr = 1e-2
    size = 6
    mains, grads = _stream(40, size)
    p0 = np.random.default_rng(3).normal(size=size).astype(np.float32)
    ref_p, ref_n, ref_lr, ref_opt = _jax_reference(p0, mains, grads, lr)
    assert ref_n < 40            # the latch fired inside the run

    it = iter(range(len(mains)))

    def sample_fn():
        t = next(it)
        return {"main": torch.tensor(mains[t]),
                "g": torch.from_numpy(grads[t])}

    def loss_fn(params, pts, aux):
        flat = torch.cat([t.reshape(-1) for wb in params for t in wb])
        return {"main": pts["main"] + 0.0 * flat.sum(),
                "lin": (flat * pts["g"]).sum()}

    solver = tsolver.Solver(loss_fn, sample_fn, lr=lr, max_n_iters=40,
                            chunk_size=chunk_size, plateau_patience=3,
                            plateau_factor=0.1, plateau_min_lr=1e-8,
                            early_stop_min_lr=1.1e-4)
    params = [(torch.from_numpy(p0[:4].reshape(2, 2).copy()),
               torch.from_numpy(p0[4:].copy()))]
    res = solver.fit(params)
    got = torch.cat([t.reshape(-1) for wb in res.params for t in wb]).numpy()
    np.testing.assert_allclose(got, ref_p, rtol=1e-5, atol=1e-7)
    assert res.n_iters == ref_n
    assert len(res.history["main"]) == ref_n
    np.testing.assert_allclose(res.history["_lr"], ref_lr, rtol=1e-6)
    assert np.isnan(res.history["main"][2])        # logged, not written
    # Adam's step count froze on the two skipped iterations and the latch
    assert int(ref_opt[0].count) == ref_n - 2


def test_debug_nan_warns_and_skips():
    def sample_fn():
        return {}

    def loss_fn(params, pts, aux):
        w, _ = params[0]
        return {"main": torch.sqrt(w.sum() - 10.0)}     # NaN while sum < 10

    solver = tsolver.Solver(loss_fn, sample_fn, lr=1e-2, max_n_iters=4,
                            chunk_size=2, debug_nan=True)
    w0 = torch.ones(2, 2)
    with pytest.warns(UserWarning, match="NaN gradients"):
        res = solver.fit([(w0, torch.zeros(2))])
    np.testing.assert_array_equal(res.params[0][0].numpy(), w0.numpy())
    assert res.n_iters == 4 and np.isnan(res.history["main"]).all()


def test_solver_fits_a_quadratic():
    """End to end on a plain least-squares fit: the loss drops."""
    g = torch.Generator().manual_seed(0)
    target = torch.randn(3, 2, generator=g)

    def sample_fn():
        return {"x": torch.randn(64, 3, generator=g)}

    def loss_fn(params, pts, aux):
        (w, b), = params
        y = pts["x"] @ target
        return {"main": torch.mean((pts["x"] @ w + b - y) ** 2)}

    solver = tsolver.Solver(loss_fn, sample_fn, lr=1e-1, max_n_iters=300,
                            chunk_size=100, early_stop=False)
    res = solver.fit([(torch.zeros(3, 2), torch.zeros(2))])
    assert res.n_iters == 300
    assert res.final_loss < 1e-3 * res.history["main"][0]
