"""The JAX package's runs that set the bars of the port's chip check
(`chip_smoke.py`, phases `vortex_cg`, `vortex_train`, `stream_train`,
`rbf_advection`, `hashgrid_advection` and the hash check), on the CPU, on
the port's own random draws.

    python tests/vortex_hashgrid_reference_jax.py KIND [--seed S] [--out DIR]

KIND is one of the phases above, or `hash`. Each run takes the
configuration that `chip_smoke.py` gives the port (`VORTEX_CG_ARGS`,
`VORTEX_TRAIN_ARGS`, `STREAM_TRAIN_ARGS`, `RBF_ADV_CFG`, `HASH_ADV_ARGS`,
imported from there so that the two cannot drift apart), at the seed the
chip check runs unless `--seed` says otherwise. It first runs the port on
the CPU, which draws the random basis, the points and the network init
from a CPU `torch.Generator`: the numbers the card's run draws too (the
vortex and RBF models always draw on the CPU; the hash-grid path runs with
`--host_rng`). Then it runs the JAX package on those same draws:

* vortex and RBF advection: the JAX model's `init_rbf` and point builder
  return the port's draws, converted; the vortex runs also give each
  residual block at the init coefficients (train: from the JAX model's
  `_scaled_mse` calls) or after the solve (cg: `block_residuals`);
* hash-grid advection: the JAX fields start from the port's init, and
  every collocation draw of the JAX losses (`sample_random`,
  `sample_boundary`) returns, through an ordered `io_callback`, the
  port's draw for that iteration, in the port's order.

It prints one JSON object, {"kind", "seed", "port_cpu": {...}, "jax":
{...}}, the quantities the chip check reads, measured as it measures them,
and writes it to DIR/KIND_seedS.json when `--out` is given. `hash` prints
the JAX package's `_fast_hash` of fixed integer corners (`HASH_CORNERS`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the configurations the port is checked at (chip_smoke imports no JAX and
# nothing heavy at import), and the port's copy of starterL's flag handling
import chip_smoke as cs  # noqa: E402
from insr_pde_tpu_torch.starterL import (build_config,  # noqa: E402
                                         parse_args)

KINDS = ("vortex_cg", "vortex_train", "stream_train", "rbf_advection",
         "hashgrid_advection", "hash")


class _Recorder:
    """A metrics sink that keeps every scalar: (tag, step) -> {key: v}."""

    def __init__(self):
        self.rows = {}

    def add_scalars(self, tag, values, step):
        self.rows.setdefault(tag, {})[int(step)] = {
            k: float(v) for k, v in values.items()}

    def close(self):
        pass


@contextlib.contextmanager
def _patched(obj, **attrs):
    old = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


def _vortex_pair(args, seed):
    """(port model on the CPU, JAX model on the port's draws)."""
    import jax.numpy as jnp
    from insr_pde_tpu.models import rbf as jrbf
    from insr_pde_tpu.models import vortex as jv
    from insr_pde_tpu_torch.convert import rbf_params_to_numpy
    from insr_pde_tpu_torch.models import vortex as tv
    ns = parse_args(args[1:] + ["--device", "cpu"])   # past "vortex"
    tcfg = build_config(ns)
    if seed is not None:
        tcfg.seed = seed
    stream = ns.formulation == "stream"
    tm = (tv.StreamVortexModel if stream else tv.VortexModel)(
        tcfg, log=False, device="cpu")
    params = jrbf.RBFParams(*(jnp.asarray(a) for a in
                              rbf_params_to_numpy(tm.params)))
    p = tm.pts
    pts = jv.SpaceTimePoints(jnp.asarray(p.x.numpy()),
                             jnp.asarray(p.t.numpy()),
                             jnp.asarray(p.norm.numpy()), p.inner, p.neu,
                             p.dirp, p.left, p.init)
    jcfg = jv.VortexConfig(**dataclasses.asdict(tcfg))
    with _patched(jv, init_rbf=lambda cfg, key: params,
                  build_points=lambda cfg, key: pts):
        jm = (jv.StreamVortexModel if stream else jv.VortexModel)(
            jcfg, log=False)
    for m in (tm, jm):
        m.tb = _Recorder()
    return tm, jm, ns, tcfg.seed


def run_vortex_cg(seed):
    tm, jm, ns, seed = _vortex_pair(cs.VORTEX_CG_ARGS, seed)
    out = {}
    for name, m in (("port_cpu", tm), ("jax", jm)):
        m.matrix_solver(solver=ns.solver)
        rows = m.tb.rows["vortex_matrix"]
        out[name] = {"residual": [rows[i]["residual"] for i in sorted(rows)],
                     "cg_iters": [rows[i]["cgls_iters"]
                                  for i in sorted(rows)],
                     "blocks": {k: v["rms"] for k, v in
                                m.block_residuals().items()}}
    return seed, out


def _jax_terms(jm):
    """The JAX model's residual blocks at its coefficients, from its
    `_scaled_mse` calls in order."""
    from insr_pde_tpu.models import vortex as jv
    seen = []
    orig = jv._scaled_mse

    def record(lhs, rhs):
        v = orig(lhs, rhs)
        seen.append(float(v))
        return v

    with _patched(jv, _scaled_mse=record):
        jm.residual_loss(jm.params.u)
    return seen


def _run_train(args, seed):
    tm, jm, ns, seed = _vortex_pair(args, seed)
    terms = {"port_cpu": [float(v) for v in tm.residual_terms(tm.params.u)],
             "jax": _jax_terms(jm)}
    out = {}
    for name, m in (("port_cpu", tm), ("jax", jm)):
        m.train(ns.train_iters)
        rows = m.tb.rows["vortex_train"]
        losses = [rows[i]["loss"] for i in sorted(rows)]
        out[name] = {"loss_first": losses[0], "loss_last": losses[-1],
                     "iters": len(losses), "terms": terms[name]}
    return seed, out


def run_vortex_train(seed):
    return _run_train(cs.VORTEX_TRAIN_ARGS, seed)


def run_stream_train(seed):
    return _run_train(cs.STREAM_TRAIN_ARGS, seed)


def run_rbf_advection(seed):
    import jax.numpy as jnp
    import torch
    from insr_pde_tpu.models import rbf_advection as jra
    from insr_pde_tpu.models.rbf import RBFParams as JParams
    from insr_pde_tpu_torch.convert import rbf_params_to_numpy
    from insr_pde_tpu_torch.models import rbf_advection as tra
    (cx, cy), width = cs.RBF_ADV_BUMP

    def jbump(x):
        c = jnp.asarray([cx, cy])
        return jnp.exp(-jnp.sum((x - c) ** 2, axis=-1) / (2 * width ** 2))

    kw = dict(cs.RBF_ADV_CFG)
    if seed is not None:
        kw["seed"] = seed
    tcfg = tra.RBFAdvectionConfig(**kw)
    tm = tra.RBFAdvectionModel(tcfg, cs._rbf_bump, device="cpu")
    params = JParams(*(jnp.asarray(a) for a in
                       rbf_params_to_numpy(tm.params)))
    p = tm.pts
    pts = jra._Points(x=jnp.asarray(p.x.numpy()), t=jnp.asarray(p.t.numpy()),
                      inner=p.inner, init=p.init, inflow=p.inflow)

    class Paired(jra.RBFAdvectionModel):
        def _build_points(self, key):
            return pts

    with _patched(jra, init_rbf=lambda cfg, key: params):
        jm = Paired(jra.RBFAdvectionConfig(**kw), jbump)
    grid = cs.rbf_adv_grid()
    out = {}
    res = tm.solve()
    g = torch.from_numpy(grid)
    out["port_cpu"] = {**cs.rbf_adv_errors(tm.evaluate(g, 0.0).numpy(),
                                           tm.evaluate(g, 1.0).numpy(),
                                           grid),
                       "residual": res, "niter": int(tm.info["niter"])}
    res = jm.solve()
    out["jax"] = {**cs.rbf_adv_errors(
        np.asarray(jm.evaluate(jnp.asarray(grid), 0.0)),
        np.asarray(jm.evaluate(jnp.asarray(grid), 1.0)), grid),
        "residual": float(res)}
    return tcfg.seed, out


def _rel_l2s(exp_dir, cfg):
    return [cs.advect_rel_l2(
        np.load(os.path.join(exp_dir, "results", f"t{t:03d}.npz"))["arr_0"],
        cfg.vis_resolution, cfg.length, cfg.vel, cfg.dt, t)
        for t in range(cs.HASH_ADV_STEPS + 1)]


def run_hashgrid_advection(seed):
    import jax
    import jax.numpy as jnp
    from jax.experimental import io_callback
    import main as jax_main
    from insr_pde_tpu.config import parse_args as jparse
    from insr_pde_tpu.models import advection as ja
    from insr_pde_tpu_torch.__main__ import main as port_main
    from insr_pde_tpu_torch.config import parse_args as tparse
    from insr_pde_tpu_torch.convert import hashgrid_params_to_numpy
    from insr_pde_tpu_torch.models import advection as tadv
    out_dir = tempfile.mkdtemp(prefix="hashgrid_ref_")
    args = list(cs.HASH_ADV_ARGS)
    if seed is not None:
        args += ["--seed", str(seed)]
    jargs = [a for a in args if a != "--host_rng"]   # a port option
    where = ["--proj_dir", out_dir, "--tag"]

    # the port on the CPU, its draws recorded in the order it makes them
    draws = []

    def recording(fn, kind):
        def draw(*a, **k):
            v = fn(*a, **k)
            draws.append((kind, v.numpy().reshape(-1, 1)))
            return v
        return draw

    with _patched(tadv, sample_random=recording(tadv.sample_random, "x"),
                  sample_boundary=recording(tadv.sample_boundary, "xb")):
        port_main(args + ["--device", "cpu"] + where + ["port"])
    tcfg = tparse(args + ["--device", "cpu"] + where + ["port"])
    init = tadv.Advection1DModel(tcfg).fields     # the same init draws
    fields = {k: jax.tree_util.tree_map(jnp.asarray,
                                        hashgrid_params_to_numpy(v))
              for k, v in init.items()}

    # the JAX package on the same init and draws
    feed = iter(draws)

    def feeder(kind):
        def host(_key):
            got, v = next(feed)
            if got != kind:
                raise RuntimeError(f"draw order: JAX asks for {kind}, the "
                                   f"port drew {got}")
            return v
        return host

    def sample_random(key, n, sdim):
        return io_callback(feeder("x"), jax.ShapeDtypeStruct(
            (n, sdim), jnp.float32), key, ordered=True)

    def sample_boundary(key, n, sdim):
        return io_callback(feeder("xb"), jax.ShapeDtypeStruct(
            (2 * (n // 2), sdim), jnp.float32), key, ordered=True)

    build = jax_main.build_model

    def paired_model(cfg, mesh=None):
        m = build(cfg, mesh)
        m.fields = dict(fields)
        return m

    with _patched(ja, sample_random=sample_random,
                  sample_boundary=sample_boundary), \
            _patched(jax_main, build_model=paired_model):
        jax_main.main(jargs + where + ["jax"])
    if next(feed, None) is not None:
        raise RuntimeError("the JAX run took fewer draws than the port made")
    jcfg = jparse(jargs + where + ["jax"], phase="train")
    return tcfg.seed, {
        "port_cpu": {"rel_l2": _rel_l2s(os.path.join(out_dir, "port"),
                                        tcfg)},
        "jax": {"rel_l2": _rel_l2s(os.path.join(out_dir, "jax"), jcfg)}}


def run_hash(seed):
    """The JAX package's hash of `chip_smoke.HASH_CORNERS` at each
    dimension, table size 2^15 (the port's is compared bit for bit)."""
    import jax.numpy as jnp
    from insr_pde_tpu.models.encodings import _fast_hash
    out = {}
    for dim, corners in cs.HASH_CORNERS.items():
        c = jnp.asarray(np.asarray(corners, np.int32))
        out[str(dim)] = np.asarray(
            _fast_hash(c, dim, cs.HASH_TABLE_SIZE)).tolist()
    return None, {"jax": out}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=KINDS)
    ap.add_argument("--seed", type=int, default=None,
                    help="default: the seed the chip check runs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import jax
    import torch
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    seed, rec = globals()[f"run_{args.kind}"](args.seed)
    rec = {"kind": args.kind, "seed": seed, **rec}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out,
                               f"{args.kind}_seed{seed}.json"), "w") as f:
            json.dump(rec, f)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
