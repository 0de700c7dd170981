"""The JAX package's runs that set the bars of the port's chip check
(`chip_smoke.py`, phases `vortex_cg`, `vortex_train`, `stream_train`,
`rbf_advection`, `hashgrid_advection`, the hash check and `paper_matrix`'s
multi-scale Taylor-Green scene, `tlgnM`), on the CPU, on the port's own
random draws.

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
* hash-grid advection and tlgnM (`paper_args("fluid2DtlgnM")`, with
  `--host_rng`): the JAX fields start from the port's init, and every
  collocation draw of the JAX losses (`sample_random`, `sample_boundary`;
  the fluid's `sample_boundary2D_separate`) returns, through an ordered
  `io_callback`, the port's draw for that iteration, in the port's order
  (`run_on_port_draws`, which `tests/elasticity_reference_jax.py paired`
  uses too).

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
         "hashgrid_advection", "hash", "tlgnM")


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


def run_on_port_draws(args, port_ns, jax_ns, samplers, out_dir,
                      adjust=None):
    """The port's entry point on the CPU with `args` (into
    `out_dir/port`), each draw of the samplers named in `samplers` (module
    attributes of `port_ns`) recorded in the order the port makes it; then
    the JAX package's `main.py` on the same flags (without `--host_rng`,
    into `out_dir/jax`), its model started from the port's init fields
    (and the port's `sample_vis`, where the model has one), and each call
    of those samplers in `jax_ns` answered, through an ordered
    `io_callback`, with the port's draw. `samplers` maps a name to (kind,
    shape): functions of the call's arguments after the generator (or key)
    that give the draw's kind and its shape. A draw asked out of order, and
    a draw left over, raise. `adjust(jax_model)` may change the JAX model
    before its run. The JAX Solver runs unpipelined (its pipelined result
    is the same bits, but its speculative chunk after an early stop would
    take draws the port never makes). Returns (port model, JAX model, the
    port's iterations per fit, JAX's)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import io_callback
    import main as jax_main
    from insr_pde_tpu.models import base as jbase
    from insr_pde_tpu_torch import __main__ as port_cli
    from insr_pde_tpu_torch.convert import (hashgrid_params_to_numpy,
                                            params_to_numpy)

    # --host_rng is a port option; one JAX device, as the port runs one
    # process (the test harness gives JAX 8 virtual CPU devices)
    jargs = [a for a in args if a != "--host_rng"] + ["--n_devices", "1"]
    where = ["--proj_dir", out_dir, "--tag"]
    draws, init = [], {}

    def recording(name):
        fn, kind = getattr(port_ns, name), samplers[name][0]

        def draw(gen, *a, **k):
            v = fn(gen, *a, **k)
            draws.append((kind(*a, **k), v.detach().cpu().numpy().reshape(
                samplers[name][1](*a, **k))))
            return v
        return draw

    build = port_cli.build_model

    def capturing(cfg, group=None):
        m = build(cfg, group)
        init["fields"] = {k: hashgrid_params_to_numpy(v)
                          if isinstance(v, dict) else params_to_numpy(v)
                          for k, v in m.fields.items()}
        vis = getattr(m, "sample_vis", None)
        init["vis"] = None if vis is None else vis.cpu().numpy()
        return m

    with _patched(port_ns, **{n: recording(n) for n in samplers}), \
            _patched(port_cli, build_model=capturing):
        port = port_cli.main(args + ["--device", "cpu"] + where + ["port"])

    feed = iter(draws)

    def feeder(kind):
        def host(_key):
            got, v = next(feed, (None, None))
            if got != kind:
                raise RuntimeError(f"draw order: JAX asks for {kind}, the "
                                   f"port drew {got}")
            return v
        return host

    def feeding(name):
        kind, shape = samplers[name]

        def draw(key, *a, **k):
            return io_callback(feeder(kind(*a, **k)), jax.ShapeDtypeStruct(
                shape(*a, **k), jnp.float32), key, ordered=True)
        return draw

    jax_iters, held = [], []

    class Solver(jbase.Solver):
        def __init__(self, *a, **k):
            super().__init__(*a, **{**k, "pipeline": False})

        def fit(self, *a, **k):
            res = super().fit(*a, **k)
            jax_iters.append(int(res.n_iters))
            return res

    jbuild = jax_main.build_model

    def paired_model(cfg, mesh=None):
        m = jbuild(cfg, mesh)
        if set(m.fields) != set(init["fields"]):
            raise RuntimeError(f"fields: JAX {sorted(m.fields)}, the port "
                               f"{sorted(init['fields'])}")
        m.fields = {k: jax.tree_util.tree_map(jnp.asarray, v)
                    for k, v in init["fields"].items()}
        if init["vis"] is not None:
            m.sample_vis = jnp.asarray(init["vis"])
        if adjust is not None:
            adjust(m)
        held.append(m)
        return m

    with _patched(jax_ns, **{n: feeding(n) for n in samplers}), \
            _patched(jbase, Solver=Solver), \
            _patched(jax_main, build_model=paired_model):
        jax_main.main(jargs + where + ["jax"])
    if next(feed, None) is not None:
        raise RuntimeError("the JAX run took fewer draws than the port made")
    port_iters = [int(r["n_iters"]) for r in port.phase_timings]
    return port, held[0], port_iters, jax_iters


def _random_kind(n, sdim=1):
    return f"random{sdim}"


def _random_shape(n, sdim=1):
    return (n, sdim)


# the fluid model's samplers: interior points and the boundary strips by
# side (insr_pde_tpu_torch/models/fluid.py, insr_pde_tpu/models/fluid.py)
FLUID_SAMPLERS = {
    "sample_random": (_random_kind, _random_shape),
    "sample_boundary2D_separate": (
        lambda n, side, epsilon=1e-4: side,
        lambda n, side, epsilon=1e-4: (2 * (n // 2), 2)),
}


def tlgnM_pair(args, out_dir):
    """The fluid scene `args` on the port's draws: (the port's iterations
    per fit, JAX's, per-t fluid statistics of each run, the largest |port
    - JAX| of the final fields' parameters)."""
    from insr_pde_tpu.models import fluid as jfluid
    from insr_pde_tpu_torch.elasticity_stats import run_stats
    from insr_pde_tpu_torch.models import fluid as tfluid
    port, jm, port_iters, jax_iters = run_on_port_draws(
        args, tfluid, jfluid, FLUID_SAMPLERS, out_dir)
    return {"port_cpu": {"iters": port_iters,
                         "stats": run_stats("fluid", os.path.join(out_dir,
                                                                  "port"))},
            "jax": {"iters": jax_iters,
                    "stats": run_stats("fluid", os.path.join(out_dir,
                                                             "jax"))},
            "param_max_abs_diff": param_max_abs_diff(port.fields, jm.fields)}


def param_max_abs_diff(port_fields, jax_fields):
    """The largest |port - JAX| over every weight and bias of every
    field."""
    from insr_pde_tpu_torch.convert import params_to_numpy
    return max(float(np.abs(np.asarray(j) - t).max())
               for name, p in port_fields.items()
               for tl, jl in zip(params_to_numpy(p), jax_fields[name])
               for t, j in zip(tl, jl))


def run_tlgnM(seed):
    """`paper_matrix`'s multi-scale Taylor-Green scene (chip_smoke
    `paper_args("fluid2DtlgnM")`) on the port's draws."""
    args = cs.paper_args("fluid2DtlgnM")
    if seed is not None:
        args += ["--seed", str(seed)]
    rec = tlgnM_pair(args, tempfile.mkdtemp(prefix="tlgnM_ref_"))
    return (seed if seed is not None else 0), rec


# the advection model's samplers (insr_pde_tpu_torch/models/advection.py,
# insr_pde_tpu/models/advection.py); the port draws the boundary points
# as a batch of one
ADVECTION_SAMPLERS = {
    "sample_random": (_random_kind, _random_shape),
    "sample_boundary": (lambda n, sdim, epsilon=1e-4, batch=0: "boundary",
                        lambda n, sdim, epsilon=1e-4, batch=0:
                        (2 * (n // 2), sdim)),
}


def run_hashgrid_advection(seed):
    from insr_pde_tpu.models import advection as jadv
    from insr_pde_tpu_torch.models import advection as tadv
    out_dir = tempfile.mkdtemp(prefix="hashgrid_ref_")
    args = list(cs.HASH_ADV_ARGS)
    if seed is not None:
        args += ["--seed", str(seed)]
    port, jm, _, _ = run_on_port_draws(args, tadv, jadv, ADVECTION_SAMPLERS,
                                       out_dir)
    return port.cfg.seed, {
        "port_cpu": {"rel_l2": _rel_l2s(os.path.join(out_dir, "port"),
                                        port.cfg)},
        "jax": {"rel_l2": _rel_l2s(os.path.join(out_dir, "jax"), jm.cfg)}}


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
