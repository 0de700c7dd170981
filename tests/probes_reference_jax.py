"""The JAX repo's tools at `chip_smoke.py`'s cuts of the port's probes, on
the CPU, on the port's own random draws: the numbers the chip check's
`probes` phase holds the card to (`PROBE_*_JAX` in chip_smoke.py).

    python tests/probes_reference_jax.py plateau|hashgrid|vortex_train|all
        [--out FILE]

Each kind first runs the port's tool on the CPU, as `chip_smoke.py` runs it
on the card (`PROBE_*_ARGS`, imported from there, with `--device cpu`):
the port draws its network init and points from a CPU generator
(`--host_rng`; the vortex model always draws on the CPU), so the card's run
draws the same numbers. Then it runs the JAX tool itself (`tools/*.py`,
through its `main(argv)` or `run_one`) on those draws:

* plateau and hashgrid: the JAX model starts from the port's initial
  fields, and every collocation draw of the JAX losses (`sample_random`,
  `sample_boundary`, `sample_boundary2D_separate`) returns, through an
  ordered `io_callback`, the port's next rows of that kind. The port's
  fused advect fit draws a chunk's points in bulk, JAX one iteration at a
  time; the rows of each kind come in the same order either way. The JAX
  `Solver` runs unpipelined, and for the plateau cut every JAX fit is
  capped at the port's `--max_iters` (the JAX tool has no such flag).
* vortex_train: the JAX model's `init_rbf` and `build_points` return the
  port's draws, converted.

Prints one JSON object per kind, {"kind", "port_cpu": {...}, "jax":
{...}}, the quantities the chip check reads, and writes them to FILE with
`--out`. On one CPU core: plateau ~6 min, hashgrid ~8, vortex_train ~10.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import chip_smoke as cs  # noqa: E402
from vortex_hashgrid_reference_jax import _patched  # noqa: E402

KINDS = ("plateau", "hashgrid", "vortex_train")


def _records(text: str) -> list:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


class _Rows:
    """The port's draws, one queue of rows per kind: record a draw, then
    hand out its rows in the same order in pieces of any size."""

    def __init__(self):
        self.rows, self.used = {}, {}

    def record(self, kind, value):
        a = value.detach().cpu().numpy()
        self.rows.setdefault(kind, []).append(a.reshape(-1, a.shape[-1]))

    def take(self, kind, shape):
        if isinstance(self.rows.get(kind), list):
            self.rows[kind] = np.concatenate(self.rows[kind])
            self.used[kind] = 0
        i, n = self.used.get(kind, 0), shape[0]
        got = self.rows[kind][i:i + n]
        if got.shape != tuple(shape):
            raise RuntimeError(f"draw {kind}: JAX asks for {shape} at row "
                               f"{i}, the port drew "
                               f"{self.rows[kind].shape[0]} rows")
        self.used[kind] = i + n
        return got.astype(np.float32)


# the samplers: name -> (kind of a call, the rows a JAX call asks for)
SAMPLERS = {
    "sample_random": (lambda n, sdim=1, **k: f"random{sdim}",
                      lambda n, sdim=1, **k: (n, sdim)),
    "sample_boundary": (lambda n, sdim, **k: f"boundary{sdim}",
                        lambda n, sdim, **k: (2 * (n // 2), sdim)),
    "sample_boundary2D_separate": (lambda n, side, **k: side,
                                   lambda n, side, **k: (2 * (n // 2), 2)),
}


def _recording(port_ns, names, rows):
    def wrap(name):
        fn, kind = getattr(port_ns, name), SAMPLERS[name][0]

        def draw(gen, *a, **k):
            v = fn(gen, *a, **k)
            rows.record(kind(*a, **k), v)
            return v
        return draw
    return {n: wrap(n) for n in names}


def _feeding(names, rows):
    import jax
    import jax.numpy as jnp
    from jax.experimental import io_callback

    def wrap(name):
        kind_of, shape_of = SAMPLERS[name]

        def draw(key, *a, **k):
            kind, shape = kind_of(*a, **k), shape_of(*a, **k)
            return io_callback(lambda _key: rows.take(kind, shape),
                               jax.ShapeDtypeStruct(shape, jnp.float32), key,
                               ordered=True)
        return draw
    return {n: wrap(n) for n in names}


def _capped_solver(cap=None):
    """The JAX Solver unpipelined, each fit capped at `cap` iterations."""
    from insr_pde_tpu.models import solver as jsolver

    class Solver(jsolver.Solver):
        def __init__(self, *a, **k):
            if cap is not None:
                k["max_n_iters"] = min(k["max_n_iters"], cap)
            super().__init__(*a, **{**k, "pipeline": False})
    return Solver


def _started_from(cls, init):
    """A subclass of the JAX model `cls` whose fields start as the port's
    init (`init["fields"]`, numpy)."""
    import jax
    import jax.numpy as jnp

    class Paired(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if set(self.fields) != set(init["fields"]):
                raise RuntimeError(f"fields: JAX {sorted(self.fields)}, the "
                                   f"port {sorted(init['fields'])}")
            self.fields = {n: jax.tree_util.tree_map(jnp.asarray, v)
                           for n, v in init["fields"].items()}
    return Paired


def _capturing(cls, init):
    """A subclass of the port's model `cls` that keeps its initial fields
    as numpy in `init`."""
    from insr_pde_tpu_torch.convert import (hashgrid_params_to_numpy,
                                            params_to_numpy)

    class Capturing(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            init["fields"] = {n: hashgrid_params_to_numpy(v)
                              if isinstance(v, dict) else params_to_numpy(v)
                              for n, v in self.fields.items()}
    return Capturing


def run_plateau(argv=None):
    """The plateau probe at `argv` (chip_smoke's PROBE_PLATEAU_ARGS by
    default, which must carry --max_iters and --candidates)."""
    from insr_pde_tpu.models import base as jbase
    from insr_pde_tpu.models import fluid as jfluid
    from insr_pde_tpu.models import solver as jsolver
    from insr_pde_tpu_torch import plateau_probe
    from insr_pde_tpu_torch.models import fluid as tfluid
    import tools.plateau_probe as jtool
    argv = list(cs.PROBE_PLATEAU_ARGS if argv is None else argv)
    names = ("sample_random", "sample_boundary2D_separate")
    rows, init = _Rows(), {}
    with _patched(tfluid, **_recording(tfluid, names, rows),
                  Fluid2DModel=_capturing(tfluid.Fluid2DModel, init)):
        port = plateau_probe.main(argv + ["--device", "cpu"])
    # the JAX tool takes the same flags but the port's --max_iters and
    # --host_rng: its fits are capped by the Solver instead
    i = argv.index("--max_iters")
    cap = int(argv[i + 1])
    jargv = [a for a in argv[:i] + argv[i + 2:] if a != "--host_rng"]
    solver = _capped_solver(cap)
    out = io.StringIO()
    with _patched(jfluid, **_feeding(names, rows),
                  Fluid2DModel=_started_from(jfluid.Fluid2DModel, init)), \
            _patched(jbase, Solver=solver), _patched(jsolver, Solver=solver), \
            contextlib.redirect_stdout(out):
        jtool.main(jargv + ["--platform", "cpu"])
    return {"port_cpu": port, "jax": _records(out.getvalue())}


def run_hashgrid(argv=None):
    """The hash-grid probe at `argv` (chip_smoke's PROBE_HASHGRID_ARGS by
    default); the JAX tool's `run_one` per network."""
    from insr_pde_tpu.models import advection as jadv
    from insr_pde_tpu.models import base as jbase
    from insr_pde_tpu_torch import hashgrid_probe
    from insr_pde_tpu_torch.models import advection as tadv
    import tools.hashgrid_probe as jtool
    names = ("sample_random", "sample_boundary")
    args = hashgrid_probe.parser().parse_args(
        cs.PROBE_HASHGRID_ARGS if argv is None else argv)
    rec = {"port_cpu": [], "jax": []}
    for net in args.networks:
        rows, init = _Rows(), {}
        with _patched(tadv, **_recording(tadv, names, rows),
                      Advection1DModel=_capturing(tadv.Advection1DModel,
                                                  init)):
            rec["port_cpu"].append(hashgrid_probe.run_one(
                net, args.T, args.iters, "cpu", host_rng=True))
        with _patched(jadv, **_feeding(names, rows),
                      Advection1DModel=_started_from(jadv.Advection1DModel,
                                                     init)), \
                _patched(jbase, Solver=_capped_solver()):
            rec["jax"].append(jtool.run_one(net, args.T, args.iters))
    return rec


def run_vortex_train(argv=None):
    """The vortex train probe at `argv` (chip_smoke's
    PROBE_VORTEX_TRAIN_ARGS by default)."""
    import jax.numpy as jnp
    from insr_pde_tpu.models import rbf as jrbf
    from insr_pde_tpu.models import vortex as jv
    from insr_pde_tpu_torch import vortex_train_probe
    from insr_pde_tpu_torch.convert import rbf_params_to_numpy
    from insr_pde_tpu_torch.models import vortex as tv
    import tools.vortex_train_probe as jtool
    argv = list(cs.PROBE_VORTEX_TRAIN_ARGS if argv is None else argv)
    port = vortex_train_probe.main(argv + ["--device", "cpu"])
    # the port's draws: a model of the probe's config on the CPU
    args = vortex_train_probe.parser().parse_args(argv)
    tm = tv.VortexModel(vortex_train_probe.config(args, "/nonexistent"),
                        log=False, device="cpu")
    params = jrbf.RBFParams(*(jnp.asarray(a) for a in
                              rbf_params_to_numpy(tm.params)))
    p = tm.pts
    pts = jv.SpaceTimePoints(jnp.asarray(p.x.numpy()),
                             jnp.asarray(p.t.numpy()),
                             jnp.asarray(p.norm.numpy()), p.inner, p.neu,
                             p.dirp, p.left, p.init)
    del tm
    out = io.StringIO()
    with _patched(jv, init_rbf=lambda cfg, key: params,
                  build_points=lambda cfg, key: pts), \
            contextlib.redirect_stdout(out):
        jtool.main(argv + ["--platform", "cpu"])
    return {"port_cpu": port, "jax": _records(out.getvalue())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=KINDS + ("all",))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("INSR_NO_COMPILATION_CACHE", "1")
    import jax
    import torch
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    recs = []
    for kind in (KINDS if args.kind == "all" else (args.kind,)):
        rec = {"kind": kind, **globals()[f"run_{kind}"]()}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f)


if __name__ == "__main__":
    main()
