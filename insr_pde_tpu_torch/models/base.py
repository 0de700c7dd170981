"""Core model protocol: timestep loop, per-phase solves, checkpoint, metrics
(counterpart of `insr_pde_tpu/models/base.py`).

Fields are parameter lists in `self.fields`; "copy weights to the prev net"
is a list assignment. Each training phase is a cached `Solver`. Every model
owns one `torch.Generator`, seeded from `cfg.seed`, on its device (on the
CPU with `--host_rng`, the draws then copied to the device): network init
and every collocation draw come from it.

Sharded (`group`, `parallel/mesh.py`): every rank draws the network init
from that generator, so the fields start replicated; rank r > 0 then draws
its collocation points from a second generator seeded from (cfg.seed, r),
and rank 0 goes on with the first, so that the ranks' batches differ. At
world 1 there is no second generator and the streams are unchanged. Only
rank 0 writes checkpoints and `log/`.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..config import Config
from ..ops.precision import resolve_device, set_full_precision
from ..parallel.mesh import Group
from ..utils.ckpt import load_pytree, save_pytree
from ..utils import viz
from ..utils.logging import MetricsWriter
from .networks import get_network
from .solver import LossFn, SampleFn, Solver


class BaseModel:
    def __init__(self, cfg: Config, group: Optional[Group] = None):
        set_full_precision()
        self.cfg = cfg
        self.group = group
        # rank 0 (or the only process) writes the outputs
        self.is_main = group is None or group.is_main
        self.n_ranks = 1 if group is None else group.size
        self.device = resolve_device(cfg.device)
        self.dt = cfg.dt
        self.max_n_iters = cfg.max_n_iters
        self.sample_resolution = cfg.sample_resolution
        self.vis_resolution = cfg.vis_resolution
        self.timestep = -1
        self.tb: Optional[MetricsWriter] = None

        # early-stop constants; patience/threshold/factor come from cfg
        self.min_lr = 1.1e-8
        self.early_stop_plateau = cfg.plateau_patience
        self.train_step = 0

        gen_device = "cpu" if cfg.host_rng else self.device
        self.init_generator = torch.Generator(device=gen_device)
        self.init_generator.manual_seed(cfg.seed)
        # the collocation draws
        self.generator = self.init_generator
        if group is not None and group.rank > 0:
            seed = np.random.SeedSequence([cfg.seed, group.rank])
            self.generator = torch.Generator(device=gen_device)
            self.generator.manual_seed(int(seed.generate_state(1)[0]))
        self.fields: Dict[str, Any] = {}   # name -> parameter list
        self.networks: Dict[str, Any] = {}  # name -> MLP
        self._solvers: Dict[str, Solver] = {}
        # one record per fit: timestep, phase tag, iterations, wall seconds
        self.phase_timings: list = []

    # ---- construction ----
    def _create_field(self, name: str, in_dim: int, out_dim: int):
        """Create a network + init params from the model's generator."""
        net = get_network(self.cfg, in_dim, out_dim)
        self.networks[name] = net
        self.fields[name] = tree_map(lambda t: t.to(self.device),
                                     net.init(self.init_generator))
        return net

    # ---- protocol ----
    def initialize(self):
        raise NotImplementedError

    def step(self):
        raise NotImplementedError

    def write_output(self, output_folder: str):
        pass

    # ---- timestep orchestration ----
    def begin_timestep(self):
        self.timestep += 1
        if self.tb is not None:
            self.tb.close()
        if not self.is_main:
            return
        self.tb = MetricsWriter(
            os.path.join(self.cfg.log_dir, f"t{self.timestep:03d}"),
            write_tb=self.cfg.write_tb)

    def end_timestep(self):
        self.save_ckpt()

    # ---- training loop ----
    def _solver_options(self) -> Dict[str, Any]:
        """The Solver keywords every phase of this model takes."""
        return dict(lr=self.cfg.lr, max_n_iters=self.max_n_iters,
                    chunk_size=self.cfg.chunk_size,
                    early_stop=self.cfg.early_stop,
                    plateau_patience=self.early_stop_plateau,
                    plateau_threshold=self.cfg.plateau_threshold,
                    plateau_factor=self.cfg.plateau_factor,
                    early_stop_min_lr=self.min_lr,
                    debug_nan=self.cfg.debug_nan, group=self.group)

    def _run_phase(self, tag: str, loss_fn: LossFn, sample_fn: SampleFn,
                   params, aux=None, vis_fn: Optional[Callable] = None,
                   solver: Optional[Solver] = None):
        """Fit `params` by minimizing sum(loss_fn(params, sample_fn(),
        aux).values()), or with a prebuilt `solver` (a Solver whose chunks
        run elsewhere, e.g. in a fused kernel; loss_fn and sample_fn are then
        its business). Scalars are logged per iteration; the optional
        vis_fn(params) runs every cfg.vis_frequency iterations (rounded to
        chunk boundaries)."""
        if solver is None:
            if tag not in self._solvers:
                self._solvers[tag] = Solver(loss_fn, sample_fn,
                                            **self._solver_options())
            solver = self._solvers[tag]

        # thread a callback only when an in-training vis can actually fire;
        # otherwise it would still cost a figure render per phase. Without
        # matplotlib no figure can be drawn (write_output warns of it).
        want_vis = (vis_fn is not None and self.tb is not None
                    and self.cfg.vis_frequency <= self.max_n_iters
                    and viz.available())
        callback = None
        if want_vis:
            last_vis = [0]

            def callback(it, p, losses):
                self.train_step = it
                if (it - last_vis[0] >= self.cfg.vis_frequency
                        or last_vis[0] == 0):
                    last_vis[0] = it
                    vis_fn(p)

        tic = time.perf_counter()
        result = solver.fit(params, aux, callback=callback)
        # fit ends in a host fetch of the last chunk's scalars, so the device
        # work of this phase is done here
        self.phase_timings.append({"timestep": self.timestep, "tag": tag,
                                   "n_iters": result.n_iters,
                                   "sec": time.perf_counter() - tic})
        self.train_step = result.n_iters

        # per-iteration scalar history -> metrics sink (one bulk write)
        if self.tb is not None:
            hist = {k: np.asarray(v) for k, v in result.history.items()}
            n = len(hist.get("main", []))
            self.tb.add_scalars_history(tag, hist, stride=max(1, n // 2000))
        return result

    # ---- checkpointing ----
    def save_ckpt(self, name: Optional[str] = None):
        if not self.is_main:
            return
        if name is None:
            path = os.path.join(self.cfg.model_dir,
                                f"ckpt_step_t{self.timestep:03d}.npz")
        else:
            path = os.path.join(self.cfg.model_dir, f"ckpt_{name}.npz")
        save_pytree(path, self.fields, metadata={"timestep": self.timestep})

    def load_ckpt(self, name):
        if isinstance(name, int):
            path = os.path.join(self.cfg.model_dir,
                                f"ckpt_step_t{name:03d}.npz")
        elif name == "latest":
            steps = [
                f for f in os.listdir(self.cfg.model_dir)
                if f.startswith("ckpt_step_t") and f.endswith(".npz")]
            if not steps:
                raise FileNotFoundError(
                    f"no per-step checkpoints in {self.cfg.model_dir}")
            # numeric max, not lexicographic: 't1000' sorts before 't999'
            latest = max(steps, key=lambda f: int(f[len("ckpt_step_t"):-4]))
            path = os.path.join(self.cfg.model_dir, latest)
        else:
            path = os.path.join(self.cfg.model_dir, f"ckpt_{name}.npz")
        self.fields, meta = load_pytree(path, self.fields, device=self.device)
        self.timestep = int(meta["timestep"])
