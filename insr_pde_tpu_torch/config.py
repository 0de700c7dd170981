"""Config/flag system of the PyTorch port.

A copy of `insr_pde_tpu/config.py` (the port imports nothing of the JAX
package): the same dataclass, subcommands (advection/fluid/elasticity), flag
names and defaults, JSON snapshot and source backup. Port additions: the
`device` field and `--device {cuda,cpu}` flag; `--matmul_precision` is
accepted for CLI parity but the port runs full f32 at every level.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Config:
    """Flat experiment configuration; attributes mirror the reference cfg object."""

    pde: str = "advection"
    is_train: bool = True

    # basic (reference config.py:86-92)
    proj_dir: str = "checkpoints"
    tag: str = "run"
    seed: int = 0

    # network (reference config.py:94-100)
    network: str = "siren"
    num_hidden_layers: int = 3
    hidden_features: int = 64
    nonlinearity: str = "sine"

    # training (reference config.py:102-111)
    ckpt: Optional[str] = None
    vis_frequency: int = 1000
    max_n_iters: int = 20000
    lr: float = 1e-4
    sample_resolution: int = 128
    vis_resolution: int = 500
    early_stop: bool = True
    # ReduceLROnPlateau schedule. Defaults = the reference's hard-coded
    # torch scheduler (base/baseModel.py:55-62: factor 0.1, patience 500,
    # rel threshold 1e-4). Tightening these (more patience, smaller
    # threshold) trades iterations for a lower per-solve floor — cheap on
    # the TPU where the compiled iteration is ~0.35 ms (COMPARISON.md) and
    # the per-solve floor is what accumulates over a multi-step horizon.
    plateau_patience: int = 500
    plateau_threshold: float = 1e-4
    plateau_factor: float = 0.1

    # timestep (reference config.py:119-125)
    init_cond: Optional[str] = None
    dt: float = 0.05
    n_timesteps: int = 30
    fps: int = 10

    # advection (reference config.py:127-130)
    length: float = 4.0
    vel: float = 0.25

    # fluid advection-phase scheme (beyond-reference: the reference is
    # plain semi-Lagrangian, fluid/model.py:72-101, whose interpolation
    # smoothing — here, the re-fit's spectral bias — decays the field
    # linearly over the horizon). "maccormack" adds the classic
    # error-compensation step: advect back, measure the round-trip defect,
    # correct the target by half of it; falls back to plain semi-Lag at
    # points whose traces leave the domain.
    advect_scheme: str = "semilag"
    # characteristic-trace order for the semi-Lagrangian backtrace
    # (beyond-reference). "euler" = the reference's one-shot straight-line
    # backtrace x - dt u(x) (fluid/model.py:83-87). "rk2" = midpoint rule
    # x - dt u(x - dt/2 u(x)): the straight-line trace cuts the corner of
    # curved characteristics, a SYSTEMATIC O(dt^2)/step amplitude loss
    # (measured ~6e-4/step on steady Taylor-Green, whose characteristics
    # are circles — COMPARISON.md plateau study); the midpoint trace makes
    # the characteristic second-order and removes that bias for one extra
    # network evaluation.
    advect_trace: str = "euler"
    # Sobolev (derivative-supervised) advection weight (beyond-reference;
    # 0 = off). Adds w * MSE(J u - J target) to the advect phase. The
    # pressure Poisson phase consumes div(u) of the advect FIT, whose
    # derivative-space noise is the fit's value noise amplified by the
    # SIREN's frequency content (~omega^2 in MSE) — the measured ~8e-6
    # pressure stall that no LR schedule moves (tools/plateau_probe.py).
    # Supervising the Jacobian directly pushes that noise down at its
    # source.
    advect_sobolev: float = 0.0
    # fluid timestep structure (beyond-reference). "split" = the reference's
    # three fits per step (advect fit -> pressure fit -> projection fit,
    # fluid/model.py:61-70). "merged" = two: the advected velocity u* is kept
    # as the PURE FUNCTION u_prev(clip(x - dt u_prev(x))) instead of being
    # re-fit, the pressure Poisson target div(u*) is that composition's EXACT
    # jacfwd divergence, and a single velocity fit lands u* - grad(p). One
    # fewer fit per step = one fewer accumulation of representation noise —
    # the measured per-step TG drift source (COMPARISON.md plateau study).
    fluid_step: str = "split"

    # elasticity (reference config.py:135-168)
    dim: int = 2
    sample_pattern: List[str] = field(default_factory=lambda: ["random", "uniform"])
    energy: List[str] = field(
        default_factory=lambda: ["arap", "kinematics", "external", "constraint"])
    ratio_constraint: float = 1e3
    ratio_volume: float = 1e1
    ratio_arap: float = 1e0
    ratio_collide: float = 1e0
    ratio_kinematics: float = 1e0
    use_mesh: bool = False
    # relative to the working directory, as the reference's scripts name
    # their meshes (./data/<name>.mesh); read only with --use_mesh 1
    mesh_path: str = "./data/woody.obj"
    external_force_timesteps: int = 5
    external_force_x: float = 0.0
    external_force_y: float = 0.0
    external_force_z: float = 0.0
    constraint_right_offset_x: float = 1e0
    constraint_right_offset_y: float = 0.0
    constraint_right_offset_z: float = 0.0
    plane_height: float = -2.0
    collide_circle_x: float = 0.0
    collide_circle_y: float = -2e0
    collide_circle_z: float = 0.0
    collide_circle_radius: float = 1.0

    # recap phase (reference config.py:113-117)
    output: str = "recap"

    # TPU-native additions (no reference analogue)
    # torch.profiler output dir: trace.json and the program spans, spans.json
    profile_dir: Optional[str] = None
    debug_nan: bool = False        # per-iteration NaN detection in the solver
    sample_resolution_init: int = 0  # 0 = reference defaults (500 2D / 100 3D)
    chunk_size: int = 250          # Adam iterations per jitted device round-trip
    # ranks of a sharded run: 0 = every rank of the launch (one process
    # without a launcher), else the launch's world size
    n_devices: int = 0
    mesh_axis: str = "data"        # collocation-sharding mesh axis name
    write_tb: bool = False         # optional tensorboard (JSONL metrics always on)
    backup_sources: bool = True
    overwrite: bool = True         # non-interactive overwrite of existing exp dir
    # MXU pass count for the SIREN derivative chains: default|high|highest
    # (1/3/6 bf16 passes). Default "high" (3-pass): measured 1.34x faster
    # than "highest" on the paper-scale pressure phase with ~2e-4 chain
    # deviation and an unchanged Taylor-Green golden; "default" (1-pass
    # bf16) is NOT safe for the second-order chains (~5e-2 deviation).
    # Speed/accuracy table in COMPARISON.md.
    matmul_precision: str = "high"
    # PyTorch port: the device every tensor lives on. "cuda" raises when no
    # card is present; it never falls back to the CPU.
    device: str = "cuda"
    # PyTorch port: draw the network init and every collocation point from
    # a CPU generator and copy them to the device, so that a run on the
    # card draws the numbers a --device cpu run with the same seed draws
    host_rng: bool = False
    # PyTorch port: the torch.distributed backend of a sharded run (None:
    # nccl on the card, gloo on the CPU; gloo for ranks sharing one card)
    dist_backend: Optional[str] = None

    # ---- derived paths ----
    @property
    def exp_dir(self) -> str:
        return os.path.join(self.proj_dir, self.tag)

    @property
    def log_dir(self) -> str:
        return os.path.join(self.exp_dir, "log")

    @property
    def model_dir(self) -> str:
        return os.path.join(self.exp_dir, "model")

    # ---- lifecycle ----
    def setup_dirs(self):
        """Create exp/log/model dirs, back up sources, dump config.json.

        Reference: config.py:44-60 (minus the interactive overwrite prompt,
        replaced by the --overwrite flag for headless runs).
        """
        if self.ckpt is None and os.path.exists(self.exp_dir):
            if not self.overwrite:
                raise RuntimeError(
                    f"Experiment dir {self.exp_dir} exists (pass --overwrite).")
            shutil.rmtree(self.exp_dir)
        for path in (self.log_dir, self.model_dir):
            os.makedirs(path, exist_ok=True)

        if self.backup_sources:
            backup_dir = os.path.join(self.exp_dir, "backup")
            pkg_root = os.path.dirname(os.path.abspath(__file__))
            shutil.copytree(pkg_root,
                            os.path.join(backup_dir, "insr_pde_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__", "data",
                                                          "_build"),
                            dirs_exist_ok=True)

        self.save_json(os.path.join(self.exp_dir, "config.json"))

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load_json(cls, path: str) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})

    def __str__(self):
        lines = ["----Experiment Configuration-----"]
        for f_ in dataclasses.fields(self):
            lines.append(f"{f_.name:24}{getattr(self, f_.name)}")
        return "\n".join(lines)


def _add_common_flags(p: argparse.ArgumentParser):
    p.add_argument("--proj_dir", type=str, default="checkpoints")
    p.add_argument("--tag", type=str, default="run")
    p.add_argument("--seed", type=int, default=0)
    # -g/--gpu_ids accepted for script-level parity with the reference CLI
    # (config.py:92); ignored — device selection is JAX-native.
    p.add_argument("-g", "--gpu_ids", type=str, default=None)

    p.add_argument("--network", type=str, default="siren",
                   choices=["siren", "grid", "hashgrid"])
    p.add_argument("--num_hidden_layers", type=int, default=3)
    p.add_argument("--hidden_features", type=int, default=64)
    p.add_argument("--nonlinearity", type=str, default="sine")

    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--vis_frequency", type=int, default=1000)
    p.add_argument("--max_n_iters", "--max_n_iter", dest="max_n_iters",
                   type=int, default=20000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("-sr", "--sample_resolution", type=int, default=128)
    p.add_argument("-vr", "--vis_resolution", type=int, default=500)
    p.add_argument("--early_stop", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--plateau_patience", type=int, default=500)
    p.add_argument("--plateau_threshold", type=float, default=1e-4)
    p.add_argument("--plateau_factor", type=float, default=0.1)

    p.add_argument("--init_cond", type=str, default=None)
    p.add_argument("--dt", type=float, default=0.05)
    p.add_argument("-T", "--n_timesteps", type=int, default=30)
    p.add_argument("--fps", type=int, default=10)

    p.add_argument("--chunk_size", type=int, default=250)
    p.add_argument("--matmul_precision", type=str, default="high",
                   choices=["default", "high", "highest"],
                   help="accepted for CLI parity with the JAX package; the "
                        "PyTorch port runs full f32 (TF32 off) at every level")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="device of every tensor; cuda raises when no card is "
                        "present")
    p.add_argument("--host_rng", action="store_true",
                   help="draw the init and the points on the CPU (the draws "
                        "of a --device cpu run) and copy them to the device")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--debug_nan", action="store_true")
    p.add_argument("--n_devices", type=int, default=0,
                   help="ranks to shard each fit's points over: 0 = every "
                        "rank of the launch (torchrun), else its world size")
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend of a sharded run "
                        "(default: nccl on the card, gloo on the CPU)")
    p.add_argument("--write_tb", action="store_true")
    p.add_argument("--overwrite", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--no_backup", dest="backup_sources", action="store_false")


def parse_args(argv=None, phase: str = "train") -> Config:
    """Build a Config from CLI args. Subcommand layout matches the reference
    (config.py:62-84): `main.py {advection,fluid,elasticity} <flags>`."""
    parser = argparse.ArgumentParser("insr_pde_tpu_torch")
    sub = parser.add_subparsers(dest="pde", required=True)

    p_adv = sub.add_parser("advection")
    p_flu = sub.add_parser("fluid")
    p_ela = sub.add_parser("elasticity")
    for p in (p_adv, p_flu, p_ela):
        _add_common_flags(p)

    p_adv.add_argument("-L", "--length", type=float, default=4.0)
    p_adv.add_argument("--vel", type=float, default=0.25)

    p_flu.add_argument("--advect_scheme", type=str, default="semilag",
                       choices=["semilag", "maccormack"],
                       help="advection-phase target: reference semi-"
                            "Lagrangian, or MacCormack error compensation "
                            "(halves the scheme's dissipation; beyond-"
                            "reference)")
    p_flu.add_argument("--advect_sobolev", type=float, default=0.0,
                       help="derivative-supervision weight for the advect "
                            "fit (0 = reference parity); lowers the "
                            "derivative-space fit noise the pressure "
                            "Poisson phase inherits as its target")
    p_flu.add_argument("--advect_trace", type=str, default="euler",
                       choices=["euler", "rk2"],
                       help="semi-Lagrangian characteristic trace: the "
                            "reference's one-shot straight-line backtrace, "
                            "or the midpoint (RK2) trace that removes the "
                            "O(dt^2)/step corner-cutting amplitude loss on "
                            "curved characteristics (beyond-reference)")
    p_flu.add_argument("--fluid_step", type=str, default="split",
                       choices=["split", "merged", "merged2"],
                       help="timestep structure: reference three-fit "
                            "operator splitting, or the merged two-fit "
                            "variant (pressure solved against the exact "
                            "divergence of the semi-Lagrangian composition, "
                            "then one combined advect+project velocity fit; "
                            "beyond-reference)")

    p_ela.add_argument("--dim", type=int, default=2)
    p_ela.add_argument("--sample_resolution_init", type=int, default=0)
    p_ela.add_argument("--sample_pattern", type=str, nargs="*",
                       default=["random", "uniform"])
    p_ela.add_argument("--energy", type=str, nargs="*",
                       default=["arap", "kinematics", "external", "constraint"])
    p_ela.add_argument("--ratio_constraint", type=float, default=1e3)
    p_ela.add_argument("--ratio_volume", type=float, default=1e1)
    p_ela.add_argument("--ratio_arap", type=float, default=1e0)
    p_ela.add_argument("--ratio_collide", type=float, default=1e0)
    p_ela.add_argument("--ratio_kinematics", type=float, default=1e0)
    p_ela.add_argument("--use_mesh", type=int, default=0)
    p_ela.add_argument("--mesh_path", type=str, default="./data/woody.obj")
    p_ela.add_argument("-T_ext", "--external_force_timesteps", type=int, default=5)
    p_ela.add_argument("-f_ext_x", "--external_force_x", type=float, default=0.0)
    p_ela.add_argument("-f_ext_y", "--external_force_y", type=float, default=0.0)
    p_ela.add_argument("-f_ext_z", "--external_force_z", type=float, default=0.0)
    p_ela.add_argument("-fix_right_x", "--constraint_right_offset_x",
                       type=float, default=1e0)
    p_ela.add_argument("-fix_right_y", "--constraint_right_offset_y",
                       type=float, default=0.0)
    p_ela.add_argument("-fix_right_z", "--constraint_right_offset_z",
                       type=float, default=0.0)
    p_ela.add_argument("--plane_height", type=float, default=-2.0)
    p_ela.add_argument("-collide_circle_x", "--collide_circle_x",
                       type=float, default=0.0)
    p_ela.add_argument("-collide_circle_y", "--collide_circle_y",
                       type=float, default=-2e0)
    p_ela.add_argument("-collide_circle_z", "--collide_circle_z",
                       type=float, default=0.0)
    p_ela.add_argument("-collide_circle_r", "--collide_circle_radius",
                       type=float, default=1.0)

    if phase != "train":
        for p in (p_adv, p_flu, p_ela):
            p.add_argument("-o", "--output", type=str, default="recap")

    args = parser.parse_args(argv)
    d = vars(args)
    d.pop("gpu_ids", None)
    d["use_mesh"] = bool(d.get("use_mesh", 0))
    names = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in d.items() if k in names})
    cfg.is_train = phase == "train"

    if not cfg.is_train:
        # recap: restore the training-time config, keep CLI overrides
        # (reference config.py:31-42)
        config_path = os.path.join(cfg.exp_dir, "config.json")
        if not os.path.exists(config_path):
            raise RuntimeError(f"Experiment checkpoint {cfg.exp_dir} not found.")
        saved = Config.load_json(config_path)
        for f_ in dataclasses.fields(Config):
            if f_.name in ("vis_resolution", "output", "proj_dir", "tag", "pde",
                           "is_train"):
                continue
            setattr(cfg, f_.name, getattr(saved, f_.name))
    return cfg
