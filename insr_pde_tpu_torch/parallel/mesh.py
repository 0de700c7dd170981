"""Process groups for collocation and least-squares sharding (counterpart
of `insr_pde_tpu/parallel/mesh.py`).

The JAX package shards over a 1-D device mesh inside one program; here
each rank is a process with one device, in PyTorch's idiom, and the three
collectives the JAX code uses (`pmean`, `psum`, `pmax`) are `all_reduce`s
over a `torch.distributed` group. Ranks come from `torchrun` (its RANK,
WORLD_SIZE and LOCAL_RANK), or from `launch` below, which spawns them over a
`FileStore`. Each rank runs on `cuda:LOCAL_RANK` unless asked for the CPU.
The default backend is NCCL on the card and gloo on the CPU; gloo is also
the backend for two ranks that share one card (NCCL refuses that).

At world size 1 there is no group (`make_group` returns None, as
`make_mesh` returns None for one device) and every collective is the
identity, so the single-process path runs unchanged.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# every collective waits at most this long for the other ranks: a rank that
# took another branch fails the run instead of hanging it
TIMEOUT_S = 60


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the default process group."""
    rank: int
    size: int
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _world_from_env() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _default_backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def current_group() -> Group:
    """The initialized default process group, at any world size (a one-rank
    group too)."""
    return Group(dist.get_rank(), dist.get_world_size(),
                 str(dist.get_backend()))


def make_group(n_devices: int = 0, backend: Optional[str] = None,
               device: str = "cuda") -> Optional[Group]:
    """The group of the ranks `--n_devices` asks for, or None at world 1.

    n_devices: 0 = every rank of the launch; else it must equal the world
    size (1 without a launcher). The world is the initialized default
    group's, else torchrun's WORLD_SIZE (the group is then initialized from
    its environment), else 1. Sets this rank's card to cuda:LOCAL_RANK when
    `device` is "cuda"."""
    world = _world_from_env()
    if n_devices not in (0, world):
        raise ValueError(
            f"--n_devices {n_devices} does not match the world size "
            f"{world} of this launch (run `torchrun --nproc_per_node "
            f"{n_devices} -m insr_pde_tpu_torch ...`, or pass --n_devices 0 "
            f"for every rank)")
    if world == 1:
        return None
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group(
            backend or _default_backend(device), init_method="env://",
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    group = current_group()
    if backend is not None and group.backend != backend:
        raise ValueError(f"the process group runs {group.backend}, "
                         f"{backend} was asked for")
    return group


# ---------------------------------------------------------- collectives


def psum(t: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Sum over the ranks (a new tensor); the identity without a group."""
    if group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def pmean(t: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Mean over the ranks: a sum, then a division by the world size (gloo
    has no AVG)."""
    if group is None:
        return t
    return psum(t, group) / group.size


def pmax(t: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Elementwise maximum over the ranks."""
    if group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


def broadcast(t: torch.Tensor, group: Optional[Group],
              src: int = 0) -> torch.Tensor:
    """Rank `src`'s tensor on every rank (a new tensor)."""
    if group is None:
        return t
    out = t.clone().contiguous()
    dist.broadcast(out, src=src)
    return out


# --------------------------------------------------------------- launch


def _rank_main(fn, rank, world, backend, device, init_file, out_dir, args):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank if device == "cuda" else 0))
    try:
        if device.startswith("cuda"):
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        result = fn(*args)
        dist.barrier()
        dist.destroy_process_group()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **(result or {}))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def launch(fn: Callable, world: int, backend: str, device: str = "cpu",
           init_file: Optional[str] = None, args: Sequence = (),
           deadline_s: float = 300.0) -> List[dict]:
    """Run fn(*args) on `world` spawned ranks of one process group.

    Each rank joins the default group over a `FileStore` at `init_file`
    (a new file; default: one in a fresh temporary directory), with
    RANK, WORLD_SIZE and LOCAL_RANK set as torchrun sets them. device:
    "cpu"; "cuda" (rank r on cuda:r); or "cuda:0" (every rank on card 0,
    LOCAL_RANK 0: two ranks sharing one card need backend "gloo"). fn must
    be importable by the children (a module-level function) and returns
    a dict of numpy arrays or None. Returns each rank's dict, in rank
    order. The ranks are joined by `deadline_s`; past it they are killed,
    and a rank that failed raises here with its traceback."""
    tmp = tempfile.mkdtemp(prefix="insr_launch_")
    init_file = init_file or os.path.join(tmp, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, device, init_file, tmp,
                               tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.join(max(end - time.monotonic(), 0.0))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        for p in alive:
            p.join()
    try:
        return _collect(fn, world, backend, procs, alive, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _collect(fn, world, backend, procs, alive, tmp) -> List[dict]:
    """Each rank's result, or a RuntimeError with every failed rank's
    traceback."""
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}"
                          + (" (killed at the deadline)" if p in alive
                             else ""))
    if errors:
        raise RuntimeError(f"launch of {getattr(fn, '__name__', fn)} on "
                           f"{world} ranks ({backend}) failed:\n"
                           + "\n".join(errors))
    out = []
    for r in range(world):
        with np.load(os.path.join(tmp, f"rank{r}.npz"),
                     allow_pickle=False) as z:
            out.append({k: z[k] for k in z.files})
    return out
