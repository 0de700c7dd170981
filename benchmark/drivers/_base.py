"""What the drivers share: building a model as `python -m
insr_pde_tpu_torch` builds it, and the record of each fit a timestep ran."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def build(argv: List[str]):
    """(cfg, model) of the program's command line `argv`, its output
    directories made, as the program's entry point does."""
    from insr_pde_tpu_torch.__main__ import build_model
    from insr_pde_tpu_torch.config import parse_args
    cfg = parse_args(argv, phase="train")
    model = build_model(cfg)
    cfg.setup_dirs()
    return cfg, model


def run_flags(config: dict, workload: dict, seed: int, work_dir: str,
              device: str) -> List[str]:
    """The configuration's flags, the traffic's point count and the run's
    own: seed, output directory, device."""
    return (list(config["args"])
            + ["-sr", str(workload["sample_resolution"]), "--seed", str(seed),
               "--proj_dir", work_dir, "--tag", "bench", "--device", device])


def fit_record(tag: str, t: int, start, aux: Dict, result,
               handoff: Optional[List[Tuple[str, list, list]]] = None) -> Dict:
    """One fit as the check reads it: its phase, timestep, the parameters
    it started from, the frozen fields it read, and what it produced (the
    program's parameters and per-iteration loss terms). `handoff` lists,
    for the first fit of a step, each field the step read beside what the
    fits before it produced for that field: (name, read, produced)."""
    return {"tag": tag, "t": t, "start": start, "aux": aux,
            "result": result.params, "n_iters": result.n_iters,
            "history": {k: v for k, v in result.history.items()
                        if not k.startswith("_")},
            "handoff": handoff or []}


def copy_fields(fields: Dict) -> Dict:
    """The networks' parameters, copied."""
    return {name: [(w.detach().clone(), b.detach().clone()) for w, b in p]
            for name, p in fields.items()}
