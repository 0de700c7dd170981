"""One run of one cell of `BENCHMARK.json`, found by name.

For the cell `<cell>` of configuration `<config>`: `configs/<config>.json`
(its `driver` key names `drivers/<driver>.py`), `workloads/<cell>.json`,
`reference/<config>.py`, `flops/<config>.py`, and `metrics/<metric>.py` for
each per-layer metric whose `workloads` lists the cell (or that lists
none). A cell, a configuration or a per-layer metric is added by adding
such files and entries, and no file is edited.

A run:
1. set-up: builds the model from the seed as the program's command line
   does, runs the t = 0 fit and one warm-up step (t = 1, which builds the
   CUDA kernels on a fresh checkout);
2. the window: whole timesteps from a step boundary until `seconds` have
   passed at a step's end (`window.py`); the peak of device memory is
   reset at its start and read at its end;
3. with `trace`: one more step under `torch.profiler`;
4. the check (`compare.py`), after the program's model is dropped;
5. the result: one JSON line, last on standard output.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_age() -> Optional[float]:
    """Seconds since this process started, from /proc; None elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, bench: Optional[dict] = None) -> dict:
    """The cell's entry, its configuration's entry and files, and the
    per-layer metrics it reports."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, entry["file"]))
    workload = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    return {"cell": cell, "config_name": cell["config"], "config": config,
            "workload": workload, "per_layer": per_layer,
            "end_to_end": end_to_end}


def _module(kind: str, name: str):
    return importlib.import_module(f"benchmark.{kind}.{name}")


def device_record(device, peak_bytes: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak_bytes}
    limit = None
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak_bytes,
            "power_limit": limit}


def _route_counters() -> Dict[str, object]:
    """The program's counters of calls whose shapes a kernel did not take,
    by name, with the function that holds each."""
    from insr_pde_tpu_torch.ops.advect_fit import advect_fit
    from insr_pde_tpu_torch.ops.siren_forward import siren_forward
    from insr_pde_tpu_torch.ops.siren_vgl import siren_vgl
    return {"chain_routes": siren_vgl, "apply_routes": siren_forward,
            "solver_routes": advect_fit}


def _routes() -> Dict[str, int]:
    return {k: getattr(owner, k) for k, owner in _route_counters().items()}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device_name: str = "cuda",
             workload_overrides: Optional[dict] = None,
             iters: Optional[int] = None,
             config_overrides: Optional[dict] = None,
             plant: Optional[Callable] = None, modes=("program",),
             started: Optional[float] = None,
             curves: Optional[list] = None) -> dict:
    """Run one cell and return its result (the last line's object, plus
    `readings` for every mode of `modes`). `plant(driver)` may break the
    program before set-up (the tests' faults); `iters` replaces the
    configuration's Adam iterations a fit and `config_overrides` others of
    its numbers, each also passed to the program as `--<key>=<value>` (the
    tests' small runs)."""
    import torch
    from .compare import check, compared_steps, verdict
    from .guard import forbidden_modules
    from .peaks import H100_SXM
    from .reference.common import set_fp32
    from .trace import traced
    from .window import run_window, step_seconds

    spec = cell_spec(name)
    config, workload = spec["config"], dict(spec["workload"])
    workload.update(workload_overrides or {})
    overrides = dict(config_overrides or {})
    if iters is not None:
        overrides["max_n_iters"] = iters
    for key, value in overrides.items():
        config = dict(config, **{key: value},
                      args=config["args"] + [f"--{key}={value}"])
    device = torch.device(device_name)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    driver_mod = _module("drivers", config["driver"])
    ref_mod = _module("reference", spec["config_name"])
    flops_mod = _module("flops", spec["config_name"])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with tempfile.TemporaryDirectory(prefix="bench-") as work:
        drv = driver_mod.Driver(config, workload, seed, work, device.type)
        if plant is not None:
            plant(drv)
        fits = drv.initialize()
        fits += drv.step()
        sync()
        age = process_age()
        setup_s = age if age is not None else time.time() - started
        log(f"[bench] {name} seed {seed}: set-up {setup_s:.3f} s "
            f"(t = 0 and the warm-up step t = 1)")

        for key, owner in _route_counters().items():
            setattr(owner, key, 0)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        n_timings = len(drv.model.phase_timings)

        def step():
            out = drv.step()
            sync()
            return out

        window_s, walls, outs = run_window(step, seconds)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        routes = _routes()
        window_fits = [f for out in outs for f in out]
        fits += window_fits
        step_ts = [out[0]["t"] for out in outs]
        timings = drv.model.phase_timings[n_timings:]
        log(f"[bench] window: {len(walls)} whole steps, t = {step_ts}, "
            f"{window_s:.4f} s; step walls {[round(w, 4) for w in walls]}")

        record = {"config": config, "workload": workload,
                  "window": {"seconds": window_s, "walls": walls,
                             "timesteps": step_ts},
                  "fits": [{"tag": t["tag"], "t": t["timestep"],
                            "n_iters": t["n_iters"], "sec": t["sec"]}
                           for t in timings],
                  "iter_flops": flops_mod.iter_flops(config, workload),
                  "kernel_work": flops_mod.kernel_work(config, workload),
                  "peaks": H100_SXM, "trace": None}
        if trace and device.type == "cuda":
            traced_fits, summary = traced(step, device)
            iters_by_tag: Dict[str, int] = {}
            for f in traced_fits:
                iters_by_tag[f["tag"]] = iters_by_tag.get(f["tag"], 0) \
                    + f["n_iters"]
            summary["iters"] = sum(iters_by_tag.values())
            summary["iters_by_tag"] = iters_by_tag
            record["trace"] = summary

        iters = int(config["max_n_iters"])
        bad_steps = sum(
            1 for out in outs
            if any(f["n_iters"] != iters or not all(
                math.isfinite(float(v[-1])) for v in f["history"].values())
                for f in out))

        # the check runs with the program's model dropped
        initial = drv.initial_fields
        inputs = drv.inputs
        del drv
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        set_fp32()
        ref = ref_mod.Reference(config, workload, seed, device, inputs)
        tic = time.perf_counter()
        spec_check = workload["check"]
        readings = check(ref, initial, fits,
                         compared_steps(step_ts, seed, spec_check["steps"],
                                        spec_check.get("named", ())),
                         modes=modes, log=log, curves=curves,
                         contact_iters=spec_check.get("contact_iters"),
                         init_iters=spec_check.get("init_iters"))
        log(f"[bench] check: {time.perf_counter() - tic:.3f} s")

    found = forbidden_modules()
    if found:
        raise SystemExit(f"JAX or the JAX package was loaded: {found}")

    limits = dict(workload["limits"])
    numbers = dict(readings["program"]) if "program" in readings else {}
    numbers["routes"] = float(sum(routes.values()))
    limits["routes"] = 0.0
    correct = (bad_steps == 0 and bool(numbers)
               and verdict(numbers, limits))

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            value = _module("metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"step_s": step_seconds(window_s, len(walls)),
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    dev = device_record(device, peak)
    result = {"correct": bool(correct), "attempted": len(walls),
              "failed": bad_steps, "metrics": metrics, "device": dev}
    if record["trace"]:
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = record["trace"]["breakdown"]
    result["checks"] = {k: {"value": numbers.get(k), "limit": limits[k]}
                        for k in limits}
    result["readings"] = readings
    return result


def emit(result: dict) -> None:
    """The check's numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(line), flush=True)
