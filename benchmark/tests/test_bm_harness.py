"""The harness's lookups by name, its import guard, the whole-step window,
the contract's limits on `BENCHMARK.json`, and the trace reduction."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import guard, window
from benchmark.trace import reduce_events

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BENCH = os.path.join(ROOT, "BENCHMARK.json")


def _bench():
    with open(BENCH) as f:
        return json.load(f)


# ---- BENCHMARK.json against the contract's shape ----

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_bm_benchmark_json_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(BENCH) <= 64 * 1024
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in {c["name"] for c in b["configs"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in {w["name"] for w in b["workloads"]}
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))


def test_bm_every_cell_has_its_files():
    b = _bench()
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "workloads",
                                           w["name"] + ".json"))
        for kind in ("reference", "flops"):
            assert os.path.exists(os.path.join(ROOT, "benchmark", kind,
                                               w["config"] + ".py"))


@pytest.mark.parametrize("config", ["fluid_tg_3x32", "elasticity_lucy_3x128"])
def test_bm_config_file_is_what_the_program_runs(config, tmp_path):
    """The configuration's keys agree with the flags the program parses."""
    from insr_pde_tpu_torch.config import parse_args
    with open(os.path.join(ROOT, "benchmark", "configs",
                           config + ".json")) as f:
        cfg = json.load(f)
    parsed = parse_args(cfg["args"] + ["--proj_dir", str(tmp_path)],
                        phase="train")
    for key in ("num_hidden_layers", "hidden_features", "dt", "lr",
                "max_n_iters", "early_stop", "chunk_size", "vis_resolution",
                "ratio_arap", "ratio_volume", "ratio_collide",
                "ratio_kinematics", "plane_height", "external_force_timesteps",
                "energy", "sample_pattern", "dim"):
        if key in cfg:
            assert getattr(parsed, key) == cfg[key], key
    if "external_force" in cfg:
        assert [parsed.external_force_x, parsed.external_force_y,
                parsed.external_force_z] == cfg["external_force"]


# ---- found by name: a cell, a configuration and a metric added as files ----

def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "benchmark")):
        for name in files:
            if name.endswith(".pyc"):
                continue
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_bm_added_files_are_found_without_edits(tmp_path):
    """A copy of the benchmark gains a configuration, a cell and a
    per-layer metric as new files and new entries only; the copy's existing
    files stay byte for byte as they were, and a CPU run of the new cell
    reports the new metric."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "insr_pde_tpu_torch"),
               os.path.join(tmp_path, "insr_pde_tpu_torch"))
    before = _digests(tmp_path)
    b = _bench()
    b["configs"].append({"name": "fluid_tg_3x16", "source":
                         "https://arxiv.org/abs/2210.00124",
                         "file": "benchmark/configs/fluid_tg_3x16.json",
                         "reduced": ["max_n_iters", "early_stop"],
                         "why": "a narrower copy, for this test"})
    b["workloads"].append({"name": "fluid_tg16.sr16", "config":
                           "fluid_tg_3x16", "traffic": "sr16", "chips": 1,
                           "why": "256 points, for this test"})
    b["per_layer"].append({"name": "window_steps", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "model step", "moves": "step_s",
                           "workloads": ["fluid_tg16.sr16"]})
    with open(os.path.join(tmp_path, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    bm = os.path.join(tmp_path, "benchmark")
    with open(os.path.join(bm, "configs", "fluid_tg_3x32.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "fluid_tg_3x16"
    cfg["hidden_features"] = 16
    cfg["args"][cfg["args"].index("--hidden_features") + 1] = "16"
    with open(os.path.join(bm, "configs", "fluid_tg_3x16.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bm, "workloads", "fluid_tg16.sr16.json"),
              "w") as f:
        json.dump({"traffic": "sr16", "sample_resolution": 16,
                   "check": {"steps": 2, "eval_resolution": 16},
                   "limits": {"weights_gap": 0.0, "loss_gap": 1e-3,
                              "field_gap": 1e-3}}, f)
    for kind in ("reference", "flops"):
        with open(os.path.join(bm, kind, "fluid_tg_3x16.py"), "w") as f:
            f.write("from .fluid_tg_3x32 import *  # noqa: F401,F403\n")
    with open(os.path.join(bm, "metrics", "window_steps.py"), "w") as f:
        f.write("def read(record):\n"
                "    return float(len(record['window']['walls']))\n")
    script = textwrap.dedent("""
        import json, sys
        sys.path.insert(0, ".")
        import torch
        torch.set_num_threads(2)
        from benchmark.harness import run_cell
        r = run_cell("fluid_tg16.sr16", 5, 0.0, True, device_name="cpu",
                     iters=5)
        print(json.dumps({"correct": r["correct"],
                          "metrics": sorted(r["metrics"]),
                          "checks": r["checks"]}))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    assert "window_steps" in res["metrics"]
    after = _digests(tmp_path)
    assert {k: after[k] for k in before} == before


# ---- the import guard ----

def test_bm_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["insr_pde_tpu_torch",
                                    "insr_pde_tpu_torch.ops.siren_vgl",
                                    "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                                    "insr_pde_tpu.ops"]) == [
        "flax", "insr_pde_tpu", "jax", "jaxlib"]


def test_bm_harness_loads_no_jax():
    """Everything the harness loads, the program's model modules with it,
    leaves no forbidden top-level name in sys.modules; the references load
    nothing of the program."""
    script = textwrap.dedent("""
        import importlib, json, pkgutil, sys
        sys.path.insert(0, ".")
        import benchmark
        from benchmark import guard
        for sub in ("reference", "flops", "metrics", "inputs"):
            pkg = importlib.import_module("benchmark." + sub)
            for m in pkgutil.iter_modules(pkg.__path__):
                importlib.import_module(f"benchmark.{sub}.{m.name}")
        refs = sorted(n for n in sys.modules
                      if n.split(".")[0] == "insr_pde_tpu_torch")
        for m in ("harness", "compare", "trace", "window", "readings",
                  "drivers.fluid", "drivers.elasticity"):
            importlib.import_module("benchmark." + m)
        import insr_pde_tpu_torch.models.fluid
        import insr_pde_tpu_torch.models.elasticity
        print(json.dumps({"refs": refs,
                          "forbidden": guard.forbidden_modules()}))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"refs": [], "forbidden": []}


def test_bm_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "fluid_tg.sr1024", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


# ---- the whole-step window ----

class _Clock:
    def __init__(self, steps):
        self.t, self.steps = 0.0, list(steps)

    def __call__(self):
        return self.t

    def step(self):
        self.t += self.steps.pop(0)


@pytest.mark.parametrize("steps,seconds,n,total", [
    ([7.0] * 10, 51.0, 8, 56.0),          # 7 steps = 49 s < 51: one more
    ([6.0, 9.0, 6.0, 9.0, 6.0, 9.0, 6.0], 45.0, 6, 45.0),   # exact close
    ([60.0, 1.0], 51.0, 1, 60.0),         # one step longer than the window
])
def test_bm_window_whole_steps(steps, seconds, n, total):
    clock = _Clock(steps)
    window_s, walls, outs = window.run_window(clock.step, seconds, clock)
    assert len(walls) == n and window_s == total
    assert window_s >= seconds and window_s - walls[-1] < seconds
    assert window.step_seconds(window_s, len(walls)) == total / n


# ---- the trace reduction ----

def test_bm_trace_busy_idle_and_gaps():
    ms = 1_000_000
    dev = [(0, 2 * ms, "k_a"), (1 * ms, 3 * ms, "k_b"),   # overlap: busy 3
           (5 * ms, 6 * ms, "k_a"), (9 * ms, 10 * ms, "k_c")]
    host = [(0, 10 * ms, "aten::step"), (3 * ms, 5 * ms, "cudaLaunchKernel"),
            (6 * ms, 9 * ms, "aten::mul"), (7 * ms, 8 * ms, "aten::copy_")]
    s = reduce_events(dev, host, 10 * ms)
    assert s["busy_s"] == pytest.approx(5e-3)
    assert s["window_s"] == pytest.approx(1e-2)
    assert s["device_ops"] == 4
    assert s["by_name"]["k_a"] == {"count": 2, "seconds": pytest.approx(3e-3)}
    gaps = dict(s["breakdown"]["idle_gaps"])
    # the gap 3-5 ms under the launch, 6-9 ms (midpoint 7.5) under the copy
    assert gaps == {"cudaLaunchKernel": pytest.approx(2e-3),
                    "aten__copy_": pytest.approx(3e-3)}
    assert s["breakdown"]["device_ops"][0][0] == "k_a"
