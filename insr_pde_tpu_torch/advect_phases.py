"""Where an iteration of the advect fit kernel spends its time, on the card.

    python -m insr_pde_tpu_torch.advect_phases [--source FILE.cu]

Builds a probe copy of the advect fit source (by default
`csrc/advect_fit.cu`) with `clock64()` stamps at its phase boundaries,
runs it at the advection path's chunk (2x20 SIREN, 5,000 + 50 points, 250
iterations per launch) and prints, per iteration, the cycles and the share
of each phase as thread 0 of block 0 sees them, and the phase's share of the
kernel's time (CUDA events) next to the unstamped kernel's. The committed
source marks its boundaries with `// phase: NAME` comments, which the probe
turns into stamps; the earlier source (one thread per row, every block
summing every partial) has no marks and gets them at the anchors of
`_V1_MARKS`. The committed kernel is never changed: the stamps exist only in
the probe's copy, built into `_build/probe/`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from .ops import cuda_build

# the earlier source's phase boundaries: (text, marked text)
_V1_MARKS = [
    ("cg::grid_group grid = cg::this_grid();",
     "cg::grid_group grid = cg::this_grid();\n    // phase: setup"),
    ("forward_row(p_s, d, x, bufs[0], bufs[1], store, r, omega, u, du);",
     "forward_row(p_s, d, x, bufs[0], bufs[1], store, r, omega, u, du);\n"
     "    // phase: forward"),
    ("g(1, 0, r) = gdu;\n    __syncthreads();",
     "g(1, 0, r) = gdu;\n    __syncthreads();\n    // phase: forward"),
    ("g_s[P + 1] = first ? sb : g_s[P + 1] + sb;\n    }",
     "g_s[P + 1] = first ? sb : g_s[P + 1] + sb;\n    }\n    // phase: loss"),
    ("store[l - 1](1, k, r);\n            }\n        }\n        __syncthreads();",
     "store[l - 1](1, k, r);\n            }\n        }\n        __syncthreads();\n"
     "        // phase: reverse"),
    ("*p = first ? sum : *p + sum;\n        }",
     "*p = first ? sum : *p + sum;\n        }\n        // phase: grads"),
    ("g = gn;\n        gn = t;", "g = gn;\n        gn = t;\n        // phase: reverse"),
    ("// every thread is done with this tile's buffers\n    __syncthreads();",
     "// every thread is done with this tile's buffers\n    __syncthreads();\n"
     "    // phase: reverse"),
    ("mine[i] = first ? 0.0f : g_s[i];",
     "mine[i] = first ? 0.0f : g_s[i];\n        // phase: grads"),
    ("const bool grads_ok = __syncthreads_and(ok) != 0;",
     "const bool grads_ok = __syncthreads_and(ok) != 0;\n        // phase: barrier_sum"),
    ("// and its tiles write g_s\n        __syncthreads();",
     "// and its tiles write g_s\n        __syncthreads();\n        // phase: update"),
    ("\n    if (blockIdx.x == 0) {\n        for (int i = tid; i < P; i += rows) {\n"
     "            params_g[i] = p_s[i];",
     "\n    // phase: end\n    if (blockIdx.x == 0) {\n"
     "        for (int i = tid; i < P; i += rows) {\n"
     "            params_g[i] = p_s[i];"),
]

_MAX_PHASES = 12

_PRELUDE = r"""
__shared__ long long phase_acc[%(n)d];
__shared__ long long phase_last;
__device__ long long g_phase_acc[%(n)d];
#define PHASE_ONE (blockIdx.x == 0 && threadIdx.x == 0)
#define PHASE_SETUP() do { if (PHASE_ONE) { \
    for (int k_ = 0; k_ < %(n)d; ++k_) phase_acc[k_] = 0; \
    phase_last = clock64(); } } while (0)
#define PHASE_STAMP(k) do { if (PHASE_ONE) { const long long t_ = clock64(); \
    phase_acc[k] += t_ - phase_last; phase_last = t_; } } while (0)
#define PHASE_END() do { if (PHASE_ONE) { \
    for (int k_ = 0; k_ < %(n)d; ++k_) g_phase_acc[k_] = phase_acc[k_]; } } while (0)
extern "C" int phase_read(long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_phase_acc, sizeof(g_phase_acc));
}
"""


def stamped_source(text: str):
    """The source with its `// phase:` marks (or the earlier source's
    anchors) turned into stamps; returns (source, phase names)."""
    if "// phase:" not in text:
        for old, new in _V1_MARKS:
            if text.count(old) != 1:
                raise ValueError(f"anchor not found once in the source: {old!r}")
            text = text.replace(old, new)
    names = []

    def stamp(m):
        indent, name = m.group(1), m.group(2)
        if name == "setup":
            return f"{indent}PHASE_SETUP();"
        if name == "end":
            return f"{indent}PHASE_END();"
        if name not in names:
            names.append(name)
        return f"{indent}PHASE_STAMP({names.index(name)});"

    text = re.sub(r"^([ \t]*)// phase: (\w+)[^\n]*$", stamp, text, flags=re.M)
    if len(names) > _MAX_PHASES:
        raise ValueError(f"{len(names)} phases, at most {_MAX_PHASES}")
    # the stamps' static shared memory comes out of the dynamic limit
    text = text.replace("constexpr int SMEM_LIMIT = 232448;",
                        "constexpr int SMEM_LIMIT = 232448 - 256;")
    include = "#include <cooperative_groups.h>\n"
    head, sep, tail = text.partition(include)
    if not sep:
        raise ValueError("no cooperative_groups include to anchor the stamps")
    return head + sep + _PRELUDE % {"n": _MAX_PHASES} + tail, names


def _nvcc(source: Path, name: str) -> ctypes.CDLL:
    """`source` built as `_build/probe/lib<name>.so` and loaded."""
    lib = cuda_build.BUILD_DIR / "probe" / f"lib{name}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-o", str(lib), str(source)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {source} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(lib))


def build_probe(source: Path) -> tuple[ctypes.CDLL, list]:
    text, names = stamped_source(source.read_text())
    src = cuda_build.BUILD_DIR / "probe" / "advect_fit_probe.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    return _nvcc(src, "advect_fit_probe"), names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=str(cuda_build.CSRC / "advect_fit.cu"))
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--nb", type=int, default=50)
    ap.add_argument("--iters", type=int, default=250)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)

    import torch
    from .models.networks import MLP
    from .models.solver import ravel
    from .ops import advect_fit as af
    if not torch.cuda.is_available():
        raise SystemExit("advect_phases: needs a CUDA card")
    dev = torch.device("cuda", 0)
    widths = [1, 20, 20, 20, 1]
    gen = torch.Generator(device=dev).manual_seed(3)
    net = MLP(1, 1, 2, 20)
    p = ravel(net.init(gen))[0].contiguous()
    q = ravel(net.init(gen))[0].contiguous()
    n, nb, iters = args.n, args.nb, args.iters
    x = (torch.rand((iters, n), generator=gen, device=dev) * 2 - 1) * 2.0
    xb = torch.where(torch.rand((iters, nb), generator=gen, device=dev) < 0.5,
                     -2.0, 2.0)
    hp = af.AdvectFitHyper(dt=0.05, vel=0.25, lr=1e-3, min_scale=1e-5,
                           stop_scale=1.1e-5)
    hist = torch.empty((iters, 4), device=dev)

    def time_launches(lib):
        af._library = lambda: lib
        times = []
        for _ in range(args.reps + 1):
            s0 = af.init_state(p)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            af.launch(s0, q, x, xb, widths, hp, hist)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times = sorted(times[1:])
        return times[len(times) // 2] / iters

    source = Path(args.source)
    probe, names = build_probe(source)
    af.bind(probe)
    plain = af.bind(_nvcc(source, "advect_fit_plain"))
    ms_plain = time_launches(plain)
    ms_probe = time_launches(probe)
    acc = (ctypes.c_longlong * _MAX_PHASES)()
    err = probe.phase_read(acc)
    if err != 0:
        raise RuntimeError(f"phase_read failed with CUDA error {err}")
    cycles = [acc[k] / iters for k in range(len(names))]
    total = sum(cycles)
    phases = {name: {"cycles_per_iter": c, "share": c / total,
                     "ms_per_iter": c / total * ms_probe}
              for name, c in zip(names, cycles)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"source {source}; N={n} NB={nb}, {iters} iterations per launch; "
          f"{smi}")
    print(f"per iteration: unstamped kernel {ms_plain:.5f} ms, stamped "
          f"{ms_probe:.5f} ms, {total:.0f} cycles of thread 0, block 0 "
          f"({total / (ms_probe * 1e3):.0f} cycles/us)")
    for name, rec in phases.items():
        print(f"  {name:12s} {rec['cycles_per_iter']:10.0f} cycles "
              f"{rec['share']:6.3f}  {rec['ms_per_iter']:.5f} ms")
    print(json.dumps({"source": str(source), "ms_per_iter": ms_plain,
                      "ms_per_iter_stamped": ms_probe, "phases": phases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
