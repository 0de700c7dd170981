"""Where a kernel's time goes, phase by phase, on the card; and a design
that was not kept, timed beside the committed one.

    python -m insr_pde_tpu_torch.kernel_phases advect_fit
    python -m insr_pde_tpu_torch.kernel_phases siren_vgl [--width 32]
        [--n 16384] [--variant NAME]
    python -m insr_pde_tpu_torch.kernel_phases siren_vgl_forward
        [--shape pressure_16384|w128_16384] [--source PATH]
    python -m insr_pde_tpu_torch.kernel_phases siren_forward
        [--shape fluid_vr128_16384|w128_l5_16384] [--source PATH]
    python -m insr_pde_tpu_torch.kernel_phases block_ell_mv
        [--shape channel|ell] [--variant NAME]

Builds a probe copy of the kernel's committed source (`csrc/<name>.cu` with
its `csrc/` headers inlined, or its variant) with `clock64()` stamps at its
phase marks, runs it, and prints the cycles and the share of each phase as
thread 0 of block 0 sees them, beside the kernel's time unstamped and
stamped (a source without marks, such as `csrc/block_ell.cu`, is timed
unstamped only). A mark is a comment `// phase: NAME`, or `// phase[fwd]:
NAME` for the forward kernels, whose marks share `csrc/siren_vgl.cu` with
the backward's:

* advect_fit: the advection path's chunk (2x20 SIREN, 5,000 + 50 points,
  250 iterations per launch), per iteration;
* siren_vgl: the backward of the value+gradient+Laplacian kernels at the
  pressure phase's shape (3 hidden layers of `--width`, d = 2, `--n`
  points), per call, and the device time of each kernel of the call (the
  backward and its cross-block sum) from a `torch.profiler` trace;
* siren_vgl_forward: the value+gradient+Laplacian forward at a shape of
  `chip_smoke.py`'s VGL_SHAPES (the pressure net 2-32-32-32-32-1, or its
  width-128 twin, on 16,384 points), per call;
* siren_forward: the fused SIREN forward at a shape of `chip_smoke.py`'s
  cases (the fluid net 2-32-32-32-32-2 on the -vr 128 grid, or 5 hidden
  layers of width 128 on 16,384 points), per call;
* block_ell_mv: the block-ELL mv on the channel preset's assembled operator
  (243,210 x 12 x 16, at the starting coefficients) or on the TPU kernel's
  scalar ELL (35,600 x 768, J = 1, random slots).

`--variant NAME` applies a patch of `kernel_variants.py` to the source, and
`--source PATH` takes another copy of the same source (for example an
earlier design, `git show COMMIT:insr_pde_tpu_torch/csrc/siren_vgl.cu`);
either is timed beside the committed build in this process (order
committed, other, other, committed; each the mean of its two medians, both
printed), after checking both against the plain version (the JAX pins'
tolerance and the same bits over two runs), and the forward cases say whether the two
builds give the same bits. The forward kernels are timed as chip_smoke.py
times them (20 launches in a CUDA graph, so that the host's ctypes calls do
not set the pace); the others between CUDA events.

`setup` and `end` marks reset and flush the accumulators. The committed
kernels are never changed: the stamps and variants exist only in copies
built into `_build/probe/`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Callable, NamedTuple, Optional

from . import kernel_variants
from .ops import cuda_build

_MAX_PHASES = 12
_MARK = re.compile(r"^([ \t]*)// phase(?:\[(\w+)\])?: (\w+)[^\n]*$", re.M)

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


def has_marks(text: str, tag=None) -> bool:
    return any(m.group(2) == tag and m.group(3) == "setup"
               for m in _MARK.finditer(text))


def stamped_source(text: str, tag=None):
    """The source with its phase marks of `tag` (`// phase: NAME` for None,
    `// phase[TAG]: NAME` else) turned into stamps, the other marks left as
    comments, and the stamps' prelude after its last #include; returns
    (source, phase names)."""
    if not has_marks(text, tag):
        mark = f"phase[{tag}]" if tag else "phase"
        raise ValueError(f"the source has no `// {mark}: setup` mark")
    names = []

    def stamp(m):
        indent, name = m.group(1), m.group(3)
        if m.group(2) != tag:
            return m.group(0)
        if name == "setup":
            return f"{indent}PHASE_SETUP();"
        if name == "end":
            return f"{indent}PHASE_END();"
        if name not in names:
            names.append(name)
        return f"{indent}PHASE_STAMP({names.index(name)});"

    text = _MARK.sub(stamp, text)
    if len(names) > _MAX_PHASES:
        raise ValueError(f"{len(names)} phases, at most {_MAX_PHASES}")
    # the stamps' static shared memory comes out of the dynamic limit
    text = text.replace("constexpr int SMEM_LIMIT = 232448;",
                        "constexpr int SMEM_LIMIT = 232448 - 256;")
    includes = list(re.finditer(r"^#include <[^>]+>\n", text, flags=re.M))
    cut = includes[-1].end()
    return text[:cut] + _PRELUDE % {"n": _MAX_PHASES} + text[cut:], names


def _nvcc_all(sources: dict) -> dict:
    """Each source `_build/probe/<name>.cu` built as `lib<name>.so`, one
    nvcc each, all started together, and loaded: {key: CDLL}."""
    procs = {}
    for key, source in sources.items():
        lib = source.with_name(f"lib{source.stem}.so")
        procs[key] = (lib, source, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
             str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for key, (lib, source, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {source} failed:\n{log}")
        out[key] = ctypes.CDLL(str(lib))
    return out


def _write_probe(text: str, name: str) -> Path:
    """`text` (its `csrc/` headers inlined) as `_build/probe/<name>.cu`."""
    src = cuda_build.BUILD_DIR / "probe" / f"{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(cuda_build.expand_includes(text))
    return src


def _median_event_ms(run, reps: int, inner: int) -> float:
    """Median over `reps` of the time of `inner` calls of `run()` in a row
    between CUDA events (so that the host's launches run ahead of the
    card), over `inner`, after one warm-up."""
    import torch
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times = sorted(times[1:])
    return times[len(times) // 2]


def _median_graph_ms(run, reps: int, inner: int) -> float:
    """Median over `reps` of the time of one replay of a CUDA graph of
    `inner` calls of `run()`, over `inner` (chip_smoke.py's `_median_ms`):
    the replays leave no host gaps between the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            run()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


class Case(NamedTuple):
    bind: Callable          # lib -> lib with its argument types set
    run: Callable           # run(lib): one launch (or chunk) of the kernel
    per: int                # divides the time of one run
    desc: str
    check: Optional[Callable] = None     # check(lib) -> a line; raises
    result: Optional[Callable] = None    # result(lib) -> outputs of a run
    graph: bool = False     # time by CUDA graph replays
    tag: Optional[str] = None            # the phase marks' tag


def _advect_fit_case(args):
    """The advect fit's main chunk; times per iteration."""
    import torch
    from .models.networks import MLP
    from .models.solver import ravel
    from .ops import advect_fit as af
    dev = torch.device("cuda", 0)
    widths = [1, 20, 20, 20, 1]
    gen = torch.Generator(device=dev).manual_seed(3)
    net = MLP(1, 1, 2, 20)
    p = ravel(net.init(gen))[0].contiguous()
    q = ravel(net.init(gen))[0].contiguous()
    n, nb, iters = args.n or 5000, args.nb, args.iters
    x = (torch.rand((iters, n), generator=gen, device=dev) * 2 - 1) * 2.0
    xb = torch.where(torch.rand((iters, nb), generator=gen, device=dev) < 0.5,
                     -2.0, 2.0)
    hp = af.AdvectFitHyper(dt=0.05, vel=0.25, lr=1e-3, min_scale=1e-5,
                           stop_scale=1.1e-5)
    hist = torch.empty((iters, 4), device=dev)

    def run(lib):
        af._library = lambda: lib
        af.launch(af.init_state(p), q, x, xb, widths, hp, hist)

    desc = f"N={n} NB={nb}, {iters} iterations per launch, per iteration"
    return Case(af.bind, run, iters, desc)


def _siren_vgl_case(args):
    """The vgl backward at the pressure phase's shape with random
    cotangents; times per call."""
    import torch
    from .models.networks import MLP
    from .ops import siren_vgl as sv
    from .ops.siren_forward import pack_params
    dev = torch.device("cuda", 0)
    n = args.n or 16384
    gen = torch.Generator(device=dev).manual_seed(1)
    params = MLP(2, 1, 3, args.width).init(gen)
    x = torch.rand((n, 2), generator=gen, device=dev) * 2.0 - 1.0
    packed, widths = pack_params(params)
    cots = [torch.randn(s, generator=gen, device=dev) * (300.0 / n)
            for s in ((n, 1), (n, 2, 1), (n, 1))]
    gp, gx = torch.empty_like(packed), torch.empty_like(x)
    scratch = {}

    def run(lib):
        sv._library = lambda: lib
        if id(lib) not in scratch:
            scratch[id(lib)] = sv.backward_scratch(widths, x)
        sv.launch_backward(packed, widths, x, *cots, scratch[id(lib)], gp,
                           gx)

    def check(lib):
        g_ref, gx_ref = sv.siren_vgl_backward_reference(params, x, *cots)
        gp_ref = torch.cat([t.reshape(-1) for wb in g_ref for t in wb])
        got = []
        for _ in range(2):
            run(lib)
            torch.cuda.synchronize()
            got.append((gp.clone(), gx.clone()))
        for a, ref in zip(got[0], (gp_ref, gx_ref)):
            torch.testing.assert_close(a, ref, rtol=1e-4, atol=5e-3)
        if not all(torch.equal(a, b) for a, b in zip(*got)):
            raise RuntimeError("siren_vgl backward: two runs differ")
        err = max((a - r).abs().max().item()
                  for a, r in zip(got[0], (gp_ref, gx_ref)))
        return f"max abs err {err:.3e} (rtol 1e-4, atol 5e-3), same bits"

    desc = f"widths {widths}, N={n}, per call"
    return Case(sv.bind, run, 1, desc, check)


def _forward_case(name, launch_outs, ref_outs, tols):
    """check and result of a forward kernel whose `launch_outs(lib)` launches
    it and returns its output buffers: both runs the same bits, each output
    within (rtol, atol) of the plain version's."""
    import torch

    def result(lib):
        outs = launch_outs(lib)
        torch.cuda.synchronize()
        return [o.clone() for o in outs]

    def check(lib):
        first, second = result(lib), result(lib)
        errs = []
        for got, ref, (rtol, atol) in zip(first, ref_outs, tols):
            torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
            errs.append((got - ref).abs().max().item())
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise RuntimeError(f"{name}: two runs differ")
        return (f"max abs err {' '.join(f'{e:.3e}' for e in errs)} (rtol/atol "
                f"{' '.join(f'{r:.0e}/{a:.0e}' for r, a in tols)}), same bits")

    return check, result


# chip_smoke.py's shapes: (d, m, hidden layers, width, N)
_VGL_FWD_SHAPES = {"pressure_16384": (2, 1, 3, 32, 16384),
                   "w128_16384": (2, 1, 3, 128, 16384)}
# chip_smoke.py's VGL_FWD_TOL: u, J, L
_VGL_FWD_TOL = ((1e-5, 1e-5), (1e-5, 1e-4), (1e-4, 2e-3))


def _siren_vgl_forward_case(args):
    """The vgl forward at a shape of chip_smoke.py's VGL_SHAPES; per call."""
    import torch
    from .models.networks import MLP
    from .ops import siren_vgl as sv
    from .ops.siren_forward import pack_params
    dev = torch.device("cuda", 0)
    shape = args.shape or "pressure_16384"
    d, m, layers, width, n = _VGL_FWD_SHAPES[shape]
    n = args.n or n
    gen = torch.Generator(device=dev).manual_seed(1)
    params = MLP(d, m, layers, width).init(gen)
    x = torch.rand((n, d), generator=gen, device=dev) * 2.0 - 1.0
    packed, widths = pack_params(params)
    outs = [torch.empty(s, device=dev) for s in ((n, m), (n, d, m), (n, m))]

    def run(lib):
        sv._library = lambda: lib
        sv.launch_forward(packed, widths, x, *outs)

    def launch_outs(lib):
        run(lib)
        return outs

    check, result = _forward_case("siren_vgl forward", launch_outs,
                                  sv.siren_vgl_reference(params, x),
                                  _VGL_FWD_TOL)
    desc = f"{shape}: widths {widths}, N={n}, per call"
    return Case(sv.bind, run, 1, desc, check, result, True, "fwd")


# chip_smoke.py's SIREN forward cases: (in, out, hidden layers, width, N,
# coords: the -vr grid or uniform random, atol)
_SIREN_SHAPES = {"fluid_vr128_16384": (2, 2, 3, 32, 128, "grid", 2e-5),
                 "w128_l5_16384": (2, 2, 5, 128, 16384, "random", 5e-5)}


def _siren_forward_case(args):
    """The fused SIREN forward at a shape of chip_smoke.py's cases; per
    call."""
    import torch
    from .models.networks import MLP
    from .ops import siren_forward as sf
    from .ops.sampling import sample_uniform
    dev = torch.device("cuda", 0)
    shape = args.shape or "fluid_vr128_16384"
    in_f, out_f, layers, width, n, kind, atol = _SIREN_SHAPES[shape]
    if kind == "random":
        n = args.n or n
    gen = torch.Generator(device=dev).manual_seed(0)
    params = MLP(in_f, out_f, layers, width).init(gen)
    if kind == "grid":
        x = sample_uniform(n, in_f, device=dev).contiguous()
    else:
        x = torch.rand((n, in_f), generator=gen, device=dev) * 2.0 - 1.0
    packed, widths = sf.pack_params(params)
    out = torch.empty((x.shape[0], out_f), device=dev)

    def run(lib):
        sf._library = lambda: lib
        sf.launch(packed, widths, x, out)

    def launch_outs(lib):
        run(lib)
        return [out]

    check, result = _forward_case(
        "siren_forward", launch_outs, [sf.siren_forward_reference(params, x)],
        [(0.0, atol)])
    desc = f"{shape}: widths {widths}, N={x.shape[0]}, per call"
    return Case(sf.bind, run, 1, desc, check, result, True, "fwd")


def _block_ell_mv_case(args):
    """One mv per call."""
    import torch
    from .ops import block_ell as be
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    if args.shape == "ell":
        R, S, nb = 35600, 768, 192000
        vals = torch.randn((R, S, 1), generator=g, device=dev)
        cols = torch.randint(0, nb, (R, S), generator=g, device=dev,
                             dtype=torch.int32)
        x = torch.randn(nb, generator=g, device=dev)
        what = "the TPU kernel's scalar ELL, random slots"
    else:
        from .models.vortex import StreamVortexModel, VortexModel
        from .starterL import build_config, parse_args
        flags = parse_args(["--preset", "channel"])
        cls = StreamVortexModel if flags.formulation == "stream" \
            else VortexModel
        model = cls(build_config(flags), log=False, device=dev)
        A, _ = model.assemble(model.params.u)
        vals, cols = A.vals, A.cols
        x = torch.randn(A.n_cols, generator=g, device=dev)
        what = "the channel preset's operator"
    out = torch.empty(vals.shape[0], device=dev)
    ref = be.block_ell_mv_reference(vals, cols, x)

    def run(lib):
        be._library = lambda: lib
        be.launch_mv(vals, cols, x, out)

    def check(lib):
        got = []
        for _ in range(2):
            run(lib)
            torch.cuda.synchronize()
            got.append(out.clone())
        err = (got[0] - ref).abs().max().item()
        bar = 1e-5 * ref.abs().max().item()
        if not torch.isfinite(got[0]).all() or not err <= bar:
            raise RuntimeError(f"block_ell_mv: max abs err {err:.3e} beyond "
                               f"{bar:.3e}")
        if not torch.equal(*got):
            raise RuntimeError("block_ell_mv: two runs differ")
        return f"max abs err {err:.3e} (bar {bar:.3e}), same bits"

    R, S, J = vals.shape
    return Case(be.bind, run, 1,
                f"{what}: R {R}, S {S}, J {J}, per call", check)


# kernel -> (case, source in csrc/, shapes it takes)
_CASES = {"advect_fit": (_advect_fit_case, "advect_fit", ()),
          "siren_vgl": (_siren_vgl_case, "siren_vgl", ()),
          "siren_vgl_forward": (_siren_vgl_forward_case, "siren_vgl",
                                tuple(_VGL_FWD_SHAPES)),
          "siren_forward": (_siren_forward_case, "siren_forward",
                            tuple(_SIREN_SHAPES)),
          "block_ell_mv": (_block_ell_mv_case, "block_ell",
                           ("channel", "ell"))}


def _kernel_times(run) -> dict:
    """Device ms of each kernel of one `run()`, from a profiler trace of 10
    runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            words = [w for w in re.findall(r"([A-Za-z_]\w*)\s*(?=<|\()",
                                           e.name) if w != "void"]
            name = words[0] if words else e.name
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e4
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(_CASES))
    other = ap.add_mutually_exclusive_group()
    other.add_argument("--variant", default=None,
                       help="a patch of kernel_variants.py, timed beside the "
                            "source it patches")
    other.add_argument("--source", default=None,
                       help="another copy of the kernel's source (e.g. an "
                            "earlier design), timed beside the committed one")
    ap.add_argument("--n", type=int, default=0,
                    help="points (default: the main path's)")
    ap.add_argument("--nb", type=int, default=50)
    ap.add_argument("--iters", type=int, default=250)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--shape", default=None,
                    help="block_ell_mv: channel|ell; siren_vgl_forward: "
                         "pressure_16384|w128_16384; siren_forward: "
                         "fluid_vr128_16384|w128_l5_16384")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)

    import torch
    case_fn, src_name, shapes = _CASES[args.kernel]
    if args.shape is not None and args.shape not in shapes:
        ap.error(f"{args.kernel} takes --shape in {shapes}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: needs a CUDA card")
    case = case_fn(args)
    inner = 1 if args.kernel == "advect_fit" else 20
    text = cuda_build.source_text(src_name)
    sources = {}                      # label -> source text
    if args.variant:
        sources["committed"] = text
        sources[args.variant] = kernel_variants.patched(src_name,
                                                        args.variant, text)
    elif args.source:
        sources["committed"] = text
        sources["other"] = cuda_build.expand_includes(
            Path(args.source).read_text())
    else:
        sources["source"] = text
    main_label = "committed" if len(sources) > 1 else "source"

    # every build at once: each source as it is, and stamped where marked
    builds = {label: _write_probe(t, f"{args.kernel}_{label}")
              for label, t in sources.items()}
    marked = [label for label, t in sources.items()
              if has_marks(t, case.tag)]
    names = {}
    for label in marked:
        stamped, names[label] = stamped_source(sources[label], case.tag)
        builds[f"{label}_probe"] = _write_probe(
            stamped, f"{args.kernel}_{label}_probe")
    built = _nvcc_all(builds)
    libs = {label: case.bind(built[label]) for label in sources}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    label_src = {"committed": str(cuda_build.CSRC / f"{src_name}.cu"),
                 "source": str(cuda_build.CSRC / f"{src_name}.cu"),
                 "other": args.source}
    print(f"{args.kernel}: {case.desc}; {smi}")
    for label in sources:
        print(f"  {label}: {label_src.get(label, f'variant {label}')}")
    record = {"kernel": args.kernel, "shape": args.shape, "desc": case.desc,
              "card": smi}
    if case.check is not None:
        for label, lib in libs.items():
            print(f"  check {label}: {case.check(lib)}")
    if case.result is not None and len(libs) > 1:
        a, b = (case.result(lib) for lib in libs.values())
        record["same_bits"] = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"  the two builds give the same bits: {record['same_bits']}")

    timer = _median_graph_ms if case.graph else _median_event_ms
    runs = {label: [] for label in libs}
    order = list(libs) + list(reversed(libs))
    for label in order:
        runs[label].append(timer(lambda: case.run(libs[label]), args.reps,
                                 inner) / case.per)
    ms = {label: sum(v) / len(v) for label, v in runs.items()}
    print("unstamped ms (" + ("CUDA graph" if case.graph else "CUDA events")
          + ", order " + ", ".join(order) + "): "
          + ", ".join(f"{k} {v:.5f}" for k, v in ms.items())
          + "; each median: " + ", ".join(
              f"{k} " + " / ".join(f"{x:.5f}" for x in v)
              for k, v in runs.items()))
    record["ms"] = ms
    record["ms_runs"] = runs

    record["phases"] = {}
    for label in marked:
        probe = case.bind(built[f"{label}_probe"])
        ms_probe = timer(lambda: case.run(probe), args.reps, inner) / case.per
        acc = (ctypes.c_longlong * _MAX_PHASES)()
        err = probe.phase_read(acc)
        if err != 0:
            raise RuntimeError(f"phase_read failed with CUDA error {err}")
        cycles = [acc[k] / case.per for k in range(len(names[label]))]
        total = sum(cycles)
        phases = {name: {"cycles": c, "share": c / total,
                         "ms": c / total * ms_probe}
                  for name, c in zip(names[label], cycles)}
        print(f"{label}: stamped {ms_probe:.5f} ms, {total:.0f} cycles of "
              f"thread 0, block 0 ({total / (ms_probe * 1e3):.0f} cycles/us)")
        for name, rec in phases.items():
            print(f"  {name:12s} {rec['cycles']:10.0f} cycles "
                  f"{rec['share']:6.3f}  {rec['ms']:.5f} ms")
        record["phases"][label] = {"ms_stamped": ms_probe, "phases": phases}
    kernels = {k: v / case.per for k, v in
               _kernel_times(lambda: case.run(libs[main_label])).items()}
    print("device ms per kernel (unstamped, profiler): "
          + ", ".join(f"{k} {v:.5f}" for k, v in kernels.items()))
    record["kernels"] = kernels
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
