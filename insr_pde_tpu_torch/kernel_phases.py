"""Where a kernel's time goes, phase by phase, on the card; and a design
that was not kept, timed beside the committed one.

    python -m insr_pde_tpu_torch.kernel_phases advect_fit
    python -m insr_pde_tpu_torch.kernel_phases siren_vgl [--width 32]
        [--n 16384] [--variant NAME]
    python -m insr_pde_tpu_torch.kernel_phases block_ell_mv
        [--shape channel|ell] [--variant NAME]

Builds a probe copy of the kernel's committed source (`csrc/advect_fit.cu`
or `csrc/siren_vgl.cu`, or its variant) with `clock64()` stamps at its
`// phase: NAME` comments, runs it, and prints the cycles and the share of
each phase as thread 0 of block 0 sees them, beside the kernel's time
(CUDA events) unstamped and stamped (a source without marks, such as
`csrc/block_ell.cu`, is timed unstamped only):

* advect_fit: the advection path's chunk (2x20 SIREN, 5,000 + 50 points,
  250 iterations per launch), per iteration;
* siren_vgl: the backward of the value+gradient+Laplacian kernels at the
  pressure phase's shape (3 hidden layers of `--width`, d = 2, `--n`
  points), per call, and the device time of each kernel of the call (the
  backward and its cross-block sum) from a `torch.profiler` trace;
* block_ell_mv: the block-ELL mv on the channel preset's assembled operator
  (243,210 x 12 x 16, at the starting coefficients) or on the TPU kernel's
  scalar ELL (35,600 x 768, J = 1, random slots).

`--variant NAME` applies a patch of `kernel_variants.py` to the source and
times the committed and the patched build in this process (order committed,
variant, variant, committed; each the mean of its two medians), after
checking both against the plain version (siren_vgl and block_ell_mv: the
JAX pins' tolerance and the same bits over two runs).

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

from . import kernel_variants
from .ops import cuda_build

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
    """The source with its `// phase:` marks turned into stamps, and the
    stamps' prelude after its last #include; returns (source, phase
    names)."""
    if not re.search(r"^\s*// phase: setup", text, flags=re.M):
        raise ValueError("the source has no `// phase: setup` mark")
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
    includes = list(re.finditer(r"^#include <[^>]+>\n", text, flags=re.M))
    cut = includes[-1].end()
    return text[:cut] + _PRELUDE % {"n": _MAX_PHASES} + text[cut:], names


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


def build_probe(source: Path, kernel: str) -> tuple[ctypes.CDLL, list]:
    text, names = stamped_source(source.read_text())
    src = cuda_build.BUILD_DIR / "probe" / f"{kernel}_probe.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    return _nvcc(src, f"{kernel}_probe"), names


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


def _advect_fit_case(args):
    """(bind, run(lib), per): the advect fit's main chunk; times per
    iteration."""
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
    return af.bind, run, iters, desc, None


def _siren_vgl_case(args):
    """(bind, run(lib), per): the vgl backward at the pressure phase's
    shape with random cotangents; times per call."""
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
    return sv.bind, run, 1, desc, check


def _block_ell_mv_case(args):
    """(bind, run(lib), per, desc, check): one mv per call."""
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
    return be.bind, run, 1, f"{what}: R {R}, S {S}, J {J}, per call", check


# kernel -> (case, source in csrc/)
_CASES = {"advect_fit": (_advect_fit_case, "advect_fit"),
          "siren_vgl": (_siren_vgl_case, "siren_vgl"),
          "block_ell_mv": (_block_ell_mv_case, "block_ell")}


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
    ap.add_argument("--variant", default=None,
                    help="a patch of kernel_variants.py, timed beside the "
                         "source it patches")
    ap.add_argument("--n", type=int, default=0,
                    help="points (default: the main path's)")
    ap.add_argument("--nb", type=int, default=50)
    ap.add_argument("--iters", type=int, default=250)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--shape", choices=("channel", "ell"), default="channel",
                    help="block_ell_mv: the operator")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: needs a CUDA card")
    case, src_name = _CASES[args.kernel]
    bind, run, per, desc, check = case(args)
    inner = 1 if args.kernel == "advect_fit" else 20
    source = cuda_build.CSRC / f"{src_name}.cu"
    text = source.read_text()
    libs = {}
    if args.variant:
        libs["committed"] = bind(_nvcc(source, f"{args.kernel}_base"))
        text = kernel_variants.patched(src_name, args.variant, text)
        source = cuda_build.BUILD_DIR / "probe" / f"{src_name}_{args.variant}.cu"
        source.parent.mkdir(parents=True, exist_ok=True)
        source.write_text(text)
    plain = bind(_nvcc(source, f"{args.kernel}_plain"))
    libs[args.variant or "source"] = plain
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{args.kernel}: source {source}; {desc}; {smi}")
    record = {"kernel": args.kernel, "source": str(source)}
    if check is not None:
        for name, lib in libs.items():
            print(f"  check {name}: {check(lib)}")
    ms = {name: [] for name in libs}
    order = list(libs) + list(reversed(libs))
    for name in order:
        ms[name].append(_median_event_ms(lambda: run(libs[name]), args.reps,
                                         inner) / per)
    ms = {name: sum(v) / len(v) for name, v in ms.items()}
    print("unstamped ms (CUDA events, order " + ", ".join(order) + "): "
          + ", ".join(f"{k} {v:.5f}" for k, v in ms.items()))
    record["ms"] = ms[args.variant or "source"]
    if args.variant:
        record["ms_committed"] = ms["committed"]

    if re.search(r"^\s*// phase: setup", text, flags=re.M):
        probe, names = build_probe(source, args.kernel)
        bind(probe)
        ms_probe = _median_event_ms(lambda: run(probe), args.reps, inner) / per
        acc = (ctypes.c_longlong * _MAX_PHASES)()
        err = probe.phase_read(acc)
        if err != 0:
            raise RuntimeError(f"phase_read failed with CUDA error {err}")
        cycles = [acc[k] / per for k in range(len(names))]
        total = sum(cycles)
        phases = {name: {"cycles": c, "share": c / total,
                         "ms": c / total * ms_probe}
                  for name, c in zip(names, cycles)}
        print(f"stamped {ms_probe:.5f} ms, {total:.0f} cycles of thread 0, "
              f"block 0 ({total / (ms_probe * 1e3):.0f} cycles/us)")
        for name, rec in phases.items():
            print(f"  {name:12s} {rec['cycles']:10.0f} cycles "
                  f"{rec['share']:6.3f}  {rec['ms']:.5f} ms")
        record.update(ms_stamped=ms_probe, phases=phases)
    kernels = {k: v / per for k, v in _kernel_times(lambda: run(plain)).items()}
    print("device ms per kernel (unstamped, profiler): "
          + ", ".join(f"{k} {v:.5f}" for k, v in kernels.items()))
    record["kernels"] = kernels
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
