"""PyTorch port, the advection Adam fit (`ops/advect_fit.py`).

* The plain version against the TPU kernel `fused_advect_fit` run in
  interpret mode with host uniforms (`tools/experiments/pallas_trainer.py`),
  at the pin of `tools/experiments/test_pallas_trainer.py` (2x20 SIREN, 128
  collocation and 16 boundary points, 60 iterations, HL 2, dt 0.05, vel
  0.25, lr 1e-3). The test maps the uniforms to points with the TPU
  kernel's formulas (`pallas_trainer.py:196-199`). Tolerances are the
  pin's: loss history rtol 2e-3, params atol 5e-5.
* The plain version against the port's generic `Solver` with the
  advection model's `_advect_loss` on the same points, with the early-stop
  latch firing inside the chunk; a NaN in one iteration's points is skipped
  as the Solver skips it; two chunks that carry the state equal one. With
  `debug_nan` the history gains the `_nan` column (any NaN in the
  gradient), set exactly on the iterations a NaN point or parameter
  reaches, and the other columns stay as they are.
* The CUDA kernel runs only on the card (a `cuda`-marked case skips here).
  Its source is also compiled with the host C++ compiler against a small
  emulation of the CUDA runtime in which every block's threads run at once
  as std::threads, joined by a per-block barrier, a per-warp barrier (for
  __syncwarp and for the shuffles, which exchange through a per-warp
  buffer) and a grid barrier across all blocks, and held against the plain
  version: at several blocks, several tiles per block, teams of 8 threads
  per row at 64, 40, 16 and 8 rows per block, and ragged last tiles; the
  case with a NaN iteration also writes the `_nan` column."""

import ctypes
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insr_pde_tpu.models.networks import MLP as JMLP
from insr_pde_tpu_torch.config import Config
from insr_pde_tpu_torch.convert import params_from_jax
from insr_pde_tpu_torch.models.advection import Advection1DModel
from insr_pde_tpu_torch.models.networks import MLP
from insr_pde_tpu_torch.models.solver import Solver, ravel
from insr_pde_tpu_torch.ops import advect_fit as af
from insr_pde_tpu_torch.ops import cuda_build
from tools.experiments.pallas_trainer import fused_advect_fit

torch.set_num_threads(1)

HL, DT, VEL, LR = 2.0, 0.05, 0.25, 1e-3
NS, NB, NIT = 128, 16, 60
WIDTHS = [1, 20, 20, 20, 1]


def _hyper(**kw):
    base = dict(dt=DT, vel=VEL, lr=LR, min_scale=1e-8 / LR,
                stop_scale=1.1e-8 / LR)
    return af.AdvectFitHyper(**{**base, **kw})


def _flat(params):
    return ravel(params)[0].detach().contiguous()


def _nets(seed=0):
    g = torch.Generator().manual_seed(seed)
    net = MLP(1, 1, 2, 20)
    return net.init(g), net.init(g)


def _points(n_iters, n=NS, nb=NB, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-HL, HL, (n_iters, n)).astype(np.float32)
    side = np.where(rng.uniform(size=(n_iters, nb)) < 0.5, -1.0, 1.0)
    xb = (side * HL + rng.uniform(-1e-4, 1e-4, (n_iters, nb))).astype(
        np.float32)
    return torch.from_numpy(x), torch.from_numpy(xb)


def test_plain_version_matches_pallas_interpret():
    jnet = JMLP(1, 1, num_hidden_layers=2, hidden_features=20)
    jp = jnet.init(jax.random.PRNGKey(0))
    jq = jnet.init(jax.random.PRNGKey(1))
    uni = jax.random.uniform(jax.random.PRNGKey(2), (NIT, NS + NB, 2))
    new_jp, jhist = fused_advect_fit(
        jp, jq, jnp.int32(0), n_iters=NIT, n_samples=NS, n_boundary=NB,
        half_length=HL, dt=DT, vel=VEL, lr=LR, early_stop=False,
        interpret=True, host_uniforms=uni)

    # the TPU kernel's own map from uniforms to points
    u = np.asarray(uni)
    x = ((u[:, :NS, 0] * 2.0 - 1.0) * HL).astype(np.float32)
    side = np.where(u[:, NS:, 1] < 0.5, -1.0, 1.0)
    xb = (side * HL + (u[:, NS:, 0] * 2.0 - 1.0) * 1e-4).astype(np.float32)

    tp = params_from_jax([(np.asarray(w), np.asarray(b)) for w, b in jp])
    tq = params_from_jax([(np.asarray(w), np.asarray(b)) for w, b in jq])
    state = af.init_state(_flat(tp))
    hist = af.advect_fit(state, _flat(tq), torch.from_numpy(x),
                         torch.from_numpy(xb), WIDTHS,
                         _hyper(early_stop=False))
    np.testing.assert_allclose(hist[:, 3].numpy(), np.asarray(jhist),
                               rtol=2e-3)
    ref = np.concatenate([np.asarray(t).reshape(-1) for wb in new_jp
                          for t in wb])
    np.testing.assert_allclose(state.params.numpy(), ref, atol=5e-5)
    assert state.istate.tolist() == [NIT, state.istate[1].item(), 0]


def _model(tmp_path, **over):
    kw = dict(pde="advection", init_cond="example1", num_hidden_layers=2,
              hidden_features=20, sample_resolution=NS, lr=LR, dt=DT,
              device="cpu", proj_dir=str(tmp_path), backup_sources=False)
    return Advection1DModel(Config(**{**kw, **over}))


def test_plain_version_matches_solver_with_latch(tmp_path):
    """A patience of 2 with a threshold few steps meet lowers the LR every
    third iteration or so, so the latch fires well inside the 40. The plain
    version and the generic Solver on the model's `_advect_loss` agree on
    every logged value and on the frozen params."""
    model = _model(tmp_path)
    p, q = _nets()
    x, xb = _points(40)
    it = iter(range(40))

    def sample():
        i = next(it)
        return {"x": x[i][:, None], "xb": xb[i][:, None]}

    kw = dict(plateau_patience=2, plateau_threshold=0.9)
    solver = Solver(model._advect_loss, sample, lr=LR, max_n_iters=40,
                    chunk_size=40, **kw)
    res = solver.fit(p, {"prev": q})
    state = af.init_state(_flat(p))
    hist = af.advect_fit(state, _flat(q), x, xb, WIDTHS, _hyper(
        plateau_patience=2, plateau_threshold=0.9))
    active = hist[:, 0].numpy() > 0.5
    assert res.n_iters == int(active.sum())
    assert 5 < res.n_iters < 40
    assert state.istate.tolist()[2] == 1
    n = res.n_iters
    for col, key in ((1, "_lr"), (2, "bc"), (3, "main")):
        np.testing.assert_allclose(hist[:n, col].numpy(), res.history[key],
                                   rtol=1e-4)
    np.testing.assert_allclose(state.params.numpy(), _flat(res.params).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_nan_points_skip_the_write():
    """A NaN point makes main and the gradient NaN: that iteration writes
    nothing (params, moments, count, scheduler), as in the Solver, and the
    fit goes on."""
    p, q = _nets()
    x, xb = _points(6)
    x[2, 5] = float("nan")
    state = af.init_state(_flat(p))
    hist = af.advect_fit(state, _flat(q), x, xb, WIDTHS, _hyper())
    assert torch.isnan(hist[2, 3]) and torch.isfinite(hist[3:, 3]).all()
    assert state.istate[0].item() == 5      # Adam count: 5 written steps
    # the same fit without the NaN iteration
    keep = [0, 1, 3, 4, 5]
    state2 = af.init_state(_flat(p))
    af.advect_fit(state2, _flat(q), x[keep].contiguous(),
                  xb[keep].contiguous(), WIDTHS, _hyper())
    for a, b in zip(state, state2):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("where", ["point", "param"])
def test_debug_nan_flags_the_nan_iterations(where):
    """A NaN point reaches one iteration's gradient; a NaN parameter every
    iteration's (no write ever clears it). `_nan` is 1 exactly there, and
    the other columns equal the history without `debug_nan`."""
    p, q = _nets()
    x, xb = _points(6)
    flat = _flat(p)
    if where == "point":
        x[2, 5] = float("nan")
        expect = [0, 0, 1, 0, 0, 0]
    else:
        flat[7] = float("nan")
        expect = [1] * 6
    plain = af.advect_fit(af.init_state(flat), _flat(q), x, xb, WIDTHS,
                          _hyper())
    flagged = af.advect_fit(af.init_state(flat), _flat(q), x, xb, WIDTHS,
                            _hyper(), debug_nan=True)
    assert af.history_keys(True) == ["_active", "_lr", "_nan", "bc", "main"]
    assert plain.shape == (6, 4) and flagged.shape == (6, 5)
    assert flagged[:, 2].tolist() == expect
    torch.testing.assert_close(flagged[:, [0, 1, 3, 4]], plain, rtol=0,
                               atol=0, equal_nan=True)


def test_two_chunks_equal_one():
    p, q = _nets()
    x, xb = _points(20)
    hp = _hyper(plateau_patience=3, plateau_threshold=0.5)
    one = af.init_state(_flat(p))
    h_one = af.advect_fit(one, _flat(q), x, xb, WIDTHS, hp)
    two = af.init_state(_flat(p))
    h_a = af.advect_fit(two, _flat(q), x[:7].contiguous(),
                        xb[:7].contiguous(), WIDTHS, hp)
    h_b = af.advect_fit(two, _flat(q), x[7:].contiguous(),
                        xb[7:].contiguous(), WIDTHS, hp)
    torch.testing.assert_close(torch.cat([h_a, h_b]), h_one)
    for a, b in zip(one, two):
        torch.testing.assert_close(a, b)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p, q = _nets()
    x, xb = _points(2)
    state = af.init_state(_flat(p))
    with pytest.raises(ValueError, match="1 input and 1 output"):
        af.advect_fit(state, _flat(q), x, xb, [2, 20, 20, 20, 1], _hyper())
    with pytest.raises(ValueError, match="shared memory"):
        af.advect_fit(state, _flat(q), x, xb, [1, 200, 200, 200, 1],
                      _hyper())
    with pytest.raises(ValueError, match="prev"):
        af.advect_fit(state, _flat(q)[:-1], x, xb, WIDTHS, _hyper())
    with pytest.raises(ValueError, match="x"):
        af.advect_fit(state, _flat(q), x.double(), xb, WIDTHS, _hyper())
    with pytest.raises(ValueError, match="iteration count"):
        af.advect_fit(state, _flat(q), x, xb[:1].contiguous(), WIDTHS,
                      _hyper())
    wide = _flat(MLP(1, 1, 1, 81).init(torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="80 units"):
        af.advect_fit(af.init_state(wide), wide, x, xb, [1, 81, 81, 1],
                      _hyper())
    # the main chunk: 40-row blocks, a tile for each of 132 SMs; few rows:
    # the fewest rows per block; wide nets: fewer rows, to fit
    assert af.plan_rows(WIDTHS, 5050, 132) == 40
    assert af.plan_rows(WIDTHS, 3000, 132) == 24
    assert af.plan_rows(WIDTHS, 144, 132) == 8
    assert af.plan_rows(WIDTHS, 50000, 132) == 64
    assert af.plan_rows([1, 80, 80, 1], 5050, 132) == 16
    assert af.plan_rows([1, 64, 64, 64, 1], 5050, 132) == 8
    assert af.plan_rows([1, 200, 200, 200, 1], 5050, 132) == 0


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    p, q = _nets()
    x, xb = _points(3)
    before = af.advect_fit.launches
    state = af.init_state(_flat(p))
    ref = af.init_state(_flat(p))
    h = af.advect_fit(state, _flat(q), x, xb, WIDTHS, _hyper())
    h_ref = af.advect_fit_reference(ref, _flat(q), x, xb, WIDTHS, _hyper())
    torch.testing.assert_close(h, h_ref, rtol=0, atol=0)
    assert af.advect_fit.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the CUDA kernel has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,nb,n_iters,patience", [(NS, NB, NIT, 500),
                                                   (5000, 50, 250, 500),
                                                   (NS, NB, NIT, 2)])
def test_kernel_matches_plain_version_on_card(cuda_device, n, nb, n_iters,
                                              patience):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    net = MLP(1, 1, 2, 20)
    p, q = _flat(net.init(g)), _flat(net.init(g))
    x = (torch.rand((n_iters, n), generator=g, device=cuda_device) * 2 - 1) * HL
    xb = (torch.rand((n_iters, nb), generator=g, device=cuda_device) * 2
          - 1) * 1e-4 + HL * torch.sign(torch.rand(
              (n_iters, nb), generator=g, device=cuda_device) - 0.5)
    hp = _hyper(plateau_patience=patience,
                plateau_threshold=0.9 if patience < 10 else 1e-4)
    got, ref = af.init_state(p), af.init_state(p)
    before = af.advect_fit.launches
    h = af.advect_fit(got, q, x, xb, WIDTHS, hp)
    h_ref = af.advect_fit_reference(ref, q, x, xb, WIDTHS, hp)
    torch.cuda.synchronize()
    assert af.advect_fit.launches == before + 1
    assert torch.equal(h[:, 0], h_ref[:, 0])
    torch.testing.assert_close(h[:, 1:], h_ref[:, 1:], rtol=2e-3, atol=0)
    torch.testing.assert_close(got.params, ref.params, rtol=0, atol=5e-5)


# The CUDA runtime as far as csrc/advect_fit.cu uses it, on the host: a
# cooperative launch runs every block's threads at once, each block with its
# own barrier, a barrier per warp (__syncwarp, and the shuffles, which
# exchange through a per-warp buffer between two of its waits) and shared
# memory (NaN at the start, so a read before a write shows), all of them
# joined by a grid barrier. `emu_sms` SMs (2 unless a test sets it) of one
# block each, so that at 2 a block walks several tiles.
_EMULATION_H = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <memory>
#include <thread>
#include <tuple>
#include <vector>
using std::isfinite;
using std::isnan;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(x)
#define __restrict__
struct float4 { float x, y, z, w; };
struct uint3_ { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local uint3_ threadIdx, blockIdx;
inline uint3_ gridDim, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorCooperativeLaunchTooLarge = 82,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16,
       cudaLaunchAttributeCooperative = 2 };
struct EmuBlock {
    std::barrier<> bar;
    std::atomic<int> acc{1};
    std::vector<float4> smem;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    std::vector<float> lanes;
    EmuBlock(unsigned threads, size_t n) : bar(threads),
        smem(n, float4{NAN, NAN, NAN, NAN}), lanes(threads, NAN) {
        for (unsigned w = 0; w * 32 < threads; ++w)
            warps.emplace_back(new std::barrier<>(std::min(32u, threads - 32 * w)));
    }
};
extern "C" { int emu_sms = 2; }
inline thread_local EmuBlock* emu_block = nullptr;
inline std::barrier<>* emu_grid = nullptr;
#define smem4 (emu_block->smem.data())
inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline void __syncwarp() { emu_block->warps[threadIdx.x / 32]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
    EmuBlock& b = *emu_block;
    b.lanes[threadIdx.x] = v;
    __syncwarp();
    const float r = b.lanes[threadIdx.x ^ off];
    __syncwarp();
    return r;
}
inline int __syncthreads_and(int p) {
    EmuBlock& b = *emu_block;
    b.bar.arrive_and_wait();
    if (threadIdx.x == 0) b.acc = 1;
    b.bar.arrive_and_wait();
    if (!p) b.acc = 0;
    b.bar.arrive_and_wait();
    const int r = b.acc;
    b.bar.arrive_and_wait();
    return r;
}
inline int __syncthreads_or(int p) {
    EmuBlock& b = *emu_block;
    b.bar.arrive_and_wait();
    if (threadIdx.x == 0) b.acc = 0;
    b.bar.arrive_and_wait();
    if (p) b.acc = 1;
    b.bar.arrive_and_wait();
    const int r = b.acc;
    b.bar.arrive_and_wait();
    return r;
}
inline float __ldcg(const float* p) { return *p; }
inline void sincosf(float x, float* s, float* c) { *s = std::sin(x); *c = std::cos(x); }
namespace cooperative_groups {
struct grid_group { void sync() { emu_grid->arrive_and_wait(); } };
inline grid_group this_grid() { return {}; }
}
template <typename K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
    *n = 1;
    return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = emu_sms; return 0; }
union cudaLaunchAttributeValue { int cooperative; };
struct cudaLaunchAttribute { int id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
    dim3 gridDim, blockDim;
    size_t dynamicSmemBytes;
    cudaStream_t stream;
    cudaLaunchAttribute* attrs;
    unsigned numAttrs;
};
template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...),
                               A&&... args) {
    if (cfg->numAttrs != 1 || cfg->attrs[0].id != cudaLaunchAttributeCooperative
        || cfg->attrs[0].val.cooperative != 1)
        return cudaErrorInvalidValue;
    const unsigned G = cfg->gridDim.x, T = cfg->blockDim.x;
    gridDim.x = G;
    blockDim.x = T;
    std::barrier<> grid_bar(G * T);
    emu_grid = &grid_bar;
    std::vector<std::unique_ptr<EmuBlock>> blocks;
    for (unsigned b = 0; b < G; ++b)
        blocks.emplace_back(new EmuBlock(T, cfg->dynamicSmemBytes / sizeof(float4) + 1));
    const auto packed = std::make_tuple(args...);
    std::vector<std::thread> team;
    for (unsigned b = 0; b < G; ++b)
        for (unsigned t = 0; t < T; ++t)
            team.emplace_back([&, b, t]() {
                threadIdx.x = t;
                blockIdx.x = b;
                emu_block = blocks[b].get();
                std::apply(kernel, packed);
            });
    for (auto& th : team) th.join();
    return cudaSuccess;
}
"""


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the CUDA source for the host")
    src = (cuda_build.CSRC / "advect_fit.cu").read_text()
    src = src.replace("extern __shared__ float4 smem4[];", "")
    out = tmp_path_factory.mktemp("emu_advect")
    (out / "cuda_runtime.h").write_text(_EMULATION_H)
    (out / "cooperative_groups.h").write_text("#pragma once\n")
    (out / "advect_fit.cpp").write_text(src)
    lib = out / "libadvect_fit_emu.so"
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared",
                           f"-I{out}", "-o", str(lib), str(out / "advect_fit.cpp"),
                           "-lpthread"], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.advect_fit_grid.argtypes = [i, i, p]
    lib.advect_fit_f32.argtypes = [p] * 10 + [i, i, i, i, p, p, i, i, i, p]
    return lib


@pytest.mark.parametrize("case", [
    # (widths, n, nb, iterations, patience, threshold, NaN iteration, SMs)
    (WIDTHS, 150, 16, 6, 500, 1e-4, None, 2),       # 64-row tiles, 2 blocks
    ([1, 12, 12, 1], 300, 40, 30, 2, 0.9, 4, 2),    # latch fires; a NaN skip
    ([1, 48, 48, 1], 70, 9, 3, 500, 1e-4, None, 2),    # 6 outputs a thread
    (WIDTHS, 90, 10, 5, 500, 1e-4, None, 16),      # 8-row tiles, 13 blocks
    ([1, 10, 10, 10, 1], 50, 13, 4, 500, 1e-4, None, 4),  # 16-row tiles;
    # width 10: 2 outputs for 2 members of a team, 1 for the other 6
])
def test_cuda_source_matches_plain_version_in_host_emulation(
        emulated_library, case):
    """At every case the last tile is ragged (166, 340, 79, 100 and 63
    rows at 64, 64, 40, 8 and 16 rows per block: 38, 20, 39, 4 and 15 rows
    in the last); at 2 SMs a block walks several tiles; a second launch
    gives the same bits. The case with a NaN iteration runs with the
    `_nan` column, which must equal the plain version's."""
    widths, n, nb, n_iters, patience, thr, nan_it, sms = case
    lib = emulated_library
    ctypes.c_int.in_dll(lib, "emu_sms").value = sms
    rows = af.plan_rows(widths, n + nb, sms)
    c_widths = (ctypes.c_int * len(widths))(*widths)
    grid = lib.advect_fit_grid(n + nb, len(widths) - 1, c_widths)
    assert grid == min(sms, -(-(n + nb) // rows))
    g = torch.Generator().manual_seed(5)
    net = MLP(1, 1, len(widths) - 3, widths[1])
    p, q = _flat(net.init(g)), _flat(net.init(g))
    x, xb = _points(n_iters, n, nb, seed=7)
    if nan_it is not None:
        xb[nan_it, 3] = float("nan")
    hp = _hyper(plateau_patience=patience, plateau_threshold=thr)
    debug_nan = nan_it is not None
    cols = len(af.history_keys(debug_nan))

    def launch():
        got = af.init_state(p)
        hist = torch.full((n_iters, cols), float("nan"))
        partial = torch.full((2, grid, p.numel() + 2), float("nan"))
        assert lib.advect_fit_f32(
            got.params.data_ptr(), q.data_ptr(),
            *(t.data_ptr() for t in got[1:]), x.data_ptr(),
            xb.data_ptr(), hist.data_ptr(), partial.data_ptr(), n_iters, n,
            nb, len(widths) - 1, c_widths,
            ctypes.cast(af._hyper_floats(hp), ctypes.c_void_p),
            patience, 1, int(debug_nan), None) == 0
        return got, hist

    got, hist = launch()
    ref = af.init_state(p)
    h_ref = af.advect_fit_reference(ref, q, x, xb, widths, hp, debug_nan)
    assert torch.equal(hist[:, 0], h_ref[:, 0])
    torch.testing.assert_close(hist[:, 1:], h_ref[:, 1:], rtol=2e-3, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(got.params, ref.params, rtol=0, atol=5e-5)
    assert got.istate.tolist() == ref.istate.tolist()
    if nan_it is not None:
        assert ref.istate[2].item() == 1 and not h_ref[:, 0].all()
        assert hist[:, 2].tolist() == [float(i == nan_it)
                                       for i in range(n_iters)]
    if sms > 2:
        again, hist2 = launch()
        assert torch.equal(hist2, hist)
        for a, b in zip(again, got):
            assert torch.equal(a, b)


def test_phase_probe_stamps_every_marked_boundary():
    """`kernel_phases` turns each `// phase:` mark of the source into a stamp
    (setup and end into the accumulators' reset and flush) and leaves the
    rest of the source as it is."""
    from insr_pde_tpu_torch import kernel_phases
    text = (cuda_build.CSRC / "advect_fit.cu").read_text()
    stamped, names = kernel_phases.stamped_source(text)
    assert names == ["forward", "loss", "reverse", "grads", "barrier", "sum",
                     "update"]
    marks = re.findall(r"^\s*// phase: (\w+)", text, flags=re.M)
    assert stamped.count("PHASE_STAMP(") - 1 == len(marks) - 2
    assert stamped.count("PHASE_SETUP();") == 1
    assert stamped.count("PHASE_END();") == 1
    assert not re.search(r"^\s*// phase:", stamped, flags=re.M)
    with pytest.raises(ValueError, match="setup"):
        kernel_phases.stamped_source("int main() {}\n")
