"""PyTorch port, the block-ELL gather-matvec and its transpose
(`ops/block_ell.py`, `ops/linalg.BlockSparse`/`PaddedSparse`/`block_gram`).

* The plain mv against the TPU kernel `ell_mv` run in interpret mode
  (`tools/experiments/pallas_spmv.py`) at J = 1, and against the JAX
  package's `PaddedSparse` and `BlockSparse` (mv, rmv, col_norms) and
  `block_gram` at J = 1 and J = 16, on the same numpy inputs. Tolerance: f32
  sums of up to a few hundred terms in another order, rtol 1e-5 / atol
  1e-5 relative to the operands' scale.
* The CSR transpose index lists every slot exactly once (every real slot,
  and no padding slot, when the rows' real slot counts are given); its
  chunk plan tiles each block's slots in even chunks of at most C; the
  streamed copy `vals_t` holds the slots' values in the index's order; and
  the chunked two-pass sum the rmv kernel runs, written in plain PyTorch,
  equals the plain rmv.
* The CUDA kernels run only on the card (`cuda`-marked cases skip here).
  The source is also compiled with the host C++ compiler against a small
  emulation of the CUDA runtime in which every block's threads run at once
  as std::threads, warp shuffles exchanging through a per-block buffer
  between barriers, and held against the plain versions at J = 1, 3, 4, 16
  and 20 (mv in its three vector modes, ragged last rows, slot counts that
  are no multiple of the unroll), on a skewed pattern (one block with many
  times the mean degree), with blocks that no slot addresses, and with
  blocks cut into several chunks; two runs give the same bits.
"""

import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insr_pde_tpu.ops import linalg as jlinalg
from insr_pde_tpu_torch.ops import block_ell as be
from insr_pde_tpu_torch.ops import cuda_build
from insr_pde_tpu_torch.ops import linalg
from tools.experiments.pallas_spmv import ell_mv

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5


def _system(R, S, J, n_blocks, seed=0, distinct=True):
    """Random block-ELL operands; with `distinct`, no row addresses a block
    twice (the assembly's invariant)."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(R, S, J)).astype(np.float32)
    if distinct:
        cols = np.stack([rng.choice(n_blocks, S, replace=False)
                         for _ in range(R)])
    else:
        cols = rng.integers(0, n_blocks, (R, S))
    x = rng.normal(size=n_blocks * J).astype(np.float32)
    r = rng.normal(size=R).astype(np.float32)
    return vals, cols.astype(np.int32), x, r


def test_plain_mv_matches_pallas_ell_mv_interpret():
    """J = 1 is the TPU kernel's scalar ELL: R 300, NNZ 8, 1,000 columns."""
    vals, cols, x, _ = _system(300, 8, 1, 1000, distinct=False)
    ref = ell_mv(jnp.asarray(vals[..., 0]), jnp.asarray(cols), jnp.asarray(x),
                 interpret=True)
    got = be.block_ell_mv(torch.from_numpy(vals), torch.from_numpy(cols),
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_padded_sparse_matches_jax():
    vals, cols, x, r = _system(120, 6, 1, 40, seed=1)
    vals = vals[..., 0]
    J_A = jlinalg.PaddedSparse(jnp.asarray(vals), jnp.asarray(cols), 40)
    A = linalg.PaddedSparse(torch.from_numpy(vals), torch.from_numpy(cols), 40)
    for got, ref in ((A.mv(torch.from_numpy(x)), J_A.mv(jnp.asarray(x))),
                     (A.rmv(torch.from_numpy(r)), J_A.rmv(jnp.asarray(r))),
                     (A.col_norms(), J_A.col_norms())):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("R,S,J,nb", [(200, 12, 16, 50), (64, 4, 8, 16),
                                      (90, 3, 20, 30)])
def test_block_sparse_matches_jax(R, S, J, nb):
    vals, cols, x, r = _system(R, S, J, nb, seed=R)
    J_A = jlinalg.BlockSparse(jnp.asarray(vals), jnp.asarray(cols), nb)
    A = linalg.BlockSparse(torch.from_numpy(vals), torch.from_numpy(cols), nb)
    for got, ref in ((A.mv(torch.from_numpy(x)), J_A.mv(jnp.asarray(x))),
                     (A.rmv(torch.from_numpy(r)), J_A.rmv(jnp.asarray(r))),
                     (A.col_norms(), J_A.col_norms())):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL * 10)


@pytest.mark.parametrize("slot_chunk", [65536, 40])
def test_block_gram_matches_jax(slot_chunk):
    """Small slot chunks make block_gram take many runs of blocks."""
    vals, cols, _, _ = _system(150, 5, 6, 25, seed=4)
    ref = jlinalg.block_gram(jnp.asarray(vals), jnp.asarray(cols), 25)
    A = linalg.BlockSparse(torch.from_numpy(vals), torch.from_numpy(cols), 25)
    got = linalg.block_gram(A, slot_chunk=slot_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=1e-4)


def test_transpose_index_lists_every_slot_once():
    vals, cols, _, _ = _system(100, 7, 1, 30, seed=5, distinct=False)
    t = be.transpose_index(torch.from_numpy(cols), 30)
    order, offsets = t.order.numpy(), t.offsets.numpy()
    assert t.order.dtype == torch.int32 and t.offsets.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(100 * 7))
    assert offsets[0] == 0 and offsets[-1] == 700
    flat = cols.reshape(-1)
    for b in range(30):
        seg = order[offsets[b]:offsets[b + 1]]
        assert (flat[seg] == b).all()
        assert (np.diff(seg) > 0).all()        # stable: slot order kept

    # with real slot counts per row: the padding slots are left out
    row_slots = np.random.default_rng(6).integers(1, 8, 100)
    t = be.transpose_index(torch.from_numpy(cols), 30,
                           torch.from_numpy(row_slots.astype(np.int32)))
    real = [r * 7 + s for r in range(100) for s in range(row_slots[r])]
    assert sorted(t.order.tolist()) == real
    assert t.offsets[-1].item() == len(real)


def test_padding_left_out_of_the_index_changes_nothing():
    """Rows padded with zero values in block 0 (as the vortex assembly
    pads): rmv, col_norms and block_gram over the index without the padding
    equal the plain versions over every slot."""
    vals, cols, _, r = _system(80, 6, 4, 20, seed=7)
    row_slots = np.where(np.arange(80) % 3 == 0, 3, 6).astype(np.int32)
    for i, n in enumerate(row_slots):
        vals[i, n:] = 0.0
        cols[i, n:] = 0
    A = linalg.BlockSparse(torch.from_numpy(vals), torch.from_numpy(cols), 20,
                           row_slots=torch.from_numpy(row_slots))
    full = linalg.BlockSparse(torch.from_numpy(vals), torch.from_numpy(cols),
                              20)
    torch.testing.assert_close(A.col_norms(), full.col_norms())
    torch.testing.assert_close(linalg.block_gram(A), linalg.block_gram(full))
    rt = torch.from_numpy(r)
    t_index = A.transpose()
    assert t_index.offsets[1].item() < full.transpose().offsets[1].item()
    torch.testing.assert_close(
        _pull_rmv(A, rt),
        be.block_ell_rmv_reference(A.vals, A.cols, rt, 20))


def _pull_rmv(A, r):
    """The pull over A's transpose index, in numpy (what the kernel sums)."""
    order, offsets = (t.numpy() for t in A.transpose()[:2])
    v = A.vals.numpy().reshape(-1, A.bdim)
    S = A.cols.shape[1]
    out = np.zeros((A.n_blocks, A.bdim), np.float32)
    for b in range(A.n_blocks):
        seg = order[offsets[b]:offsets[b + 1]]
        out[b] = (v[seg] * r.numpy()[seg // S, None]).sum(0)
    return torch.from_numpy(out.reshape(-1))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    vals, cols, x, r = _system(50, 4, 16, 12, seed=8)
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    before = (be.mv_launches, be.rmv_launches)
    torch.testing.assert_close(be.block_ell_mv(v, c, torch.from_numpy(x)),
                               be.block_ell_mv_reference(v, c,
                                                         torch.from_numpy(x)),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        be.block_ell_rmv(v, c, torch.from_numpy(r), 12),
        be.block_ell_rmv_reference(v, c, torch.from_numpy(r), 12),
        rtol=0, atol=0)
    assert (be.mv_launches, be.rmv_launches) == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    vals, cols, x, r = _system(10, 3, 4, 6, seed=9)
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    with pytest.raises(ValueError, match="cols"):
        be.block_ell_mv(v, c.long(), torch.from_numpy(x))
    with pytest.raises(ValueError, match="vals"):
        be.block_ell_mv(v.double(), c, torch.from_numpy(x))
    with pytest.raises(ValueError, match="multiple of J"):
        be.block_ell_mv(v, c, torch.from_numpy(x)[:-1])
    with pytest.raises(ValueError, match="vector"):
        be.block_ell_rmv(v, c, torch.from_numpy(r)[:-1], 6)
    # mv: (lanes per row, floats per vector)
    assert be.lanes(12, 16) == (16, 4)          # the channel operator
    assert be.lanes(768, 1) == (32, 4)          # the TPU kernel's scalar ELL
    assert be.lanes(3, 20) == (4, 4)
    assert be.lanes(5, 4) == (2, 4)
    assert be.lanes(24, 1) == (2, 4)
    assert be.lanes(7, 1) == (2, 1)             # S % 4 != 0: scalar loads
    assert be.lanes(6, 3) == (8, 1)
    assert be.lanes(12, 16, aligned=False) == (32, 1)
    assert be.rmv_lanes(16) == (4, 4)
    assert be.rmv_lanes(1) == (1, 1)
    assert be.rmv_lanes(20) == (4, 4)
    assert be.rmv_lanes(6) == (1, 4)
    assert be.rmv_lanes(256) == (4, 32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,S,J,nb", [(35600, 768, 1, 192000),
                                      (4000, 12, 16, 800)])
def test_kernels_match_plain_versions_on_card(cuda_device, R, S, J, nb):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    vals = torch.randn((R, S, J), generator=g, device=cuda_device)
    cols = torch.randint(0, nb, (R, S), generator=g, device=cuda_device,
                         dtype=torch.int32)
    x = torch.randn(nb * J, generator=g, device=cuda_device)
    r = torch.randn(R, generator=g, device=cuda_device)
    before = (be.mv_launches, be.rmv_launches)
    out = be.block_ell_mv(vals, cols, x)
    ref = be.block_ell_mv_reference(vals, cols, x)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-5 * ref.abs().max().item())
    out = be.block_ell_rmv(vals, cols, r, nb)
    ref = be.block_ell_rmv_reference(vals, cols, r, nb)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * ref.abs().max().item())
    assert torch.equal(out, be.block_ell_rmv(vals, cols, r, nb))
    torch.cuda.synchronize()
    assert (be.mv_launches, be.rmv_launches) == (before[0] + 1,
                                                 before[1] + 2)


# The CUDA runtime as far as csrc/block_ell.cu uses it, on the host: a
# launch runs the grid's blocks one after another, each block's threads at
# once; a warp shuffle writes each thread's value to a per-block buffer and
# reads its partner's between two barriers.
_EMULATION_H = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __launch_bounds__(x)
#define __restrict__
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct uint3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local uint3_ threadIdx, blockIdx;
inline uint3_ gridDim, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 74,
       cudaDevAttrMultiProcessorCount = 16,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline std::barrier<>* emu_barrier = nullptr;
inline std::vector<float> emu_lanes;
inline std::vector<float4> emu_smem;
#define smem4 (emu_smem.data())
inline std::atomic<int> emu_fault{0};
inline cudaError_t cudaGetLastError() { return emu_fault.exchange(0); }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
template <typename K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline int emu_sms = 2;
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = emu_sms; return 0; }
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
    *n = 1;
    return 0;
}
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
// the ring's mbarrier: phases completed, bytes still expected; a bulk copy
// is a memcpy that checks the hardware's alignment rules
struct EmuRingBar { std::atomic<unsigned> done; std::atomic<int> tx; };
static_assert(sizeof(EmuRingBar) == sizeof(unsigned long long));
inline std::atomic<int> emu_ring_stages{0};
extern "C" int emu_ring_stages_taken() { return emu_ring_stages.exchange(0); }
inline void ring_init(unsigned long long* bar) {
    new (bar) EmuRingBar{};
    ++emu_ring_stages;
}
inline void ring_expect(unsigned long long* bar, unsigned bytes) {
    reinterpret_cast<EmuRingBar*>(bar)->tx += static_cast<int>(bytes);
}
inline void ring_copy(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
    if (((reinterpret_cast<std::uintptr_t>(dst) | reinterpret_cast<std::uintptr_t>(src)
          | bytes) & 15) != 0)
        emu_fault = cudaErrorMisalignedAddress;
    std::memcpy(dst, src, bytes);
    EmuRingBar* b = reinterpret_cast<EmuRingBar*>(bar);
    if ((b->tx -= static_cast<int>(bytes)) == 0) b->done.fetch_add(1);
}
inline void ring_fence() {}
inline void ring_wait(unsigned long long* bar, unsigned parity) {
    EmuRingBar* b = reinterpret_cast<EmuRingBar*>(bar);
    while ((b->done.load() & 1u) == parity) std::this_thread::yield();
}
template <typename T> inline T __ldg(const T* p) { return *p; }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
    emu_lanes[threadIdx.x] = v;
    emu_barrier->arrive_and_wait();
    const float r = emu_lanes[threadIdx.x ^ off];
    emu_barrier->arrive_and_wait();
    return r;
}
template <typename K, typename... A>
void emu_launch(K kernel, unsigned grid, unsigned threads, size_t smem, A... args) {
    gridDim.x = grid;
    blockDim.x = threads;
    for (unsigned b = 0; b < grid; ++b) {
        emu_lanes.assign(threads, NAN);
        emu_smem.assign(smem / sizeof(float4) + 1, float4{NAN, NAN, NAN, NAN});
        std::barrier<> bar(threads);
        emu_barrier = &bar;
        std::vector<std::thread> team;
        for (unsigned t = 0; t < threads; ++t)
            team.emplace_back([=]() { threadIdx.x = t; blockIdx.x = b; kernel(args...); });
        for (auto& th : team) th.join();
    }
}
"""


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the CUDA source for the host")
    src = (cuda_build.CSRC / "block_ell.cu").read_text()
    src, n = re.subn(r"(\w+)<<<([^,]+),([^,]+),([^,]+),[^>]+>>>\(",
                     r"emu_launch(\1, \2, \3, \4, ", src)
    assert n == 4
    # the header's ring primitives take the place of the PTX ones
    src, n = re.subn(r"// ring primitives \{\n.*?// \} ring primitives\n", "",
                     src, flags=re.S)
    assert n == 1
    src = src.replace("extern __shared__ float4 smem4[];", "")
    out = tmp_path_factory.mktemp("emu_block_ell")
    (out / "cuda_runtime.h").write_text(_EMULATION_H)
    (out / "block_ell.cpp").write_text(src)
    lib = out / "libblock_ell_emu.so"
    # -fno-gnu-unique: the emulation's inline globals stay in this library,
    # not shared with another emulated source loaded in the same process
    proc = subprocess.run([cxx, "-std=c++20", "-fno-gnu-unique", "-O1",
                           "-fPIC", "-shared",
                           f"-I{out}", "-o", str(lib),
                           str(out / "block_ell.cpp"), "-lpthread"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.block_ell_mv_f32.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.block_ell_rmv_f32.argtypes = [p] * 7 + [i] * 4 + [p]
    return lib


@pytest.mark.parametrize("R,S,J,nb,padded", [
    (70, 24, 1, 300, False),    # the TPU kernel's scalar form: 4 slots a vector
    (45, 12, 16, 20, True),     # the vortex shape, 2 rows per warp
    (40, 5, 4, 9, False),       # one 4-float vector per slot, 5 per row
    (33, 3, 20, 11, True),      # J = 20: 5 vectors per slot
    (37, 7, 1, 50, False),      # J = 1, S % 4 != 0: scalar loads
    (290, 9, 3, 40, True),      # J = 3: scalar loads, 8 lanes, 2 steps
    (530, 12, 16, 60, False),   # 34 ring tiles of 16 rows, the last ragged
    (300, 4, 20, 25, True),     # ring tiles of 32 rows, 5 per block
])
def test_cuda_source_matches_plain_versions_in_host_emulation(
        emulated_library, R, S, J, nb, padded):
    """mv at 1e-5 relative to max |plain|, in the planned vector mode (the
    ring of bulk-copied tiles where J % 4 == 0 and S % 4 == 0, walked by 2
    blocks so that it wraps) and in scalar loads (the plan for unaligned
    operands), the same bits on a second run; rmv at 1e-4 (longer sums);
    the rmv over an index without the padding slots where rows are
    padded."""
    lib = emulated_library
    vals, cols, x, r = _system(R, S, J, nb, seed=J, distinct=False)
    row_slots = None
    if padded:
        row_slots = np.where(np.arange(R) % 2 == 0, S // 2, S).astype(np.int32)
        for i, n in enumerate(row_slots):
            vals[i, n:] = 0.0
            cols[i, n:] = 0
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    xt, rt = torch.from_numpy(x), torch.from_numpy(r)

    ref = be.block_ell_mv_reference(v, c, xt)
    for aligned in (True, False):
        G, V = be.lanes(S, J, aligned)
        runs = []
        for _ in range(2):
            out = torch.full((R,), float("nan"))
            assert lib.block_ell_mv_f32(v.data_ptr(), c.data_ptr(),
                                        xt.data_ptr(), out.data_ptr(), R, S,
                                        J, G, V, None) == 0
            runs.append(out)
        ring = aligned and J % 4 == 0 and S % 4 == 0
        assert (lib.emu_ring_stages_taken() > 0) == ring
        torch.testing.assert_close(runs[0], ref, rtol=0,
                                   atol=1e-5 * ref.abs().max().item())
        assert torch.equal(runs[0], runs[1])

    out = _emulated_rmv(lib, v, c, rt, nb, None if row_slots is None
                        else torch.from_numpy(row_slots))
    ref = be.block_ell_rmv_reference(v, c, rt, nb)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * ref.abs().max().item())
    # bad lane counts and vector widths are refused, not launched
    assert lib.block_ell_mv_f32(v.data_ptr(), c.data_ptr(), xt.data_ptr(),
                                out.data_ptr(), R, S, J, 12, 1, None) != 0
    assert lib.block_ell_mv_f32(v.data_ptr(), c.data_ptr(), xt.data_ptr(),
                                out.data_ptr(), R, S, J, 4, 2, None) != 0
    if J % 4 and (J != 1 or S % 4):
        assert lib.block_ell_mv_f32(v.data_ptr(), c.data_ptr(),
                                    xt.data_ptr(), out.data_ptr(), R, S, J,
                                    4, 4, None) != 0


def _emulated_rmv(lib, v, c, rt, nb, row_slots=None, chunk=be.RMV_CHUNK):
    """One rmv through the emulated kernels: index, plan and vals_t built by
    the wrapper's functions."""
    J = v.shape[-1]
    t = be.transpose_index(c, nb, row_slots, chunk=chunk)
    vals_t = be.transpose_vals(v, t)
    n_chunks = t.chunk_start.numel() - 1
    partial = torch.full((max(n_chunks, 1) * J,), float("nan"))
    out = torch.full((nb * J,), float("nan"))
    _, F = be.rmv_lanes(J)
    assert lib.block_ell_rmv_f32(
        vals_t.data_ptr(), t.rows.data_ptr(), t.chunk_start.data_ptr(),
        t.chunk_off.data_ptr(), rt.data_ptr(), partial.data_ptr(),
        out.data_ptr(), n_chunks, nb, J, F, None) == 0
    return out


def _skewed(R, S, J, nb, seed):
    """Random operands in which block 0 (a boundary site) takes half of every
    row's slots (many times the mean degree) and blocks nb - 3 .. nb - 1 take
    none."""
    vals, cols, _, r = _system(R, S, J, nb, seed=seed, distinct=False)
    cols = cols % (nb - 3)
    cols[:, : S // 2] = 0
    return vals, cols, r


@pytest.mark.parametrize("R,S,J,nb,chunk", [
    (60, 8, 16, 24, 16),     # skewed: block 0 cut into 15 chunks of 16
    (50, 6, 1, 40, 5),       # J = 1, every block cut into chunks of <= 5
    (40, 4, 20, 12, 7),      # J = 20: 4-float loads, 2 passes of lanes
    (30, 5, 6, 10, 256),     # J = 6: scalar loads, one chunk per block
])
def test_rmv_source_on_skewed_and_empty_blocks_in_host_emulation(
        emulated_library, R, S, J, nb, chunk):
    """rmv at 1e-4 of max |plain| on a pattern with one heavy block and
    blocks no slot addresses (their outputs are exact zeros); a second run
    gives the same bits."""
    vals, cols, r = _skewed(R, S, J, nb, seed=R + J)
    v, c, rt = (torch.from_numpy(a) for a in (vals, cols, r))
    t = be.transpose_index(c, nb, chunk=chunk)
    n0 = t.offsets[1].item()                    # block 0's slots
    assert n0 >= R * (S // 2)
    assert t.chunk_off[1].item() == -(-n0 // chunk)
    out = _emulated_rmv(emulated_library, v, c, rt, nb, chunk=chunk)
    ref = be.block_ell_rmv_reference(v, c, rt, nb)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * ref.abs().max().item())
    assert (out.reshape(nb, J)[nb - 3:] == 0).all()
    again = _emulated_rmv(emulated_library, v, c, rt, nb, chunk=chunk)
    assert torch.equal(out, again)


@pytest.mark.parametrize("chunk", [1, 3, 16, 256])
def test_chunk_plan_tiles_each_block_in_even_chunks(chunk):
    """Every listed slot lies in exactly one chunk, each chunk inside one
    block, at most `chunk` slots, the block's chunks differing by at most one
    slot; a block with no slots has no chunk."""
    _, cols, _ = _skewed(70, 6, 1, 20, seed=11)
    t = be.transpose_index(torch.from_numpy(cols), 20, chunk=chunk)
    starts, off = t.chunk_start.numpy(), t.chunk_off.numpy()
    offsets = t.offsets.numpy()
    assert t.chunk_start.dtype == torch.int32 and t.chunk_off.dtype == torch.int32
    assert starts[0] == 0 and starts[-1] == offsets[-1] == 70 * 6
    assert off[0] == 0 and off[-1] == starts.size - 1
    sizes = np.diff(starts)
    assert (sizes >= 1).all() and (sizes <= chunk).all()
    for b in range(20):
        n = offsets[b + 1] - offsets[b]
        mine = sizes[off[b]:off[b + 1]]
        assert off[b + 1] - off[b] == -(-n // chunk)
        assert mine.sum() == n
        if n:
            assert starts[off[b]] == offsets[b]
            assert mine.max() - mine.min() <= 1
    np.testing.assert_array_equal(t.rows.numpy(), t.order.numpy() // 6)


def test_transpose_vals_follow_the_index():
    vals, cols, _, _ = _system(40, 5, 4, 9, seed=12, distinct=False)
    v = torch.from_numpy(vals)
    t = be.transpose_index(torch.from_numpy(cols), 9)
    vt = be.transpose_vals(v, t)
    assert vt.shape == (200, 4) and vt.is_contiguous()
    flat = vals.reshape(-1, 4)
    for i, slot in enumerate(t.order.tolist()):
        assert np.array_equal(vt[i].numpy(), flat[slot])
    A = linalg.BlockSparse(v, torch.from_numpy(cols), 9)
    assert A.vals_t is None                     # built on the card only
    A.rmv(torch.ones(40))
    assert A.vals_t is None
    assert torch.equal(A.transposed_vals(), vt)


@pytest.mark.parametrize("J,chunk", [(16, 8), (1, 3), (5, 64)])
def test_chunked_two_pass_sum_equals_plain_rmv(J, chunk):
    """The kernel's sum in plain PyTorch: per chunk, vals_t * r[rows] over
    its slots; per block, its chunks' partials in chunk order."""
    vals, cols, r = _skewed(90, 6, J, 15, seed=13)
    v, c, rt = (torch.from_numpy(a) for a in (vals, cols, r))
    t = be.transpose_index(c, 15, chunk=chunk)
    prod = be.transpose_vals(v, t) * rt[t.rows.long()][:, None]
    starts = t.chunk_start.tolist()
    partial = torch.stack([prod[a:b].sum(0) for a, b in
                           zip(starts[:-1], starts[1:])])
    off = t.chunk_off.tolist()
    out = torch.stack([partial[a:b].sum(0) if b > a else torch.zeros(J)
                       for a, b in zip(off[:-1], off[1:])]).reshape(-1)
    torch.testing.assert_close(out, be.block_ell_rmv_reference(v, c, rt, 15),
                               rtol=1e-5, atol=1e-5)
