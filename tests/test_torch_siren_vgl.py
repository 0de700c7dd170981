"""PyTorch port, the fused value+gradient+Laplacian module (`ops/siren_vgl.py`).

On the CPU `siren_vgl` runs its plain versions: the forward-Laplacian chain
and the hand-derived reverse sweep. They are held against the JAX kernels run
in interpret mode (`tools/experiments/pallas_vgl.py`, as its own tests run
them) at the JAX pins' shapes and tolerances
(`tools/experiments/test_pallas_vgl.py`):
  forward  u rtol 1e-5 atol 1e-5, J rtol 1e-5 atol 1e-4, L rtol 1e-4 atol 2e-3;
  backward gW, gb, gx rtol 1e-4 atol 5e-3;
  L-only   loss 1e-4 relative, gW, gb rtol 5e-3 atol 1e-3.
The CUDA kernels run only on the card: their cases are marked `cuda` and skip
here. Their source's logic (tiling, ragged last tile, per-block partials
across tiles, the fixed-order reduction) is also checked on the CPU: it is
compiled with the host C++ compiler against a small emulation of the CUDA
runtime (each block's threads are std::threads joined by a std::barrier)
and held against the plain versions."""

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
from insr_pde_tpu.ops import forward_laplacian as jfl
from insr_pde_tpu_torch.convert import params_from_jax
from insr_pde_tpu_torch.kernel_variants import VARIANTS
from insr_pde_tpu_torch.models.networks import MLP
from insr_pde_tpu_torch.ops import cuda_build
from insr_pde_tpu_torch.ops.forward_laplacian import value_grad_laplacian
from insr_pde_tpu_torch.ops.siren_forward import pack_params
from insr_pde_tpu_torch.ops.siren_vgl import (siren_vgl,
                                              siren_vgl_backward_reference,
                                              siren_vgl_reference)
from tools.experiments.pallas_vgl import (siren_vgl_bwd_interpret,
                                          siren_vgl_interpret)

torch.set_num_threads(1)

FWD_PINS = [  # (d, m, hidden layers, width, N)
    (2, 1, 3, 32, 300),    # the fluid pressure net
    (2, 2, 2, 16, 64),     # vector output
    (1, 1, 2, 20, 130),    # the 1D advection net
    (3, 2, 1, 24, 32),     # 3D input
]
BWD_PINS = FWD_PINS[:2]


def _case(d, m, layers, width, n, seed):
    jp = JMLP(in_features=d, out_features=m, num_hidden_layers=layers,
              hidden_features=width).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    tp = params_from_jax([(np.asarray(w), np.asarray(b)) for w, b in jp])
    return jp, tp, x


def _cotangents(n, d, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, m)).astype(np.float32),
            rng.normal(size=(n, d, m)).astype(np.float32),
            rng.normal(size=(n, m)).astype(np.float32))


def _leaves(params):
    return [t for wb in params for t in wb]


@pytest.mark.parametrize("pin", FWD_PINS)
def test_plain_forward_matches_pallas_interpret(pin):
    jp, tp, x = _case(*pin, seed=0)
    u, J, L = (a.numpy() for a in siren_vgl_reference(tp, torch.from_numpy(x)))
    ju, jJ, jL = (np.asarray(a) for a in
                  siren_vgl_interpret(jp, jnp.asarray(x)))
    d, m, n = pin[0], pin[1], pin[4]
    assert u.shape == (n, m) and J.shape == (n, d, m) and L.shape == (n, m)
    np.testing.assert_allclose(u, ju, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(J, jJ, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(L, jL, rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("pin", BWD_PINS)
def test_plain_backward_matches_pallas_interpret(pin):
    """Random cotangents on all three outputs: gW, gb and gx."""
    jp, tp, x = _case(*pin, seed=2)
    d, m, n = pin[0], pin[1], pin[4]
    gu, gJ, gL = _cotangents(n, d, m, seed=4)
    gp, gx = siren_vgl_backward_reference(
        tp, torch.from_numpy(x), *(torch.from_numpy(g) for g in (gu, gJ, gL)))
    jgp, jgx = siren_vgl_bwd_interpret(jp, jnp.asarray(x), jnp.asarray(gu),
                                       jnp.asarray(gJ), jnp.asarray(gL))
    for got, ref in zip(_leaves(gp) + [gx], _leaves(jgp) + [jgx]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=5e-3)


@pytest.mark.parametrize("pin", BWD_PINS)
def test_function_backward_matches_autograd_of_the_chain(pin):
    """The autograd.Function on CPU tensors (plain forward, hand-derived
    reverse sweep) gives the gradients that torch autograd of the chain
    gives, for params and coords."""
    _, tp, x = _case(*pin, seed=2)
    d, m, n = pin[0], pin[1], pin[4]
    cots = [torch.from_numpy(g) for g in _cotangents(n, d, m, seed=4)]

    def grads(fn):
        params = [(w.clone().requires_grad_(True), b.clone().requires_grad_(True))
                  for w, b in tp]
        xt = torch.from_numpy(x).requires_grad_(True)
        outs = fn(params, xt)
        leaves = _leaves(params) + [xt]
        return torch.autograd.grad(outs, leaves, cots)

    for got, ref in zip(grads(siren_vgl), grads(value_grad_laplacian)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=5e-3)


def test_laplacian_only_cotangent_matches_jax_grad():
    """The pressure-loss pattern: a loss of L alone, through MLP.
    value_grad_laplacian (autograd hands zero cotangents for u and J),
    against jax.grad of the XLA chain's loss."""
    jp, tp, x = _case(2, 1, 3, 32, 200, seed=5)
    target = np.sin(3.0 * x[:, 0]) * np.cos(2.0 * x[:, 1])

    def jloss(p):
        L = jfl.value_grad_laplacian(p, jnp.asarray(x))[2][:, 0]
        return jnp.mean((L - target) ** 2)

    jval, jg = jax.value_and_grad(jloss)(jp)
    params = [(w.requires_grad_(True), b.requires_grad_(True)) for w, b in tp]
    L = MLP(2, 1, 3, 32).value_grad_laplacian(params, torch.from_numpy(x))[2]
    loss = torch.mean((L[:, 0] - torch.from_numpy(target)) ** 2)
    loss.backward()
    assert abs(loss.item() - float(jval)) < 1e-4 * max(1.0, abs(float(jval)))
    # f32 accumulation-order noise through the w^3 Laplacian-cotangent terms
    # reaches ~0.2% on O(10^3)-magnitude entries (the JAX pin's note)
    for t, ref in zip(_leaves(params), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=5e-3, atol=1e-3)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    _, tp, x = _case(*FWD_PINS[0], seed=0)
    xt = torch.from_numpy(x)
    before = (siren_vgl.fwd_launches, siren_vgl.bwd_launches)
    params = [(w.clone().requires_grad_(True), b.clone().requires_grad_(True))
              for w, b in tp]
    out = siren_vgl(params, xt)
    for got, ref in zip(out, siren_vgl_reference(tp, xt)):
        np.testing.assert_array_equal(got.detach().numpy(), ref.numpy())
    sum(o.sum() for o in out).backward()
    assert all(t.grad is not None for t in _leaves(params))
    assert (siren_vgl.fwd_launches, siren_vgl.bwd_launches) == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, tp, x = _case(*FWD_PINS[0], seed=0)
    xt = torch.from_numpy(x)
    with pytest.raises(TypeError):
        siren_vgl(tp, xt.double())
    with pytest.raises(ValueError):
        siren_vgl(tp, xt.t())                            # not contiguous
    with pytest.raises(ValueError):
        siren_vgl(tp, xt[:, :1].contiguous())            # in_dim mismatch
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="128"):
        siren_vgl(MLP(2, 1, 1, 129).init(g), xt)
    with pytest.raises(ValueError, match="input dims"):
        siren_vgl(MLP(4, 1, 1, 8).init(g), torch.zeros((5, 4)))
    with pytest.raises(ValueError):
        siren_vgl([], xt)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FWD_PINS + [(2, 1, 3, 32, 16384),
                                              (2, 1, 3, 128, 4099)])
def test_kernels_match_plain_versions_on_card(cuda_device, shape):
    d, m, layers, width, n = shape
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = MLP(d, m, layers, width).init(g)
    x = torch.rand((n, d), generator=g, device=cuda_device) * 2 - 1
    cots = [torch.randn(s, generator=g, device=cuda_device)
            for s in ((n, m), (n, d, m), (n, m))]
    leaves = [t.clone().requires_grad_(True) for t in _leaves(params)]
    xt = x.clone().requires_grad_(True)
    before = (siren_vgl.fwd_launches, siren_vgl.bwd_launches)
    outs = siren_vgl([(leaves[i], leaves[i + 1])
                      for i in range(0, len(leaves), 2)], xt)
    torch.autograd.backward(outs, cots)
    torch.cuda.synchronize()
    assert (siren_vgl.fwd_launches, siren_vgl.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    for got, ref, rtol, atol in zip(outs, siren_vgl_reference(params, x),
                                    (1e-5, 1e-5, 1e-4), (1e-5, 1e-4, 2e-3)):
        torch.testing.assert_close(got.detach(), ref, rtol=rtol, atol=atol)
    gp, gx = siren_vgl_backward_reference(params, x, *cots)
    for got, ref in zip(leaves + [xt], _leaves(gp) + [gx]):
        torch.testing.assert_close(got.grad, ref, rtol=1e-4, atol=5e-3)


# The CUDA runtime as far as csrc/siren_vgl.cu uses it, on the host: a
# launch runs the grid's blocks one after another, each block's threads at
# once, with a block barrier and a barrier per warp (the shuffles exchange
# through a per-block buffer between two of its waits). Shared memory
# starts as NaN in every block, so a read before a write shows.
_EMULATION_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __launch_bounds__(...)
#define __restrict__
struct float4 { float x, y, z, w; };
struct uint3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local uint3_ threadIdx, blockIdx;
inline uint3_ gridDim, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct EmuBlock {
    std::barrier<> bar;
    std::vector<float4> smem;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    std::vector<float> lanes;
    EmuBlock(unsigned threads, size_t n) : bar(threads),
        smem(n, float4{NAN, NAN, NAN, NAN}), lanes(threads, NAN) {
        for (unsigned w = 0; w * 32 < threads; ++w)
            warps.emplace_back(new std::barrier<>(std::min(32u, threads - 32 * w)));
    }
};
inline EmuBlock* emu_block = nullptr;
#define smem4 (emu_block->smem.data())
inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
    EmuBlock& b = *emu_block;
    std::barrier<>& w = *b.warps[threadIdx.x / 32];
    b.lanes[threadIdx.x] = v;
    w.arrive_and_wait();
    const float r = b.lanes[threadIdx.x ^ off];
    w.arrive_and_wait();
    return r;
}
template <typename T> inline T __ldg(const T* p) { return *p; }
template <typename K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline void sincosf(float x, float* s, float* c) { *s = std::sin(x); *c = std::cos(x); }
template <typename K, typename... A>
void emu_launch(K kernel, unsigned grid, unsigned threads, size_t smem, A... args) {
    gridDim.x = grid;
    blockDim.x = threads;
    for (unsigned b = 0; b < grid; ++b) {
        EmuBlock block(threads, smem / sizeof(float4) + 1);
        emu_block = &block;
        std::vector<std::thread> team;
        for (unsigned t = 0; t < threads; ++t)
            team.emplace_back([=]() { threadIdx.x = t; blockIdx.x = b; kernel(args...); });
        for (auto& th : team) th.join();
    }
}
"""


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    """csrc/siren_vgl.cu built for the host. The backward's grid is capped
    at 2 blocks, so that a block sums the partials of several tiles."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the CUDA source for the host")
    src = (cuda_build.CSRC / "siren_vgl.cu").read_text()
    src = src.replace("extern __shared__ float4 smem4[];", "")
    src = src.replace("BWD_GRID_MIN = 256", "BWD_GRID_MIN = 2")
    src = src.replace("PARTIAL_FLOATS = 1 << 21", "PARTIAL_FLOATS = 0")
    src = re.sub(r"(\w+(?:<\w+>)?)<<<([^,]+),([^,]+),([^,]+),[^>]+>>>\(",
                 r"emu_launch(\1, \2, \3, \4, ", src)
    out = tmp_path_factory.mktemp("emu")
    (out / "cuda_runtime.h").write_text(_EMULATION_H)
    (out / "siren_vgl.cpp").write_text(src)
    lib = out / "libsiren_vgl_emu.so"
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared",
                           f"-I{out}", "-o", str(lib), str(out / "siren_vgl.cpp"),
                           "-lpthread"], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("shape", [(2, 1, 3, 32, 300), (3, 2, 1, 24, 32),
                                   (1, 1, 2, 20, 70), (2, 1, 2, 128, 21),
                                   (1, 1, 3, 32, 45), (3, 1, 2, 32, 77)])
def test_cuda_source_matches_plain_versions_in_host_emulation(
        emulated_library, shape):
    """The kernels' code, run by host threads: forward at the pins'
    forward tolerances; backward with random cotangents at the backward's
    and with the L-only cotangents of the pressure loss at theirs. N is no
    multiple of the tile (32 rows at width 32 and d <= 2, 16 at d = 3, 8 at
    width 128); a second backward gives the same bits."""
    d, m, layers, width, n = shape
    lib = emulated_library
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.siren_vgl_backward_blocks.argtypes = [i, i, i, ctypes.c_void_p]
    lib.siren_vgl_forward_f32.argtypes = [p] * 5 + [i, i, i, p,
                                                    ctypes.c_float, p]
    lib.siren_vgl_backward_f32.argtypes = [p] * 8 + [i, i, i, p,
                                                     ctypes.c_float, p]
    g = torch.Generator().manual_seed(3)
    params = MLP(d, m, layers, width).init(g)
    x = torch.rand((n, d), generator=g) * 2 - 1
    packed, widths = pack_params(params)
    c_widths = (ctypes.c_int * len(widths))(*widths)
    outs = [torch.full(s, float("nan")) for s in ((n, m), (n, d, m), (n, m))]
    assert lib.siren_vgl_forward_f32(
        x.data_ptr(), packed.data_ptr(), *(o.data_ptr() for o in outs), n, d,
        layers + 2, c_widths, 30.0, None) == 0
    ref = siren_vgl_reference(params, x)
    for got, r, rtol, atol in zip(outs, ref, (1e-5, 1e-5, 1e-4),
                                  (1e-5, 1e-4, 2e-3)):
        torch.testing.assert_close(got, r, rtol=rtol, atol=atol)

    blocks = lib.siren_vgl_backward_blocks(n, d, layers + 2, c_widths)
    assert blocks in (1, 2)

    def backward(cots):
        scratch = torch.full((blocks, packed.numel()), float("nan"))
        gp = torch.full_like(packed, float("nan"))
        gx = torch.full_like(x, float("nan"))
        assert lib.siren_vgl_backward_f32(
            x.data_ptr(), packed.data_ptr(), *(c.data_ptr() for c in cots),
            scratch.data_ptr(), gp.data_ptr(), gx.data_ptr(), n, d,
            layers + 2, c_widths, 30.0, None) == 0
        return gp, gx

    target = torch.sin(3.0 * x[:, :1]) * torch.cos(2.0 * x[:, -1:])
    kinds = [([torch.randn(o.shape, generator=g) for o in outs], (1e-4, 5e-3)),
             ([torch.zeros_like(outs[0]), torch.zeros_like(outs[1]),
               2.0 * (ref[2] - target) / n], (5e-3, 1e-3))]
    for cots, (rtol, atol) in kinds:
        gp, gx = backward(cots)
        g_ref, gx_ref = siren_vgl_backward_reference(params, x, *cots)
        torch.testing.assert_close(gp, torch.cat([t.reshape(-1) for t in
                                                  _leaves(g_ref)]),
                                   rtol=rtol, atol=atol)
        torch.testing.assert_close(gx, gx_ref, rtol=rtol, atol=atol)
    again = backward(cots)
    assert torch.equal(again[0], gp) and torch.equal(again[1], gx)


def test_phase_probe_stamps_the_backward():
    """`kernel_phases` finds the backward's `// phase:` marks (recompute,
    the layer inputs, the weight gradients, G W^T with the reverse rules)
    and puts its prelude after the source's include."""
    from insr_pde_tpu_torch import kernel_phases
    text = (cuda_build.CSRC / "siren_vgl.cu").read_text()
    stamped, names = kernel_phases.stamped_source(text)
    assert names == ["recompute", "inputs", "wgrad", "gwt"]
    assert stamped.count("PHASE_SETUP();") == stamped.count("PHASE_END();") == 1
    assert stamped.index("#include <cuda_runtime.h>") \
        < stamped.index("__device__ long long g_phase_acc")
    assert "SMEM_LIMIT = 232448 - 256;" in stamped


@pytest.mark.parametrize("kernel,name", [
    (k, n) for k, vs in sorted(VARIANTS.items()) for n in sorted(vs)])
def test_kernel_variants_apply_to_the_committed_sources(kernel, name):
    """Every measured design of `kernel_variants` still patches its
    committed source (each replacement exactly once), and a variant of a
    source with phase marks keeps them for the probe."""
    from insr_pde_tpu_torch import kernel_phases, kernel_variants
    text = (cuda_build.CSRC / f"{kernel}.cu").read_text()
    out = kernel_variants.patched(kernel, name, text)
    assert out != text
    for _, new in kernel_variants.VARIANTS[kernel][name]:
        assert new in out
    if "// phase: setup" in text:
        assert kernel_phases.stamped_source(out)[1] \
            == kernel_phases.stamped_source(text)[1]
    with pytest.raises(ValueError, match="occurs 0 times"):
        kernel_variants.patched(kernel, name, "int main() {}\n")
