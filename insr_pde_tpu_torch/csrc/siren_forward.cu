// Fused SIREN forward for Hopper (sm_90a), f32 throughout.
//
// Replaces the TPU kernel `_siren_kernel` of insr_pde_tpu/ops/pallas_siren.py
// (launched by `_forward_pallas`): h <- sin(30 (h W_i + b_i)) through the
// hidden layers and a linear last layer, with the whole layer chain kept on
// chip so that device memory sees the coords, the weights and the output
// only.
//
// What bounds it on this card: arithmetic, not bytes. The fluid net
// 2->32->32->32->32->2 reads 8 bytes and writes 8 bytes per point but does
// 3,200 multiply-adds and 128 precise sinf per point; at 16,384 points (the
// -vr 128 output grid) the call is a few microseconds of the FP32 pipe, so
// the latency of the layer chain on the few rows each SM gets sets its time.
// At width 128 (5 hidden layers) the multiply-adds dominate.
//
// The layer engine is csrc/sine_mlp_tile.cuh (shared with the vgl forward)
// at one channel: all layers' weights staged once per block by cp.async (a
// two-layer ring at width 128), R rows x 8 columns a thread, one activation
// buffer, a row plan by the SM count, the last layer spread over the block.
// R = 8 rows a thread (8 activation floats and 2 weight float4 loads feed 64
// fmas) at one block per SM, as at width 128 (128-row tiles); R = 1 at two
// blocks per SM where that keeps more threads busy, as on the 16,384-point
// grid of the fluid net (63-row tiles: a thread per row and column group;
// R = 8 there would keep 2 warps an SM busy, 2.8x slower).

#include <cuda_runtime.h>

#include "sine_mlp_tile.cuh"

namespace {

using sine_mlp::Plan;

template <int R>
__global__ void __launch_bounds__(sine_mlp::THREADS, sine_mlp::blocks_per_sm(R))
siren_forward_kernel(const float* __restrict__ coords,
                     const float* __restrict__ packed, float* __restrict__ out,
                     int n_rows, Plan plan, float omega) {
    sine_mlp::forward_tiles<0, R>(coords, packed, out, nullptr, nullptr, n_rows,
                                  plan, omega);
}

template <int R>
cudaError_t launch(const float* coords, const float* packed, float* out,
                   int n_rows, const Plan& plan, size_t smem, int sms,
                   float omega, cudaStream_t stream) {
    static sine_mlp::LaunchCache cache;
    return sine_mlp::launch_tiles(siren_forward_kernel<R>, plan, smem, sms, cache,
                                  stream, coords, packed, out, n_rows, plan, omega);
}

}  // namespace

// coords (n_rows, widths[0]) f32 row-major; packed = [W_0 (row-major), b_0,
// W_1, b_1, ...] f32; out (n_rows, widths[n_layers]) f32. widths has
// n_layers + 1 entries. Launches on `stream`, allocates nothing, and returns
// the cudaError_t of the launch (0 on success).
extern "C" int siren_forward_f32(const float* coords, const float* packed,
                                 float* out, int n_rows, int n_layers,
                                 const int* widths, float omega, void* stream) {
    Plan plan;
    cudaError_t err = sine_mlp::plan_layers(n_layers, widths, plan);
    if (err != cudaSuccess || n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n_rows == 0) return 0;
    int sms = 0;
    err = sine_mlp::sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    int R = 0;
    const size_t smem = sine_mlp::choose_plan(plan, 1, 8, n_rows, sms, &R);
    if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = R == 1 ? launch<1>(coords, packed, out, n_rows, plan, smem, sms, omega, s)
                 : launch<8>(coords, packed, out, n_rows, plan, smem, sms, omega, s);
    return static_cast<int>(err);
}
