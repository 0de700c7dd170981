// Fused SIREN forward for Hopper (sm_90a), f32 throughout.
//
// Replaces the TPU kernel `_siren_kernel` of insr_pde_tpu/ops/pallas_siren.py
// (launched by `_forward_pallas`): h <- sin(30 (h W_i + b_i)) through the
// hidden layers and a linear last layer, with the whole layer chain kept on
// chip so that device memory sees the coords and the output only.
//
// What bounds it on this card: arithmetic, not bytes. The fluid net
// 2->32->32->32->32->2 reads 8 bytes and writes 8 bytes per point but does
// 6,400 FLOP of multiply-adds and 128 precise sinf per point; at 16,384
// points (the -vr 128 output grid) the whole call is ~0.1 GFLOP and the
// launch itself dominates.
//
// Design, and what it does about that:
//   * A block owns ROWS rows (points); TEAM threads share a row, each
//     computing every TEAM-th group of CG output columns. One thread per
//     row left only 4 warps per SM at the 16,384-point output grid (128
//     blocks on 132 SMs), and the kernel ran at the latency of one thread's
//     serial chain; TEAM = 4 gives 4x the warps and a quarter of the chain.
//   * The block's activations live in shared memory, column-major
//     (act[col][row]): the 32 threads of a warp share a column group and
//     take 32 neighbouring rows, so they touch 32 neighbouring banks.
//   * Each layer's W and b are staged in shared memory one layer at a time
//     (five 128x128 f32 layers would exceed the 227 KB a block can hold),
//     zero-padded to a multiple of CG columns. Every thread of a warp reads
//     the same weight word, a broadcast, as float4.
//   * A thread computes CG output columns at once in registers: per input
//     feature, one activation load and two float4 weight loads feed CG fmas.
//   * No tensor cores: the TPU kernel pins Precision.HIGHEST, so products
//     stay f32 (fmaf). Precise sinf, never __sinf and never fast-math: the
//     argument 30 z lies far outside [-pi, pi], where the intrinsic loses
//     the digits the 2e-5 pins need.
//   * Any N (the last tile is masked), any in/out width up to MAX_WIDTH,
//     up to MAX_LAYERS layers. wgmma/TMA are left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;         // rows per block
constexpr int TEAM = 4;          // threads per row
constexpr int THREADS = ROWS * TEAM;
constexpr int CG = 8;            // output columns per register group
constexpr int MAX_WIDTH = 128;   // widest layer (as the TPU kernel's 128 lanes)
constexpr int MAX_LAYERS = 32;

struct SirenDims {
    int n_layers;
    int width[MAX_LAYERS + 1];   // width[0] = in_dim, width[l + 1] = out of layer l
    int offset[MAX_LAYERS];      // W_l at packed + offset[l] (row-major in x out), b_l after it
};

__host__ __device__ inline int pad_cols(int n) { return (n + CG - 1) / CG * CG; }

__global__ void __launch_bounds__(THREADS)
siren_forward_kernel(const float* __restrict__ coords,
                     const float* __restrict__ packed,
                     float* __restrict__ out, int n_rows, SirenDims dims,
                     int act_width, float omega) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* h_in = smem;                                // [act_width][ROWS]
    float* h_out = smem + act_width * ROWS;            // [act_width][ROWS]
    float* w_s = smem + 2 * act_width * ROWS;          // [fin][fpad], then b [fpad]

    const int tid = threadIdx.x;
    const int r = tid % ROWS;            // this thread's row in the block
    const int team = tid / ROWS;         // which column groups it computes
    const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
    const long long row = row0 + r;
    const bool valid = row < n_rows;

    const int in_dim = dims.width[0];
    for (int i = tid; i < ROWS * in_dim; i += THREADS) {   // coalesced
        const int ri = i / in_dim;
        const int k = i - ri * in_dim;
        h_in[k * ROWS + ri] = row0 + ri < n_rows ? coords[row0 * in_dim + i] : 0.0f;
    }

    for (int l = 0; l < dims.n_layers; ++l) {
        const int fin = dims.width[l];
        const int fout = dims.width[l + 1];
        const int fpad = pad_cols(fout);
        const float* W = packed + dims.offset[l];
        const float* b = W + fin * fout;
        float* b_s = w_s + fin * fpad;
        const bool last = l == dims.n_layers - 1;

        // every thread is done with the previous layer (its W and its reads
        // of h_in) and has written its part of this layer's input
        __syncthreads();
        for (int i = tid; i < fin * fpad; i += THREADS) {
            const int k = i / fpad;
            const int c = i - k * fpad;
            w_s[i] = c < fout ? W[k * fout + c] : 0.0f;
        }
        for (int c = tid; c < fpad; c += THREADS)
            b_s[c] = c < fout ? b[c] : 0.0f;
        __syncthreads();

        for (int c0 = team * CG; c0 < fpad; c0 += TEAM * CG) {
            float acc[CG];
#pragma unroll
            for (int j = 0; j < CG; ++j) acc[j] = 0.0f;
            for (int k = 0; k < fin; ++k) {
                const float hk = h_in[k * ROWS + r];
                const float4 wa = *reinterpret_cast<const float4*>(w_s + k * fpad + c0);
                const float4 wb = *reinterpret_cast<const float4*>(w_s + k * fpad + c0 + 4);
                acc[0] = fmaf(hk, wa.x, acc[0]);
                acc[1] = fmaf(hk, wa.y, acc[1]);
                acc[2] = fmaf(hk, wa.z, acc[2]);
                acc[3] = fmaf(hk, wa.w, acc[3]);
                acc[4] = fmaf(hk, wb.x, acc[4]);
                acc[5] = fmaf(hk, wb.y, acc[5]);
                acc[6] = fmaf(hk, wb.z, acc[6]);
                acc[7] = fmaf(hk, wb.w, acc[7]);
            }
            if (!last) {
#pragma unroll
                for (int j = 0; j < CG; ++j)
                    h_out[(c0 + j) * ROWS + r] = sinf(omega * (acc[j] + b_s[c0 + j]));
            } else if (valid) {
#pragma unroll
                for (int j = 0; j < CG; ++j)
                    if (c0 + j < fout) out[row * fout + c0 + j] = acc[j] + b_s[c0 + j];
            }
        }
        float* t = h_in;
        h_in = h_out;
        h_out = t;
    }
}

// The most dynamic shared memory any call can ask for: two activation
// buffers and one padded layer at MAX_WIDTH.
constexpr int MAX_SMEM_BYTES =
    (2 * MAX_WIDTH * ROWS + MAX_WIDTH * MAX_WIDTH + MAX_WIDTH) * sizeof(float);

// Raise the kernel's dynamic shared-memory limit once per device, at the
// first call, so that later calls (and CUDA graph captures) make no
// attribute call.
cudaError_t allow_max_smem() {
    constexpr int MAX_DEVICES = 64;
    static bool done[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(siren_forward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM_BYTES);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
    return err;
}

}  // namespace

// coords (n_rows, widths[0]) f32 row-major; packed = [W_0 (row-major), b_0,
// W_1, b_1, ...] f32; out (n_rows, widths[n_layers]) f32. widths has
// n_layers + 1 entries. Launches on `stream`, allocates nothing, and returns
// the cudaError_t of the launch (0 on success).
extern "C" int siren_forward_f32(const float* coords, const float* packed,
                                 float* out, int n_rows, int n_layers,
                                 const int* widths, float omega, void* stream) {
    if (n_layers < 1 || n_layers > MAX_LAYERS || n_rows < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    SirenDims dims;
    dims.n_layers = n_layers;
    int act_width = pad_cols(widths[0]);
    int w_floats = 0;
    int offset = 0;
    for (int l = 0; l <= n_layers; ++l) {
        if (widths[l] < 1 || widths[l] > MAX_WIDTH)
            return static_cast<int>(cudaErrorInvalidValue);
        dims.width[l] = widths[l];
    }
    for (int l = 0; l < n_layers; ++l) {
        const int fin = widths[l];
        const int fout = widths[l + 1];
        dims.offset[l] = offset;
        offset += fin * fout + fout;
        act_width = act_width > pad_cols(fout) ? act_width : pad_cols(fout);
        const int wl = fin * pad_cols(fout) + pad_cols(fout);
        w_floats = w_floats > wl ? w_floats : wl;
    }
    if (n_rows == 0) return 0;
    const size_t smem = (2 * static_cast<size_t>(act_width) * ROWS + w_floats) * sizeof(float);
    const cudaError_t err = allow_max_smem();
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((n_rows + ROWS - 1) / ROWS);
    siren_forward_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        coords, packed, out, n_rows, dims, act_width, omega);
    return static_cast<int>(cudaGetLastError());
}
