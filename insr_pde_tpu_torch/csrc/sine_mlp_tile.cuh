// The forward of a sine MLP over a tile of rows, for Hopper (sm_90a), f32:
// one engine for the fused SIREN forward (csrc/siren_forward.cu, one channel)
// and the value + Jacobian + Laplacian forward (csrc/siren_vgl.cu, d + 2
// channels: h, J_0..J_{d-1}, L). Per layer and row
//     z = h W + b,  Jz_a = J_a W,  Lz = L W
// and through the hidden layers h' = sin(w z); the vgl forward also carries
//     J'_a = w cos(w z) Jz_a,  L' = w cos(w z) Lz - w^2 sin(w z) sum_a Jz_a^2.
// The last layer is linear.
//
// What bounds it on this card: the FP32 pipe. The pressure net
// 2-32-32-32-32-1 takes 4 x 3,168 = 12,672 multiply-adds and 128 precise
// sincosf per row against 20 bytes of coords and outputs, so a block's time is
// the issue slots its multiply-adds, shared-memory loads and sines take, and
// the latency of the layer chain where too few warps share an SM.
//
// Design, and what it does about that:
//   * Every layer's W and b (padded to a multiple of 8 columns; the bias is
//     row fin of the staged layer, as it follows W in the packed layout) are
//     brought into shared memory once per block by cp.async, overlapped with
//     the first tile's inputs, before any layer runs. Where they do not fit
//     beside the activations (width 128), two layer buffers form a ring:
//     layer l + 2 is copied while layer l + 1 computes. 16-byte copies where a
//     layer's rows are 16-byte aligned in the packed buffer, 4-byte copies
//     else (the pressure net's last layer is 33 floats); padding columns are
//     stored zeros.
//   * A thread owns R rows x 8 columns of a hidden layer for every channel:
//     per input column k, R x C activation floats (R-wide vector loads, the
//     rows of a column being contiguous) and two float4 weight loads feed
//     R x C x 8 fmas. A warp takes 8 neighbouring row groups of 4
//     neighbouring column groups (WarpShape), so that its activation loads
//     are 8 distinct vectors and its weight loads 4 distinct float4s: one
//     shared-memory wavefront each at R <= 2. The row stride spreads the
//     warp's stores over the banks.
//   * One column group per thread: every output of a hidden layer stays in
//     registers until the layer's products are done, so one activation
//     buffer serves as input and output (a barrier between the reads and the
//     writes), which leaves room for more rows a tile.
//   * The row plan follows the SM count: a tile holds the rows that spread
//     the call evenly over the SMs' blocks, up to what the warps and the
//     shared memory hold, and a persistent grid of at most one wave walks
//     the tiles (weights staged once per block where they stay resident).
//     Of two plans, the one that keeps more threads of an SM busy: R = 8
//     (SIREN) or 2 (vgl) rows a thread at one block per SM, or R = 1 at two
//     blocks per SM. The 32-wide nets on 16,384 rows take R = 1 (63-row
//     tiles, 504 busy threads an SM); the wide R would leave 64 (SIREN) or
//     252 (vgl) busy and take 0.0384 against 0.0136 ms (SIREN, its sines
//     then run on 2 warps) and 0.0252 against 0.0229 ms (vgl) on an H100
//     80GB HBM3 at 700 W (`kernel_phases --variant wide_r`). Width 128 has
//     no R = 1 plan: its two-layer ring does not fit two blocks an SM.
//   * The linear last layer (m = 1 or 2 outputs, usually) is spread over the
//     whole block: one thread per (channel, row, output).
//   * Each output's sum runs k = 0..fin-1 by fmaf from 0, then the bias, as
//     in the first design, so the results are the same bits.
//   * No tensor cores: the TPU kernels pin Precision.HIGHEST, so products
//     stay f32 (fmaf). Precise sinf/sincosf, never the intrinsics and never
//     fast-math: w z lies far outside [-pi, pi], and L carries w^2 factors.
// `// phase[fwd]:` comments mark where the time is split (`python -m
// insr_pde_tpu_torch.kernel_phases siren_forward|siren_vgl_forward`).

#pragma once

#include <cuda_runtime.h>

namespace sine_mlp {
namespace {  // internal linkage: each library that includes this keeps its own

constexpr int THREADS = 256;
constexpr int CG = 8;                 // columns of a hidden layer per thread
constexpr int MAX_WIDTH = 128;        // widest layer (as the TPU kernels' 128 lanes)
constexpr int MAX_LAYERS = 32;
constexpr int SMEM_LIMIT = 232448;    // 227 KB of dynamic shared memory per block
constexpr int SM_SMEM = 233472;       // 228 KB of shared memory per SM
constexpr int BLOCK_RESERVED = 1024;  // the runtime's shared memory per block

__host__ __device__ inline int pad_cols(int n) { return (n + CG - 1) / CG * CG; }

struct Plan {
    int n_layers;
    int width[MAX_LAYERS + 1];    // width[0] = in, width[l + 1] = out of layer l
    int offset[MAX_LAYERS];       // W_l at packed + offset[l] (fin x fout), b_l after it
    int w_off[MAX_LAYERS];        // resident: staged layer l at weights + w_off[l]
    int resident;                 // floats of every staged layer
    int w_stage;                  // floats of the largest staged layer
    int ring;                     // 1: two buffers of w_stage floats, not resident
    int act_width;                // widest padded layer, the inputs included
    int rows;                     // rows per tile, a multiple of R
    int rs;                       // row stride of the activations
    int n_tiles;
};

// How a hidden layer's (row group, column group) items map onto the warps:
// a warp takes wr neighbouring row groups of wc neighbouring column groups
// (wc = 4 where the layer has 4 or more), so that a warp's activation
// loads are wr distinct vectors (broadcast to its wc column groups) and its
// weight loads wc distinct float4s; warp w takes row block w % n_rb of
// column block w / n_rb.
struct WarpShape {
    int n_rg, n_cg, wc, wr, n_rb, n_cb;
    __host__ __device__ WarpShape(int row_groups, int col_groups)
        : n_rg(row_groups), n_cg(col_groups),
          wc(col_groups >= 4 ? 4 : col_groups >= 2 ? 2 : 1), wr(32 / wc),
          n_rb((row_groups + wr - 1) / wr), n_cb((col_groups + wc - 1) / wc) {}
};

// R rows a thread: 1 runs two blocks per SM (registers capped at 128).
__host__ __device__ constexpr int blocks_per_sm(int R) { return R == 1 ? 2 : 1; }

// async copy primitives {
__device__ inline unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void async_copy4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// 16 bytes; both addresses 16-byte aligned
__device__ inline void async_copy16(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ inline void async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ inline void async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}
// } async copy primitives

// Issue the copies of layer l (fin + 1 rows of fout floats: W, then b) into
// w (fin + 1 rows of pad_cols(fout)), and zero the padding columns.
__device__ inline void stage_layer_async(const float* __restrict__ packed,
                                         const Plan& plan, int l, float* w) {
    const float* src = packed + plan.offset[l];
    const int fin = plan.width[l];
    const int fout = plan.width[l + 1];
    const int fpad = pad_cols(fout);
    const int n_rows = fin + 1;
    if ((fout & 3) == 0 && (reinterpret_cast<unsigned long long>(src) & 15) == 0) {
        const int q = fout / 4;
        for (int i = threadIdx.x; i < n_rows * q; i += THREADS) {
            const int k = i / q;
            const int c = 4 * (i - k * q);
            async_copy16(w + k * fpad + c, src + k * fout + c);
        }
    } else {
        for (int i = threadIdx.x; i < n_rows * fout; i += THREADS) {
            const int k = i / fout;
            const int c = i - k * fout;
            async_copy4(w + k * fpad + c, src + k * fout + c);
        }
    }
    const int tail = fpad - fout;
    for (int i = threadIdx.x; i < n_rows * tail; i += THREADS) {
        const int k = i / tail;
        w[k * fpad + fout + (i - k * tail)] = 0.0f;
    }
}

// The chain's start for the tile's rows: h = x, J_a = e_a, L = 0 (rows
// past the end read x = 0). ASYNC: the coords by cp.async (the caller
// commits and waits), else by plain loads.
template <int D>
__device__ inline void load_inputs(const float* __restrict__ coords, float* act,
                                   int aw, int rs, int d_in, long long row0,
                                   int n_rows, int rows, bool async) {
    constexpr int C = D == 0 ? 1 : D + 2;
    for (int i = threadIdx.x; i < rows * d_in; i += THREADS) {
        const int ri = i / d_in;
        const int k = i - ri * d_in;
        float* dst = act + k * rs + ri;
        if (row0 + ri >= n_rows) *dst = 0.0f;
        else if (async) async_copy4(dst, coords + row0 * d_in + i);
        else *dst = coords[row0 * d_in + i];
        if constexpr (D > 0) {
#pragma unroll
            for (int a = 0; a < D; ++a)
                act[((1 + a) * aw + k) * rs + ri] = a == k ? 1.0f : 0.0f;
            act[((C - 1) * aw + k) * rs + ri] = 0.0f;
        }
    }
}

// R neighbouring floats of one activation column (R-aligned).
template <int R>
__device__ inline void load_rows(const float* p, float (&v)[R]) {
    if constexpr (R % 4 == 0) {
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
            const float4 t = reinterpret_cast<const float4*>(p)[q];
            v[4 * q] = t.x;
            v[4 * q + 1] = t.y;
            v[4 * q + 2] = t.z;
            v[4 * q + 3] = t.w;
        }
    } else if constexpr (R == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        v[0] = t.x;
        v[1] = t.y;
    } else {
#pragma unroll
        for (int i = 0; i < R; ++i) v[i] = p[i];
    }
}

template <int R>
__device__ inline void store_rows(float* p, const float (&v)[R]) {
    if constexpr (R % 4 == 0) {
#pragma unroll
        for (int q = 0; q < R / 4; ++q)
            reinterpret_cast<float4*>(p)[q] =
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else if constexpr (R == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
        for (int i = 0; i < R; ++i) p[i] = v[i];
    }
}

// A hidden unit's rules, in place in acc[c][i][j] (channel c), from its
// sums: h' = sin(w z), z = h W + b; and for D >= 1 J'_a = w cos(w z) Jz_a,
// L' = w cos(w z) Lz - w^2 sin(w z) sum_a Jz_a^2.
template <int D, int R, int N>
__device__ __forceinline__ void unit_rules(float (&acc)[D == 0 ? 1 : D + 2][R][N], int i,
                                           int j, float bias, float omega) {
    constexpr int C = D == 0 ? 1 : D + 2;
    const float z = acc[0][i][j] + bias;
    if constexpr (D == 0) {
        acc[0][i][j] = sinf(omega * z);
    } else {
        const float w2 = omega * omega;
        float s, c;
        sincosf(omega * z, &s, &c);
        const float wc = omega * c;
        float q = 0.0f;
#pragma unroll
        for (int a = 0; a < D; ++a) q = fmaf(acc[1 + a][i][j], acc[1 + a][i][j], q);
        acc[0][i][j] = s;
#pragma unroll
        for (int a = 0; a < D; ++a) acc[1 + a][i][j] = wc * acc[1 + a][i][j];
        acc[C - 1][i][j] = wc * acc[C - 1][i][j] - w2 * s * q;
    }
}

// The forward of a tile walk. D = 0: the SIREN forward, one channel (h),
// out0 (n_rows, m). D >= 1: the vgl forward of d = D inputs, channels h,
// J_0..J_{D-1}, L; out0 = u (n_rows, m), out_j = J (n_rows, D, m), out_l =
// L (n_rows, m). Called by a __global__ kernel of THREADS threads with the
// dynamic shared memory that plan_rows returned for the plan.
template <int D, int R>
__device__ __forceinline__ void forward_tiles(const float* __restrict__ coords,
                                              const float* __restrict__ packed,
                                              float* __restrict__ out0,
                                              float* __restrict__ out_j,
                                              float* __restrict__ out_l,
                                              int n_rows, const Plan& plan,
                                              float omega) {
    constexpr int C = D == 0 ? 1 : D + 2;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int aw = plan.act_width;
    const int rs = plan.rs;
    const int rows = plan.rows;
    const int n_layers = plan.n_layers;
    const int d_in = plan.width[0];
    const int m = plan.width[n_layers];
    float* act = smem;                          // (channel, column, row)
    float* weights = smem + C * aw * rs;
    const int tid = threadIdx.x;
    // layer steps this block computes (ring: step s computes layer
    // s % n_layers from buffer s % 2, then stages step s + 2's layer there)
    const int my_tiles = (plan.n_tiles - static_cast<int>(blockIdx.x) +
                          static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x);
    const int n_steps = my_tiles * n_layers;
    // phase[fwd]: setup

    // the first tile's coords with layer 0 as one copy group, then
    // (resident) the other layers or (ring) step 1 as another
    load_inputs<D>(coords, act, aw, rs, d_in, static_cast<long long>(blockIdx.x) * rows,
                   n_rows, rows, true);
    if (plan.ring) {
        for (int s = 0; s < 2; ++s) {
            if (s < n_steps)
                stage_layer_async(packed, plan, s % n_layers, weights + s * plan.w_stage);
            async_commit();
        }
    } else {
        for (int l = 0; l < n_layers; ++l) {
            stage_layer_async(packed, plan, l, weights + plan.w_off[l]);
            if (l == 0) async_commit();
        }
        async_commit();
    }
    // phase[fwd]: issue

    int step = 0;
    for (int tile = blockIdx.x; tile < plan.n_tiles; tile += gridDim.x) {
        const long long row0 = static_cast<long long>(tile) * rows;
        // later tiles: the previous tile's last layer has read `act`
        // (barrier at its end)
        if (step > 0)
            load_inputs<D>(coords, act, aw, rs, d_in, row0, n_rows, rows, false);
        // phase[fwd]: inputs

        for (int l = 0; l < n_layers; ++l, ++step) {
            const int fin = plan.width[l];
            const int fout = plan.width[l + 1];
            const int fpad = pad_cols(fout);
            const float* w = plan.ring ? weights + (step & 1) * plan.w_stage
                                       : weights + plan.w_off[l];
            const float* b = w + fin * fpad;
            if (plan.ring || step == 0) async_wait<1>();
            else async_wait<0>();
            // this layer's weights and inputs are in place
            __syncthreads();
            // phase[fwd]: staging

            if (l < n_layers - 1) {
                // thread tid: rows r0..r0+R-1, columns c0..c0+7, in a warp
                // of wr row groups x wc column groups
                const WarpShape ws(rows / R, fpad / CG);
                const int warp = tid / 32;
                const int lane = tid % 32;
                const int rg = warp % ws.n_rb * ws.wr + lane % ws.wr;
                const int cg = warp / ws.n_rb * ws.wc + lane / ws.wr;
                const int r0 = rg * R;
                const int c0 = cg * CG;
                const bool busy = rg < ws.n_rg && cg < ws.n_cg;
                float acc[C][R][CG];
#pragma unroll
                for (int c = 0; c < C; ++c)
#pragma unroll
                    for (int i = 0; i < R; ++i)
#pragma unroll
                        for (int j = 0; j < CG; ++j) acc[c][i][j] = 0.0f;
                if (busy) {
                    const float* wk = w + c0;
                    const float* ak = act + r0;
#pragma unroll 2
                    for (int k = 0; k < fin; ++k) {
                        const float4 wa = reinterpret_cast<const float4*>(wk + k * fpad)[0];
                        const float4 wb = reinterpret_cast<const float4*>(wk + k * fpad)[1];
                        const float wv[CG] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
                        for (int c = 0; c < C; ++c) {
                            float a[R];
                            load_rows<R>(ak + (c * aw + k) * rs, a);
#pragma unroll
                            for (int i = 0; i < R; ++i)
#pragma unroll
                                for (int j = 0; j < CG; ++j)
                                    acc[c][i][j] = fmaf(a[i], wv[j], acc[c][i][j]);
                        }
                    }
                }
                // phase[fwd]: products

                if (busy) {
#pragma unroll
                    for (int i = 0; i < R; ++i)
#pragma unroll
                        for (int j = 0; j < CG; ++j)
                            unit_rules<D>(acc, i, j, b[c0 + j], omega);
                }
                // every thread is done reading this layer's inputs and weights
                __syncthreads();
                if (busy) {
#pragma unroll
                    for (int c = 0; c < C; ++c)
#pragma unroll
                        for (int j = 0; j < CG; ++j) {
                            float v[R];
#pragma unroll
                            for (int i = 0; i < R; ++i) v[i] = acc[c][i][j];
                            store_rows<R>(act + (c * aw + c0 + j) * rs + r0, v);
                        }
                }
                // phase[fwd]: epilogue
            } else {
                // the linear last layer: thread e of the block takes
                // (channel, row, output) e, e + THREADS, ...
                const int n_items = C * rows * m;
                for (int e = tid; e < n_items; e += THREADS) {
                    const int c = e / (rows * m);
                    const int rem = e - c * rows * m;
                    const int r = rem / m;
                    const int col = rem - r * m;
                    const float* a = act + c * aw * rs + r;
                    float sum = 0.0f;
#pragma unroll 4
                    for (int k = 0; k < fin; ++k)
                        sum = fmaf(a[k * rs], w[k * fpad + col], sum);
                    const float v = c == 0 ? sum + b[col] : sum;
                    // phase[fwd]: last
                    const long long row = row0 + r;
                    if (row < n_rows) {
                        if (c == 0) out0[row * m + col] = v;
                        else if (c == C - 1) out_l[row * m + col] = v;
                        else out_j[(row * D + c - 1) * m + col] = v;
                    }
                    // phase[fwd]: store
                }
                // every thread is done reading `act` and this buffer
                __syncthreads();
            }
            if (plan.ring) {
                // the layer two steps on, into the buffer just read
                if (step + 2 < n_steps)
                    stage_layer_async(packed, plan, (step + 2) % n_layers,
                                      weights + (step & 1) * plan.w_stage);
                async_commit();
            }
        }
    }
    // phase[fwd]: end
}

// Validate the shape and fill the layer table; 0 if the kernels take it.
inline cudaError_t plan_layers(int n_layers, const int* widths, Plan& plan) {
    if (n_layers < 1 || n_layers > MAX_LAYERS) return cudaErrorInvalidValue;
    plan.n_layers = n_layers;
    plan.act_width = 0;
    int offset = 0;
    int staged = 0;
    int most = 0;
    for (int l = 0; l <= n_layers; ++l) {
        if (widths[l] < 1 || widths[l] > MAX_WIDTH) return cudaErrorInvalidValue;
        plan.width[l] = widths[l];
        if (pad_cols(widths[l]) > plan.act_width) plan.act_width = pad_cols(widths[l]);
    }
    for (int l = 0; l < n_layers; ++l) {
        const int fin = widths[l];
        const int fout = widths[l + 1];
        plan.offset[l] = offset;
        offset += fin * fout + fout;
        plan.w_off[l] = staged;
        const int layer = (fin + 1) * pad_cols(fout);
        staged += layer;
        if (layer > most) most = layer;
    }
    plan.resident = staged;
    plan.w_stage = most;
    return cudaSuccess;
}

// The widest padded hidden layer (CG where there is none).
inline int hidden_pad(const Plan& plan) {
    int hidden = CG;
    for (int l = 1; l < plan.n_layers; ++l)
        if (pad_cols(plan.width[l]) > hidden) hidden = pad_cols(plan.width[l]);
    return hidden;
}

// Threads of an SM with an item of the widest hidden layer.
inline int busy_threads(const Plan& plan, int R) {
    return blocks_per_sm(R) * plan.rows / R * (hidden_pad(plan) / CG);
}

// The row plan for C channels and R rows a thread: rows per tile that spread
// n_rows evenly over the blocks_per_sm(R) blocks of `sms` SMs, capped by the
// warps (one column group of every hidden layer per thread) and the shared
// memory those blocks may share; every layer resident where it fits beside
// the activations, else the two-buffer ring. The row stride keeps R-wide
// vector loads aligned and spreads a warp's stores over the banks (odd for
// R = 1, 2 mod 4 for R = 2). Returns the dynamic shared memory in bytes, 0
// if no plan fits.
inline size_t plan_rows(Plan& plan, int C, int R, int n_rows, int sms) {
    const int bps = blocks_per_sm(R);
    const WarpShape ws(0, hidden_pad(plan) / CG);
    int rows = R * ws.wr * (THREADS / 32 / ws.n_cb);
    const int slots = sms * bps;
    const int per_block = (n_rows + slots - 1) / slots;
    const int even = (per_block + R - 1) / R * R;
    if (even < rows) rows = even;
    const size_t limit = bps == 1 ? SMEM_LIMIT : SM_SMEM / bps - BLOCK_RESERVED;
    for (; rows >= R; rows -= R) {
        const int rs = (rows + 3) / 4 * 4 + (R == 1 ? 1 : R == 2 ? 2 : 0);
        const size_t act = static_cast<size_t>(C) * plan.act_width * rs;
        for (int ring = 0; ring <= 1; ++ring) {
            const size_t floats = act + (ring ? 2 * plan.w_stage : plan.resident);
            if (floats * sizeof(float) <= limit) {
                plan.ring = ring;
                plan.rows = rows;
                plan.rs = rs;
                plan.n_tiles = (n_rows + rows - 1) / rows;
                return floats * sizeof(float);
            }
        }
    }
    return 0;
}

// The plan of the R (r_wide at one block per SM, or 1 at two) that keeps
// more threads of an SM busy in the hidden layers; the wider R where they
// tie. Returns the dynamic shared memory in bytes (0 if neither fits).
inline size_t choose_plan(Plan& plan, int C, int r_wide, int n_rows, int sms, int* R) {
    Plan one = plan;
    const size_t s_wide = plan_rows(plan, C, r_wide, n_rows, sms);
    const size_t s_one = plan_rows(one, C, 1, n_rows, sms);
    if (s_one > 0 && (s_wide == 0 || busy_threads(one, 1) > busy_threads(plan, r_wide))) {
        plan = one;
        *R = 1;
        return s_one;
    }
    *R = r_wide;
    return s_wide;
}

constexpr int MAX_DEVICES = 64;

// The SM count of the current device, read once per device.
inline cudaError_t sm_count(int* sms) {
    static int known[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && known[dev] > 0) {
        *sms = known[dev];
        return cudaSuccess;
    }
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && dev < MAX_DEVICES) known[dev] = *sms;
    return err;
}

// Raise a kernel's dynamic shared-memory limit once per device, at the
// first call, so that later calls (and CUDA graph captures) make no
// attribute call.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, bool* done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
    return err;
}

// What launch_tiles keeps of one kernel on each device, so that later calls
// (and CUDA graph captures) make no attribute or occupancy call: its
// shared-memory limit raised, and its blocks per SM at the last shared
// memory size it was launched with.
struct LaunchCache {
    bool raised[MAX_DEVICES];
    size_t smem[MAX_DEVICES];
    int per_sm[MAX_DEVICES];
};

// Launch `kernel`, a __global__ wrapper of forward_tiles, for `plan`: a
// block per tile, at most one wave of blocks (which then walk the tiles).
template <typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kernel, const Plan& plan, size_t smem, int sms,
                         LaunchCache& cache, cudaStream_t stream, Args... args) {
    cudaError_t err = allow_max_smem(kernel, cache.raised);
    if (err != cudaSuccess) return err;
    int grid = plan.n_tiles;
    if (grid > sms) {
        int dev = 0;
        err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        int per_sm = dev < MAX_DEVICES && cache.smem[dev] == smem ? cache.per_sm[dev] : 0;
        if (per_sm == 0) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                                smem);
            if (err != cudaSuccess) return err;
            if (per_sm < 1) per_sm = 1;
            if (dev < MAX_DEVICES) {
                cache.smem[dev] = smem;
                cache.per_sm[dev] = per_sm;
            }
        }
        if (grid > sms * per_sm) grid = sms * per_sm;
    }
    kernel<<<grid, THREADS, smem, stream>>>(args...);
    return cudaGetLastError();
}

}  // namespace
}  // namespace sine_mlp
