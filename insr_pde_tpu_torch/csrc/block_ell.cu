// Block-ELL gather-matvec and its transpose, the operator pair of every
// CGLS iteration of the vortex least-squares solve.
//
//   block_ell_mv:   out[r]    = sum_s sum_j vals[r,s,j] * x[cols[r,s]*J + j]
//   block_ell_rmv:  out[b*J+j] = sum over the slots (r, s) with cols[r,s] = b
//                                of vals[r,s,j] * rv[r]
//
// vals (R, S, J) f32, cols (R, S) int32 block ids, x (n_blocks*J,) f32.
//
// block_ell_mv replaces the TPU kernel `_ell_mv_kernel`
// (tools/experiments/pallas_spmv.py:46, pallas_call :63), the scalar ELL
// out[r] = sum_k vals[r,k] x[cols[r,k]], which is this kernel at J = 1. The
// TPU kernel kept all of x in VMEM and streamed row tiles of vals and cols;
// here x (512 KB at the channel preset) stays in the 50 MB L2 and each row
// is read once from device memory. block_ell_rmv replaces the transpose of
// `_ell_mv_kernel`, which has no TPU kernel: the JAX package runs A^T r as
// XLA's segment_sum (`BlockSparse.rmv`, insr_pde_tpu/ops/linalg.py:486).
//
// Bound: bytes. Per call the function must read vals (R*S*J*4 bytes, 187 MB
// at the channel preset), cols or the transpose index, x or rv, and write
// out; two flops per 4-byte value of vals, far below the card's 20 flops per
// byte. The design keeps every read of vals coalesced and every other
// access in L2:
//
// * mv: a group of G lanes per row (G a power of two dividing 32, 32 / G
//   rows per warp). The first design (one 4-byte load of vals per lane and
//   slot, each slot a dependent chain cols[s] -> x) kept ~128 bytes of vals
//   in flight per warp, 45% of the memory rate. Now a row's S*J floats (one
//   contiguous run, 768 bytes at the channel preset) are cut into vectors
//   of V floats, and lane l of the group takes the vectors l, l + G, ...,
//   U = 4 of them per step, issuing their value loads, their column loads
//   and then their x loads before any product:
//   - J % 4 == 0 (V = 4): a vector is 16 bytes of one slot, its x the 16
//     bytes at cols[s]*J + 4 jv (one float4 gather). At J = 16, S = 12 a
//     row is 48 vectors: G = 16 lanes, two rows per warp, a whole row's
//     768 bytes of vals in flight per half-warp.
//   - J = 1 and S % 4 == 0 (V = 4, the TPU kernel's scalar ELL): a vector
//     is 4 slots, their ids one int4 load, their x four scalar gathers; G =
//     32, a warp per row.
//   - otherwise (V = 1): one float per lane and step.
//   x stays in L2 (512 KB at the channel preset) and is gathered from
//   there (chip_smoke.py times mv beside a run whose gathers all hit L1).
//   The group's sum is a butterfly of shuffles in a fixed order.
//   At J % 4 == 0 and S % 4 == 0 the values and slot ids do not come from
//   the lanes' loads but from a ring (block_ell_mv_ring_kernel): a tile of
//   THREADS / G rows is one contiguous run of vals and one of cols, so two
//   bulk copies (cp.async.bulk, the TMA's 1D form) bring it into a stage
//   of shared memory, counted by the stage's mbarrier. A block keeps
//   RING_STAGES tiles in flight (4 x 13 KB at the channel preset, four
//   blocks an SM) on a persistent grid, and its lanes read each tile from
//   shared memory as they read it from device memory before. The register
//   version streamed 70% of the memory rate at the channel preset, the
//   ring 79% (PERF.md). At J = 1 it was slower (its rows' 768 scattered
//   gathers, not the stream, set that time), so J = 1 keeps the register
//   version.
// * rmv: a deterministic pull over a CSR transpose of the sparsity pattern
//   (the flat slots r*S + s sorted stably by block id, and where each
//   block's slots begin), built once per pattern by the wrapper. The index
//   is CSR, not padded to the largest degree. A row's padding slots (block
//   0, zero values by construction) may be left out of it: the vortex
//   assembly pads ~40% of its rows to the slot count, and kept in, they
//   would all fall to block 0 (~6e5 slots against ~3e2 elsewhere).
//   What held the first design (one warp per block column, gathering
//   vals[order[i]]) back: the channel operator's boundary blocks carry
//   several times the mean degree and finished last; each step was a
//   dependent chain order[i] -> vals, rv with two slots in flight per warp;
//   and at J = 1 each lane's load touched its own sector. So:
//   - Work is balanced by slots: each block's slot list is cut into
//     chunks of at most C slots (evenly: ceil(n / C) chunks), one warp per
//     chunk, so a column of 2,000 slots costs what seven of 290 do. The
//     chunk plan is built with the index, once per pattern.
//   - The values stream: the wrapper keeps vals_t, a copy of vals in the
//     transpose order with each slot's row id beside it (rows_t), built
//     once per assembled operator. A warp reads contiguous memory, 16 bytes
//     a lane at J % 4 == 0 (at J = 16: 4 lanes per slot, 8 slots per warp
//     step, U = 4 steps of loads in flight), coalesced 4-byte loads at J =
//     1; only the gather rv[rows_t[i]] is indirect, from a vector that
//     stays in L2.
//   - A second, small pass sums each block's chunk partials in chunk order.
//   No float atomics anywhere: the same inputs give the same bits on every
//   run, which CGLS on these ill-conditioned systems needs (summation-order
//   noise is amplified across iterations). One rmv is two launches.
//
// Every loop that surrounds a shuffle runs the same number of times in
// every lane of a warp (rows or chunks beyond the end run with empty work).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RING_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;    // 227 KB of dynamic shared memory per block

inline bool pow2_divides(int a, int b) {   // a a power of two dividing b
    return a > 0 && (a & (a - 1)) == 0 && b % a == 0;
}

// The mv vector modes (see the note at the top).
enum MvMode { MV_SLOT_VEC = 0, MV_SLOTS4 = 1, MV_SCALAR = 2 };

// One group of G lanes per row; lane `lane` takes the row's vectors lane,
// lane + G, ..., U per step, in that order, into one sum.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
block_ell_mv_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                    const float* __restrict__ x, float* __restrict__ out,
                    int R, int S, int J, int G) {
    constexpr int U = 4;
    constexpr int V = MODE == MV_SCALAR ? 1 : 4;
    const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
    const int lane = threadIdx.x % G;
    const int n_vec = S * J / V;
    const int jv_per_slot = J / V;          // MV_SLOT_VEC: vectors per slot
    // its log2 where it is a power of two (J = 16: 2), else -1
    const int jv_shift = (jv_per_slot & (jv_per_slot - 1)) == 0 ? __ffs(jv_per_slot) - 1 : -1;
    float acc = 0.f;
    if (r < R) {
        const float* v = vals + r * S * J;
        const int* c = cols + r * S;
        for (int e0 = lane; e0 < n_vec; e0 += U * G) {
            float4 vv[U];
            float4 xv[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int e = e0 + u * G;
                vv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
                if (e < n_vec) {
                    if constexpr (V == 4)
                        vv[u] = __ldg(reinterpret_cast<const float4*>(v) + e);
                    else
                        vv[u].x = __ldg(v + e);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int e = e0 + u * G;
                xv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
                if (e < n_vec) {
                    if constexpr (MODE == MV_SLOT_VEC) {
                        const int s = jv_shift >= 0 ? e >> jv_shift : e / jv_per_slot;
                        const int jv = e - s * jv_per_slot;
                        const long long b = __ldg(c + s);
                        xv[u] = __ldg(reinterpret_cast<const float4*>(x + b * J) + jv);
                    } else if constexpr (MODE == MV_SLOTS4) {
                        const int4 b = __ldg(reinterpret_cast<const int4*>(c) + e);
                        xv[u] = make_float4(__ldg(x + b.x), __ldg(x + b.y),
                                            __ldg(x + b.z), __ldg(x + b.w));
                    } else {
                        const int s = e / J;
                        const long long b = __ldg(c + s);
                        xv[u].x = __ldg(x + b * J + (e - s * J));
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                acc = fmaf(vv[u].x, xv[u].x, acc);
                if constexpr (V == 4) {
                    acc = fmaf(vv[u].y, xv[u].y, acc);
                    acc = fmaf(vv[u].z, xv[u].z, acc);
                    acc = fmaf(vv[u].w, xv[u].w, acc);
                }
            }
        }
    }
    for (int off = G / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (r < R && lane == 0) out[r] = acc;
}

// The mv ring's TMA primitives: an mbarrier per stage completes a phase on
// one arrival and the bytes of the stage's bulk copies. The tests' host
// emulation supplies its own versions of the functions between the marks.
// ring primitives {
__device__ inline unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void ring_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The arrival, announcing `bytes` of copies to come.
__device__ inline void ring_expect(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// to shared memory, counted against `bar`.
__device__ inline void ring_copy(void* dst, const void* src, unsigned bytes,
                                 unsigned long long* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1], %2, [%3];"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

// This thread's accesses of shared memory before the copies it issues next.
__device__ inline void ring_fence() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Until the phase of parity `parity` has completed.
__device__ inline void ring_wait(unsigned long long* bar, unsigned parity) {
    unsigned done = 0;
    while (!done)
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// } ring primitives

// Floats of one ring stage: a tile's vals, then its cols padded to 16 bytes.
__host__ __device__ inline long long ring_stage_floats(int G, int S, int J) {
    const long long tr = THREADS / G;
    return tr * S * J + ((tr * S + 3) & ~3LL);
}

// mv over the ring: the stages, then one mbarrier per stage, in dynamic
// shared memory. Block b takes the tiles b, b + gridDim.x, ...; thread 0
// keeps the next RING_STAGES of them in flight and refills a stage once
// every thread is done with it. A row's lanes, steps and sum are those of
// block_ell_mv_kernel<MV_SLOT_VEC>, over the stage instead of device memory.
__global__ void __launch_bounds__(THREADS)
block_ell_mv_ring_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                         const float* __restrict__ x, float* __restrict__ out,
                         int R, int S, int J, int G, int n_tiles) {
    constexpr int U = 4;
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);
    const int tr = THREADS / G;
    const int row_f = S * J;
    const int vals_f = tr * row_f;
    const long long stage_f = ring_stage_floats(G, S, J);
    unsigned long long* bars =
        reinterpret_cast<unsigned long long*>(ring + RING_STAGES * stage_f);
    if (threadIdx.x == 0)
        for (int s = 0; s < RING_STAGES; ++s) ring_init(&bars[s]);
    __syncthreads();
    const int tiles = (int)blockIdx.x < n_tiles
                      ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    auto issue = [&](int k) {             // the block's k-th tile into stage k % RING_STAGES
        const long long r0 = ((long long)blockIdx.x + (long long)k * gridDim.x) * tr;
        const int rows = R - r0 < tr ? (int)(R - r0) : tr;
        unsigned long long* bar = &bars[k % RING_STAGES];
        float* dst = ring + (k % RING_STAGES) * stage_f;
        ring_fence();
        ring_expect(bar, (unsigned)rows * (row_f + S) * 4u);
        ring_copy(dst, vals + r0 * row_f, (unsigned)rows * row_f * 4u, bar);
        ring_copy(dst + vals_f, cols + r0 * S, (unsigned)rows * S * 4u, bar);
    };
    if (threadIdx.x == 0)
        for (int k = 0; k < tiles && k < RING_STAGES; ++k) issue(k);
    const int lane = threadIdx.x % G;
    const int lr = threadIdx.x / G;       // the thread's row in the tile
    const int n_vec = row_f / 4;
    const int jv_per_slot = J / 4;
    const int jv_shift = (jv_per_slot & (jv_per_slot - 1)) == 0 ? __ffs(jv_per_slot) - 1 : -1;
    for (int k = 0; k < tiles; ++k) {
        const int st = k % RING_STAGES;
        ring_wait(&bars[st], (k / RING_STAGES) & 1);
        const long long r = ((long long)blockIdx.x + (long long)k * gridDim.x) * tr + lr;
        const float4* v = reinterpret_cast<const float4*>(ring + st * stage_f + lr * row_f);
        const int* c = reinterpret_cast<const int*>(ring + st * stage_f + vals_f) + lr * S;
        float acc = 0.f;
        if (r < R) {
            for (int e0 = lane; e0 < n_vec; e0 += U * G) {
                float4 vv[U], xv[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int e = e0 + u * G;
                    vv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
                    xv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
                    if (e < n_vec) {
                        const int s = jv_shift >= 0 ? e >> jv_shift : e / jv_per_slot;
                        const long long b = c[s];
                        vv[u] = v[e];
                        xv[u] = __ldg(reinterpret_cast<const float4*>(x + b * J)
                                      + (e - s * jv_per_slot));
                    }
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    acc = fmaf(vv[u].x, xv[u].x, acc);
                    acc = fmaf(vv[u].y, xv[u].y, acc);
                    acc = fmaf(vv[u].z, xv[u].z, acc);
                    acc = fmaf(vv[u].w, xv[u].w, acc);
                }
            }
        }
        for (int off = G / 2; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (r < R && lane == 0) out[r] = acc;
        __syncthreads();                  // every thread is done with stage st
        if (threadIdx.x == 0 && k + RING_STAGES < tiles) issue(k + RING_STAGES);
    }
}

// The ring's launch: the dynamic shared-memory limit raised once per
// device, then a persistent grid of as many blocks as the SMs hold.
cudaError_t launch_mv_ring(const float* vals, const int* cols, const float* x,
                           float* out, int R, int S, int J, int G, size_t smem,
                           cudaStream_t st) {
    constexpr int MAX_DEVICES = 64;
    static bool raised[MAX_DEVICES] = {};
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (dev >= MAX_DEVICES || !raised[dev])) {
        err = cudaFuncSetAttribute(block_ell_mv_ring_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
    }
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_ell_mv_ring_kernel,
                                                            THREADS, smem);
    if (err != cudaSuccess) return err;
    const int tr = THREADS / G;
    const long long n_tiles = ((long long)R + tr - 1) / tr;
    const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const unsigned grid = (unsigned)(n_tiles < most ? n_tiles : most);
    block_ell_mv_ring_kernel<<<grid, THREADS, smem, st>>>(vals, cols, x, out, R, S, J, G,
                                                          (int)n_tiles);
    return cudaGetLastError();
}

// rmv, pass 1: one warp per chunk, a run of at most C consecutive slots of
// one block column in the transpose order. vals_t (nnz, J) holds the slots'
// values in that order and rows_t (nnz,) their row ids, so a warp streams
// contiguous memory. Lane l takes the vector jv = l % F of V floats of a
// slot (V = 4, one 16-byte load, when J % 4 == 0) and the slots
// lo + l / F, lo + l / F + P, ... (P = 32 / F slot lanes), U of them per
// step with their loads issued before their products; then a fixed
// butterfly over the slot lanes, and slot lane 0 writes the chunk's
// partial (J,).
template <int V>
__global__ void __launch_bounds__(THREADS)
block_ell_rmv_chunk_kernel(const float* __restrict__ vals_t,
                           const int* __restrict__ rows_t,
                           const int* __restrict__ chunk_start,
                           const float* __restrict__ rv,
                           float* __restrict__ partial, int n_chunks, int J,
                           int F) {
    constexpr int U = 4;
    const long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    const int fl = lane % F, sl = lane / F, P = 32 / F;
    const int NV = J / V;
    int lo = 0, hi = 0;
    if (c < n_chunks) {
        lo = __ldg(chunk_start + c);
        hi = __ldg(chunk_start + c + 1);
    }
    const int n_pass = (NV + F - 1) / F;
    for (int m = 0; m < n_pass; ++m) {
        const int jv = fl + m * F;
        float acc[V];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0.f;
        if (jv < NV) {
            for (int i0 = lo + sl; i0 < hi; i0 += U * P) {
                float v[U][V];
                float w[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int i = i0 + u * P;
                    const float* src = vals_t + (long long)i * J + jv * V;
                    if (i < hi) {
                        if constexpr (V == 4) {
                            const float4 q = __ldg(reinterpret_cast<const float4*>(src));
                            v[u][0] = q.x; v[u][1] = q.y; v[u][2] = q.z; v[u][3] = q.w;
                        } else {
                            v[u][0] = __ldg(src);
                        }
                        w[u] = __ldg(rv + __ldg(rows_t + i));
                    } else {
#pragma unroll
                        for (int e = 0; e < V; ++e) v[u][e] = 0.f;
                        w[u] = 0.f;
                    }
                }
#pragma unroll
                for (int u = 0; u < U; ++u)
#pragma unroll
                    for (int e = 0; e < V; ++e) acc[e] = fmaf(v[u][e], w[u], acc[e]);
            }
        }
        // across the slot lanes only: offsets >= F keep the vector lane
        for (int off = 16; off >= F; off >>= 1)
#pragma unroll
            for (int e = 0; e < V; ++e)
                acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
        if (c < n_chunks && sl == 0 && jv < NV) {
            float* dst = partial + c * J + jv * V;
#pragma unroll
            for (int e = 0; e < V; ++e) dst[e] = acc[e];
        }
    }
}

// rmv, pass 2: out[b*J + j] = the sum of the partials of block b's chunks
// chunk_off[b] .. chunk_off[b+1], in chunk order (0 for a block with no
// slots).
__global__ void __launch_bounds__(THREADS)
block_ell_rmv_column_kernel(const float* __restrict__ partial,
                            const int* __restrict__ chunk_off,
                            float* __restrict__ out, int n_blocks, int J) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (long long)n_blocks * J) return;
    const long long b = e / J;
    const int j = (int)(e - b * J);
    const int c1 = __ldg(chunk_off + b + 1);
    float s = 0.f;
    for (int c = __ldg(chunk_off + b); c < c1; ++c)
        s += __ldg(partial + (long long)c * J + j);
    out[e] = s;
}

unsigned grid_for(long long groups, int G) {
    return (unsigned)((groups * G + THREADS - 1) / THREADS);
}

}  // namespace

// A x for the block-ELL (vals, cols): out (R,). G lanes per row (a power
// of two dividing 32) and floats per vector V: 4 when J % 4 == 0 or (J == 1
// and S % 4 == 0), with vals, cols and x 16-byte aligned, else 1. Through
// the ring where V = 4, J % 4 == 0, S % 4 == 0 and its stages fit. Returns
// a CUDA error code (0 = launched).
extern "C" int block_ell_mv_f32(const float* vals, const int* cols, const float* x,
                                float* out, int R, int S, int J, int G, int V,
                                void* stream) {
    if (R < 0 || S < 1 || J < 1 || !pow2_divides(G, 32) || (V != 1 && V != 4))
        return (int)cudaErrorInvalidValue;
    const bool aligned = ((reinterpret_cast<unsigned long long>(vals)
                           | reinterpret_cast<unsigned long long>(cols)
                           | reinterpret_cast<unsigned long long>(x)) & 15) == 0;
    const int mode = V == 1 ? MV_SCALAR : J % 4 == 0 ? MV_SLOT_VEC : MV_SLOTS4;
    if (V == 4 && (!aligned || (mode == MV_SLOTS4 && (J != 1 || S % 4 != 0))))
        return (int)cudaErrorInvalidValue;
    if (R == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto mv = mode == MV_SLOT_VEC ? block_ell_mv_kernel<MV_SLOT_VEC>
            : mode == MV_SLOTS4 ? block_ell_mv_kernel<MV_SLOTS4>
                                : block_ell_mv_kernel<MV_SCALAR>;
    const size_t ring_smem = (RING_STAGES * ring_stage_floats(G, S, J)
                              + 2 * RING_STAGES) * sizeof(float);
    if (mode == MV_SLOT_VEC && S % 4 == 0 && ring_smem <= (size_t)SMEM_LIMIT)
        return (int)launch_mv_ring(vals, cols, x, out, R, S, J, G, ring_smem, st);
    const unsigned grid = grid_for(R, G);
    mv<<<grid, THREADS, 0, st>>>(vals, cols, x, out, R, S, J, G);
    return (int)cudaGetLastError();
}

// A^T rv over the transpose-ordered values vals_t (nnz, J) and row ids
// rows_t (nnz,), cut into n_chunks chunks (chunk_start (n_chunks + 1,):
// where each begins; chunk_off (n_blocks + 1,): each block's first chunk),
// all int32: out (n_blocks * J,). partial is scratch of n_chunks * J floats.
// F vector lanes per slot (a power of two dividing 32) of V = 4 floats when
// J % 4 == 0, else 1. Two launches; returns a CUDA error code (0 =
// launched).
extern "C" int block_ell_rmv_f32(const float* vals_t, const int* rows_t,
                                 const int* chunk_start, const int* chunk_off,
                                 const float* rv, float* partial, float* out,
                                 int n_chunks, int n_blocks, int J, int F,
                                 void* stream) {
    const int V = J % 4 == 0 ? 4 : 1;
    if (n_chunks < 0 || n_blocks < 0 || J < 1 || !pow2_divides(F, 32) || F > J / V)
        return (int)cudaErrorInvalidValue;
    if (n_blocks == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n_chunks > 0) {
        auto chunks = V == 4 ? block_ell_rmv_chunk_kernel<4> : block_ell_rmv_chunk_kernel<1>;
        const unsigned grid = grid_for(n_chunks, 32);
        chunks<<<grid, THREADS, 0, st>>>(vals_t, rows_t, chunk_start, rv, partial,
                                         n_chunks, J, F);
        const int err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    const unsigned grid = grid_for((long long)n_blocks * J, 1);
    block_ell_rmv_column_kernel<<<grid, THREADS, 0, st>>>(partial, chunk_off, out,
                                                          n_blocks, J);
    return (int)cudaGetLastError();
}
