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
// * mv: a group of G lanes per row (G a power of two dividing 32). Lane l
//   takes feature j = l % F (F lanes, a power of two <= J) and slot s = l / F
//   (P = G / F slot lanes), then strides over the slots by P and over the
//   features by F. At J = 16, G = F = 16: two rows per warp, each lane one
//   feature, looping over the S slots; a row's S*J floats are contiguous,
//   so each step of a group reads 64 contiguous bytes of vals and 64 of x.
//   At J = 1 (the TPU kernel's scalar form) F = 1 and the 32 lanes take
//   slots. The group's sum is a butterfly of shuffles in a fixed order.
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

inline bool pow2_divides(int a, int b) {   // a a power of two dividing b
    return a > 0 && (a & (a - 1)) == 0 && b % a == 0;
}

__global__ void __launch_bounds__(THREADS)
block_ell_mv_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                    const float* __restrict__ x, float* __restrict__ out,
                    int R, int S, int J, int G, int F) {
    const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
    const int lane = threadIdx.x % G;
    const int jl = lane % F, sl = lane / F, P = G / F;
    float acc = 0.f;
    if (r < R) {
        const float* v = vals + r * S * J;
        const int* c = cols + r * S;
        for (int s = sl; s < S; s += P) {
            const float* xb = x + (long long)__ldg(c + s) * J;
            const float* vs = v + (long long)s * J;
            for (int j = jl; j < J; j += F)
                acc = fmaf(__ldg(vs + j), __ldg(xb + j), acc);
        }
    }
    for (int off = G / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (r < R && lane == 0) out[r] = acc;
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

// A x for the block-ELL (vals, cols): out (R,). G lanes per row, F feature
// lanes (powers of two, F | G | 32). Returns a CUDA error code (0 = launched).
extern "C" int block_ell_mv_f32(const float* vals, const int* cols, const float* x,
                                float* out, int R, int S, int J, int G, int F,
                                void* stream) {
    if (R < 0 || S < 1 || J < 1 || !pow2_divides(G, 32) || !pow2_divides(F, G))
        return (int)cudaErrorInvalidValue;
    if (R == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned grid = grid_for(R, G);
    block_ell_mv_kernel<<<grid, THREADS, 0, st>>>(vals, cols, x, out, R, S, J, G, F);
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
