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
// is read once from device memory. block_ell_rmv has no TPU kernel (the JAX
// package runs A^T r as XLA's segment_sum).
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
//   (`order`: the flat slots r*S + s sorted stably by block id, `offsets`:
//   where each block's slots begin), built once per pattern by the wrapper.
//   A group of 32 lanes per block column: F feature lanes x P slot lanes,
//   each slot lane walking every P-th slot of the block in order, then a
//   fixed butterfly over the slot lanes. No float atomics: the same inputs
//   give the same bits on every run, which CGLS on these ill-conditioned
//   systems needs (summation-order noise is amplified across iterations).
//   The index is CSR, not padded to the largest degree. A row's padding
//   slots (block 0, zero values by construction) may be left out of it:
//   the vortex assembly pads ~40% of its rows to the slot count, and kept
//   in, they would all fall to block 0, whose one lane group would then
//   walk ~6e5 slots while every other walks ~3e2.
//
// Every loop that surrounds a shuffle runs the same number of times in
// every lane of a warp (rows or blocks beyond the end run with empty work).

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

__global__ void __launch_bounds__(THREADS)
block_ell_rmv_kernel(const float* __restrict__ vals, const int* __restrict__ order,
                     const int* __restrict__ offsets, const float* __restrict__ rv,
                     float* __restrict__ out, int n_blocks, int S, int J, int G,
                     int F) {
    const long long b = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
    const int lane = threadIdx.x % G;
    const int jl = lane % F, sl = lane / F, P = G / F;
    int lo = 0, hi = 0;
    if (b < n_blocks) {
        lo = __ldg(offsets + b);
        hi = __ldg(offsets + b + 1);
    }
    const int n_chunks = (J + F - 1) / F;
    for (int m = 0; m < n_chunks; ++m) {
        const int j = jl + m * F;
        float acc = 0.f;
        if (j < J) {
            for (int i = lo + sl; i < hi; i += P) {
                const int slot = __ldg(order + i);
                acc = fmaf(__ldg(vals + (long long)slot * J + j),
                           __ldg(rv + slot / S), acc);
            }
        }
        // across the slot lanes only: offsets >= F keep the feature lane
        for (int off = G / 2; off >= F; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (b < n_blocks && sl == 0 && j < J) out[b * J + j] = acc;
    }
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

// A^T rv over the CSR transpose (order (nnz,), offsets (n_blocks + 1,), int32):
// out (n_blocks * J,). Returns a CUDA error code (0 = launched).
extern "C" int block_ell_rmv_f32(const float* vals, const int* order, const int* offsets,
                                 const float* rv, float* out, int n_blocks, int S,
                                 int J, int G, int F, void* stream) {
    if (n_blocks < 0 || S < 1 || J < 1 || !pow2_divides(G, 32) || !pow2_divides(F, G))
        return (int)cudaErrorInvalidValue;
    if (n_blocks == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned grid = grid_for(n_blocks, G);
    block_ell_rmv_kernel<<<grid, THREADS, 0, st>>>(vals, order, offsets, rv, out,
                                                   n_blocks, S, J, G, F);
    return (int)cudaGetLastError();
}
