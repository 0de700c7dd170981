// Fused SIREN value + Jacobian + Laplacian, forward and backward, for Hopper
// (sm_90a), f32 throughout.
//
// Replaces the TPU kernels of tools/experiments/pallas_vgl.py:
//   * vgl_forward_kernel  <- `_vgl_fwd_kernel` (with `_forward_chain`): per
//     row, the value u, Jacobian J and Laplacian L of a sine MLP, carrying
//     (h, J_0..J_{d-1}, L) through every layer:
//         z = h W + b,  Jz_a = J_a W,  Lz = L W
//         h' = sin(w z),  J'_a = w cos(w z) Jz_a,
//         L' = w cos(w z) Lz - w^2 sin(w z) sum_a Jz_a^2
//   * vgl_backward_kernel + vgl_reduce_kernel <- `_vgl_bwd_kernel`: the
//     hand-derived reverse sweep for cotangents (gu, gJ, gL), recomputing
//     the forward per tile:
//         gz    = gh' wc - w^2 s sum_a gJ'_a Jz_a - gL' (w^2 s Lz + w^3 c Q)
//         gJz_a = gJ'_a wc - 2 w^2 s gL' Jz_a,   gLz = gL' wc
//         gW = h^T gz + sum_a J_a^T gJz_a + L^T gLz,  gb = sum_rows gz
//         gh = gz W^T,  gJ_a = gJz_a W^T,  gL = gLz W^T,  gx = gh at layer 0
//     (wc = w cos(w z), s = sin(w z), Q = sum_a Jz_a^2).
//
// What bounds it on this card: arithmetic, not bytes. The pressure net
// 2->32->32->32->32->1 at d = 2 does (d + 2) = 4 products with every weight,
// ~12,700 multiply-adds per row in the forward and about three times that in
// the backward (recompute, dW, G W^T), against 24 bytes of coords and
// outputs per row. At the 16,384 collocation points of the pressure phase a
// call is a few microseconds of f32 work, so the rate at which shared memory
// feeds the multiply-adds, and the latency of the layer chain inside a
// block, set its time.
//
// Design, and what it does about that:
//   * The forward is the layer engine of csrc/sine_mlp_tile.cuh (shared with
//     the SIREN forward) at d + 2 channels: every layer's weights staged
//     once per block by cp.async (a two-layer ring at width 128), one
//     activation buffer, the last layer spread over the block; a thread
//     takes FWD_R = 2 rows x 8 columns at one block per SM (width 128:
//     32-row tiles), or 1 row x 8 columns at two blocks per SM where that
//     keeps more threads busy (the pressure phase: 63-row tiles, 261 blocks
//     on 132 SMs). Its
//     first design (64-row tiles, one layer staged at a time behind two
//     barriers, one row per thread) ran at 25% of its bound.
//   * A backward block owns `rows` rows (a power of two, at most 64) and
//     256 threads: a team of 256 / rows threads per row in the recompute and
//     in G W^T, each computing every n-th group of 4 output columns for all
//     d + 2 channels at once, so that each weight read from shared memory
//     feeds d + 2 fmas.
//   * Activations, stored pre-activations and cotangents live in shared
//     memory channel- and column-major with a row stride of rows + 1 (odd):
//     the layer products read neighbouring rows of one column (neighbouring
//     banks).
//   * One layer's W and b (or W^T in the reverse sweep) are staged in shared
//     memory at a time, zero-padded to a multiple of 8 columns, with four
//     loads in flight per thread.
//   * The backward keeps z, Jz and Lz of every hidden layer per row. Its
//     first design (64 rows, ~204 KB: one block of 8 warps per SM; each
//     weight gradient one thread's sum of C x rows terms, two shared loads
//     per fma; each tile's share read, added and written back in device
//     memory; a sine and cosine three times per hidden unit and row; a
//     reduction of 13 blocks) ran at 8x its bound. Now:
//     - rows: the largest power of two whose buffers let two blocks share
//       an SM (32 rows, ~106 KB for the pressure net), else the largest
//       that fits at all (8 rows at width 128); the launch bounds follow
//       the plan (registers capped at 128 only where two blocks share);
//     - weight gradients as a register-tiled product: for gW_l (fin x fout)
//       = sum over channels c and rows r of A(c, k, r) G(c, j, r), a thread
//       owns a 4 x 4 micro-tile (MT): 8 shared loads feed 16 fmas. Narrow
//       layers: 8 lanes of a warp take 8 neighbouring column groups of one
//       row group and 4 slices of the rows (r = slice, slice + 4, ...),
//       which meet in a fixed butterfly; layers of 128 or more: 32 lanes
//       take columns 32 apart and every row (the few rows of a wide net's
//       tile leave a slice too little to sum). Either way the loads hit
//       distinct banks;
//     - a sine and cosine twice per hidden unit and row: once in the
//       recompute, once where the reverse sweep rebuilds a layer's inputs
//       from the stored z, which it then overwrites with w cos(w z) for the
//       reverse rule (whose sin(w z) is the input h still in place);
//     - the cross-block sum on many blocks (vgl_reduce_kernel): each block
//       sums 32 parameters over the partials, 8 threads per parameter taking
//       every 8th partial in order, then the 8 in a fixed order.
//   * The weight gradients are summed over all rows without atomics: a block
//     walks its tiles in order and keeps one partial (the packed layout
//     [W_0, b_0, W_1, ...]) in device memory that only its own threads read
//     (ahead of the sums) and write. The grid has a block per tile while the
//     partials fit 8 MB (the pressure net: 512 blocks, one write per
//     element), else 256 blocks; it is fixed by the shape, so the result is
//     the same bit for bit from run to run.
//   * Cotangents are read as given: autograd's zeros for u and J in the
//     pressure loss ("L-only") are read, not skipped.
//   * No tensor cores: the TPU kernels pin Precision.HIGHEST, so products
//     stay f32 (fmaf). Precise sincosf, never __sinf/__cosf and never
//     fast-math: w z lies far outside [-pi, pi], and L carries w^2 and w^3
//     factors.
// `// phase:` comments mark where the backward's time is split
// (`python -m insr_pde_tpu_torch.kernel_phases siren_vgl` stamps a copy of
// this source there); the forward's `// phase[fwd]:` marks are in the
// engine's header.

#include <cuda_runtime.h>

#include "sine_mlp_tile.cuh"

namespace {

// the card's and the layers' facts, shared with the forward engine
using sine_mlp::allow_max_smem;
using sine_mlp::BLOCK_RESERVED;
using sine_mlp::MAX_LAYERS;
using sine_mlp::MAX_WIDTH;
using sine_mlp::pad_cols;  // layers are padded to a multiple of 8 columns
using sine_mlp::SM_SMEM;
using sine_mlp::SMEM_LIMIT;
using sine_mlp::THREADS;

constexpr int MAX_ROWS = 64;      // rows per block at most
constexpr int FWD_R = 2;          // forward: rows per thread at one block per SM
constexpr int BWD_CG = 4;         // backward: output columns per register group
constexpr int MAX_D = 3;
constexpr int BWD_BLOCKS_PER_SM = 2;  // the backward's row plan aims at this
constexpr int BWD_GRID_MIN = 256;     // the backward's grid: at least this many
constexpr int PARTIAL_FLOATS = 1 << 21;  // blocks, more while their partials fit this
constexpr int MT = 4;                 // weight gradients: MT x MT micro-tiles
constexpr int SLICES = 4;             // and 4 slices of the (c, r) sum
constexpr int RED_PARAMS = 32;        // reduce: parameters per block
constexpr int RED_GROUPS = THREADS / RED_PARAMS;

struct VglDims {
    int n_layers;
    int d;
    int rows;                     // rows per block (power of two)
    int rows_log2;
    int act_width;                // widest padded layer, the in_dim included
    int n_params;                 // sum over layers of fin * fout + fout
    int s_total;                  // backward: floats of stored pre-activations
    int width[MAX_LAYERS + 1];    // width[0] = d, width[l + 1] = out of layer l
    int offset[MAX_LAYERS];       // W_l at packed + offset[l] (fin x fout), b_l after it
    int s_off[MAX_LAYERS];        // backward: z, Jz, Lz of hidden layer l in shared memory
};

// Element (channel c, column k, row r) of a tile in shared memory.
struct Tile {
    float* base;
    int cols;
    int rs;
    __device__ float& operator()(int c, int k, int r) const {
        return base[(c * cols + k) * rs + r];
    }
};

// acc[c][j] = sum_{k < n_in} in(c, k, r) * w_s[k * ld + c0 + j] for the C
// channels of row r: NC / 4 float4 weight loads feed C * NC fmas.
template <int C, int NC>
__device__ inline void tile_product(const Tile& in, int r, int n_in,
                                    const float* w_s, int ld, int c0,
                                    float (&acc)[C][NC]) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[c][j] = 0.0f;
    for (int k = 0; k < n_in; ++k) {
        float w[NC];
#pragma unroll
        for (int q = 0; q < NC / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(w_s + k * ld + c0 + 4 * q);
            w[4 * q] = v.x;
            w[4 * q + 1] = v.y;
            w[4 * q + 2] = v.z;
            w[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float a = in(c, k, r);
#pragma unroll
            for (int j = 0; j < NC; ++j) acc[c][j] = fmaf(a, w[j], acc[c][j]);
        }
    }
}

// The chain's start for the tile's rows: h = x, J_a = e_a, L = 0 (rows past
// the end read x = 0).
template <int D>
__device__ inline void load_inputs(const float* __restrict__ coords,
                                   const Tile& t, long long row0, int n_rows,
                                   int rows) {
    for (int i = threadIdx.x; i < rows * D; i += THREADS) {
        const int ri = i / D;
        const int k = i - ri * D;
        t(0, k, ri) = row0 + ri < n_rows ? coords[row0 * D + i] : 0.0f;
#pragma unroll
        for (int a = 0; a < D; ++a) t(1 + a, k, ri) = a == k ? 1.0f : 0.0f;
        t(D + 1, k, ri) = 0.0f;
    }
}

// Stage W_l (fin x fpad) and b_l (fpad, the row k = fin) of the packed
// parameters, zero-padded; four loads in flight per thread.
__device__ inline void stage_layer(const float* __restrict__ W, int fin,
                                   int fout, float* w_s) {
    const int fpad = pad_cols(fout);
    const int n = (fin + 1) * fpad;
    for (int i0 = threadIdx.x; i0 < n; i0 += 4 * THREADS) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * THREADS;
            const int k = i / fpad;
            const int c = i - k * fpad;
            v[u] = i < n && c < fout ? W[k * fout + c] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (i0 + u * THREADS < n) w_s[i0 + u * THREADS] = v[u];
    }
}

// Stage W_l^T, [fout][pad(fin)], zero-padded; four loads in flight per
// thread.
__device__ inline void stage_transposed(const float* __restrict__ W, int fin,
                                        int fout, float* w_s) {
    const int finpad = pad_cols(fin);
    const int n = fout * finpad;
    for (int i0 = threadIdx.x; i0 < n; i0 += 4 * THREADS) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * THREADS;
            const int j = i / finpad;
            const int k = i - j * finpad;
            v[u] = i < n && k < fin ? W[k * fout + j] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (i0 + u * THREADS < n) w_s[i0 + u * THREADS] = v[u];
    }
}

// This tile's share of gW_l (fin x fout, row-major at dst) and gb_l (fout,
// after it): gW_l[k][j] = sum_{c, r} a(c, k, r) g(c, j, r), gb_l[j] =
// sum_r g(0, j, r). ADD: add to what the block wrote for its earlier tiles
// (read ahead of the sums), else assign (its first tile). A thread owns an
// MT x MT micro-tile: MT rows k of one row group and MT columns j. Warp w
// takes the groups w, w + 8, ... of one row group and a run of columns:
// * narrow layers: lane l the columns of group l % 8 (MT neighbours) and
//   the slice l / 8 of the rows (r = slice, slice + 4, ...); the 4 slices
//   meet in a fixed butterfly;
// * wide layers (fout >= 32 MT): lane l the columns l, l + 32, ... of the
//   run and every row (no butterfly).
// Either way the lanes' loads of g hit distinct banks (the row stride is
// odd) and those of a are broadcasts. Every lane of a warp runs the same
// groups, so the shuffles meet. The sums walk each (channel, column) run of
// rows from pointers set once per channel, unrolled, so that a load is a
// base and a constant offset: an index computed per load would take more
// instructions than the fmas it feeds.
template <int C, bool ADD, bool WIDE>
__device__ inline void weight_grads(const Tile& a, const Tile& g, int fin,
                                    int fout, int rows, float* dst) {
    constexpr int slices = WIDE ? 1 : SLICES;
    constexpr int run = (WIDE ? 32 : 8) * MT;      // columns per group
    const int lane = threadIdx.x % 32;
    const int sl = WIDE ? 0 : lane / 8;
    const int tj = WIDE ? lane : lane % 8;
    const int jg = (fout + run - 1) / run;
    const int n_groups = (fin + MT - 1) / MT * jg;
    for (int grp = threadIdx.x / 32; grp < n_groups; grp += THREADS / 32) {
        const int k0 = grp / jg * MT;
        int jj[MT];
#pragma unroll
        for (int j = 0; j < MT; ++j)
            jj[j] = grp % jg * run + (WIDE ? tj + 32 * j : tj * MT + j);
        float old[MT][MT];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < MT; ++j)
                old[i][j] = ADD && sl == 0 && k0 + i < fin && jj[j] < fout
                            ? dst[(k0 + i) * fout + jj[j]] : 0.0f;
        float acc[MT][MT];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < MT; ++j) acc[i][j] = 0.0f;
        bool va[MT], vg[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            va[i] = k0 + i < fin;
            vg[i] = jj[i] < fout;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float* pa[MT];
            const float* pg[MT];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                pa[i] = &a(c, va[i] ? k0 + i : 0, sl);
                pg[i] = &g(c, vg[i] ? jj[i] : 0, sl);
            }
#pragma unroll 4
            for (int r = 0; r < rows - sl; r += slices) {
                float av[MT], gv[MT];
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    av[i] = va[i] ? pa[i][r] : 0.0f;
                    gv[i] = vg[i] ? pg[i][r] : 0.0f;
                }
#pragma unroll
                for (int i = 0; i < MT; ++i)
#pragma unroll
                    for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
            }
        }
        if constexpr (!WIDE) {
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < MT; ++j) {
                    acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 8);
                    acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
                }
        }
        if (sl == 0) {
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < MT; ++j)
                    if (k0 + i < fin && jj[j] < fout)
                        dst[(k0 + i) * fout + jj[j]] = ADD ? old[i][j] + acc[i][j]
                                                           : acc[i][j];
        }
    }
    // the bias: 8 lanes per column, each every 8th row, then a butterfly
    float* db = dst + fin * fout;
    for (int e0 = 0; e0 < fout * 8; e0 += THREADS) {
        const int e = e0 + threadIdx.x;
        const int j = e / 8;
        const float prior = ADD && j < fout && e % 8 == 0 ? db[j] : 0.0f;
        float sum = 0.0f;
        if (j < fout)
            for (int r = e % 8; r < rows; r += 8) sum += g(0, j, r);
        for (int off = 1; off < 8; off <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (j < fout && e % 8 == 0) db[j] = ADD ? prior + sum : sum;
    }
}

// MINB: the blocks per SM of the row plan, which caps the registers.
template <int D, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
vgl_backward_kernel(const float* __restrict__ coords,
                    const float* __restrict__ packed,
                    const float* __restrict__ gu, const float* __restrict__ gjac,
                    const float* __restrict__ glap, float* __restrict__ partial,
                    float* __restrict__ gx, int n_rows, VglDims dims,
                    int n_tiles, float omega) {
    constexpr int C = D + 2;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int rows = dims.rows;
    const int rs = rows + 1;
    const int aw = dims.act_width;
    const int n_layers = dims.n_layers;
    const int m = dims.width[n_layers];
    float* s_base = smem;                               // z, Jz, Lz per hidden layer
    const Tile t_p{smem + dims.s_total, aw, rs};
    const Tile t_q{smem + dims.s_total + C * aw * rs, aw, rs};
    float* w_s = smem + dims.s_total + 2 * C * aw * rs;

    const int tid = threadIdx.x;
    const int r = tid % rows;
    const int team = tid / rows;
    const int n_team = THREADS / rows;
    const float w2 = omega * omega;
    float* part = partial + static_cast<long long>(blockIdx.x) * dims.n_params;
    // phase: setup

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const bool first = tile == static_cast<int>(blockIdx.x);
        const long long row0 = static_cast<long long>(tile) * rows;

        // 1. recompute the hidden layers, keeping each one's z, Jz, Lz
        Tile in = t_p;
        Tile out = t_q;
        load_inputs<D>(coords, in, row0, n_rows, rows);
        for (int l = 0; l < n_layers - 1; ++l) {
            const int fin = dims.width[l];
            const int fout = dims.width[l + 1];
            const int fpad = pad_cols(fout);
            const float* b_s = w_s + fin * fpad;
            const Tile st{s_base + dims.s_off[l], fpad, rs};
            __syncthreads();
            stage_layer(packed + dims.offset[l], fin, fout, w_s);
            __syncthreads();
            for (int c0 = team * BWD_CG; c0 < fpad; c0 += n_team * BWD_CG) {
                float acc[C][BWD_CG];
                tile_product<C, BWD_CG>(in, r, fin, w_s, fpad, c0, acc);
#pragma unroll
                for (int j = 0; j < BWD_CG; ++j) {
                    const int col = c0 + j;
                    const float z = acc[0][j] + b_s[col];
                    float s, c;
                    sincosf(omega * z, &s, &c);
                    const float wc = omega * c;
                    float q = 0.0f;
#pragma unroll
                    for (int a = 0; a < D; ++a) q = fmaf(acc[1 + a][j], acc[1 + a][j], q);
                    st(0, col, r) = z;
#pragma unroll
                    for (int a = 0; a < D; ++a) st(1 + a, col, r) = acc[1 + a][j];
                    st(C - 1, col, r) = acc[C - 1][j];
                    out(0, col, r) = s;
#pragma unroll
                    for (int a = 0; a < D; ++a) out(1 + a, col, r) = wc * acc[1 + a][j];
                    out(C - 1, col, r) = wc * acc[C - 1][j] - w2 * s * q;
                }
            }
            const Tile t = in;
            in = out;
            out = t;
        }
        __syncthreads();
        // phase: recompute

        // 2. the cotangents of the linear last layer's outputs
        Tile g = t_p;
        Tile a_t = t_q;
        for (int i = tid; i < rows * m; i += THREADS) {
            const int ri = i & (rows - 1);
            const int col = i >> dims.rows_log2;
            const long long rr = row0 + ri;
            const bool ok = rr < n_rows;
            g(0, col, ri) = ok ? gu[rr * m + col] : 0.0f;
#pragma unroll
            for (int a = 0; a < D; ++a)
                g(1 + a, col, ri) = ok ? gjac[(rr * D + a) * m + col] : 0.0f;
            g(C - 1, col, ri) = ok ? glap[rr * m + col] : 0.0f;
        }

        // 3. the reverse sweep
        for (int l = n_layers - 1; l >= 0; --l) {
            const int fin = dims.width[l];
            const int fout = dims.width[l + 1];
            const int finpad = pad_cols(fin);
            const float* W = packed + dims.offset[l];
            const Tile sp{s_base + (l > 0 ? dims.s_off[l - 1] : 0), finpad, rs};
            // the inputs h, J, L of layer l, from layer l - 1's z, Jz, Lz;
            // z is then replaced by w cos(w z) for the reverse rule below
            if (l == 0) {
                load_inputs<D>(coords, a_t, row0, n_rows, rows);
            } else {
#pragma unroll 2
                for (int i = tid; i < rows * fin; i += THREADS) {
                    const int ri = i & (rows - 1);
                    const int k = i >> dims.rows_log2;
                    float s, c;
                    sincosf(omega * sp(0, k, ri), &s, &c);
                    const float wc = omega * c;
                    float q = 0.0f;
#pragma unroll
                    for (int a = 0; a < D; ++a) q = fmaf(sp(1 + a, k, ri), sp(1 + a, k, ri), q);
                    a_t(0, k, ri) = s;
#pragma unroll
                    for (int a = 0; a < D; ++a) a_t(1 + a, k, ri) = wc * sp(1 + a, k, ri);
                    a_t(C - 1, k, ri) = wc * sp(C - 1, k, ri) - w2 * s * q;
                    sp(0, k, ri) = wc;
                }
            }
            // W_l^T for the product with the cotangents
            stage_transposed(W, fin, fout, w_s);
            __syncthreads();
            // phase: inputs

            float* dst = part + dims.offset[l];
            if (fout >= 32 * MT) {
                if (first) weight_grads<C, false, true>(a_t, g, fin, fout, rows, dst);
                else weight_grads<C, true, true>(a_t, g, fin, fout, rows, dst);
            } else {
                if (first) weight_grads<C, false, false>(a_t, g, fin, fout, rows, dst);
                else weight_grads<C, true, false>(a_t, g, fin, fout, rows, dst);
            }
            __syncthreads();
            // phase: wgrad

            if (l == 0) {
                // d/d coords: only the value channel reaches x (the starts of
                // J and L are constants)
                for (int i = tid; i < rows * D; i += THREADS) {
                    const int ri = i / D;
                    const int k = i - ri * D;
                    const long long rr = row0 + ri;
                    if (rr < n_rows) {
                        float sum = 0.0f;
                        for (int j = 0; j < fout; ++j)
                            sum = fmaf(g(0, j, ri), w_s[j * finpad + k], sum);
                        gx[rr * D + k] = sum;
                    }
                }
                // phase: gwt
                break;
            }

            // G W_l^T: cotangents of layer l's inputs, turned into those of
            // layer l - 1's pre-activations, with s = sin(w z) the input h
            // (a_t channel 0) and w cos(w z) where z was
            for (int c0 = team * BWD_CG; c0 < finpad; c0 += n_team * BWD_CG) {
                float acc[C][BWD_CG];
                tile_product<C, BWD_CG>(g, r, fout, w_s, finpad, c0, acc);
#pragma unroll
                for (int j = 0; j < BWD_CG; ++j) {
                    const int col = c0 + j;
                    if (col >= fin) continue;
                    const float s = a_t(0, col, r);
                    const float wc = sp(0, col, r);
                    const float lz = sp(C - 1, col, r);
                    const float gl = acc[C - 1][j];
                    float q = 0.0f;
                    float gjz = 0.0f;
#pragma unroll
                    for (int a = 0; a < D; ++a) {
                        const float jz = sp(1 + a, col, r);
                        q = fmaf(jz, jz, q);
                        gjz = fmaf(acc[1 + a][j], jz, gjz);
                    }
                    a_t(0, col, r) = acc[0][j] * wc - w2 * s * gjz
                                     - gl * (w2 * s * lz + w2 * wc * q);
#pragma unroll
                    for (int a = 0; a < D; ++a)
                        a_t(1 + a, col, r) = acc[1 + a][j] * wc
                                             - 2.0f * w2 * s * gl * sp(1 + a, col, r);
                    a_t(C - 1, col, r) = gl * wc;
                }
            }
            __syncthreads();
            // phase: gwt
            const Tile t = g;
            g = a_t;
            a_t = t;
        }
        // every thread is done with this tile's buffers
        __syncthreads();
        // phase: gwt
    }
    // phase: end
}

// gparams[p] = the sum over the backward's blocks of partial[block][p]: a
// block takes RED_PARAMS parameters; RED_GROUPS threads per parameter sum
// the blocks g, g + RED_GROUPS, ... in order, then thread 0 of each
// parameter sums the groups' sums in order (dynamic shared memory of
// THREADS floats).
__global__ void __launch_bounds__(THREADS)
vgl_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int n_blocks, int n_params) {
    extern __shared__ float4 smem4[];
    float* sums = reinterpret_cast<float*>(smem4);
    const int pl = threadIdx.x % RED_PARAMS;
    const int grp = threadIdx.x / RED_PARAMS;
    const int p = blockIdx.x * RED_PARAMS + pl;
    float sum = 0.0f;
    if (p < n_params) {
#pragma unroll 8
        for (int b = grp; b < n_blocks; b += RED_GROUPS)
            sum += __ldg(partial + static_cast<long long>(b) * n_params + p);
    }
    sums[threadIdx.x] = sum;
    __syncthreads();
    if (grp == 0 && p < n_params) {
        float total = sums[pl];
        for (int q = 1; q < RED_GROUPS; ++q) total += sums[q * RED_PARAMS + pl];
        out[p] = total;
    }
}

// Validate the shape and fill everything but the row plan.
cudaError_t make_dims(int d, int n_layers, const int* widths, VglDims& dims) {
    if (d < 1 || d > MAX_D || n_layers < 1 || n_layers > MAX_LAYERS || widths[0] != d)
        return cudaErrorInvalidValue;
    dims.n_layers = n_layers;
    dims.d = d;
    dims.act_width = pad_cols(d);
    int offset = 0;
    for (int l = 0; l <= n_layers; ++l) {
        if (widths[l] < 1 || widths[l] > MAX_WIDTH) return cudaErrorInvalidValue;
        dims.width[l] = widths[l];
        if (pad_cols(widths[l]) > dims.act_width) dims.act_width = pad_cols(widths[l]);
    }
    for (int l = 0; l < n_layers; ++l) {
        dims.offset[l] = offset;
        offset += widths[l] * widths[l + 1] + widths[l + 1];
    }
    dims.n_params = offset;
    return cudaSuccess;
}

// Floats of one staged layer: W and b (the recompute), or W^T (the reverse
// sweep).
int weight_floats(const VglDims& dims) {
    int most = 0;
    for (int l = 0; l < dims.n_layers; ++l) {
        const int fin = dims.width[l];
        const int fout = dims.width[l + 1];
        int f = fin * pad_cols(fout) + pad_cols(fout);
        if (fout * pad_cols(fin) > f) f = fout * pad_cols(fin);
        if (f > most) most = f;
    }
    return most;
}

// Dynamic shared memory of a backward block of `rows` rows; fills
// s_off/s_total.
size_t smem_bytes(VglDims& dims, int rows) {
    const int C = dims.d + 2;
    const int rs = rows + 1;
    int s_total = 0;
    for (int l = 0; l < dims.n_layers - 1; ++l) {
        dims.s_off[l] = s_total;
        s_total += C * pad_cols(dims.width[l + 1]) * rs;
    }
    dims.s_total = s_total;
    return (static_cast<size_t>(s_total) + 2 * C * dims.act_width * rs
            + weight_floats(dims)) * sizeof(float);
}

// The backward's rows: the largest power of two, from 8 rows up, that lets
// BWD_BLOCKS_PER_SM blocks share an SM, else the largest whose buffers fit;
// 0 if none does.
size_t plan_rows(VglDims& dims) {
    const size_t shared = static_cast<size_t>(SM_SMEM / BWD_BLOCKS_PER_SM - BLOCK_RESERVED);
    if (shared < static_cast<size_t>(SMEM_LIMIT)) {
        for (int rows = MAX_ROWS; rows >= 8; rows /= 2) {
            const size_t bytes = smem_bytes(dims, rows);
            if (bytes <= shared) {
                dims.rows = rows;
                dims.rows_log2 = __builtin_ctz(rows);
                return bytes;
            }
        }
    }
    for (int rows = MAX_ROWS; rows >= 1; rows /= 2) {
        const size_t bytes = smem_bytes(dims, rows);
        if (bytes <= static_cast<size_t>(SMEM_LIMIT)) {
            dims.rows = rows;
            dims.rows_log2 = __builtin_ctz(rows);
            return bytes;
        }
    }
    return 0;
}

// The backward's grid, fixed by the shape: a block per tile up to
// BWD_GRID_MIN blocks, or up to as many as PARTIAL_FLOATS floats of
// partials hold (all 512 tiles of the pressure phase: no block adds to its
// partial); the blocks walk the rest of the tiles.
int bwd_grid(int n_rows, const VglDims& dims) {
    const int n_tiles = (n_rows + dims.rows - 1) / dims.rows;
    const int fit = PARTIAL_FLOATS / dims.n_params;
    const int cap = fit > BWD_GRID_MIN ? fit : BWD_GRID_MIN;
    return n_tiles < cap ? n_tiles : cap;
}

// The forward: the engine of csrc/sine_mlp_tile.cuh at d + 2 channels.
template <int D, int R>
__global__ void __launch_bounds__(sine_mlp::THREADS, sine_mlp::blocks_per_sm(R))
vgl_forward_kernel(const float* __restrict__ coords,
                   const float* __restrict__ packed, float* __restrict__ u,
                   float* __restrict__ jac, float* __restrict__ lap,
                   int n_rows, sine_mlp::Plan plan, float omega) {
    sine_mlp::forward_tiles<D, R>(coords, packed, u, jac, lap, n_rows, plan, omega);
}

template <int D>
cudaError_t launch_forward(const float* coords, const float* packed, float* u,
                           float* jac, float* lap, int n_rows,
                           const sine_mlp::Plan& plan, int R, size_t smem, int sms,
                           float omega, cudaStream_t stream) {
    static sine_mlp::LaunchCache cache[2];
    if (R == 1)
        return sine_mlp::launch_tiles(vgl_forward_kernel<D, 1>, plan, smem, sms, cache[0],
                                      stream, coords, packed, u, jac, lap, n_rows, plan,
                                      omega);
    return sine_mlp::launch_tiles(vgl_forward_kernel<D, FWD_R>, plan, smem, sms, cache[1],
                                  stream, coords, packed, u, jac, lap, n_rows, plan, omega);
}

// The backward on the tiles of `rows` rows, then the reduction.
template <int D, int MINB>
cudaError_t launch_backward(const float* coords, const float* packed,
                            const float* gu, const float* gjac,
                            const float* glap, float* partial, float* gparams,
                            float* gx, int n_rows, const VglDims& dims,
                            size_t smem, float omega, cudaStream_t stream) {
    static bool done[64] = {};
    cudaError_t err = allow_max_smem(vgl_backward_kernel<D, MINB>, done);
    if (err != cudaSuccess) return err;
    const int n_tiles = (n_rows + dims.rows - 1) / dims.rows;
    const int grid = bwd_grid(n_rows, dims);
    auto bwd = vgl_backward_kernel<D, MINB>;
    bwd<<<grid, THREADS, smem, stream>>>(coords, packed, gu, gjac, glap, partial, gx,
                                         n_rows, dims, n_tiles, omega);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const unsigned red_grid = (dims.n_params + RED_PARAMS - 1) / RED_PARAMS;
    vgl_reduce_kernel<<<red_grid, THREADS, THREADS * sizeof(float), stream>>>(
        partial, gparams, grid, dims.n_params);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_backward(const float* coords, const float* packed,
                            const float* gu, const float* gjac,
                            const float* glap, float* partial, float* gparams,
                            float* gx, int n_rows, const VglDims& dims,
                            size_t smem, float omega, cudaStream_t stream) {
    if (smem <= static_cast<size_t>(SM_SMEM / BWD_BLOCKS_PER_SM - BLOCK_RESERVED))
        return launch_backward<D, BWD_BLOCKS_PER_SM>(
            coords, packed, gu, gjac, glap, partial, gparams, gx, n_rows, dims, smem,
            omega, stream);
    return launch_backward<D, 1>(coords, packed, gu, gjac, glap, partial, gparams, gx,
                                 n_rows, dims, smem, omega, stream);
}

}  // namespace

// The number of weight-gradient partials the backward writes for this shape
// (the wrapper allocates blocks x n_params floats of scratch), or a negative
// cudaError_t if the kernels do not take the shape.
extern "C" int siren_vgl_backward_blocks(int n_rows, int d, int n_layers,
                                         const int* widths) {
    VglDims dims;
    cudaError_t err = make_dims(d, n_layers, widths, dims);
    if (err != cudaSuccess || n_rows < 1) return -static_cast<int>(cudaErrorInvalidValue);
    if (plan_rows(dims) == 0) return -static_cast<int>(cudaErrorInvalidValue);
    return bwd_grid(n_rows, dims);
}

// coords (n_rows, d) f32 row-major; packed = [W_0 (row-major), b_0, W_1,
// b_1, ...] f32; widths has n_layers + 1 entries, widths[0] = d. Writes
// u (n_rows, m), jac (n_rows, d, m), lap (n_rows, m), m = widths[n_layers].
// Launches on `stream`, allocates nothing, returns the cudaError_t (0 on
// success).
extern "C" int siren_vgl_forward_f32(const float* coords, const float* packed,
                                     float* u, float* jac, float* lap,
                                     int n_rows, int d, int n_layers,
                                     const int* widths, float omega,
                                     void* stream) {
    sine_mlp::Plan plan;
    cudaError_t err = sine_mlp::plan_layers(n_layers, widths, plan);
    if (err != cudaSuccess || d < 1 || d > MAX_D || widths[0] != d || n_rows < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_rows == 0) return 0;
    int sms = 0;
    err = sine_mlp::sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    int R = 0;
    const size_t smem = sine_mlp::choose_plan(plan, d + 2, FWD_R, n_rows, sms, &R);
    if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (d) {
        case 1: err = launch_forward<1>(coords, packed, u, jac, lap, n_rows, plan, R, smem, sms, omega, s); break;
        case 2: err = launch_forward<2>(coords, packed, u, jac, lap, n_rows, plan, R, smem, sms, omega, s); break;
        default: err = launch_forward<3>(coords, packed, u, jac, lap, n_rows, plan, R, smem, sms, omega, s); break;
    }
    return static_cast<int>(err);
}

// The backward of siren_vgl_forward_f32 for cotangents gu (n_rows, m),
// gjac (n_rows, d, m), glap (n_rows, m): gparams (n_params, the packed
// layout of `packed`) and gx (n_rows, d). `partial` is scratch of
// siren_vgl_backward_blocks(...) x n_params floats. Launches the sweep and
// the fixed-order reduction on `stream`, allocates nothing, returns the
// cudaError_t (0 on success).
extern "C" int siren_vgl_backward_f32(const float* coords, const float* packed,
                                      const float* gu, const float* gjac,
                                      const float* glap, float* partial,
                                      float* gparams, float* gx, int n_rows,
                                      int d, int n_layers, const int* widths,
                                      float omega, void* stream) {
    VglDims dims;
    cudaError_t err = make_dims(d, n_layers, widths, dims);
    if (err != cudaSuccess || n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = plan_rows(dims);
    if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (d) {
        case 1: err = launch_backward<1>(coords, packed, gu, gjac, glap, partial, gparams, gx, n_rows, dims, smem, omega, s); break;
        case 2: err = launch_backward<2>(coords, packed, gu, gjac, glap, partial, gparams, gx, n_rows, dims, smem, omega, s); break;
        default: err = launch_backward<3>(coords, packed, gu, gjac, glap, partial, gparams, gx, n_rows, dims, smem, omega, s); break;
    }
    return static_cast<int>(err);
}
