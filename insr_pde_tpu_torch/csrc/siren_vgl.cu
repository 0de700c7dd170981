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
// call is a few microseconds of f32 work, so launch latency and the latency
// of the layer chain inside a block set its time.
//
// Design, and what it does about that:
//   * A block owns `rows` rows (a power of two, at most 64) and 256 threads:
//     a team of 256 / rows threads per row, each computing every n-th group
//     of CG output columns, for all d + 2 channels at once, so that each
//     weight read from shared memory feeds d + 2 fmas.
//   * Activations, stored pre-activations and cotangents live in shared
//     memory channel- and column-major with a row stride of rows + 1 (odd):
//     the layer products read 32 neighbouring rows of one column (neighbouring
//     banks), and the weight-gradient sums read one row of 32 neighbouring
//     columns (stride rows + 1, again distinct banks).
//   * One layer's W and b (or W^T in the reverse sweep) are staged in shared
//     memory at a time, zero-padded to a multiple of CG columns. `rows` is
//     the largest power of two whose buffers fit the 227 KB a block may hold:
//     64 for the pressure net's backward (~204 KB: four hidden layers' z,
//     Jz, Lz of 64 rows), 8 for a 128-wide net's backward.
//   * The weight gradients are summed over all rows without atomics: a block
//     walks its tiles in order and keeps one partial (the packed layout
//     [W_0, b_0, W_1, ...]) in device memory that only it reads and writes;
//     vgl_reduce_kernel then sums the partials in block order. The grid of
//     the backward is fixed by the shape, so the result is the same bit for
//     bit from run to run.
//   * Cotangents are read as given: autograd's zeros for u and J in the
//     pressure loss ("L-only") are read, not skipped.
//   * No tensor cores: the TPU kernels pin Precision.HIGHEST, so products
//     stay f32 (fmaf). Precise sincosf, never __sinf/__cosf and never
//     fast-math: w z lies far outside [-pi, pi], and L carries w^2 and w^3
//     factors. wgmma/TMA and faster tiling are left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 64;      // rows per block at most
constexpr int CG = 8;             // output columns per register group
constexpr int MAX_WIDTH = 128;    // widest layer (as the TPU kernels' 128 lanes)
constexpr int MAX_LAYERS = 32;
constexpr int MAX_D = 3;
constexpr int SMEM_LIMIT = 232448;    // 227 KB of dynamic shared memory per block
constexpr int MAX_BWD_BLOCKS = 256;   // partials of the weight gradients

struct VglDims {
    int n_layers;
    int d;
    int rows;                     // rows per block (power of two)
    int act_width;                // widest padded layer, the in_dim included
    int n_params;                 // sum over layers of fin * fout + fout
    int s_total;                  // backward: floats of stored pre-activations
    int width[MAX_LAYERS + 1];    // width[0] = d, width[l + 1] = out of layer l
    int offset[MAX_LAYERS];       // W_l at packed + offset[l] (fin x fout), b_l after it
    int s_off[MAX_LAYERS];        // backward: z, Jz, Lz of hidden layer l in shared memory
};

__host__ __device__ inline int pad_cols(int n) { return (n + CG - 1) / CG * CG; }

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
// channels of row r: one pair of float4 weight loads feeds C * CG fmas.
template <int C>
__device__ inline void tile_product(const Tile& in, int r, int n_in,
                                    const float* w_s, int ld, int c0,
                                    float (&acc)[C][CG]) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < CG; ++j) acc[c][j] = 0.0f;
    for (int k = 0; k < n_in; ++k) {
        const float4 wa = *reinterpret_cast<const float4*>(w_s + k * ld + c0);
        const float4 wb = *reinterpret_cast<const float4*>(w_s + k * ld + c0 + 4);
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float a = in(c, k, r);
            acc[c][0] = fmaf(a, wa.x, acc[c][0]);
            acc[c][1] = fmaf(a, wa.y, acc[c][1]);
            acc[c][2] = fmaf(a, wa.z, acc[c][2]);
            acc[c][3] = fmaf(a, wa.w, acc[c][3]);
            acc[c][4] = fmaf(a, wb.x, acc[c][4]);
            acc[c][5] = fmaf(a, wb.y, acc[c][5]);
            acc[c][6] = fmaf(a, wb.z, acc[c][6]);
            acc[c][7] = fmaf(a, wb.w, acc[c][7]);
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

// Stage W_l (fin x fpad) and b_l (fpad) of the packed parameters.
__device__ inline void stage_layer(const float* __restrict__ W, int fin,
                                   int fout, float* w_s) {
    const int fpad = pad_cols(fout);
    const float* b = W + fin * fout;
    for (int i = threadIdx.x; i < fin * fpad; i += THREADS) {
        const int k = i / fpad;
        const int c = i - k * fpad;
        w_s[i] = c < fout ? W[k * fout + c] : 0.0f;
    }
    for (int c = threadIdx.x; c < fpad; c += THREADS)
        w_s[fin * fpad + c] = c < fout ? b[c] : 0.0f;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
vgl_forward_kernel(const float* __restrict__ coords,
                   const float* __restrict__ packed, float* __restrict__ u,
                   float* __restrict__ jac, float* __restrict__ lap,
                   int n_rows, VglDims dims, float omega) {
    constexpr int C = D + 2;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int rows = dims.rows;
    const int rs = rows + 1;
    const int aw = dims.act_width;
    Tile t_in{smem, aw, rs};
    Tile t_out{smem + C * aw * rs, aw, rs};
    float* w_s = smem + 2 * C * aw * rs;

    const int tid = threadIdx.x;
    const int r = tid % rows;
    const int team = tid / rows;
    const int n_team = THREADS / rows;
    const long long row0 = static_cast<long long>(blockIdx.x) * rows;
    const long long row = row0 + r;
    const bool valid = row < n_rows;
    const float w2 = omega * omega;

    load_inputs<D>(coords, t_in, row0, n_rows, rows);
    for (int l = 0; l < dims.n_layers; ++l) {
        const int fin = dims.width[l];
        const int fout = dims.width[l + 1];
        const int fpad = pad_cols(fout);
        const float* b_s = w_s + fin * fpad;
        const bool last = l == dims.n_layers - 1;
        // every thread is done with the previous layer's W and input
        __syncthreads();
        stage_layer(packed + dims.offset[l], fin, fout, w_s);
        __syncthreads();

        for (int c0 = team * CG; c0 < fpad; c0 += n_team * CG) {
            float acc[C][CG];
            tile_product<C>(t_in, r, fin, w_s, fpad, c0, acc);
#pragma unroll
            for (int j = 0; j < CG; ++j) {
                const int col = c0 + j;
                const float z = acc[0][j] + b_s[col];
                if (!last) {
                    float s, c;
                    sincosf(omega * z, &s, &c);
                    const float wc = omega * c;
                    float q = 0.0f;
#pragma unroll
                    for (int a = 0; a < D; ++a) q = fmaf(acc[1 + a][j], acc[1 + a][j], q);
                    t_out(0, col, r) = s;
#pragma unroll
                    for (int a = 0; a < D; ++a) t_out(1 + a, col, r) = wc * acc[1 + a][j];
                    t_out(C - 1, col, r) = wc * acc[C - 1][j] - w2 * s * q;
                } else if (valid && col < fout) {
                    u[row * fout + col] = z;
#pragma unroll
                    for (int a = 0; a < D; ++a) jac[(row * D + a) * fout + col] = acc[1 + a][j];
                    lap[row * fout + col] = acc[C - 1][j];
                }
            }
        }
        const Tile t = t_in;
        t_in = t_out;
        t_out = t;
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
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
            for (int c0 = team * CG; c0 < fpad; c0 += n_team * CG) {
                float acc[C][CG];
                tile_product<C>(in, r, fin, w_s, fpad, c0, acc);
#pragma unroll
                for (int j = 0; j < CG; ++j) {
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

        // 2. the cotangents of the linear last layer's outputs
        Tile g = t_p;
        Tile a_t = t_q;
        for (int i = tid; i < rows * m; i += THREADS) {
            const int ri = i % rows;
            const int col = i / rows;
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
            // the inputs h, J, L of layer l, from layer l - 1's z, Jz, Lz
            if (l == 0) {
                load_inputs<D>(coords, a_t, row0, n_rows, rows);
            } else {
                const Tile sp{s_base + dims.s_off[l - 1], finpad, rs};
                for (int i = tid; i < rows * fin; i += THREADS) {
                    const int ri = i % rows;
                    const int k = i / rows;
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
                }
            }
            // W_l^T, [fout][finpad], for the product with the cotangents
            for (int i = tid; i < fout * finpad; i += THREADS) {
                const int j = i / finpad;
                const int k = i - j * finpad;
                w_s[i] = k < fin ? W[k * fout + j] : 0.0f;
            }
            __syncthreads();

            // this tile's share of gW_l and gb_l, at their packed offsets
            for (int e = tid; e < (fin + 1) * fout; e += THREADS) {
                const int k = e / fout;
                const int j = e - k * fout;
                float sum = 0.0f;
                if (k < fin) {
#pragma unroll
                    for (int c = 0; c < C; ++c)
                        for (int ri = 0; ri < rows; ++ri)
                            sum = fmaf(a_t(c, k, ri), g(c, j, ri), sum);
                } else {
                    for (int ri = 0; ri < rows; ++ri) sum += g(0, j, ri);
                }
                float* p = part + dims.offset[l] + e;
                *p = first ? sum : *p + sum;
            }
            __syncthreads();

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
                break;
            }

            // G W_l^T: cotangents of layer l's inputs, turned into those of
            // layer l - 1's pre-activations
            const Tile sp{s_base + dims.s_off[l - 1], finpad, rs};
            for (int c0 = team * CG; c0 < finpad; c0 += n_team * CG) {
                float acc[C][CG];
                tile_product<C>(g, r, fout, w_s, finpad, c0, acc);
#pragma unroll
                for (int j = 0; j < CG; ++j) {
                    const int col = c0 + j;
                    float s, c;
                    sincosf(omega * sp(0, col, r), &s, &c);
                    const float wc = omega * c;
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
                                     - gl * (w2 * s * lz + omega * w2 * c * q);
#pragma unroll
                    for (int a = 0; a < D; ++a)
                        a_t(1 + a, col, r) = acc[1 + a][j] * wc
                                             - 2.0f * w2 * s * gl * sp(1 + a, col, r);
                    a_t(C - 1, col, r) = gl * wc;
                }
            }
            __syncthreads();
            const Tile t = g;
            g = a_t;
            a_t = t;
        }
        // every thread is done with this tile's buffers
        __syncthreads();
    }
}

// gparams[p] = sum over blocks, in block order, of partial[block][p].
__global__ void vgl_reduce_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int n_blocks,
                                  int n_params) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n_params) return;
    float sum = 0.0f;
    for (int b = 0; b < n_blocks; ++b)
        sum += partial[static_cast<long long>(b) * n_params + p];
    out[p] = sum;
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

// Floats of one staged layer: W and b, or W^T in the reverse sweep.
int weight_floats(const VglDims& dims, bool backward) {
    int most = 0;
    for (int l = 0; l < dims.n_layers; ++l) {
        const int fin = dims.width[l];
        const int fout = dims.width[l + 1];
        int f = fin * pad_cols(fout) + pad_cols(fout);
        if (backward && fout * pad_cols(fin) > f) f = fout * pad_cols(fin);
        if (f > most) most = f;
    }
    return most;
}

// Dynamic shared memory of a block of `rows` rows; fills s_off/s_total.
size_t smem_bytes(VglDims& dims, int rows, bool backward) {
    const int C = dims.d + 2;
    const int rs = rows + 1;
    int s_total = 0;
    if (backward) {
        for (int l = 0; l < dims.n_layers - 1; ++l) {
            dims.s_off[l] = s_total;
            s_total += C * pad_cols(dims.width[l + 1]) * rs;
        }
    }
    dims.s_total = s_total;
    return (static_cast<size_t>(s_total) + 2 * C * dims.act_width * rs
            + weight_floats(dims, backward)) * sizeof(float);
}

// The largest power-of-two row count whose buffers fit; 0 if none does.
size_t plan_rows(VglDims& dims, bool backward) {
    for (int rows = MAX_ROWS; rows >= 1; rows /= 2) {
        const size_t bytes = smem_bytes(dims, rows, backward);
        if (bytes <= static_cast<size_t>(SMEM_LIMIT)) {
            dims.rows = rows;
            return bytes;
        }
    }
    return 0;
}

int bwd_grid(int n_rows, int rows) {
    const int n_tiles = (n_rows + rows - 1) / rows;
    return n_tiles < MAX_BWD_BLOCKS ? n_tiles : MAX_BWD_BLOCKS;
}

// Raise a kernel's dynamic shared-memory limit once per device, at the first
// call, so that later calls (and CUDA graph captures) make no attribute call.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, bool* done) {
    constexpr int MAX_DEVICES = 64;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
    return err;
}

template <int D>
cudaError_t launch_forward(const float* coords, const float* packed, float* u,
                           float* jac, float* lap, int n_rows,
                           const VglDims& dims, size_t smem, float omega,
                           cudaStream_t stream) {
    static bool done[64] = {};
    const cudaError_t err = allow_max_smem(vgl_forward_kernel<D>, done);
    if (err != cudaSuccess) return err;
    const unsigned blocks = static_cast<unsigned>((n_rows + dims.rows - 1) / dims.rows);
    vgl_forward_kernel<D><<<blocks, THREADS, smem, stream>>>(
        coords, packed, u, jac, lap, n_rows, dims, omega);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_backward(const float* coords, const float* packed,
                            const float* gu, const float* gjac,
                            const float* glap, float* partial, float* gparams,
                            float* gx, int n_rows, const VglDims& dims,
                            size_t smem, float omega, cudaStream_t stream) {
    static bool done[64] = {};
    cudaError_t err = allow_max_smem(vgl_backward_kernel<D>, done);
    if (err != cudaSuccess) return err;
    const int n_tiles = (n_rows + dims.rows - 1) / dims.rows;
    const int grid = bwd_grid(n_rows, dims.rows);
    vgl_backward_kernel<D><<<grid, THREADS, smem, stream>>>(
        coords, packed, gu, gjac, glap, partial, gx, n_rows, dims, n_tiles, omega);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    vgl_reduce_kernel<<<(dims.n_params + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        partial, gparams, grid, dims.n_params);
    return cudaGetLastError();
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
    if (plan_rows(dims, true) == 0) return -static_cast<int>(cudaErrorInvalidValue);
    return bwd_grid(n_rows, dims.rows);
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
    VglDims dims;
    cudaError_t err = make_dims(d, n_layers, widths, dims);
    if (err != cudaSuccess || n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = plan_rows(dims, false);
    if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n_rows == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (d) {
        case 1: err = launch_forward<1>(coords, packed, u, jac, lap, n_rows, dims, smem, omega, s); break;
        case 2: err = launch_forward<2>(coords, packed, u, jac, lap, n_rows, dims, smem, omega, s); break;
        default: err = launch_forward<3>(coords, packed, u, jac, lap, n_rows, dims, smem, omega, s); break;
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
    const size_t smem = plan_rows(dims, true);
    if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (d) {
        case 1: err = launch_backward<1>(coords, packed, gu, gjac, glap, partial, gparams, gx, n_rows, dims, smem, omega, s); break;
        case 2: err = launch_backward<2>(coords, packed, gu, gjac, glap, partial, gparams, gx, n_rows, dims, smem, omega, s); break;
        default: err = launch_backward<3>(coords, packed, gu, gjac, glap, partial, gparams, gx, n_rows, dims, smem, omega, s); break;
    }
    return static_cast<int>(err);
}
