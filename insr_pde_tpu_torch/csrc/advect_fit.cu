// The 1D advection Adam fit, one chunk of iterations per launch, for Hopper
// (sm_90a), f32 throughout.
//
// Replaces the TPU kernel `kernel` of `fused_advect_fit`
// (tools/experiments/pallas_trainer.py:142, pallas_call :289), which runs the
// whole advect Adam loop of a sine SIREN u: R -> R in one kernel. Iteration
// `it` takes the collocation points x[it] (n) and boundary points xb[it] (nb)
// and computes, with u0 the frozen previous field,
//     r    = (u(x) - u0(x)) / dt + vel (u'(x) + u0'(x)) / 2
//     main = mean(r^2),   bc = mean(u(xb)^2)
// then the gradient of main + bc (u0' takes none), a bias-corrected Adam
// step scaled by the plateau LR scale, ReduceLROnPlateau on main and the
// early-stop latch, with the semantics of the port's Solver: Adam's count
// advances only on written iterations, a non-finite main or gradient skips
// the write, the latch freezes params, moments, count and scheduler state.
//
// The gradient is derived by hand, not by autodiff: the forward carries
// (h, dh = dh/dx) through each layer,
//     z = h W + b,  dz = dh W,  h' = sin(w z),  dh' = w cos(w z) dz,
// with cotangents gu = 2 r / (n dt), gdu = r vel / n per collocation point
// and gu = 2 u / nb per boundary point, and the reverse sweep is
//     gW = h^T gz + dh^T gdz,  gb = sum_rows gz,
//     gh = gz W^T,  gdh = gdz W^T,
//     gz_prev = gh w cos(w z) - gdh w^2 sin(w z) dz,  gdz_prev = gdh w cos(w z).
//
// What bounds it on this card: operations, barely. At the paper's 2x20 net
// (840 multiply-adds per point per evaluation) and 5,050 points an
// iteration is about 7e7 flops, about a microsecond of f32 work, and a few
// kilobytes of points; in this simple design the chain of dependent layers
// per row, the grid-wide barrier and the partial sums set the time.
//
// Design, and what it does about that:
//   * A cooperative grid (every block co-resident, sized from the occupancy
//     query and the SM count) whose blocks own tiles of `rows` rows of the
//     n + nb points, one thread per row. Each block keeps the params, the
//     previous params and Adam's moments in shared memory (901 floats each
//     at 2x20), and, per row, z and dz of every sine layer for the reverse
//     sweep.
//   * Each block sums its rows' weight gradients (threads over weight
//     elements, rows in order) and its rows' r^2 and u_b^2 into one partial,
//     and writes it to device memory. After ONE grid barrier per iteration
//     every block sums all partials in block order: every block gets the
//     same bits and applies the same Adam and plateau update to its own
//     copy. Block 0 alone writes the history and the final state. No
//     atomics in the sums: every run gives the same bits.
//   * The partials are double-buffered by iteration parity: a block cannot
//     pass the next iteration's barrier before every block has finished
//     reading this iteration's partials, so no partial is overwritten while
//     it is read.
//   * Shared-memory rows are stored column-major with a stride of rows + 1
//     (odd), so the per-row products read neighbouring banks and the
//     weight-gradient sums (one column of all rows) read distinct banks.
//   * f32 fmaf and precise sincosf (w z lies far outside [-pi, pi], where
//     fast sines are wrong); no tensor cores (the TPU kernel pins f32
//     products).

#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LAYERS = 16;
constexpr int MAX_WIDTH = 256;
constexpr int SMEM_LIMIT = 232448;              // 227 KB per block
constexpr int ROW_CHOICES[3] = {128, 64, 32};   // rows = threads per block

// f32 constants, in the order the wrapper passes them.
struct FitHyper {
    float dt, vel, lr, factor, keep, min_scale, stop_scale;
    float b1, one_minus_b1, b2, one_minus_b2, eps, omega;
};

struct FitDims {
    int n_layers;
    int rows;                   // rows per tile = threads per block
    int hidden;                 // widest layer: the buffers' column count
    int n_params;
    int n, nb;                  // collocation and boundary points per iteration
    int n_tiles;
    int width[MAX_LAYERS + 1];  // width[0] = 1, width[n_layers] = 1
    int offset[MAX_LAYERS];     // W_l at params + offset[l] (fin x fout), b_l after it
};

// Element (channel c, column k, row r) of a two-channel row buffer.
struct Buf {
    float* base;
    int cols;
    int rs;
    __device__ float& operator()(int c, int k, int r) const {
        return base[(c * cols + k) * rs + r];
    }
};

// u and du/dx of the net `w` at x for this thread's row r, through the
// buffers a and b (this row only); with `store`, z and dz of every sine
// layer l go to store[l].
__device__ void forward_row(const float* w, const FitDims& d, float x, Buf a,
                            Buf b, const Buf* store, int r, float omega,
                            float& u, float& du) {
    a(0, 0, r) = x;
    a(1, 0, r) = 1.0f;
    for (int l = 0; l < d.n_layers; ++l) {
        const int fin = d.width[l];
        const int fout = d.width[l + 1];
        const float* W = w + d.offset[l];
        const float* bias = W + fin * fout;
        const bool last = l == d.n_layers - 1;
        for (int j = 0; j < fout; ++j) {
            float z = 0.0f;
            float dz = 0.0f;
            for (int k = 0; k < fin; ++k) {
                z = fmaf(a(0, k, r), W[k * fout + j], z);
                dz = fmaf(a(1, k, r), W[k * fout + j], dz);
            }
            z += bias[j];
            if (last) {
                u = z;
                du = dz;
                continue;
            }
            if (store != nullptr) {
                store[l](0, j, r) = z;
                store[l](1, j, r) = dz;
            }
            float s, c;
            sincosf(omega * z, &s, &c);
            b(0, j, r) = s;
            b(1, j, r) = omega * c * dz;
        }
        const Buf t = a;
        a = b;
        b = t;
    }
}

// One tile of rows: forward of both nets, loss terms, cotangents and the
// reverse sweep; adds the tile's weight gradients and loss sums to g_s
// (assigns them for the block's first tile).
__device__ void fit_tile(const float* p_s, const float* q_s, float* g_s,
                         float* lm, float* lb, const Buf* store, Buf* bufs,
                         const FitDims& d, const FitHyper& hp,
                         const float* __restrict__ x_g,
                         const float* __restrict__ xb_g, int it, int tile,
                         bool first) {
    const int r = threadIdx.x;
    const int rows = d.rows;
    const int row = tile * rows + r;
    const bool colloc = row < d.n;
    const bool bound = !colloc && row < d.n + d.nb;
    const float x = colloc ? x_g[static_cast<long long>(it) * d.n + row]
                  : bound ? xb_g[static_cast<long long>(it) * d.nb + (row - d.n)]
                          : 0.0f;
    const float omega = hp.omega;

    float u0 = 0.0f, du0 = 0.0f, u = 0.0f, du = 0.0f;
    if (colloc) forward_row(q_s, d, x, bufs[0], bufs[1], nullptr, r, omega, u0, du0);
    forward_row(p_s, d, x, bufs[0], bufs[1], store, r, omega, u, du);

    float gu = 0.0f, gdu = 0.0f;
    lm[r] = 0.0f;
    lb[r] = 0.0f;
    if (colloc) {
        const float res = (u - u0) / hp.dt + hp.vel * (du + du0) / 2.0f;
        lm[r] = res * res;
        gu = 2.0f * res / static_cast<float>(d.n) / hp.dt;
        gdu = res * hp.vel / static_cast<float>(d.n);
    } else if (bound) {
        lb[r] = u * u;
        gu = 2.0f * u / static_cast<float>(d.nb);
    }
    Buf g = bufs[2];      // cotangents of the current layer's outputs
    Buf a = bufs[0];      // the current layer's inputs
    Buf gn = bufs[1];     // cotangents of the previous layer's outputs
    g(0, 0, r) = gu;
    g(1, 0, r) = gdu;
    __syncthreads();
    if (r == 0) {
        float sm = 0.0f, sb = 0.0f;
        for (int i = 0; i < rows; ++i) {
            sm += lm[i];
            sb += lb[i];
        }
        const int P = d.n_params;
        g_s[P] = first ? sm : g_s[P] + sm;
        g_s[P + 1] = first ? sb : g_s[P + 1] + sb;
    }

    for (int l = d.n_layers - 1; l >= 0; --l) {
        const int fin = d.width[l];
        const int fout = d.width[l + 1];
        const float* W = p_s + d.offset[l];
        // every thread is done reading the previous layer's inputs
        __syncthreads();
        if (l == 0) {
            a(0, 0, r) = x;
            a(1, 0, r) = 1.0f;
        } else {
            for (int k = 0; k < fin; ++k) {
                float s, c;
                sincosf(omega * store[l - 1](0, k, r), &s, &c);
                a(0, k, r) = s;
                a(1, k, r) = omega * c * store[l - 1](1, k, r);
            }
        }
        __syncthreads();

        // this tile's gW_l and gb_l, rows in order, at their packed offsets
        for (int e = r; e < (fin + 1) * fout; e += rows) {
            const int k = e / fout;
            const int j = e - k * fout;
            float sum = 0.0f;
            if (k < fin) {
                for (int i = 0; i < rows; ++i) {
                    sum = fmaf(a(0, k, i), g(0, j, i), sum);
                    sum = fmaf(a(1, k, i), g(1, j, i), sum);
                }
            } else {
                for (int i = 0; i < rows; ++i) sum += g(0, j, i);
            }
            float* p = g_s + d.offset[l] + e;
            *p = first ? sum : *p + sum;
        }
        if (l == 0) break;

        // cotangents of layer l - 1's z and dz, this row only
        for (int k = 0; k < fin; ++k) {
            float gh = 0.0f, gdh = 0.0f;
            for (int j = 0; j < fout; ++j) {
                gh = fmaf(g(0, j, r), W[k * fout + j], gh);
                gdh = fmaf(g(1, j, r), W[k * fout + j], gdh);
            }
            const float z = store[l - 1](0, k, r);
            const float dz = store[l - 1](1, k, r);
            float s, c;
            sincosf(omega * z, &s, &c);
            const float wc = omega * c;
            gn(0, k, r) = gh * wc - gdh * (omega * omega * s * dz);
            gn(1, k, r) = gdh * wc;
        }
        const Buf t = g;
        g = gn;
        gn = t;
    }
    // every thread is done with this tile's buffers
    __syncthreads();
}

__global__ void __launch_bounds__(128)
advect_fit_kernel(float* __restrict__ params_g, const float* __restrict__ prev_g,
                  float* __restrict__ mu_g, float* __restrict__ nu_g,
                  int* __restrict__ istate, float* __restrict__ fstate,
                  const float* __restrict__ x_g, const float* __restrict__ xb_g,
                  float* __restrict__ hist, float* __restrict__ partial,
                  int n_iters, FitDims d, FitHyper hp, int patience,
                  int early_stop) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int P = d.n_params;
    const int rows = d.rows;
    const int rs = rows + 1;
    const int H = d.hidden;
    float* p_s = smem;
    float* q_s = p_s + P;
    float* m_s = q_s + P;
    float* v_s = m_s + P;
    float* g_s = v_s + P;                       // P weight gradients + 2 loss sums
    float* rest = g_s + P + 4;
    Buf store[MAX_LAYERS];
    for (int l = 0; l < d.n_layers - 1; ++l) {
        store[l] = Buf{rest, H, rs};
        rest += 2 * H * rs;
    }
    Buf bufs[3];
    for (int i = 0; i < 3; ++i) {
        bufs[i] = Buf{rest, H, rs};
        rest += 2 * H * rs;
    }
    float* lm = rest;
    float* lb = lm + rs;

    const int tid = threadIdx.x;
    for (int i = tid; i < P; i += rows) {
        p_s[i] = params_g[i];
        q_s[i] = prev_g[i];
        m_s[i] = mu_g[i];
        v_s[i] = nu_g[i];
    }
    // the scheduler state: a copy in every thread, the same in every block
    int count = istate[0];
    int bad = istate[1];
    bool stopped = istate[2] != 0;
    float best = fstate[0];
    float scale = fstate[1];
    __syncthreads();

    cg::grid_group grid = cg::this_grid();
    const int G = gridDim.x;
    const long long stride = P + 2;
    for (int it = 0; it < n_iters; ++it) {
        bool first = true;
        for (int tile = blockIdx.x; tile < d.n_tiles; tile += G) {
            fit_tile(p_s, q_s, g_s, lm, lb, store, bufs, d, hp, x_g, xb_g, it,
                     tile, first);
            first = false;
        }
        float* mine = partial + ((it & 1) * static_cast<long long>(G) + blockIdx.x) * stride;
        for (int i = tid; i < P + 2; i += rows) mine[i] = first ? 0.0f : g_s[i];
        grid.sync();

        // every block: the same sums, in block order
        const float* all = partial + (it & 1) * static_cast<long long>(G) * stride;
        int ok = 1;
        for (int i = tid; i < P + 2; i += rows) {
            float s = 0.0f;
            // __ldcg: from L2, never a stale L1 line of two iterations ago
            for (int b = 0; b < G; ++b) s += __ldcg(all + b * stride + i);
            g_s[i] = s;
            if (i < P && !isfinite(s)) ok = 0;
        }
        const bool grads_ok = __syncthreads_and(ok) != 0;
        const float main = g_s[P] / static_cast<float>(d.n);
        const float bc = g_s[P + 1] / static_cast<float>(d.nb);
        const bool active = !stopped;
        if (blockIdx.x == 0 && tid == 0) {
            float* h = hist + 4LL * it;
            h[0] = active ? 1.0f : 0.0f;
            h[1] = hp.lr * scale;
            h[2] = bc;
            h[3] = main;
        }
        if (active && isfinite(main) && grads_ok) {
            const int count_n = count + 1;
            const float t = static_cast<float>(count_n);
            const float c1 = 1.0f - powf(hp.b1, t);
            const float c2 = 1.0f - powf(hp.b2, t);
            for (int i = tid; i < P; i += rows) {
                const float gi = g_s[i];
                const float m = hp.one_minus_b1 * gi + hp.b1 * m_s[i];
                const float v = hp.one_minus_b2 * (gi * gi) + hp.b2 * v_s[i];
                const float upd = -hp.lr * ((m / c1) / (sqrtf(v / c2) + hp.eps));
                m_s[i] = m;
                v_s[i] = v;
                p_s[i] = p_s[i] + upd * scale;
            }
            // ReduceLROnPlateau on main (mode min, rel threshold, cooldown 0)
            const bool improved = main < best * hp.keep;
            int bad_n = improved ? 0 : bad + 1;
            float scale_n = scale;
            if (bad_n > patience) {
                scale_n = fmaxf(scale * hp.factor, hp.min_scale);
                bad_n = 0;
            }
            if (improved) best = main;
            bad = bad_n;
            scale = scale_n;
            if (early_stop && scale_n <= hp.stop_scale) stopped = true;
            count = count_n;
        }
        // the update is done before the next iteration's forward reads p_s
        // and its tiles write g_s
        __syncthreads();
    }

    if (blockIdx.x == 0) {
        for (int i = tid; i < P; i += rows) {
            params_g[i] = p_s[i];
            mu_g[i] = m_s[i];
            nu_g[i] = v_s[i];
        }
        if (tid == 0) {
            istate[0] = count;
            istate[1] = bad;
            istate[2] = stopped ? 1 : 0;
            fstate[0] = best;
            fstate[1] = scale;
        }
    }
}

size_t smem_bytes(const FitDims& d, int rows) {
    const size_t rs = rows + 1;
    const size_t n_sine = d.n_layers - 1;
    return (5 * static_cast<size_t>(d.n_params) + 4
            + (n_sine + 3) * 2 * d.hidden * rs + 2 * rs) * sizeof(float);
}

// Validate the shape, fill the dims and the row plan; 0 if the kernel does
// not take the shape, else the dynamic shared memory of a block.
size_t make_dims(int n, int nb, int n_layers, const int* widths, FitDims& d) {
    if (n < 1 || nb < 1 || n_layers < 2 || n_layers > MAX_LAYERS
        || widths[0] != 1 || widths[n_layers] != 1)
        return 0;
    d.n_layers = n_layers;
    d.n = n;
    d.nb = nb;
    d.hidden = 1;
    int offset = 0;
    for (int l = 0; l <= n_layers; ++l) {
        if (widths[l] < 1 || widths[l] > MAX_WIDTH) return 0;
        d.width[l] = widths[l];
        if (widths[l] > d.hidden) d.hidden = widths[l];
    }
    for (int l = 0; l < n_layers; ++l) {
        d.offset[l] = offset;
        offset += widths[l] * widths[l + 1] + widths[l + 1];
    }
    d.n_params = offset;
    for (int rows : ROW_CHOICES) {
        const size_t bytes = smem_bytes(d, rows);
        if (bytes <= static_cast<size_t>(SMEM_LIMIT)) {
            d.rows = rows;
            d.n_tiles = (n + nb + rows - 1) / rows;
            return bytes;
        }
    }
    return 0;
}

// The co-resident grid: min(tiles, blocks per SM x SMs).
cudaError_t plan_grid(const FitDims& d, size_t smem, int* grid) {
    cudaError_t err = cudaFuncSetAttribute(
        advect_fit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    int dev = 0, per_sm = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, advect_fit_kernel,
                                                        d.rows, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int cap = per_sm * sms;
    if (cap < 1) return cudaErrorCooperativeLaunchTooLarge;
    *grid = d.n_tiles < cap ? d.n_tiles : cap;
    return cudaSuccess;
}

}  // namespace

// The grid advect_fit_f32 launches for n_rows = n + nb points per iteration
// (the wrapper allocates 2 x grid x (n_params + 2) floats of partials), or a
// negative cudaError_t if the kernel does not take the shape.
extern "C" int advect_fit_grid(int n_rows, int n_layers, const int* widths) {
    FitDims d;
    const size_t smem = make_dims(n_rows, 1, n_layers, widths, d);
    if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
    d.n_tiles = (n_rows + d.rows - 1) / d.rows;
    int grid = 0;
    const cudaError_t err = plan_grid(d, smem, &grid);
    return err == cudaSuccess ? grid : -static_cast<int>(err);
}

// n_iters Adam iterations in one cooperative launch on `stream`. params,
// mu, nu (n_params), istate int32 [count, bad, stopped] and fstate f32
// [best, scale] are read and written back; prev (n_params) is read;
// x (n_iters, n) and xb (n_iters, nb) are the points; hist (n_iters, 4)
// gets [active, lr, bc, main] per iteration; partial is scratch of
// 2 x advect_fit_grid(...) x (n_params + 2) floats. `hyper` holds dt, vel,
// lr, plateau factor, 1 - threshold, min scale, stop scale, b1, 1 - b1, b2,
// 1 - b2, eps, omega. Allocates nothing; returns the cudaError_t (0 on
// success).
extern "C" int advect_fit_f32(float* params, const float* prev, float* mu,
                              float* nu, int* istate, float* fstate,
                              const float* x, const float* xb, float* hist,
                              float* partial, int n_iters, int n, int nb,
                              int n_layers, const int* widths,
                              const float* hyper, int patience,
                              int early_stop, void* stream) {
    FitDims d;
    const size_t smem = make_dims(n, nb, n_layers, widths, d);
    if (smem == 0 || n_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n_iters == 0) return 0;
    FitHyper hp;
    float* fields[] = {&hp.dt, &hp.vel, &hp.lr, &hp.factor, &hp.keep,
                       &hp.min_scale, &hp.stop_scale, &hp.b1, &hp.one_minus_b1,
                       &hp.b2, &hp.one_minus_b2, &hp.eps, &hp.omega};
    for (int i = 0; i < 13; ++i) *fields[i] = hyper[i];
    int grid = 0;
    cudaError_t err = plan_grid(d, smem, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(d.rows);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, advect_fit_kernel, params, prev, mu, nu,
                             istate, fstate, x, xb, hist, partial, n_iters, d,
                             hp, patience, early_stop);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
