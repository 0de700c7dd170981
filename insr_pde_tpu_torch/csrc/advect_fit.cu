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
// kilobytes of points. What sets the time is latency: the chain of
// dependent layers per row, the grid-wide barrier and the sums across
// blocks. The first design (one thread per row, 128-row blocks, 40 blocks
// on 40 of the 132 SMs, every block re-summing all 40 partials) ran at ~90x
// the bound. This one:
//   * Spreads the rows: blocks of RB rows (the points cut into one tile per
//     SM, in steps of 8 rows: 40 rows and 127 blocks at the main chunk) and a
//     team of 8 threads per row. Each thread of a team computes the outputs
//     j = q, q + 8, ... (OUT of them, a template parameter, 3 at width 20)
//     of every layer with OUT independent chains in registers, reading the
//     row's activations (a broadcast within the team) and the weights from
//     shared memory; the team meets at __syncwarp between layers. The last
//     layer (one output) splits its inputs over the team and sums them by
//     a fixed butterfly of shuffles.
//   * Keeps per row and sine layer h, dh, w cos(w z) and dz, so the reverse
//     sweep computes no sine again.
//   * Computes the weight gradients as small products over the block's
//     rows: the thread (k, q) owns row k of the layer's (fin + 1) x fout
//     gradient (k = fin: the bias) at the columns q, q + 8, ... and
//     accumulates them in registers across the rows in order.
//   * Sums across blocks in two fixed-order levels: each block writes its
//     partial, and after a grid barrier each block sums a slice of the
//     elements over all partials (16 lanes per element take the partials in
//     strides, then a fixed butterfly) and writes the totals; after a
//     second barrier every block reads the P + 2 totals. Every block thus
//     reads the same bits and applies the same Adam and plateau update to
//     its own copy of the params; block 0 alone writes the history and the
//     final state. No atomics in any sum: every run gives the same bits.
//   * Partials and totals need no double buffer: a block writes the next
//     iteration's partial only after the second barrier, when every block
//     has summed this one, and the next totals only after the next first
//     barrier, when every block has read these.
//   * Row buffers are column-major with a row stride of RB + 4, so the 4
//     rows x 8 team members of a warp write 32 distinct banks.
//   * f32 fmaf and precise sincosf (w z lies far outside [-pi, pi], where
//     fast sines are wrong); no tensor cores (the TPU kernel pins f32
//     products).
// Every loop that surrounds a shuffle or a __syncwarp runs the same number
// of times in every thread of a warp. `// phase:` comments mark where the
// time of an iteration is split (`python -m insr_pde_tpu_torch.advect_phases`
// stamps a copy of this source there).

#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LAYERS = 16;
constexpr int TEAM = 8;                         // threads per row
constexpr int MAX_HIDDEN = 80;                  // TEAM x the largest OUT
constexpr int SMEM_LIMIT = 232448;              // 227 KB per block
constexpr int ROW_STEP = 8;                     // rows per block: a multiple of 8,
constexpr int MAX_ROWS = 64;                    // at most 64
constexpr int SPLIT = 16;                       // lanes per element of a cross-block sum

// f32 constants, in the order the wrapper passes them.
struct FitHyper {
    float dt, vel, lr, factor, keep, min_scale, stop_scale;
    float b1, one_minus_b1, b2, one_minus_b2, eps, omega;
};

struct FitDims {
    int n_layers;
    int rows;                   // rows per tile (RB); TEAM * rows threads per block
    int rs;                     // row stride of the buffers: rows + 4
    int hidden;                 // widest layer: the buffers' column count
    int n_params;
    int n, nb;                  // collocation and boundary points per iteration
    int n_tiles;
    int width[MAX_LAYERS + 1];  // width[0] = 1, width[n_layers] = 1
    int offset[MAX_LAYERS];     // W_l at params + offset[l] (fin x fout), b_l after it
};

// A sine layer's per-row values: column k of row r at c[(k * rs) + r].
struct Act {
    float* h;      // sin(w z)
    float* dh;     // w cos(w z) dz
    float* wc;     // w cos(w z)
    float* dz;
};

// A two-channel row buffer: (value, tangent) or (cotangent of z, of dz).
struct Pair {
    float* a;
    float* b;
};

// The row buffers of a block: the sine layers' Act, then two Pairs, each
// channel `col` = hidden x rs floats. Computed from the shared-memory base
// (not kept in arrays), so every access is a shared-memory load.
struct RowBufs {
    float* act0;
    float* pp0;
    int col;
    __device__ Act act(int l) const {
        float* b = act0 + 4 * l * col;
        return Act{b, b + col, b + 2 * col, b + 3 * col};
    }
    __device__ Pair pair(int i) const {
        float* b = pp0 + 2 * i * col;
        return Pair{b, b + col};
    }
};

// z and dz of the outputs j = q + TEAM i (i < OUT, j < fout) of a dense
// layer for row r: inputs (hin, dhin) columns of the buffers, or (x, 1)
// when hin is null (the first layer, fin = 1).
template <int OUT>
__device__ __forceinline__ void dense(const float* W, int fin, int fout,
                                      const float* hin, const float* dhin,
                                      float x, int rs, int r, int q,
                                      float (&z)[OUT], float (&dz)[OUT]) {
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
        z[i] = 0.0f;
        dz[i] = 0.0f;
    }
#pragma unroll 4
    for (int k = 0; k < fin; ++k) {
        const float h = hin != nullptr ? hin[k * rs + r] : x;
        const float dh = hin != nullptr ? dhin[k * rs + r] : 1.0f;
        const float* Wk = W + k * fout;
#pragma unroll
        for (int i = 0; i < OUT; ++i) {
            const int j = q + TEAM * i;
            if (j < fout) {
                z[i] = fmaf(h, Wk[j], z[i]);
                dz[i] = fmaf(dh, Wk[j], dz[i]);
            }
        }
    }
    const float* bias = W + fin * fout;
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
        const int j = q + TEAM * i;
        if (j < fout) z[i] += bias[j];
    }
}

// u and du/dx of the net `w` at x for row r, by the team (every member
// gets the same bits). With `store` (the trained net, kept for the reverse
// sweep) the sine layers' outputs go to the layers' Act, else through the
// ping-pong Pairs.
template <int OUT>
__device__ void net_forward(const float* w, const FitDims& d, float x,
                            const RowBufs& bufs, bool store, int r, int q,
                            float omega, float& u, float& du) {
    const int rs = d.rs;
    const float* hin = nullptr;
    const float* dhin = nullptr;
    for (int l = 0; l < d.n_layers - 1; ++l) {
        const int fin = d.width[l];
        const int fout = d.width[l + 1];
        float z[OUT], dz[OUT];
        dense<OUT>(w + d.offset[l], fin, fout, hin, dhin, x, rs, r, q, z, dz);
        const Act a = bufs.act(l);
        const Pair pr = bufs.pair(l & 1);
        float* hout = store ? a.h : pr.a;
        float* dhout = store ? a.dh : pr.b;
#pragma unroll
        for (int i = 0; i < OUT; ++i) {
            const int j = q + TEAM * i;
            if (j < fout) {
                float s, c;
                sincosf(omega * z[i], &s, &c);
                const float wc = omega * c;
                hout[j * rs + r] = s;
                dhout[j * rs + r] = wc * dz[i];
                if (store) {
                    a.wc[j * rs + r] = wc;
                    a.dz[j * rs + r] = dz[i];
                }
            }
        }
        __syncwarp();
        hin = hout;
        dhin = dhout;
    }
    // the last layer (one output): inputs k = q, q + TEAM, ... per member,
    // then a fixed butterfly over the team
    const int l = d.n_layers - 1;
    const int fin = d.width[l];
    const float* W = w + d.offset[l];
    float zs = 0.0f, dzs = 0.0f;
    for (int k = q; k < fin; k += TEAM) {
        zs = fmaf(hin[k * rs + r], W[k], zs);
        dzs = fmaf(dhin[k * rs + r], W[k], dzs);
    }
    for (int off = 1; off < TEAM; off <<= 1) {
        zs += __shfl_xor_sync(0xffffffffu, zs, off);
        dzs += __shfl_xor_sync(0xffffffffu, dzs, off);
    }
    u = zs + W[fin];
    du = dzs;
}

// One tile of rows: forward of both nets, loss terms, cotangents and the
// reverse sweep; adds the tile's weight gradients and loss sums to g_s
// (assigns them for the block's first tile).
template <int OUT>
__device__ void fit_tile(const float* p_s, const float* q_s, float* g_s,
                         float* lm, float* lb, float* xs,
                         const RowBufs& bufs, const FitDims& d, const FitHyper& hp,
                         const float* __restrict__ x_g,
                         const float* __restrict__ xb_g, int it, int tile,
                         bool first) {
    const int tid = threadIdx.x;
    const int r = tid / TEAM;
    const int q = tid % TEAM;
    const int rows = d.rows;
    const int rs = d.rs;
    const int row = tile * rows + r;
    const bool colloc = row < d.n;
    const bool bound = !colloc && row < d.n + d.nb;
    const float x = colloc ? x_g[static_cast<long long>(it) * d.n + row]
                  : bound ? xb_g[static_cast<long long>(it) * d.nb + (row - d.n)]
                          : 0.0f;
    const float omega = hp.omega;

    float u0 = 0.0f, du0 = 0.0f, u = 0.0f, du = 0.0f;
    net_forward<OUT>(q_s, d, x, bufs, false, r, q, omega, u0, du0);
    net_forward<OUT>(p_s, d, x, bufs, true, r, q, omega, u, du);

    float gu = 0.0f, gdu = 0.0f, m2 = 0.0f, b2 = 0.0f;
    if (colloc) {
        const float res = (u - u0) / hp.dt + hp.vel * (du + du0) / 2.0f;
        m2 = res * res;
        gu = 2.0f * res / static_cast<float>(d.n) / hp.dt;
        gdu = res * hp.vel / static_cast<float>(d.n);
    } else if (bound) {
        b2 = u * u;
        gu = 2.0f * u / static_cast<float>(d.nb);
    }
    // the last layer's output cotangents, for every row of the block; the
    // q-net's buffers are free again
    Pair cur = bufs.pair(0);
    Pair nxt = bufs.pair(1);
    if (q == 0) {
        lm[r] = m2;
        lb[r] = b2;
        xs[r] = x;
        cur.a[r] = gu;
        cur.b[r] = gdu;
    }
    __syncthreads();
    // phase: forward
    if (tid < 32) {
        // the tile's loss sums, rows in a fixed order
        float sm = 0.0f, sb = 0.0f;
        for (int i = tid; i < rows; i += 32) {
            sm += lm[i];
            sb += lb[i];
        }
        for (int off = 16; off > 0; off >>= 1) {
            sm += __shfl_xor_sync(0xffffffffu, sm, off);
            sb += __shfl_xor_sync(0xffffffffu, sb, off);
        }
        if (tid == 0) {
            const int P = d.n_params;
            g_s[P] = first ? sm : g_s[P] + sm;
            g_s[P + 1] = first ? sb : g_s[P + 1] + sb;
        }
    }
    // phase: loss

    for (int l = d.n_layers - 1; l >= 0; --l) {
        const int fin = d.width[l];
        const int fout = d.width[l + 1];
        const float* W = p_s + d.offset[l];
        // cur holds the cotangents of layer l's outputs for every row
        if (l > 0) {
            // cotangents of layer l - 1's z and dz, this row, units
            // k = q + TEAM i
            float gh[OUT], gdh[OUT];
#pragma unroll
            for (int i = 0; i < OUT; ++i) {
                gh[i] = 0.0f;
                gdh[i] = 0.0f;
            }
#pragma unroll 4
            for (int j = 0; j < fout; ++j) {
                const float gz = cur.a[j * rs + r];
                const float gdz = cur.b[j * rs + r];
#pragma unroll
                for (int i = 0; i < OUT; ++i) {
                    const int k = q + TEAM * i;
                    if (k < fin) {
                        gh[i] = fmaf(gz, W[k * fout + j], gh[i]);
                        gdh[i] = fmaf(gdz, W[k * fout + j], gdh[i]);
                    }
                }
            }
            const Act a = bufs.act(l - 1);
#pragma unroll
            for (int i = 0; i < OUT; ++i) {
                const int k = q + TEAM * i;
                if (k < fin) {
                    const int e = k * rs + r;
                    const float wc = a.wc[e];
                    nxt.a[e] = gh[i] * wc - gdh[i] * (omega * omega * a.h[e] * a.dz[e]);
                    nxt.b[e] = gdh[i] * wc;
                }
            }
        }
        // phase: reverse

        // this tile's gW_l and gb_l: thread (k, q) owns row k of the
        // (fin + 1) x fout gradient (k = fin: the bias) at the columns
        // j = q + TEAM i, accumulated over the rows in order
        const float* hin = l > 0 ? bufs.act(l - 1).h : xs;
        const float* dhin = l > 0 ? bufs.act(l - 1).dh : nullptr;
        for (int k = tid / TEAM; k <= fin; k += rows) {
            float acc[OUT];
#pragma unroll
            for (int i = 0; i < OUT; ++i) acc[i] = 0.0f;
            if (k < fin) {
#pragma unroll 4
                for (int i2 = 0; i2 < rows; ++i2) {
                    const float h = hin[k * rs + i2];
                    const float dh = dhin != nullptr ? dhin[k * rs + i2] : 1.0f;
#pragma unroll
                    for (int i = 0; i < OUT; ++i) {
                        const int j = q + TEAM * i;
                        if (j < fout) {
                            acc[i] = fmaf(h, cur.a[j * rs + i2], acc[i]);
                            acc[i] = fmaf(dh, cur.b[j * rs + i2], acc[i]);
                        }
                    }
                }
            } else {
#pragma unroll 4
                for (int i2 = 0; i2 < rows; ++i2) {
#pragma unroll
                    for (int i = 0; i < OUT; ++i) {
                        const int j = q + TEAM * i;
                        if (j < fout) acc[i] += cur.a[j * rs + i2];
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < OUT; ++i) {
                const int j = q + TEAM * i;
                if (j < fout) {
                    float* p = g_s + d.offset[l] + k * fout + j;
                    *p = first ? acc[i] : *p + acc[i];
                }
            }
        }
        // phase: grads
        // every thread is done with cur and has written nxt
        __syncthreads();
        const Pair t = cur;
        cur = nxt;
        nxt = t;
    }
}

template <int OUT>
__global__ void __launch_bounds__(TEAM * MAX_ROWS)
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
    const int rs = d.rs;
    const int H = d.hidden;
    const int nt = TEAM * d.rows;                // threads per block
    float* p_s = smem;
    float* q_s = p_s + P;
    float* m_s = q_s + P;
    float* v_s = m_s + P;
    float* g_s = v_s + P;                       // P weight gradients + 2 loss sums
    float* rest = g_s + P + 4;
    const RowBufs bufs{rest, rest + 4 * (d.n_layers - 1) * H * rs, H * rs};
    rest = bufs.pp0 + 4 * H * rs;
    float* lm = rest;
    float* lb = lm + rs;
    float* xs = lb + rs;

    const int tid = threadIdx.x;
    for (int i = tid; i < P; i += nt) {
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
    const int n_el = P + 2;
    float* total = partial + static_cast<long long>(G) * n_el;
    // this block's slice of the elements for the first-level sums
    const int per_block = (n_el + G - 1) / G;
    const int e0 = blockIdx.x * per_block;
    const int group = tid / SPLIT;
    const int gl = tid % SPLIT;
    const int n_groups = nt / SPLIT;
    const int rounds = (per_block + n_groups - 1) / n_groups;
    // phase: setup
    for (int it = 0; it < n_iters; ++it) {
        bool first = true;
        for (int tile = blockIdx.x; tile < d.n_tiles; tile += G) {
            fit_tile<OUT>(p_s, q_s, g_s, lm, lb, xs, bufs, d, hp, x_g, xb_g,
                          it, tile, first);
            first = false;
        }
        float* mine = partial + static_cast<long long>(blockIdx.x) * n_el;
        for (int i = tid; i < n_el; i += nt) mine[i] = first ? 0.0f : g_s[i];
        // phase: grads
        grid.sync();
        // phase: barrier

        // first level: the elements e0 .. e0 + per_block over every block's
        // partial; a group of SPLIT lanes per element, lane l of a group
        // taking the blocks l, l + SPLIT, ... in order, then a fixed
        // butterfly in the group. __ldcg: from L2, never a stale L1 line.
        for (int m = 0; m < rounds; ++m) {
            const int slot = group + m * n_groups;
            const int e = e0 + slot;
            const bool mine_e = slot < per_block && e < n_el;
            float s = 0.0f;
            if (mine_e) {
#pragma unroll 16
                for (int b = gl; b < G; b += SPLIT)
                    s += __ldcg(partial + static_cast<long long>(b) * n_el + e);
            }
            for (int off = SPLIT / 2; off > 0; off >>= 1)
                s += __shfl_xor_sync(0xffffffffu, s, off);
            if (mine_e && gl == 0) total[e] = s;
        }
        // phase: sum
        grid.sync();
        // phase: barrier

        int ok = 1;
#pragma unroll 8
        for (int i = tid; i < n_el; i += nt) {
            const float s = __ldcg(total + i);
            g_s[i] = s;
            if (i < P && !isfinite(s)) ok = 0;
        }
        const bool grads_ok = __syncthreads_and(ok) != 0;
        // phase: sum
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
#pragma unroll 8
            for (int i = tid; i < P; i += nt) {
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
        // phase: update
    }

    // phase: end
    if (blockIdx.x == 0) {
        for (int i = tid; i < P; i += nt) {
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

using KernelFn = void (*)(float*, const float*, float*, float*, int*, float*,
                          const float*, const float*, float*, float*, int,
                          FitDims, FitHyper, int, int);

// The instantiation for outputs per team member ceil(hidden / TEAM), rounded
// up to one that is built; null beyond MAX_HIDDEN.
KernelFn pick_kernel(int hidden) {
    const int out = (hidden + TEAM - 1) / TEAM;
    if (out <= 1) return advect_fit_kernel<1>;
    if (out <= 2) return advect_fit_kernel<2>;
    if (out <= 3) return advect_fit_kernel<3>;
    if (out <= 4) return advect_fit_kernel<4>;
    if (out <= 5) return advect_fit_kernel<5>;
    if (out <= 6) return advect_fit_kernel<6>;
    if (out <= 8) return advect_fit_kernel<8>;
    if (out <= 10) return advect_fit_kernel<10>;
    return nullptr;
}

size_t smem_bytes(const FitDims& d, int rows) {
    const size_t rs = rows + 4;
    const size_t n_sine = d.n_layers - 1;
    return (5 * static_cast<size_t>(d.n_params) + 4
            + (4 * n_sine + 4) * d.hidden * rs + 3 * rs) * sizeof(float);
}

// Validate the shape and fill the dims, with the rows per block left to
// plan_grid; 0 if the kernel does not take the shape, else the dynamic
// shared memory of a block at the fewest rows.
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
        if (widths[l] < 1 || widths[l] > MAX_HIDDEN) return 0;
        d.width[l] = widths[l];
        if (widths[l] > d.hidden) d.hidden = widths[l];
    }
    for (int l = 0; l < n_layers; ++l) {
        d.offset[l] = offset;
        offset += widths[l] * widths[l + 1] + widths[l + 1];
    }
    d.n_params = offset;
    const size_t bytes = smem_bytes(d, ROW_STEP);
    return bytes <= static_cast<size_t>(SMEM_LIMIT) ? bytes : 0;
}

// The row plan and the co-resident grid: the rows per block that cut the
// points into one tile per SM (rounded up to ROW_STEP, within ROW_STEP ..
// MAX_ROWS, less while the buffers do not fit), and min(tiles, blocks per
// SM x SMs) blocks. Sets d.rows, d.rs, d.n_tiles and the shared memory of a
// block.
cudaError_t plan_grid(FitDims& d, KernelFn kernel, size_t* smem, int* grid) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int n_rows = d.n + d.nb;
    const int per_tile = (n_rows + sms - 1) / sms;
    int rows = (per_tile + ROW_STEP - 1) / ROW_STEP * ROW_STEP;
    rows = rows < ROW_STEP ? ROW_STEP : rows > MAX_ROWS ? MAX_ROWS : rows;
    while (rows > ROW_STEP && smem_bytes(d, rows) > static_cast<size_t>(SMEM_LIMIT))
        rows -= ROW_STEP;
    d.rows = rows;
    d.rs = rows + 4;
    d.n_tiles = (n_rows + rows - 1) / rows;
    *smem = smem_bytes(d, rows);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        TEAM * rows, *smem);
    if (err != cudaSuccess) return err;
    const int cap = per_sm * sms;
    if (cap < 1) return cudaErrorCooperativeLaunchTooLarge;
    *grid = d.n_tiles < cap ? d.n_tiles : cap;
    return cudaSuccess;
}

}  // namespace

// The grid advect_fit_f32 launches for n_rows = n + nb points per iteration
// (the wrapper allocates 2 x grid x (n_params + 2) floats of scratch: the
// blocks' partials, then the totals), or a negative cudaError_t if the
// kernel does not take the shape.
extern "C" int advect_fit_grid(int n_rows, int n_layers, const int* widths) {
    FitDims d;
    if (n_rows < 2 || make_dims(n_rows - 1, 1, n_layers, widths, d) == 0)
        return -static_cast<int>(cudaErrorInvalidValue);
    KernelFn kernel = pick_kernel(d.hidden);
    size_t smem = 0;
    int grid = 0;
    const cudaError_t err = plan_grid(d, kernel, &smem, &grid);
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
    if (make_dims(n, nb, n_layers, widths, d) == 0 || n_iters < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_iters == 0) return 0;
    FitHyper hp;
    float* fields[] = {&hp.dt, &hp.vel, &hp.lr, &hp.factor, &hp.keep,
                       &hp.min_scale, &hp.stop_scale, &hp.b1, &hp.one_minus_b1,
                       &hp.b2, &hp.one_minus_b2, &hp.eps, &hp.omega};
    for (int i = 0; i < 13; ++i) *fields[i] = hyper[i];
    KernelFn kernel = pick_kernel(d.hidden);
    size_t smem = 0;
    int grid = 0;
    cudaError_t err = plan_grid(d, kernel, &smem, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(TEAM * d.rows);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, params, prev, mu, nu, istate, fstate,
                             x, xb, hist, partial, n_iters, d, hp, patience,
                             early_stop);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
