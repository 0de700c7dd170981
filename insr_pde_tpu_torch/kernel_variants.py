"""Designs that were measured against the committed kernels and not kept,
as text patches of the committed sources.

    python -m insr_pde_tpu_torch.kernel_phases KERNEL --variant NAME

builds `patched(KERNEL, NAME)` beside the committed source and times both
in one process. A patch is a list of (old, new) replacements; each `old`
must occur in the committed source exactly once, so a variant that no
longer applies fails loudly instead of measuring something else.

* siren_vgl `store_sc`: the backward keeps sin(w z) and w cos(w z) of every
  hidden unit beside Jz and Lz (d + 3 stored channels instead of d + 2: z,
  Jz, Lz), so that rebuilding a layer's inputs takes no sine; under the
  committed row plan (two blocks per SM) that leaves 16 rows a block at the
  pressure net.
* siren_vgl `store_sc_one_block`: the same with one block of 32 rows per SM.
* block_ell `no_ring`: mv without its ring of bulk-copied tiles, every
  shape on the lanes' own loads (the register version, which the committed
  source keeps for J = 1 and for S % 4 != 0).
* block_ell `ring_at_j1`: the ring at J = 1 only (S % 4 == 0; 4 slot ids
  a vector, 4 scalar gathers), the register version elsewhere; for
  `--shape ell`.
* siren_vgl `tf32x3`: the vgl forward's hidden-layer products on the tensor
  cores, 3xTF32 (each product a b as a_hi b_hi + a_hi b_lo + a_lo b_hi of
  TF32 halves, by mma.sync m16n8k8), a warp per 16-row m-tile and up to 4
  8-column n-tiles, every channel; the first layer (fin = d) and the last
  keep their fmaf sums. Not the same bits: its sums round elsewhere.

* siren_forward, siren_vgl `wide_r`: the forward engine's plan always at
  the wide row tile (8 rows a thread for the SIREN forward, 2 for the vgl
  forward) at one block per SM, never 1 row a thread at two blocks per SM.

A patch of the forward engine applies to the source with its headers
inlined (`cuda_build.source_text`), as `kernel_phases` builds it.
"""

from __future__ import annotations

_STORE_SC = [
    ("        s_total += C * pad_cols(dims.width[l + 1]) * rs;",
     "        s_total += (C + 1) * pad_cols(dims.width[l + 1]) * rs;"),
    ("                    st(0, col, r) = z;\n",
     "                    st(0, col, r) = s;\n"
     "                    st(C, col, r) = wc;\n"),
    ("                    float s, c;\n"
     "                    sincosf(omega * sp(0, k, ri), &s, &c);\n"
     "                    const float wc = omega * c;\n",
     "                    const float s = sp(0, k, ri);\n"
     "                    const float wc = sp(C, k, ri);\n"),
    ("                    sp(0, k, ri) = wc;\n", ""),
    ("                    const float wc = sp(0, col, r);",
     "                    const float wc = sp(C, col, r);"),
]

_RING_AT_J1 = [
    ("                        const int s = jv_shift >= 0 ? e >> jv_shift : e / jv_per_slot;\n"
     "                        const long long b = c[s];\n"
     "                        vv[u] = v[e];\n"
     "                        xv[u] = __ldg(reinterpret_cast<const float4*>(x + b * J)\n"
     "                                      + (e - s * jv_per_slot));\n",
     "                        const int4 b = reinterpret_cast<const int4*>(c)[e];\n"
     "                        vv[u] = v[e];\n"
     "                        xv[u] = make_float4(__ldg(x + b.x), __ldg(x + b.y),\n"
     "                                            __ldg(x + b.z), __ldg(x + b.w));\n"),
    ("    if (mode == MV_SLOT_VEC && S % 4 == 0 && ring_smem <= (size_t)SMEM_LIMIT)",
     "    if (mode == MV_SLOTS4 && ring_smem <= (size_t)SMEM_LIMIT)"),
]

_NO_RING = [
    ("    if (mode == MV_SLOT_VEC && S % 4 == 0 && ring_smem <= (size_t)SMEM_LIMIT)",
     "    if (false)"),
]

_TF32X3_LAYER = r"""// 3xTF32 products of one hidden layer by mma.sync (kernel_variants
// `tf32x3`), the unit rules on the fragments, the stores; false where the
// layer does not fit (fin % 8 != 0, a tile of too many rows for the warps).
__device__ inline void tf32_split(float x, unsigned& hi, unsigned& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    const float r = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

__device__ inline void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                const unsigned (&b)[2]) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int D>
__device__ inline bool tf32x3_layer(float* act, int aw, int rs, const float* w,
                                    int fin, int fpad, int rows, float omega) {
    constexpr int C = D == 0 ? 1 : D + 2;
    constexpr int NB = 4;
    const int n_mt = (rows + 15) / 16;
    const int n_nt = fpad / CG;
    const int groups = THREADS / 32 / n_mt;
    if (fin % 8 != 0 || groups == 0 || 16 * n_mt > rs) return false;
    const int nb = (n_nt + groups - 1) / groups;
    if (nb > NB) return false;
    const float* b = w + fin * fpad;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r0 = warp % n_mt * 16;
    const int nt0 = warp / n_mt * nb;
    const bool busy = warp / n_mt < groups;
    float acc[C][NB][4];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.0f;
    if (busy) {
        for (int k0 = 0; k0 < fin; k0 += 8) {
            unsigned bh[NB][2], bl[NB][2];
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                const int nt = nt0 + j < n_nt ? nt0 + j : n_nt - 1;
                const float* wk = w + (k0 + t) * fpad + nt * 8 + g;
                tf32_split(wk[0], bh[j][0], bl[j][0]);
                tf32_split(wk[4 * fpad], bh[j][1], bl[j][1]);
            }
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float* a = act + (c * aw + k0 + t) * rs + r0 + g;
                unsigned ah[4], al[4];
                tf32_split(a[0], ah[0], al[0]);
                tf32_split(a[8], ah[1], al[1]);
                tf32_split(a[4 * rs], ah[2], al[2]);
                tf32_split(a[4 * rs + 8], ah[3], al[3]);
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    if (j < nb) {
                        mma_tf32(acc[c][j], al, bh[j]);
                        mma_tf32(acc[c][j], ah, bl[j]);
                        mma_tf32(acc[c][j], ah, bh[j]);
                    }
                }
            }
        }
    }
    // phase[fwd]: products

#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (busy && j < nb && nt0 + j < n_nt)
                unit_rules<D>(acc, j, e, b[(nt0 + j) * 8 + 2 * t + (e & 1)], omega);
    // every thread is done reading the layer's inputs
    __syncthreads();
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = (nt0 + j) * 8 + 2 * t + (e & 1);
                if (busy && j < nb && nt0 + j < n_nt)
                    act[(c * aw + col) * rs + r0 + g + (e >> 1) * 8] = acc[c][j][e];
            }
    // phase[fwd]: epilogue
    return true;
}

"""

_TF32X3 = [
    ("// The forward of a tile walk.",
     _TF32X3_LAYER + "// The forward of a tile walk."),
    ("            if (l < n_layers - 1) {\n",
     "            if (l < n_layers - 1\n"
     "                && tf32x3_layer<D>(act, aw, rs, w, fin, fpad, rows, omega)) {\n"
     "            } else if (l < n_layers - 1) {\n"),
]

_WIDE_R = [
    ("    if (s_one > 0 && (s_wide == 0 || busy_threads(one, 1) > busy_threads(plan, r_wide))) {",
     "    if (false) {"),
]

VARIANTS = {
    "siren_forward": {"wide_r": _WIDE_R},
    "siren_vgl": {
        "wide_r": _WIDE_R,
        "store_sc": _STORE_SC,
        "store_sc_one_block": _STORE_SC + [
            ("constexpr int BWD_BLOCKS_PER_SM = 2;",
             "constexpr int BWD_BLOCKS_PER_SM = 1;")],
        "tf32x3": _TF32X3,
    },
    "block_ell": {"no_ring": _NO_RING, "ring_at_j1": _RING_AT_J1},
}


def patched(kernel: str, name: str, text: str) -> str:
    """`text` (the committed source of `kernel`) with the variant's
    replacements; raises if one does not apply exactly once."""
    try:
        patch = VARIANTS[kernel][name]
    except KeyError:
        raise ValueError(f"no variant {name!r} of {kernel!r}; known: "
                         f"{ {k: sorted(v) for k, v in VARIANTS.items()} }")
    for old, new in patch:
        n = text.count(old)
        if n != 1:
            raise ValueError(f"variant {kernel}/{name}: {old.strip()[:60]!r} "
                             f"occurs {n} times in the source, not once")
        text = text.replace(old, new)
    return text
