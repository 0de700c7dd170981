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
"""

from __future__ import annotations

_STORE_SC = [
    ("            s_total += C * pad_cols(dims.width[l + 1]) * rs;",
     "            s_total += (C + 1) * pad_cols(dims.width[l + 1]) * rs;"),
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

VARIANTS = {
    "siren_vgl": {
        "store_sc": _STORE_SC,
        "store_sc_one_block": _STORE_SC + [
            ("constexpr int BWD_BLOCKS_PER_SM = 2;",
             "constexpr int BWD_BLOCKS_PER_SM = 1;")],
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
