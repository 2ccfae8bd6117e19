#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s kernel-vs-plain tolerances, on one
CUDA card: ``python3 chip_mutants.py [GROUP ...] [--match TEXT]`` from the
repository root (``--match``: only the mutants whose name holds TEXT, and
each group's control)
(groups: ``egcl_allpairs``, ``egcl_params``, ``egcl_blocks``,
``egcl_wide``, ``egcl_f32``, ``egcl_blocks_f32``, ``egcl_f32_wide``,
``wide_nf``, ``edge_pipeline``, ``edge_pipeline_sm90``, ``edge_wide``,
``pair_energy``; all by default; ``wide_nf`` is the all-pairs EGCL's
wide-nf routes of both files and ``egcl_wide_nf.cuh`` (the projections,
the j-side sums, dh and dW1), read through the wrapper's entry points at
(nf, H, N, B) = (128, 128, 13, 64), (256, 256, 13, 64), (128, 128, 55,
16) and (200, 192, 147, 4) over two input seeds and over one of them again
beside a stream of 1 GiB copies, bf16 per element as ``step_errs`` reads
it, f32 against TOL / TOL_PARAM; a mutant of one file is read in that
file's dtype, of the shared header in bf16; ``edge_pipeline`` is the tiled f32
K5/K6 at H = 64 and 128, read at the shapes of chip_smoke.py's phase edge
that run them;
``edge_pipeline_sm90`` is the bf16 Hopper K5/K6, read at its bf16 shapes,
the outputs against TOL_EDGE and the parameter gradients' f32 sums
against TOL_PARAM, among them its shapes of 17 and 33 edge features (e W1
in two and three k16 steps); ``edge_wide`` is the K5/K6 of both files at
H = 192 and 256 with W2 and W3 streamed through a ring of slabs (and the
padded 96 and 160), read at chip_smoke.py's phase edge_wide shapes
(EDGE_WIDTHS x EDGE_WIDE_SHAPES, each shape at its ``widths``) over two
input seeds and over one of
them again beside a stream of 1 GiB copies: bf16 per element as
``edge_step_errs`` reads it, f32 against TOL_EDGE / TOL_PARAM; a mutant of
one file is read in that file's dtype only; ``egcl_allpairs`` is the
bf16 Hopper K1 and K2 of ``egcl_allpairs_sm90.cu``, read at chip_smoke.py's
main, ragged and large shapes; ``egcl_params`` is its bf16
parameter-gradient variant in the same file, read at the vi, ico, ragged
and large shapes; ``egcl_blocks`` is the bf16 block-pair K1, K2 and K2 p
in the same file (molecules past one warpgroup's shared memory), read at
chip_smoke.py's BLOCKS_SHAPES, the outputs against TOL and the parameter
gradients' f32 sums against TOL_PARAM; ``egcl_wide`` is the same
kernels at H = 192 and 256 with W2 and W3 streamed through a ring of
slabs, read at N = 13, 55 and 147 over two input seeds, and over one of
them again while a second stream copies 1 GiB buffers (a fault of the
ring's timing shows only where a slab's copy is late), each output and
parameter gradient per element as chip_smoke.py's ``step_errs`` reads it
against STEP_TOL and TERMS_TOL; ``egcl_f32`` is the
tiled f32 K1,
K2 and K2 p of ``egcl_allpairs_f32.cu``, read at the dw4, ala2 and
ragged shapes; ``egcl_blocks_f32`` is the f32 block-pair K1, K2 and K2 p
in the same file (molecules past the tiled kernels' shared memory), read
at chip_smoke.py's f32_blocks_shapes(), the outputs against TOL and the
parameter gradients' f32 sums against TOL_PARAM; ``egcl_f32_wide`` is
the same f32 block-pair kernels at H = 192 and 256 with W2 and W3 streamed
through a ring of slabs (and K2 p's dW2 / dW3 kept in the block's slice),
read at N = 22 (nf = 4), 55 and 147 (nf = 5) over two input seeds and over
one of them again beside a stream of 1 GiB copies, the outputs against TOL
and the parameter gradients' f32 sums against TOL_PARAM; ``pair_energy``
is K7, read at every shape of phase pair).

For each mutant below, the package and ``chip_smoke.py`` are copied into a
temporary directory, one deliberate fault is written into the copy's CUDA
source, and a fresh process builds that copy and prints max |kernel -
plain| / max |plain| per output at ``chip_smoke.py``'s shapes -- the
reading ``chip_smoke.py`` holds against its tolerances (a non-finite
output reads as infinite). Each group's unmutated source runs first as the
control. The checkout itself is never modified.
"""

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# group -> {name: None (control), or an edit (text in the source, its
# replacement[, how often the text occurs: 1 unless given]), or a list of
# such edits}
MUTANTS = {
    "egcl_allpairs": {
        "control": None,
        "i-side sums drop each tile's last row": (
            "w.segi[r] = r < nr ? L.rw[k].i : -1;",
            "w.segi[r] = r < nr - 1 ? L.rw[k].i : -1;"),
        "j-side sums drop each tile's last row": (
            "w.segj[r] = r < nr ? L.rw[k].j : -1;",
            "w.segj[r] = r < nr - 1 ? L.rw[k].j : -1;"),
        "valid ignores mask_j (padded neighbours count)": (
            "r.valid = w.mask[i] * w.maskj[j];",
            "r.valid = w.mask[i];"),
        "r2 not rounded to the compute dtype before w1r": (
            "return add2(z, mul2(bcast(r.r2), wr));",
            "return add2(z, to_bf2(r.r2 * __low2float(wr), "
            "r.r2 * __high2float(wr)));"),
        "a molecule's last partial tile dropped (floor for ceil)": (
            "return (E + kTile - 1) / kTile;",
            "return E / kTile;"),
    },
    "egcl_params": {
        "control": None,
        "dW2's K drops each tile's last row (m1 zeroed there)": (
            "*tile_at(w.D2, r, c) = m1;",
            "*tile_at(w.D2, r, c) = r == kTile - 1 ? bcast(0.f) : m1;"),
        "dz2 unmasked past the molecule's last row (m1 never is)": (
            "const bf2 dm = mul2(add2(acc2(d, p), da), L.valid2[p & 1]);",
            "const bf2 dm = mul2(add2(acc2(d, p), da), row0 + r < P.E ? "
            "L.valid2[p & 1] : bcast(1.f));"),
        "dw4 takes the rounded dgate": (
            "w.wrow[kTile + r] = dgr[k];",
            "w.wrow[kTile + r] = rnd1(dgr[k]);"),
        "dw1r takes the rounded r2": (
            "w.wrow[r] = L.rw[k].r2;",
            "w.wrow[r] = rnd1(L.rw[k].r2);"),
        "one slice of partials dropped (zeroed at the end)": (
            "                       v[(kVdw4 + 2) * H + c];\n  }",
            "                       v[(kVdw4 + 2) * H + c];\n  }\n"
            "  wg_sync(wg);\n  if (blockIdx.x == 0 && wg == 0)\n"
            "    for (int k = t; k < PL.P; k += kWG) part[k] = 0.f;"),
        "a molecule's last partial tile dropped (floor for ceil)": (
            "return (E + kTile - 1) / kTile;",
            "return E / kTile;"),
    },
    # the bf16 block-pair K1, K2 and K2 p (molecules past one warpgroup's
    # shared memory)
    "egcl_blocks": {
        "control": None,
        "the last j-block's partials left unwritten": (
            "      copy_rows(a.pj + (((size_t)b * nI + ib) * N + jb * A) * C,",
            "      if (jb + 1 < nI)\n"
            "      copy_rows(a.pj + (((size_t)b * nI + ib) * N + jb * A) * C,"),
        "the second kernel drops the first i-block's partials": (
            "for (int ib = 0; ib < nI; ++ib) v += pj[(size_t)ib * N * C + c];",
            "for (int ib = 1; ib < nI; ++ib) v += pj[(size_t)ib * N * C + c];"),
        "self-pairs skipped off the diagonal block pair too": (
            "j = jj + (P.diag && jj >= i);",
            "j = jj + (jj >= i);"),
        "dW1b from the i-block's atoms": (
            "add_h_outer<H>(part + PL.dW1b, w.hj, w.accj, nj, nf, t);",
            "add_h_outer<H>(part + PL.dW1b, w.h, w.accj, nj, nf, t);"),
        "a j-block's hB from W1a": (
            "pb = fmaf(w.hj[i * nf + k], s.W1b[k * H + c], pb);",
            "pb = fmaf(w.hj[i * nf + k], s.W1a[k * H + c], pb);"),
        "work items skipped (the grid stride one too long)": (
            "it += (long long)gridDim.x * nwg) {",
            "it += (long long)gridDim.x * nwg + 1) {", 2),
    },
    # the bf16 block pairs at H = 192 and 256, W2 and W3 streamed through
    # a ring of slabs
    "egcl_wide": {
        "control": None,
        "wrong slab index (the next group's columns)": (
            "const int prod = (s / G) % rg.nprod, g = s % G;",
            "const int prod = (s / G) % rg.nprod, g = (s + 1) % G;"),
        "a skipped barrier wait (the slab used before it has landed)": (
            "  cp_async_wait<kRing - 2>();\n  wg_publish(wg);\n"
            "  issue_slab<H>(rg, rg.s + kRing - 1, t);",
            "  wg_publish(wg);\n  issue_slab<H>(rg, rg.s + kRing - 1, t);"),
        "a slab ring of one (the next slab copied over the one in use)": (
            "__device__ __forceinline__ int slot_of(int s) { return s % kRing; }",
            "__device__ __forceinline__ int slot_of(int s) { return 0; }"),
        "W2^T's slabs taken from W3": (
            "const bf16* W = prod == 0 || prod == 3 ? rg.W2 : rg.W3;",
            "const bf16* W = prod == 0 ? rg.W2 : rg.W3;"),
    },
    # the tiled f32 K1 and K2 p. In f32 the compute-dtype rounding is the
    # identity, so "the rounded dgate" is written as dgate cut to bf16's 8
    # mantissa bits (truncated), the rounding the bf16 path takes there.
    "egcl_f32": {
        "control": None,
        "i-side sums drop each tile's last row": (
            "const int re = min((l + 1) * K - g0, nr);",
            "const int re = min((l + 1) * K - g0, nr - 1);"),
        "j-side sums drop each tile's last row": (
            "const int lo = max(g0, e0), hi = min(g0 + nr, e0 + E);",
            "const int lo = max(g0, e0), hi = min(g0 + nr - 1, e0 + E);"),
        "valid ignores mask_j (padded neighbours count)": (
            "s.valid[r] = mask[ai] * mask[aj];",
            "s.valid[r] = mask[ai];"),
        "a molecule straddling a row tile loses its rows in the second": (
            "s.valid[r] = mask[ai] * mask[aj];",
            "s.valid[r] = m * E < g0 ? 0.f : mask[ai] * mask[aj];"),
        "dW2's depth drops each tile's last row": (
            "outer<H>(X1, X2, nr, ky, nx, g.dW2);",
            "outer<H>(X1, X2, nr - 1, ky, nx, g.dW2);"),
        "dw4 takes the rounded dgate": (
            "g.pw4[u] = fmaf(g1[u], dgate, g.pw4[u]);",
            "g.pw4[u] = fmaf(g1[u], __uint_as_float(__float_as_uint(dgate) "
            "& 0xffff0000u), g.pw4[u]);"),
        # (K2 p and K2 share the line)
        "the next molecule tile prefetched from the current one": (
            "if (new_atoms) prefetch_atoms<H, true>(a, s, ab ^ 1, nxt.tile);",
            "if (new_atoms) prefetch_atoms<H, true>(a, s, ab ^ 1, cur.tile);",
            2),
        "the weights' swizzle off by one row on load": (
            "const int dst = r * H + ((kc ^ ((r >> 2) & 7)) << 2);",
            "const int dst = r * H + ((kc ^ (((r + 1) >> 2) & 7)) << 2);"),
        # the input-gradient K2 (egcl_f32_bwd_kernel) alone
        "K2: a row tile's last row dropped from the i-side sums": (
            "isum_rows(si, A, s.rd, V, g0, nr, N, NT);",
            "isum_rows(si, A, s.rd, V, g0, nr - 1, N, NT);"),
        "K2: a row tile's last row dropped from the j-side sums": (
            "jsum_rows(sj, A, s.rd + nf, V, g0, nr, N, NT);",
            "jsum_rows(sj, A, s.rd + nf, V, g0, nr - 1, N, NT);"),
        "K2: a packed molecule's dh reads its neighbour's j-side sums": (
            "dh[it] = si[l * A + k] + sj[l * A + 3 + k];",
            "dh[it] = si[l * A + k] + sj[((l + N) % na) * A + 3 + k];"),
        "K2: dz1 W1b^T taken with W1a": (
            "(k < nf ? s.W1a + k * H : s.W1b + (k - nf) * H) + c0);",
            "(k < nf ? s.W1a + k * H : s.W1a + (k - nf) * H) + c0);"),
    },
    # the f32 block-pair K1, K2 and K2 p (molecules past the tiled f32
    # kernels' shared memory)
    "egcl_blocks_f32": {
        "control": None,
        "the last j-block's partials left unwritten": [
            ("      for (int k = tid; k < nj * A3; k += NT) pj[k] = sj[k];",
             "      if (jb + 1 < nI)\n"
             "      for (int k = tid; k < nj * A3; k += NT) pj[k] = sj[k];"),
            ("        pj[w] = x;", "        if (jb + 1 < nI) pj[w] = x;")],
        "the finish kernel drops the first i-block's partials": (
            "for (int ib = 0; ib < nI; ++ib) x += pj[(size_t)ib * N * A3 + v];",
            "for (int ib = 1; ib < nI; ++ib) x += pj[(size_t)ib * N * A3 + v];"),
        "self-pairs skipped off the diagonal block pair too": [
            ("const int aj = A + jj + (P.diag && jj >= i);",
             "const int aj = A + jj + (jj >= i);"),
            ("      if (P.diag && i == l) continue;",
             "      if (i == l) continue;"),
            ("const int g = i * P.ncol + l - (P.diag && l > i);",
             "const int g = i * P.ncol + l - (l > i);")],
        "dW1b from the i-block's atoms": (
            "for (int l = 0; l < nj; ++l) v = fmaf(hj[l * nf + k], "
            "dz1j[l * H + c], v);",
            "for (int l = 0; l < nj; ++l) v = fmaf(at[l * nf + k], "
            "dz1j[l * H + c], v);"),
        "work items skipped (the grid stride one too long)": (
            "for (long long it = blockIdx.x; it < items; it += gridDim.x) {",
            "for (long long it = blockIdx.x; it < items; "
            "it += gridDim.x + 1) {", 3),
    },
    # the f32 block pairs at H = 192 and 256, W2 and W3 streamed through a
    # ring of slabs, K2 p's dW2 / dW3 in the block's slice
    "egcl_f32_wide": {
        "control": None,
        "wrong slab index (the next slab's k)": (
            "const int prod = (s / G) % rg.nprod, g = s % G;",
            "const int prod = (s / G) % rg.nprod, g = (s + 1) % G;"),
        "a ring of one slot (the next slab copied over the one in use)": (
            "__device__ __forceinline__ int slot_of(int s) { return s % kRing; }",
            "__device__ __forceinline__ int slot_of(int s) { return 0; }"),
        "a skipped wait (the slab used before its copies have landed)": (
            "  cp_async_wait<kRing - 2>();\n  __syncthreads();\n"
            "  issue_slab<H>(rg, rg.s + kRing - 1);",
            "  __syncthreads();\n  issue_slab<H>(rg, rg.s + kRing - 1);"),
        "W2^T's slabs taken from W3": (
            "const float* W = prod == 0 || prod == 3 ? rg.W2 : rg.W3;",
            "const float* W = prod == 0 ? rg.W2 : rg.W3;"),
        "a dW partial written to the next slab's columns": (
            "*reinterpret_cast<float4*>(dW + k * H + n) =",
            "*reinterpret_cast<float4*>(dW + k * H + (n + 64) % H) ="),
    },
    # the wide-nf routes (each mutant names the file it edits): the header's
    # projection, sum, dh and dW1 kernels, read in bf16 (a fault of the
    # shared header shows in either dtype; the bf16 library builds in half
    # the f32 one's time), and each file's block pairs with PROJ
    "wide_nf": {
        "control": None,
        "a wrong k-chunk offset (W1's chunk one row down)": {
            "egcl_wide_nf.cuh": (
                "const int kb = kc + e / kBN, n = e % kBN;",
                "const int kb = kc + e / kBN + 1, n = e % kBN;")},
        "a skipped chunk (the second k-chunk's FMAs left out)": {
            "egcl_wide_nf.cuh": (
                "    chunk_fma(st.a[c & 1], st.b[c & 1], min(kBK, k1 - k0 - "
                "c * kBK), tm, tn,",
                "    if (c != 1)\n"
                "    chunk_fma(st.a[c & 1], st.b[c & 1], min(kBK, k1 - k0 - "
                "c * kBK), tm, tn,")},
        "W1a used for the j side": {
            "egcl_wide_nf.cuh": (
                "const int side = n0 / H, c0 = n0 - side * H;\n"
                "  const T* W = side ? W1b : W1a;",
                "const int side = n0 / H, c0 = n0 - side * H;\n"
                "  const T* W = W1a;")},
        "dz1 summed over one i-block's rows, not the atom's partners": {
            "egcl_wide_nf.cuh": (
                "for (int ib = 0; ib < nI; ++ib) v += p[(size_t)ib * N * C];",
                "for (int ib = nI - 1; ib < nI; ++ib) "
                "v += p[(size_t)ib * N * C];")},
        "a skipped chunk wait (the next chunk read before it is staged)": {
            "egcl_wide_nf.cuh": (
                "    if (more) put(st, (c + 1) & 1, ra, rb);\n"
                "    __syncthreads();",
                "    if (more) put(st, (c + 1) & 1, ra, rb);")},
        "bf16: hB's rows copied from hA's columns": {
            "egcl_allpairs_sm90": (
                "a.proj + (nb + i) * 2 * H + H + c);",
                "a.proj + (nb + i) * 2 * H + c);")},
        "f32: K2's dz1 not stored (the sums take dz3)": {
            "egcl_allpairs_f32": (
                "    if constexpr (PROJ)\n"
                "      *reinterpret_cast<float4*>(X0 + r * LD + c0) =\n"
                "          make_float4(d[0], d[1], d[2], d[3]);",
                "")},
    },
    # K5/K6 at H = 192 and 256 (each mutant names the file it edits)
    "edge_wide": {
        "control": None,
        "f32: wrong slab index (the next slab's k)": {"edge_pipeline": (
            "const int prod = (s / G) % rg.nprod, g = s % G;",
            "const int prod = (s / G) % rg.nprod, g = (s + 1) % G;")},
        "f32: a ring of one slot (the next slab copied over the one in "
        "use)": {"edge_pipeline": (
            "__device__ __forceinline__ int slot_of(int s) { return s % kRing; }",
            "__device__ __forceinline__ int slot_of(int s) { return 0; }")},
        "f32: W2^T's slabs taken from W3": {"edge_pipeline": (
            "const float* W = prod == 0 || prod == 3 ? rg.W2 : rg.W3;",
            "const float* W = prod == 0 ? rg.W2 : rg.W3;")},
        "f32: a dW partial written to the next slab's columns": {
            "edge_pipeline": (
                "*reinterpret_cast<float4*>(dW + k * H + n) =",
                "*reinterpret_cast<float4*>(dW + k * H + (n + 64) % H) =")},
        "f32: a skipped wait (the slab used before its copies have "
        "landed)": {"edge_pipeline": (
            "  cp_async_wait<kRing - 2>();\n  __syncthreads();\n"
            "  issue_slab<H>(rg, rg.s + kRing - 1);",
            "  __syncthreads();\n  issue_slab<H>(rg, rg.s + kRing - 1);")},
        "bf16: wrong slab index (the next slab of the stream)": {
            "edge_pipeline_sm90": (
                "const Slab sl = slab_of<H>(x % rg.per);",
                "const Slab sl = slab_of<H>((x + 1) % rg.per);")},
        "bf16: a ring of one slot (the next slab copied over the one in "
        "use)": {"edge_pipeline_sm90": [
            ("(char*)rg.slots + (size_t)(x % kRing) *",
             "(char*)rg.slots + (size_t)0 *"),
            ("at[k] = smem_addr(rg.slots) + ((rg.s + k) % kRing) * kSlot;",
             "at[k] = smem_addr(rg.slots);")]},
        "bf16: W2^T's slabs taken from W3": {"edge_pipeline_sm90": (
            "return Slab{false, true, j - 5 * G};",
            "return Slab{true, true, j - 5 * G};")},
        "bf16: a dW1 partial written to the next slab's columns": {
            "edge_pipeline_sm90": (
                "float* p = dW1 + c * H + h;",
                "float* p = dW1 + c * H + (h + 64) % H;")},
        "bf16: a skipped wait (the slab used before its copies have "
        "landed)": {"edge_pipeline_sm90": (
            "  cp_async_wait<0>();\n  wg_publish(wg);\n"
            "  if (rg.issued < rg.s + n) {",
            "  wg_publish(wg);\n  if (rg.issued < rg.s + n) {")},
    },
    # the tiled kernels (H = 64, 128, f32), which every f32 shape of phase
    # edge runs (h96 zero-padded to 128)
    "edge_pipeline": {
        "control": None,
        "K5: the K-sums drop each atom's last row of a tile": (
            "for (int r = rs; r < re; ++r) acc += src[r * ld + c];",
            "for (int r = rs; r < re - 1; ++r) acc += src[r * ld + c];"),
        "K6: the clip mask made inclusive": (
            "inside = (pre > -100.f && pre < 100.f) ? 1.f : 0.f;\n"
            "        const float dtr =",
            "inside = (pre >= -100.f && pre <= 100.f) ? 1.f : 0.f;\n"
            "        const float dtr ="),
        "a padded row counted (unmasked, in the outer products)": [
            ("return r < nr ? at(em, r) : 0.f;", "return at(em, r);"),
            ("outer<H>(X1, X0, nr, ky, nx, dW3);",
             "outer<H>(X1, X0, 8 * q, ky, nx, dW3);"),
            ("outer<H>(X1, X2, nr, ky, nx, dW2);",
             "outer<H>(X1, X2, 8 * q, ky, nx, dW2);")],
        "a block's slice left unwritten (block 0's dW3)": (
            "*reinterpret_cast<float4*>(part + L.dW3 + k * H + n) =",
            "if (blockIdx.x != 0)\n"
            "        *reinterpret_cast<float4*>(part + L.dW3 + k * H + n) ="),
        "a prefetched tile from the wrong rows (the current ones again)": (
            "prefetch_rows<T, H>(a, s, st ^ 1, nxt);",
            "prefetch_rows<T, H>(a, s, st ^ 1, cur);", 2),
        "the weights' swizzle off by one row on load": (
            "const int dst = r * H + ((kc ^ ((r >> 2) & 7)) << 2);",
            "const int dst = r * H + ((kc ^ (((r + 1) >> 2) & 7)) << 2);"),
    },
    # the bf16 Hopper kernels (H = 64, 128)
    "edge_pipeline_sm90": {
        "control": None,
        "K5: agg's K-sums drop each atom's last row": (
            "        for (int k = 0; k < K; ++k) {",
            "        for (int k = 0; k < K - 1; ++k) {"),
        "K6: the clip mask made inclusive": (
            "(raw > -100.f && raw < 100.f)",
            "(raw >= -100.f && raw <= 100.f)"),
        "m1 rounded toward zero, not to nearest": (
            "to_bf2(silu_t(d[2 * p] + b.x), silu_t(d[2 * p + 1] + b.y));",
            "__halves2bfloat162(__float2bfloat16_rz(silu_t(d[2 * p] + b.x)),"
            " __float2bfloat16_rz(silu_t(d[2 * p + 1] + b.y)));"),
        "dgate not rounded to bf16": (
            "dgr[k] = rnd1((pr[0] + pr[1]) + pr[2]);",
            "dgr[k] = (pr[0] + pr[1]) + pr[2];"),
        "a padded row's em read from the stage, not zero": (
            "L.em[k] = L.in[k] ? bf_bits(sem[r]) : 0.f;",
            "L.em[k] = bf_bits(sem[r]);"),
        "b2 left out of pre2's recompute in the backward": (
            "          const float2 b = load_f2(s.b2 + c);\n"
            "          const float2 da",
            "          const float2 b = make_float2(0.f, 0.f);\n"
            "          const float2 da"),
        "a warpgroup's first tile added into its unwritten slice": (
            "part, i == 0, dw1, rg);", "part, false, dw1, rg);"),
        "a prefetched tile from the wrong rows (the current ones again)": (
            "walk(a, g, S, i + 1),", "walk(a, g, S, i),"),
        "W2's rows swapped in pairs on load": (
            "(char*)s.W2 + swz(k, c, H)) = v2;",
            "(char*)s.W2 + swz(k ^ 1, c, H)) = v2;"),
        "the K-sum carry not reset at an atom's first tile (K > 64)": (
            "      if (!T.first) {", "      if (true) {"),
        "a column sum's lane adds into its neighbour's column": (
            "2 * L.q + (g & 1)] += s;", "2 * L.q + ((g & 1) ^ 1)] += s;"),
        # C > 16: e W1 in KC > 1 k16 steps
        "C > 16: the second k16 chunk of e W1 dropped (m1)": (
            "        mma_chunk<KC, 1>(d, E, W1, 16 * KC, n0);",
            "        mma_chunk<(KC > 1 ? 1 : KC), 1>(d, E, W1, 16 * KC, n0);"),
        "C > 16: de's later chunks read W1's first 16 rows": (
            "smem_desc(W1 + 2048 * cc + (kk / 4) * (128 * kCP) +",
            "smem_desc(W1 + 0 * cc + (kk / 4) * (128 * kCP) +"),
        "C > 16: a warpgroup's first tile of dW1 added into its unwritten "
        "slice": (
            "store_dw1<H, KC>(part + PL.dW1, a.C, tw, t, !fresh);",
            "store_dw1<H, KC>(part + PL.dW1, a.C, tw, t, true);"),
    },
    "pair_energy": {
        "control": None,
        "min-image wraps at exactly half a box (roundf's choice)": (
            "n[k] = a <= hb[k] ? 0.f : copysignf(1.f, d[k]);",
            "n[k] = a < hb[k] ? 0.f : copysignf(1.f, d[k]);"),
        "the min-image divide replaced by an unchecked reciprocal": [
            ("n[k] = a <= hb[k] ? 0.f : copysignf(1.f, d[k]);",
             "n[k] = rintf(d[k] * (1.0f / bx[k]));"),
            ("  if (exact) {", "  if (false) {")],
        "d2 = 0 pairs counted": (
            "bool valid = real && d2 > 0.f;", "bool valid = real;"),
        "the last column split dropped": (
            "const int count = a.splits == 1 ? nm * N : min(a.cols, N - c_first);",
            "const int count = a.splits == 1 ? nm * N\n"
            "      : s == a.splits - 1 ? 0 : min(a.cols, N - c_first);"),
        "a packed molecule's lanes cross into the next molecule": (
            "const int n = a.splits == 1 ? N : count;",
            "const int n = a.splits == 1 ? N + 1 : count;"),
    },
}

HEAD = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
def report(label, errs, tol):
    worst = max(r for _, r in errs.values())
    print(f"  {label}: " + "  ".join(f"{n} {r:.2e}" for n, (_, r) in
          errs.items()) + f"  | max {worst:.2e} vs tol {tol:g} -> "
          + ("caught" if worst > tol else "passes"), flush=True)
"""

# K5/K6 at the shapes of chip_smoke.py's phase edge that run the Hopper
# kernels (HOPPER True) or the others
EDGE_READ = HEAD + """
from enflow_tpu_torch.ops import edge_pipeline as ep
for sname, shape in cs.EDGE_SHAPES.items():
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        if (dname not in shape.get("dtypes", (dname,))
                or (ep.kernel_for(dt, shape["H"]) == "sm90") != HOPPER):
            continue
        e, cd, em, W, dagg, dfs, _ = cs.gathered_inputs(shape, dt, seed=13)
        k = (ep.edge_pipeline_fwd(e, cd, em, W)
             + ep.edge_pipeline_bwd(e, cd, em, W, dagg, dfs))
        p = (ep.edge_pipeline_plain(e, cd, em, *W)
             + ep.edge_pipeline_plain_bwd(e, cd, em, *W, dagg, dfs))
        errs = cs.rel_errs(cs.EDGE_OUT, k, p)
        report(f"{sname} {dname} agg, F_sum, de, dcd",
               {n: errs[n] for n in cs.EDGE_OUT[:4]}, cs.TOL_EDGE[dname])
        report(f"{sname} {dname} parameter gradients (f32 sums)",
               {n: errs[n] for n in cs.EDGE_OUT[4:]}, cs.TOL_PARAM[dname])
"""

READ = {
    "egcl_allpairs": HEAD + """
from enflow_tpu_torch.ops import egcl_allpairs as ops
large = dict(B=64, N=ops.largest_molecule(1, 5, 128, "bwd"), nf=5, H=128)
for sname, shape in (("main", cs.MAIN), ("ragged", cs.RAGGED),
                     ("large", large)):
    args = cs.edge_inputs(shape, torch.bfloat16, seed=11)[:7]
    _, errs = cs.kernel_errs(ops, *args)
    report(f"{sname} bfloat16", errs, cs.TOL["bfloat16"])
""",
    "egcl_params": HEAD + """
from enflow_tpu_torch.ops import egcl_allpairs as ops
large = dict(B=64, N=ops.largest_molecule(1, 5, 128, "bwd_params"), nf=5,
             H=128)
for sname, shape in (("vi", cs.VI), ("ico", cs.ICO), ("ragged", cs.RAGGED),
                     ("large", large)):
    h, pos, box, mf, W, dagg, dfs, _ = cs.edge_inputs(shape, torch.bfloat16,
                                                      seed=19)
    args = (h, pos, box, mf, W, dagg, dfs)
    errs = cs.rel_errs(cs.PARAM_OUT, ops.allpairs_edges_bwd(
        *args, params=True), ops.allpairs_edges_plain_bwd(*args, params=True))
    report(f"{sname} bfloat16", {n: e for n, e in errs.items()
                                 if n not in ("dh", "dpos")},
           cs.TOL_PARAM["bfloat16"])
""",
    "egcl_blocks": HEAD + """
from enflow_tpu_torch.ops import egcl_allpairs as ops
largest = {k: ops.largest_molecule(1, 5, 128, k)
           for k in ("fwd", "bwd", "bwd_params")}
names = {"fwd": ("agg", "f_sum"), "bwd": ("dh", "dpos"),
         "bwd_params": cs.PARAM_OUT}
for sname, base in cs.BLOCKS_SHAPES:
    for kind in ("fwd", "bwd", "bwd_params"):
        shape = dict(base)
        shape.setdefault("N", largest[kind] + 1)
        h, pos, box, mf, W, dagg, dfs, _ = cs.edge_inputs(
            shape, torch.bfloat16, seed=37)
        args = (h, pos, box, mf, W, dagg, dfs)
        if kind == "fwd":
            k = ops.allpairs_edges_fwd(h, pos, box, mf, W)
            p = ops.allpairs_edges_plain(h, pos, box, mf, W)
        else:
            k = ops.allpairs_edges_bwd(*args, params=kind == "bwd_params")
            p = ops.allpairs_edges_plain_bwd(*args,
                                             params=kind == "bwd_params")
        errs = cs.rel_errs(names[kind], k, p)
        report(f"{sname} {kind} outputs", {
            n: e for n, e in errs.items() if n not in cs.PARAM_OUT[2:]},
            cs.TOL["bfloat16"])
        if kind == "bwd_params":
            report(f"{sname} {kind} parameter gradients (f32 sums)",
                   {n: errs[n] for n in cs.PARAM_OUT[2:]},
                   cs.TOL_PARAM["bfloat16"])
        del k, p
        torch.cuda.empty_cache()
""",
    "egcl_wide": HEAD + """
from enflow_tpu_torch.ops import egcl_allpairs as ops
names = {"fwd": ("agg", "f_sum"), "bwd": ("dh", "dpos"),
         "bwd_params": cs.PARAM_OUT}
# a second stream copying 1 GiB buffers device to device while a kernel
# runs: the weight slabs' copies then compete for L2 and HBM
big = torch.empty(2 ** 28, device="cuda")
dst = torch.empty_like(big)
side = torch.cuda.Stream()
def stress():
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(40):
            dst.copy_(big)
for H, N, B in ((192, 13, 256), (192, 55, 64), (192, 147, 16),
                (256, 13, 256), (256, 55, 64), (256, 147, 16)):
    for seed, loaded in ((58, False), (59, False), (58, True)):
        h, pos, box, mf, W, dagg, dfs, _ = cs.edge_inputs(
            dict(B=B, N=N, nf=5, H=H, n_pad=2), torch.bfloat16, seed=seed)
        args = (h, pos, box, mf, W, dagg, dfs)
        for kind in ("fwd", "bwd", "bwd_params"):
            if loaded:
                stress()
            if kind == "fwd":
                k = ops.allpairs_edges_fwd(h, pos, box, mf, W)
                p = ops.allpairs_edges_plain(h, pos, box, mf, W)
            else:
                k = ops.allpairs_edges_bwd(*args, params=kind == "bwd_params")
                p = ops.allpairs_edges_plain_bwd(
                    *args, params=kind == "bwd_params")
            torch.cuda.synchronize()
            errs = cs.step_errs(names[kind], k, p, cs.plain_terms(args)
                                if kind == "bwd_params" else None)
            print(f"  H={H} N={N} B={B} seed {seed} {kind}"
                  + (" beside a copy stream" if loaded else "") + ": "
                  + cs.steps_text(errs) + " -> "
                  + ("passes" if cs.steps_ok(errs) else "caught"),
                  flush=True)
            del k, p
        torch.cuda.empty_cache()
""",
    "egcl_blocks_f32": HEAD + """
from enflow_tpu_torch.ops import egcl_allpairs as ops
names = {"fwd": ("agg", "f_sum"), "bwd": ("dh", "dpos"),
         "bwd_params": cs.PARAM_OUT}
for sname, kind, shape in cs.f32_blocks_shapes():
    h, pos, box, mf, W, dagg, dfs, _ = cs.edge_inputs(shape, torch.float32,
                                                      seed=37)
    args = (h, pos, box, mf, W, dagg, dfs)
    if kind == "fwd":
        k = ops.allpairs_edges_fwd(h, pos, box, mf, W)
        p = ops.allpairs_edges_plain(h, pos, box, mf, W)
    else:
        k = ops.allpairs_edges_bwd(*args, params=kind == "bwd_params")
        p = ops.allpairs_edges_plain_bwd(*args, params=kind == "bwd_params")
    errs = cs.rel_errs(names[kind], k, p)
    report(f"{sname} {kind} outputs", {
        n: e for n, e in errs.items() if n not in cs.PARAM_OUT[2:]},
        cs.TOL["float32"])
    if kind == "bwd_params":
        report(f"{sname} {kind} parameter gradients (f32 sums)",
               {n: errs[n] for n in cs.PARAM_OUT[2:]},
               cs.TOL_PARAM["float32"])
    del k, p
    torch.cuda.empty_cache()
""",
    "egcl_f32_wide": HEAD + """
from enflow_tpu_torch.ops import egcl_allpairs as ops
names = {"fwd": ("agg", "f_sum"), "bwd": ("dh", "dpos"),
         "bwd_params": cs.PARAM_OUT}
# a second stream copying 1 GiB buffers device to device while a kernel
# runs: the weight slabs' copies then compete for L2 and HBM
big = torch.empty(2 ** 28, device="cuda")
dst = torch.empty_like(big)
side = torch.cuda.Stream()
def stress():
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(40):
            dst.copy_(big)
for H, N, B, nf in ((192, 22, 64, 4), (256, 22, 64, 4), (192, 55, 16, 5),
                    (256, 55, 16, 5), (256, 147, 4, 5)):
    for seed, loaded in ((58, False), (59, False), (58, True)):
        h, pos, box, mf, W, dagg, dfs, _ = cs.edge_inputs(
            dict(B=B, N=N, nf=nf, H=H, n_pad=2), torch.float32, seed=seed)
        args = (h, pos, box, mf, W, dagg, dfs)
        for kind in ("fwd", "bwd", "bwd_params"):
            if loaded:
                stress()
            if kind == "fwd":
                k = ops.allpairs_edges_fwd(h, pos, box, mf, W)
                p = ops.allpairs_edges_plain(h, pos, box, mf, W)
            else:
                k = ops.allpairs_edges_bwd(*args, params=kind == "bwd_params")
                p = ops.allpairs_edges_plain_bwd(
                    *args, params=kind == "bwd_params")
            torch.cuda.synchronize()
            errs = cs.rel_errs(names[kind], k, p)
            label = (f"H={H} N={N} B={B} seed {seed} {kind}"
                     + (" beside a copy stream" if loaded else ""))
            report(f"{label} outputs", {
                n: e for n, e in errs.items() if n not in cs.PARAM_OUT[2:]},
                cs.TOL["float32"])
            if kind == "bwd_params":
                report(f"{label} parameter gradients (f32 sums)",
                       {n: errs[n] for n in cs.PARAM_OUT[2:]},
                       cs.TOL_PARAM["float32"])
            del k, p
        torch.cuda.empty_cache()
""",
    "egcl_f32": HEAD + """
from enflow_tpu_torch.ops import egcl_allpairs as ops
for sname, shape in (("dw4", cs.DW4), ("ala2", cs.ALA2),
                     ("ragged", cs.RAGGED)):
    h, pos, box, mf, W, dagg, dfs, _ = cs.edge_inputs(shape, torch.float32,
                                                      seed=23)
    args = (h, pos, box, mf, W, dagg, dfs)
    k = (ops.allpairs_edges_fwd(h, pos, box, mf, W)
         + ops.allpairs_edges_bwd(*args, params=True)
         + ops.allpairs_edges_bwd(*args))
    p = (ops.allpairs_edges_plain(h, pos, box, mf, W)
         + ops.allpairs_edges_plain_bwd(*args, params=True)
         + ops.allpairs_edges_plain_bwd(*args))
    errs = cs.rel_errs(("agg", "f_sum") + cs.PARAM_OUT + ("dh K2", "dpos K2"),
                       k, p)
    report(f"{sname} float32", errs, cs.TOL["float32"])
""",
    "edge_wide": HEAD + """
import os
from enflow_tpu_torch.ops import build
from enflow_tpu_torch.ops import edge_pipeline as ep
dnames = os.environ["MUTANT_DTYPES"].split(",")
build.build_all([{"float32": "edge_pipeline",
                  "bfloat16": "edge_pipeline_sm90"}[d] for d in dnames])
big = torch.empty(2 ** 28, device="cuda")
dst = torch.empty_like(big)
side = torch.cuda.Stream()
def stress():
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(40):
            dst.copy_(big)
for H in cs.EDGE_WIDTHS:
    for sname, base in cs.EDGE_WIDE_SHAPES.items():
        if H not in base.get("widths", (H,)):
            continue
        shape = dict(base, H=H)
        for dname in dnames:
            if dname not in shape.get("dtypes", (dname,)):
                continue
            dt = getattr(torch, dname)
            fwd_only = shape.get("fwd_only", False)
            for seed, loaded in ((61, False), (62, False), (61, True)):
                e, cd, em, W, dagg, dfs, _ = cs.gathered_inputs(shape, dt,
                                                                seed)
                if loaded:
                    stress()
                k = ep.edge_pipeline_fwd(e, cd, em, W)
                p = ep.edge_pipeline_plain(e, cd, em, *W)
                if not fwd_only:
                    k = k + ep.edge_pipeline_bwd(e, cd, em, W, dagg, dfs)
                    p = p + ep.edge_pipeline_plain_bwd(e, cd, em, *W, dagg,
                                                       dfs)
                torch.cuda.synchronize()
                names = cs.EDGE_OUT[:len(k)]
                label = (f"H={H} {sname} {dname} seed {seed}"
                         + (" beside a copy stream" if loaded else ""))
                if dname == "bfloat16":
                    errs = cs.edge_step_errs(names, k, p, None if fwd_only
                                             else cs.edge_wide_terms(
                                                 e, cd, em, W, dagg, dfs))
                    print(f"  {label}: " + cs.steps_text(errs) + " -> "
                          + ("passes" if cs.steps_ok(errs) else "caught"),
                          flush=True)
                else:
                    errs = cs.rel_errs(names, k, p)
                    report(f"{label} agg, F_sum, de, dcd",
                           {n: errs[n] for n in names[:4]},
                           cs.TOL_EDGE[dname])
                    if not fwd_only:
                        report(f"{label} parameter gradients (f32 sums)",
                               {n: errs[n] for n in names[4:]},
                               cs.TOL_PARAM[dname])
                del e, cd, em, W, dagg, dfs, k, p
                torch.cuda.empty_cache()
""",
    "wide_nf": HEAD + """
import os
from enflow_tpu_torch.ops import build
from enflow_tpu_torch.ops import egcl_allpairs as ops
dnames = os.environ["MUTANT_DTYPES"].split(",")
build.build_all([{"float32": "egcl_allpairs_f32",
                  "bfloat16": "egcl_allpairs_sm90"}[d] for d in dnames])
names = {"fwd": ("agg", "f_sum"), "bwd": ("dh", "dpos"),
         "bwd_params": cs.PARAM_OUT}
big = torch.empty(2 ** 28, device="cuda")
dst = torch.empty_like(big)
side = torch.cuda.Stream()
def stress():
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(40):
            dst.copy_(big)
for nf, H, N, B in ((128, 128, 13, 64), (256, 256, 13, 64),
                    (128, 128, 55, 16), (200, 192, 147, 4)):
    for dname in dnames:
        dt = getattr(torch, dname)
        code = 1 if dname == "bfloat16" else 0
        for seed, loaded in ((71, False), (72, False), (71, True)):
            h, pos, box, mf, W, dagg, dfs, _ = cs.edge_inputs(
                dict(B=B, N=N, nf=nf, H=H, n_pad=2), dt, seed=seed)
            args = (h, pos, box, mf, W, dagg, dfs)
            for kind in ("fwd", "bwd", "bwd_params"):
                assert ops.route_of(code, (B, N, nf, H), kind) == \\
                    ops.WIDE_NF_ROUTE[code]
                if loaded:
                    stress()
                if kind == "fwd":
                    k = ops.allpairs_edges_fwd(h, pos, box, mf, W)
                    p = ops.allpairs_edges_plain(h, pos, box, mf, W)
                else:
                    k = ops.allpairs_edges_bwd(*args,
                                               params=kind == "bwd_params")
                    p = ops.allpairs_edges_plain_bwd(
                        *args, params=kind == "bwd_params")
                torch.cuda.synchronize()
                label = (f"nf={nf} H={H} N={N} B={B} {dname} seed {seed} "
                         f"{kind}" + (" beside a copy stream" if loaded
                                      else ""))
                if code:
                    errs = cs.step_errs(names[kind], k, p, cs.plain_terms(
                        args) if kind == "bwd_params" else None)
                    print(f"  {label}: " + cs.steps_text(errs) + " -> "
                          + ("passes" if cs.steps_ok(errs) else "caught"),
                          flush=True)
                else:
                    errs = cs.rel_errs(names[kind], k, p)
                    report(f"{label} outputs", {
                        n: e for n, e in errs.items()
                        if n not in cs.PARAM_OUT[2:]}, cs.TOL["float32"])
                    if kind == "bwd_params":
                        report(f"{label} parameter gradients (f32 sums)",
                               {n: errs[n] for n in cs.PARAM_OUT[2:]},
                               cs.TOL_PARAM["float32"])
                del k, p
            torch.cuda.empty_cache()
""",
    "edge_pipeline": EDGE_READ.replace("HOPPER", "False"),
    "edge_pipeline_sm90": EDGE_READ.replace("HOPPER", "True"),
    "pair_energy": HEAD + """
from enflow_tpu_torch.ops import pair_energy as pe
for sname, shape in cs.PAIR_SHAPES.items():
    pos, mask, box = cs.pair_inputs(shape, seed=17)
    args = (pos, mask, box, shape["form"], shape["softening"],
            shape.get("cutoff"), shape.get("coincident", False))
    report(sname, cs.rel_errs(("E", "dE/dpos"), pe.pair_energy_and_grad(
        *args), pe.pair_energy_plain(*args)), cs.TOL_PAIR)
""",
}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    match = None
    if "--match" in args:
        k = args.index("--match")
        match = args[k + 1]
        del args[k:k + 2]
    groups = args or list(MUTANTS)
    for group in groups:
        source = {"egcl_allpairs": "egcl_allpairs_sm90",
                  "egcl_params": "egcl_allpairs_sm90",
                  "egcl_blocks": "egcl_allpairs_sm90",
                  "egcl_wide": "egcl_allpairs_sm90",
                  "egcl_f32": "egcl_allpairs_f32",
                  "egcl_blocks_f32": "egcl_allpairs_f32",
                  "egcl_f32_wide": "egcl_allpairs_f32"}.get(group, group)
        for name, edit in MUTANTS[group].items():
            if match and edit is not None and match not in name:
                continue
            # an edit names its file where the group spans two (edge_wide)
            edits = (edit if isinstance(edit, dict) else
                     {} if edit is None else {source: edit})
            with tempfile.TemporaryDirectory() as tmp:
                shutil.copytree(ROOT / "enflow_tpu_torch",
                                Path(tmp) / "enflow_tpu_torch",
                                ignore=shutil.ignore_patterns("_build",
                                                              "__pycache__"))
                shutil.copy(ROOT / "chip_smoke.py", tmp)
                for src_name, ed in edits.items():
                    src_rel = f"enflow_tpu_torch/csrc/{src_name}" + (
                        "" if src_name.endswith(".cuh") else ".cu")
                    src = Path(tmp) / src_rel
                    text = src.read_text()
                    for old, new, *times in ([] if ed is None else
                                             [ed] if isinstance(ed, tuple)
                                             else ed):
                        if text.count(old) != (times[0] if times else 1):
                            raise RuntimeError(
                                f"mutant '{name}': its text is not in "
                                f"{src_rel} as often as expected")
                        text = text.replace(old, new)
                    src.write_text(text)
                # edge_wide, wide_nf: a mutant is read in its file's dtype
                # only (wide_nf's header in bf16)
                dtypes = ",".join(
                    {"edge_pipeline": "float32",
                     "edge_pipeline_sm90": "bfloat16",
                     "egcl_allpairs_f32": "float32",
                     "egcl_allpairs_sm90": "bfloat16",
                     "egcl_wide_nf.cuh": "bfloat16"}.get(k, "")
                    for k in edits) if edit else "float32,bfloat16"
                print(f"[mutant] {group}: {name}", flush=True)
                subprocess.run([sys.executable, "-c", READ[group]], cwd=tmp,
                               check=True, env=dict(
                                   os.environ, MUTANT_DTYPES=dtypes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
