// Fused all-pairs EGCL edge pipeline in bf16, designed for Hopper
// (sm_90a): the forward, the input-gradient backward, and the backward
// with the nine parameter gradients, one molecule a warpgroup and, for
// molecules past that, over pairs of atom blocks.
//
// Replaces the Pallas TPU kernels of enflow_tpu/ops/egcl_fused_v3.py:
//   forward  -> the pallas_call of _fused_fwd (:365), _fwd_kernel
//   backward -> the pallas_call of _fused_bwd (:414), _bwd_kernel, in its
//               input-gradient form (dh and dpos; what sampling asks for)
//               and with the parameter gradients dW1a ... dw4 of
//               _bwd_kernel:256-273 (what training asks for)
// for the bf16 compute dtype at H = 64 or 128 (and, over block pairs, 192
// and 256). The contract, for all pairs i != j of real atoms of one
// molecule:
//   cd   = minimg(pos_i - pos_j)                (f32, round half to even)
//   z1   = h_i W1a + h_j W1b + b1 + |cd|^2 w1r  (compute dtype)
//   m2   = silu(silu(z1) W2 + b2) * valid       (compute dtype)
//   gate = silu(m2 W3 + b3) w4                  (f32)
//   agg_i  = sum_j m2,   f_sum_i = sum_j clip(cd*gate, +-100) * valid
// valid = mask_i * mask_j * (i != j); every product accumulates in f32,
// and values are rounded to bf16 at the points where _fwd_block /
// _bwd_kernel (egcl_fused_v3.py:167-254) round. The float32 kernels are
// egcl_allpairs_f32.cu; the wrapper zero-pads every other width up to the
// next of these four (ops/egcl_allpairs.py padded_width).
//
// What bounds it on this card. At the main-path shape (B=1024 molecules,
// N=13, nf=5, H=128) the tensor-core work is ~11 us (forward) and ~21 us
// (backward) at the bf16 peak. Every element of the H-wide activations
// also passes SiLU's sigmoid, an ex2 and a rcp on the MUFU: 6 operations
// per element forward, 8 backward (each SiLU derivative shares the
// recomputed forward's sigmoid, z1's is recomputed), at 16 per clock per
// SM ~29 and ~39 us over the 156 valid pairs of a molecule; and around
// them the adds, products and roundings of the TPU kernel's rounding
// points, ~22 and ~53 operations per element (~13 and ~32 us on the FP32
// lanes). chip_smoke.py prints these floors beside each kernel's time. With
// two or three warpgroups per SM the elementwise chains are latency-bound:
// the kernels run at several times these floors.
//
// Design:
// - Persistent blocks of up to 3 (forward) or 2 (backward) warpgroups,
//   fewer when a large molecule's per-atom arrays need the room, one block
//   per SM. A block stores W2 and W3 once, in bf16, in the 128-byte-
//   swizzled layout that wgmma reads (rows of 64-column halves, 128 bytes a
//   row). The forward reads that copy as an MN-major B operand (X W), the
//   backward as a K-major one (X W^T). No second copy.
// - Each warpgroup owns whole molecules: no state is shared between
//   warpgroups after the weights. A molecule's N(N-1) pairs i != j, in
//   i-major order (row q: i = q / (N-1), the q % (N-1)-th j != i), are
//   walked in 64-row tiles (wgmma's M); self-pairs are never visited (they
//   contribute exactly zero). A molecule fills whole tiles (N=13: 156 rows
//   in 3 tiles, 81%); a warp whose 16 rows all lie past the molecule's
//   last row skips its elementwise work. The warpgroups on an SM overlap
//   one's elementwise work with another's products.
// - Activations are bf16 [64, H] tiles in shared memory, in the same
//   swizzled layout, read by wgmma as its A operand (z1 is built from the
//   per-atom projections hA = h W1a, hB = h W1b, bf16). A product runs in
//   32-column chunks (m64n32k16, f32 accumulators in registers), two at a
//   time: one chunk's epilogue (rounding, bias, SiLU, valid mask, bf16
//   store into the next activation tile) runs while the tensor cores
//   compute the other. The chunk loop is not unrolled, which keeps the code
//   small for the instruction cache and the registers few enough for three
//   warpgroups. The bf16 adds and products run as bf16x2 instructions
//   (add.rn / mul.rn: one rounding each, the same value as an f32
//   operation rounded to bf16, as the exact sum or product of two bf16
//   values rounds once either way); SiLU and its derivative run in f32
//   with __expf and __fdividef (a few f32 ulps) before the bf16 rounding.
//   The backward stores rnd(dsilu(z2)) and rnd(dsilu(z3)) as the forward
//   recompute makes them, so the chain backwards needs no transcendental
//   but z1's. The gate's and dr2's row dots are in-thread f32 sums plus two
//   quad shuffles.
// - Node sums as products: agg_i (and in the backward dz1 on the i side
//   and on the j side) are S T, where T is the tile of bf16 rows (m2 or
//   dz1) already in shared memory and S the 0/1 matrix of which rows
//   belong to which atom (wgmma with S in registers); the per-row
//   3-vectors (trans, dcd) go through the same product. Each element of a
//   node sum has one owner thread and a fixed order: two launches give
//   identical bits.
//
// Parameter gradients: a compile-time variant of the backward
// (egcl_sm90_bwd_kernel<H, true>, bwd_tile's PARAMS) on the same schedule,
// tiles and rounding points; the nine gradients are f32 sums of the same
// bf16 products as _bwd_kernel's, reordered. At the VI shape (B=512, N=13,
// nf=5, H=128) they add ~5.5 GFLOP (the two H x H outer products over
// 79,872 valid pairs, ~5.6 us at the bf16 peak) to the input-gradient
// backward's ~10.6; the MUFU work is unchanged (4
// sigmoids per element) and the elementwise work grows from ~53 to ~59
// operations per element (m1's recompute, the partials' adds).
// - dW2 = m1^T dz2 and dW3 = m2^T dz3 on wgmma with the tile's 64 edge rows
//   as K: both operands are the activation tiles read MN-major (no
//   transposed copy). Rows past the molecule's last row hold zeros in dz2
//   and dz3 (and m2), and finite values in m1. The H x H results (2H^2 =
//   32,768 f32, more than a warpgroup's registers) go per m64n64 chunk
//   into the warpgroup's own slice of a [slices, P] f32 buffer in global
//   memory: stored on its first tile, read-modify-written after, every
//   element by one thread in a fixed order; the wrapper sums the slices.
//   That is ~256 KB of L2 traffic per tile (~400 MB over the VI shape's
//   1,536 tiles), with the old values loaded while the tensor cores run.
//   No atomics: two launches give identical bits.
// - Liveness, in three tiles: dz3 is written over dsilu(z3) in place, so
//   m2 lives in X1 until m2^T dz3; g1, which the recompute makes beside
//   dsilu(z3), goes to a scratch tile at the end of the warpgroup's slice
//   (16 KB, L2) and comes back into D2 once dz2 has consumed dsilu(z2);
//   the dz1 pass recomputes m1 into D2 from the sigmoid that its dsilu(z1)
//   takes anyway (no MUFU operation more), after dw4 has read g1.
// - Column sums as products: db2, db3 (rows of ones), dw1r (r2) and dw4
//   (dgate) are S T with T the dz2, dz3, dz1 or g1 tile and S in
//   registers. _bwd_kernel takes r2 and dgate unrounded (f32): each f32
//   weight becomes three rows of bf16 pieces whose sum is the weight
//   exactly, so the products are exact and only the f32 sums round.
//   dW1a = sum_i h_i (x) (sum_j dz1_ij) and dW1b likewise are h times the
//   node sums of dz1, per molecule (O(N nf H), not per pair); db1 is a
//   row of ones beside dw1r.
// - Shared memory: the variant reads dagg from global memory instead of
//   staging it, and adds 5 KB per warpgroup (row weights, vector sums),
//   so it takes two warpgroups at N=13 and one up to N=61 at nf=5, H=128.
//   The input-gradient backward keeps dagg staged: read from global
//   memory in the dz2 epilogue, it made that kernel ~5% slower at the
//   main-path shape (chip_smoke.py --ab against the staged source, one
//   process; PERF.md).
// The per-atom arrays bound N (egcl_sm90_smem_bytes; at nf=5, H=128 one
// warpgroup takes N <= 111 forward, N <= 55 backward and N <= 61 with
// parameter gradients).
//
// Larger molecules: the block-pair kernels (egcl_sm90_blocks_*), every N,
// on the same tiles, chunks, epilogues and rounding points. A molecule is
// cut into nI blocks of A atoms (the wrapper's plan: 32, 2 warpgroups a
// block of threads forward, 1 backward). The unit of work is a (molecule,
// i-block) pair, walked by one warpgroup: the i-block's atoms stay in
// shared memory with its i-side sums, each j-block is loaded in turn over
// the last (its atoms, hB), and the block pair's edge rows are visited in
// 64-row tiles as a molecule's are (Pairs: i-major, self-pairs skipped on
// the diagonal block pair). The forward's node sums are i-side only, so a
// work item ends with its rows of agg and fsum. The backward's j-side sums
// of each block pair go to their own row of the partials pj [B, nI, N,
// H+4] (f32, in global memory), the i-side sums to si [B, N, H+4]; a
// second kernel sums each atom's partials over the i-blocks in order and
// forms dh and dpos. The parameter gradients keep one slice per warpgroup:
// dW2, dW3 and the vector sums per tile as above, dW1b per block pair
// (h_j times its j-side sums), dW1a per work item. Every sum has one owner
// and a fixed order, no atomics: two launches give the same bits.
//
// Wide hidden widths (H = 192, 256; the block-pair kernels only, one
// warpgroup a block). W2 + W3 are 262,144 bytes at H = 256, more than a
// block may use, so they stay in global memory (L2-resident) and pass
// through a ring of kRing slabs in each warpgroup's shared memory: a slab
// is 64 output columns of one product in the resident copy's swizzled
// layout, [H, 64] of W for X W (one 64-column half of it, MN-major) and
// [64, H] of W's rows for X W^T (K-major), 128 H bytes either way. A tile
// uses the slabs in a fixed stream (W2, W3, and backward W3^T, W2^T; H /
// 64 slabs each), one slab for each pair of 32-column chunks of the chunk
// loop, so each output element's K-sum runs the same k16 steps in the
// same order as from a resident copy, and the epilogues are the resident
// kernels' own. The warpgroup's 128 threads copy the next slab with
// cp.async into the slot that the slab before the current one used while
// the tensor cores work on the current one. Shared memory sets the shape:
// the backward's three [64, H] tiles, two slabs and sums leave room for
// one warpgroup a block and 8 atoms at H = 256 (32 forward; 32 each way at
// H = 192). That one warpgroup runs the elementwise chains with little
// latency hidden: at N=55, H=256 the kernels take ~12x (K1, K2) and ~25x
// (K2 p) their tensor-core bound (PERF.md), while the slabs' L2 reads (256
// KB a tile forward, 512 KB backward; 12.9 GB a K1 launch at B=1024) move
// at ~1.3 TB/s.
//
// Wide node features (route "wide_nf", every H and N; egcl_wide_nf.cuh).
// The block pairs keep W1a and W1b whole in shared memory, in f32 (8 nf H
// bytes), and h per atom: past nf ~36 (K1) / ~14 (K2) at H = 256, or ~110 /
// ~89 at H = 128, no block of 8 atoms fits. Where the block pairs' plan
// finds none, the wrapper runs them with their PROJ flag instead: the
// projections hA = rnd(h W1a), hB = rnd(h W1b) come precomputed from
// egcl_nf_proj_kernel ([B N, 2H] bf16, the same f32 FMA chain and rounding
// as load_iblock's), load_iblock / load_jblock copy their rows in, and the
// launch's nf is 0 for everything else (no W1, no h in shared memory, no
// dW1a / dW1b in the slices). The backward's sums are the block pairs' own
// (si, pj); egcl_wide_nf.cuh's kernels then form dpos, dh = rnd(dz1_i)
// W1a^T + rnd(dz1_j) W1b^T and, with parameter gradients, dW1a = h^T
// (sum_j dz1) and dW1b = h^T (sum_i dz1) per atom.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "egcl_part_layout.cuh"
#include "egcl_wide_nf.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kMaxWGFwd = 3, kMaxWGBwd = 2;
constexpr size_t kMaxSmem = 232448;
// weight slabs a warpgroup's ring holds (the wide kernels)
constexpr int kRing = 2;

// The widths whose W2 and W3 a block holds whole (resident), and those that
// the block-pair kernels stream through a ring of slabs.
__host__ __device__ constexpr bool resident(int H) {
  return H == 64 || H == 128;
}
__host__ __device__ constexpr bool streamed(int H) {
  return H == 192 || H == 256;
}

// Warpgroups a block of threads at most: one at the streamed widths (a
// second ring and tile set do not fit).
__host__ __device__ constexpr int max_wg(bool fwd, int H) {
  return streamed(H) ? 1 : fwd ? kMaxWGFwd : kMaxWGBwd;
}

struct Args {
  int B, N, nf, H;
  const bf16* h;          // [B, N, nf]
  const float* pos;       // [B, N, 3]
  const float* box;       // [B, 3]
  const bf16* mask;       // [B, N] (0/1)
  const bf16* W1a;        // [nf, H]
  const bf16* W1b;        // [nf, H]
  const bf16* w1r;        // [H]
  const bf16* b1;         // [H]
  const bf16* W2;         // [H, H]
  const bf16* b2;         // [H]
  const bf16* W3;         // [H, H]
  const bf16* b3;         // [H]
  const bf16* w4;         // [H]
  const bf16* dagg;       // [B, N, H]   (backward)
  const bf16* dfsum;      // [B, N, 3]   (backward)
  bf16* agg;              // [B, N, H]   (forward)
  bf16* fsum;             // [B, N, 3]   (forward)
  bf16* dh;               // [B, N, nf]  (backward)
  float* dpos;            // [B, N, 3]   (backward)
  float* part;            // [slices, slice_floats] (parameter gradients)
  // the block-pair kernels: atoms a block, blocks a molecule, and the
  // backward's i-side sums [B, N, H+4] and j-side partials [B, nI, N, H+4]
  int A, nI;
  float* si;
  float* pj;
  // the wide_nf route: the projections [B, N, 2H] (hA | hB), the j-side
  // sums [B, N, H] and dW1's row-split partials [splits, 2, nf, H]
  const bf16* proj;
  float* sj;
  float* dw1;
  int splits;
};

// A warpgroup's slice of the partials: the nine gradients (PartLayout),
// then the warpgroup's scratch tile of g1 (bf16 [64, H], swizzled).
__host__ __device__ inline int slice_floats(int nf, int H) {
  return PartLayout(nf, H).P + kTile * H / 2;
}

// The parameter-gradient variant's vector sums per warpgroup, [9, H] in
// shared memory: dw1r's three pieces, db1, db2, db3, dw4's three pieces.
enum { kVdw1r = 0, kVdb1 = 3, kVdb2 = 4, kVdb3 = 5, kVdw4 = 6 };

// What a launch runs: the forward, the input-gradient backward, or the
// backward with the parameter gradients.
enum Kind { kFwd = 0, kBwd = 1, kBwdParams = 2 };

// ---- arithmetic (the rest in sm90_common.cuh)

// SiLU and its derivative of a bf16 pair, rounded to bf16
__device__ __forceinline__ bf2 silu2(bf2 z) {
  const float2 f = __bfloat1622float2(z);
  return to_bf2(silu(f.x), silu(f.y));
}
__device__ __forceinline__ bf2 dsilu2(bf2 z) {
  const float2 f = __bfloat1622float2(z);
  return to_bf2(dsilu(f.x), dsilu(f.y));
}
// Both from one sigmoid: silu into m, its derivative into ds
__device__ __forceinline__ void silu_dsilu2(bf2 z, bf2& m, bf2& ds) {
  const float2 f = __bfloat1622float2(z);
  const float sx = sigm(f.x), sy = sigm(f.y);
  m = to_bf2(f.x * sx, f.y * sy);
  ds = to_bf2(sx * (1.0f + f.x * (1.0f - sx)), sy * (1.0f + f.y * (1.0f - sy)));
}
// f32 dot of a bf16 pair with an f32 pair, added to acc
__device__ __forceinline__ float dot2(bf2 v, float2 w, float acc) {
  const float2 f = __bfloat1622float2(v);
  return fmaf(f.y, w.y, fmaf(f.x, w.x, acc));
}

// ---- shared memory

// The block's weights: W2, W3 swizzled (resident widths only); the vectors
// in bf16 (bf16x2 operands) and w1r, w4 also in f32 (the row dots); W1a,
// W1b in f32.
struct Blk {
  bf16 *W2, *W3, *b1, *b2, *b3, *w1r, *w4;
  float *W1a, *W1b, *w1rf, *w4f;
};

// One warpgroup's molecule: activation tiles X0, X1 (and D2, the
// backward's rnd(dsilu(z2))), bf16 [64, H] swizzled; the per-row
// 3-vectors stored transposed [8, 64] swizzled (rows 3..7 zero); each
// row's atoms for the node sums (-1 past the tile's last row); the
// per-atom projections (rows padded to HP = H + 8); the node sums [N, C =
// H + 4] f32 (columns H .. H+2 the 3-vector sums). dagg is staged in
// shared memory (row stride HP) by the input-gradient backward and read
// from global memory (row stride H) by the parameter-gradient one. The
// latter also keeps each tile's per-row f32 weights (r2, then dgate; 64
// each) and its vector sums [9, H] (kVdw1r ...). At the streamed widths the
// warpgroup's ring of kRing weight slabs (128 H bytes each) comes first.
struct Wg {
  bf16 *ring, *X0, *X1, *D2, *vec, *hA, *hB;
  const bf16* dagg;
  int dstride;
  short *segi, *segj;
  float *acci, *accj, *h, *pos, *mask, *box, *dfs, *wrow, *vacc;
  float *hj, *posj, *maskj;    // the j atoms' (the same arrays for a molecule)
};

__host__ __device__ inline void carve_blk(Bump& m, Blk& s, int nf, int H) {
  const size_t WB = sizeof(bf16) * H * H;
  s.W2 = s.W3 = nullptr;
  if (resident(H)) {
    s.W2 = (bf16*)m.take(WB, 1024);
    s.W3 = (bf16*)m.take(WB, 1024);
  }
  s.b1 = (bf16*)m.take(sizeof(bf16) * H);
  s.b2 = (bf16*)m.take(sizeof(bf16) * H);
  s.b3 = (bf16*)m.take(sizeof(bf16) * H);
  s.w1r = (bf16*)m.take(sizeof(bf16) * H);
  s.w4 = (bf16*)m.take(sizeof(bf16) * H);
  s.W1a = (float*)m.take(sizeof(float) * nf * H);
  s.W1b = (float*)m.take(sizeof(float) * nf * H);
  s.w1rf = (float*)m.take(sizeof(float) * H);
  s.w4f = (float*)m.take(sizeof(float) * H);
}

// N atoms a side: a whole molecule (the i and j atoms are the same), or
// with `blocks` an atom block (the j atoms in arrays of their own).
__host__ __device__ inline void carve_wg(Bump& m, Wg& w, int N, int nf, int H,
                                         int kind, bool blocks = false) {
  const bool bwd = kind != kFwd, params = kind == kBwdParams;
  const size_t T = sizeof(bf16) * kTile * H, HP = H + 8, C = H + 4;
  w.ring = streamed(H) ? (bf16*)m.take(kRing * T, 1024) : nullptr;
  w.X0 = (bf16*)m.take(T, 1024);
  w.X1 = (bf16*)m.take(T, 1024);
  w.D2 = bwd ? (bf16*)m.take(T, 1024) : nullptr;
  w.vec = (bf16*)m.take(sizeof(bf16) * 8 * kTile, 1024);
  w.hA = (bf16*)m.take(sizeof(bf16) * N * HP);
  w.hB = (bf16*)m.take(sizeof(bf16) * N * HP);
  w.dagg = kind == kBwd ? (bf16*)m.take(sizeof(bf16) * N * HP) : nullptr;
  w.dstride = kind == kBwd ? (int)HP : H;
  w.wrow = params ? (float*)m.take(sizeof(float) * 2 * kTile) : nullptr;
  w.vacc = params ? (float*)m.take(sizeof(float) * 9 * H) : nullptr;
  w.segi = (short*)m.take(sizeof(short) * kTile);
  w.segj = (short*)m.take(sizeof(short) * kTile);
  w.acci = (float*)m.take(sizeof(float) * N * C);
  w.accj = bwd ? (float*)m.take(sizeof(float) * N * C) : nullptr;
  w.h = (float*)m.take(sizeof(float) * N * nf);
  w.pos = (float*)m.take(sizeof(float) * N * 3);
  w.mask = (float*)m.take(sizeof(float) * N);
  w.box = (float*)m.take(sizeof(float) * 4);
  w.dfs = bwd ? (float*)m.take(sizeof(float) * N * 3) : nullptr;
  if (blocks) {
    w.hj = (float*)m.take(sizeof(float) * N * nf);
    w.posj = (float*)m.take(sizeof(float) * N * 3);
    w.maskj = (float*)m.take(sizeof(float) * N);
  } else {
    w.hj = w.h;
    w.posj = w.pos;
    w.maskj = w.mask;
  }
}

// Bytes of dynamic shared memory of a block of nwg warpgroups (with 1024
// bytes to align the base).
size_t smem_bytes(int N, int nf, int H, int kind, int nwg,
                  bool blocks = false) {
  Bump m{nullptr, 0};
  Blk s;
  carve_blk(m, s, nf, H);
  for (int k = 0; k < nwg; ++k) {
    Wg w;
    carve_wg(m, w, N, nf, H, kind, blocks);
  }
  return m.off + 1024;
}

// The block's weights into shared memory (all threads; W2 and W3 at the
// resident widths only) and the
// warpgroup's tiles (and vector sums) zeroed (every row of a wgmma operand
// must be finite); then the fence that makes them visible to wgmma and a
// block barrier.
template <int H>
__device__ void load_weights(const Args& a, const Blk& s, const Wg& w,
                             int t, int kind) {
  const bool bwd = kind != kFwd;
  if (kind == kBwdParams)
    for (int k = t; k < 9 * H; k += kWG) w.vacc[k] = 0.f;
  const int nf = a.nf;
  if constexpr (resident(H))
    for (int idx = threadIdx.x; idx < H * H / 8; idx += blockDim.x) {
      const int k = idx / (H / 8), c = 8 * (idx % (H / 8));
      const uint4 v2 = *reinterpret_cast<const uint4*>(a.W2 + k * H + c);
      const uint4 v3 = *reinterpret_cast<const uint4*>(a.W3 + k * H + c);
      *reinterpret_cast<uint4*>((char*)s.W2 + swz(k, c, H)) = v2;
      *reinterpret_cast<uint4*>((char*)s.W3 + swz(k, c, H)) = v3;
    }
  for (int k = threadIdx.x; k < nf * H; k += blockDim.x) {
    s.W1a[k] = __bfloat162float(a.W1a[k]);
    s.W1b[k] = __bfloat162float(a.W1b[k]);
  }
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    s.b1[k] = a.b1[k];
    s.b2[k] = a.b2[k];
    s.b3[k] = a.b3[k];
    s.w1r[k] = a.w1r[k];
    s.w4[k] = a.w4[k];
    s.w1rf[k] = __bfloat162float(a.w1r[k]);
    s.w4f[k] = __bfloat162float(a.w4[k]);
  }
  const int words = kTile * H / 2;
  uint32_t* tiles[] = {(uint32_t*)w.X0, (uint32_t*)w.X1, (uint32_t*)w.D2};
  for (int u = 0; u < (bwd ? 3 : 2); ++u)
    for (int k = t; k < words; k += kWG) tiles[u][k] = 0u;
  for (int k = t; k < 4 * kTile; k += kWG) ((uint32_t*)w.vec)[k] = 0u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Molecule b's atoms into the warpgroup's arrays (thread t of 128): h,
// pos, mask, box, the projections hA = h W1a, hB = h W1b rounded to bf16
// (as the TPU kernel rounds its dots), zeroed node sums; for the backward
// also dfsum, and dagg (bf16) where it is staged. Ends with the
// warpgroup's barrier.
template <int H>
__device__ void load_molecule(const Args& a, const Blk& s, const Wg& w,
                              int b, int t, int wg, int kind) {
  const bool bwd = kind != kFwd;
  const int N = a.N, nf = a.nf, HP = H + 8, C = H + 4;
  const size_t nb = (size_t)b * N;
  // the small inputs in one pass (one load each, issued together)
  const int nh = N * nf, np = nh + 3 * N, nm = np + N;
  for (int k = t; k < nm + 3; k += kWG) {
    if (k < nh)
      w.h[k] = __bfloat162float(a.h[nb * nf + k]);
    else if (k < np)
      w.pos[k - nh] = a.pos[nb * 3 + k - nh];
    else if (k < nm)
      w.mask[k - np] = __bfloat162float(a.mask[nb + k - np]);
    else
      w.box[k - nm] = a.box[(size_t)b * 3 + k - nm];
  }
  for (int k = t; k < N * C; k += kWG) w.acci[k] = 0.f;
  if (bwd) {
    for (int k = t; k < N * C; k += kWG) w.accj[k] = 0.f;
    if (kind == kBwd)
      for (int k = t; k < N * H / 8; k += kWG) {
        const int i = k / (H / 8), c = 8 * (k % (H / 8));
        *reinterpret_cast<uint4*>((bf16*)w.dagg + i * HP + c) =
            *reinterpret_cast<const uint4*>(a.dagg + (nb + i) * H + c);
      }
    for (int k = t; k < N * 3; k += kWG)
      w.dfs[k] = __bfloat162float(a.dfsum[nb * 3 + k]);
  }
  wg_sync(wg);
  for (int idx = t; idx < N * H; idx += kWG) {
    const int i = idx / H, c = idx % H;
    float pa = 0.f, pb = 0.f;
    for (int k = 0; k < nf; ++k) {
      pa = fmaf(w.h[i * nf + k], s.W1a[k * H + c], pa);
      pb = fmaf(w.h[i * nf + k], s.W1b[k * H + c], pb);
    }
    w.hA[i * HP + c] = __float2bfloat16_rn(pa);
    w.hB[i * HP + c] = __float2bfloat16_rn(pb);
  }
  wg_sync(wg);
}

// ---- the weight products (resident, or streamed through a ring)

// 16 bytes from global to shared memory, asynchronously (L2 only: .cg), in
// the thread's current group; commit closes the group, wait<N> returns
// once at most N of the thread's groups are still in flight. Other threads
// (and wgmma, the async proxy) see the bytes after wait, a
// fence.proxy.async and a barrier (wg_publish).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warpgroup's place in its stream of weight slabs (the streamed widths).
// Slab s of the stream is product (s / G) % nprod of a tile, G = H / 64:
// W2 (X W), W3 (X W), and for the backward W3 (X W^T), W2 (X W^T); within
// it output columns 64 (s % G) ..; it lands in slot slot_of(s) of the ring.
// Every thread of the warpgroup keeps the same copy.
struct Ring {
  bf16* slots;             // the ring in shared memory
  const bf16 *W2, *W3;     // [H, H] in global memory
  int s;                   // the next slab to use
  int nprod;               // products a tile: 2 forward, 4 backward
};

__device__ __forceinline__ int slot_of(int s) { return s % kRing; }

// The warpgroup's copies of slab s into its slot, one commit group
// (thread t of 128; 16-byte pieces, the swizzled layout of the resident
// copy: for X W the 64-column half of W, R = H rows; for X W^T W's rows 64
// g .. 64 g + 63 as a [64, H] tile).
template <int H>
__device__ void issue_slab(const Ring& rg, int s, int t) {
  constexpr int G = H / 64;
  const int prod = (s / G) % rg.nprod, g = s % G;
  const bf16* W = prod == 0 || prod == 3 ? rg.W2 : rg.W3;
  char* dst = (char*)rg.slots + (size_t)slot_of(s) * (sizeof(bf16) * kTile * H);
  if (prod < 2)
    for (int idx = t; idx < 8 * H; idx += kWG) {
      const int k = idx >> 3, c = 8 * (idx & 7);
      cp_async16(dst + swz(k, c, H), W + (size_t)k * H + 64 * g + c);
    }
  else
    for (int idx = t; idx < 8 * H; idx += kWG) {
      const int r = idx / (H / 8), c = 8 * (idx % (H / 8));
      cp_async16(dst + swz(r, c, kTile), W + (size_t)(64 * g + r) * H + c);
    }
  cp_async_commit();
}

// The ring of a work loop: the first kRing - 1 slabs issued.
template <int H>
__device__ Ring start_ring(const Args& a, const Wg& w, int nprod, int t) {
  Ring rg{w.ring, a.W2, a.W3, 0, nprod};
  for (int s = 0; s < kRing - 1; ++s) issue_slab<H>(rg, s, t);
  return rg;
}

// Slab rg.s once it has landed, as a shared address: this thread's copies
// waited for, then everyone's published to wgmma (the barrier also tells
// that every reader of slab s - 1 is done), then slab s + kRing - 1 issued
// into slab s - 1's slot while slab s is in use.
template <int H>
__device__ __forceinline__ uint32_t next_slab(Ring& rg, int t, int wg) {
  cp_async_wait<kRing - 2>();
  wg_publish(wg);
  issue_slab<H>(rg, rg.s + kRing - 1, t);
  const int slot = slot_of(rg.s++);
  return smem_addr(rg.slots) + slot * (sizeof(bf16) * kTile * H);
}

// The product X W (TB = 1) or X W^T (TB = 0) of the activation tile x and
// the weight W (W2 or W3) in 32-column chunks, two in flight, epi taking
// each chunk's accumulators: at the resident widths from the block's
// swizzled copy at W (chunks); at the streamed widths from the ring, one
// slab a pair of chunks (W unused: the stream's order is the tile's order
// of products), each chunk's K-sum in the same k16 steps and order.
template <int H, int TB, typename Epi>
__device__ __forceinline__ void product(Ring& rg, uint32_t x, uint32_t W,
                                        int t, int wg, Epi&& epi) {
  if constexpr (resident(H)) {
    chunks<H, TB>(x, W, epi);
  } else {
    constexpr int R = TB ? H : kTile;
#pragma unroll 1
    for (int n0 = 0; n0 < H; n0 += 2 * kChunk) {
      const uint32_t slab = next_slab<H>(rg, t, wg);
      float dA[16], dB[16];
      fence_regs(dA);
      wgmma_fence();
      mma_chunk<H / 16, TB>(dA, x, slab, R, 0);
      wgmma_commit();
      fence_regs(dB);
      wgmma_fence();
      mma_chunk<H / 16, TB>(dB, x, slab, R, kChunk);
      wgmma_commit();
      wgmma_wait_for<1>();
      fence_regs(dA);
      epi(dA, n0);
      wgmma_wait_for<0>();
      fence_regs(dB);
      epi(dB, n0 + kChunk);
    }
  }
}

// ---- one tile of edge rows

// The edge rows of the warpgroup's i atoms against its j atoms: a whole
// molecule (i and j the same N atoms, ncol = N - 1) or a pair of atom
// blocks (ncol = nj, or nj - 1 where the two blocks are one, diag). Row q
// < E = ni ncol is the pair (i, j), i = q / ncol, j the (q % ncol)-th j
// atom, skipping j = i where diag; rows past E are padding (valid 0,
// atoms 0).
struct Pairs {
  int ncol, nj, E;
  bool diag;
};

__host__ __device__ inline Pairs pairs_of(int ni, int nj, bool diag) {
  const int ncol = nj - (diag ? 1 : 0);
  return Pairs{ncol, nj, ni * ncol, diag};
}

struct Row {
  int i, j;
  float cd[3], r2, valid;
};

__device__ __forceinline__ void row_of(Row& r, const Wg& w, const Pairs& P,
                                       int q) {
  if (q < P.E) {
    const int i = q / P.ncol, jj = q - i * P.ncol,
              j = jj + (P.diag && jj >= i);
    r.i = i;
    r.j = j;
    float r2 = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float c = w.pos[i * 3 + d] - w.posj[j * 3 + d];
      const float bx = w.box[d];
      c = c - rintf(c / bx) * bx;     // round half to even, as jnp.round
      r.cd[d] = c;
      r2 += c * c;
    }
    r.r2 = r2;
    r.valid = w.mask[i] * w.maskj[j];
  } else {
    r.i = r.j = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) r.cd[d] = 0.f;
    r.r2 = r.valid = 0.f;
  }
}

// A thread's place in the accumulator layout of a 64-row product: warp w's
// lane l holds rows r0 = 16w + l / 4 and r0 + 8, columns 8j + 2 (l % 4)
// and the next; value pair p is row p & 1, 8-column block p / 2.
struct Lane {
  int q, r0;
  bool live;       // the warp has a row of the molecule (else it skips the
                   // elementwise work and stores zeros)
  Row rw[2];
  bf2 valid2[2];
};

__device__ __forceinline__ void lane_of(Lane& L, const Wg& w, const Pairs& P,
                                        int row0, int t) {
  const int warp = t >> 5, lane = t & 31;
  L.q = lane & 3;
  L.r0 = 16 * warp + (lane >> 2);
  L.live = row0 + 16 * warp < P.E;
  row_of(L.rw[0], w, P, row0 + L.r0);
  row_of(L.rw[1], w, P, row0 + L.r0 + 8);
  L.valid2[0] = bcast(L.rw[0].valid);
  L.valid2[1] = bcast(L.rw[1].valid);
}

// z1 = hA_i + hB_j + b1 + r2 w1r at columns c, c+1 of a row, rounded where
// _fwd_block rounds (bf16x2: one rounding per operation).
template <int H>
__device__ __forceinline__ bf2 z1_pair(const Blk& s, const Wg& w,
                                       const Row& r, int c) {
  const int HP = H + 8;
  const bf2 ha = *reinterpret_cast<const bf2*>(w.hA + r.i * HP + c);
  const bf2 hb = *reinterpret_cast<const bf2*>(w.hB + r.j * HP + c);
  const bf2 b1 = *reinterpret_cast<const bf2*>(s.b1 + c);
  const bf2 wr = *reinterpret_cast<const bf2*>(s.w1r + c);
  const bf2 z = add2(add2(ha, hb), b1);
  return add2(z, mul2(bcast(r.r2), wr));
}

__device__ __forceinline__ bf2 vec_at(const bf16* v, int c) {
  return *reinterpret_cast<const bf2*>(v + c);
}

// Zeros into the thread's places of X, columns n0 .. n1-1 (a warp past
// the molecule's rows: every row of a node-sum operand must be finite).
template <int H>
__device__ __forceinline__ void zero_rows(bf16* X, const Lane& L, int n0,
                                          int n1) {
  for (int c = n0 + 2 * L.q; c < n1; c += 8) {
    *tile_at(X, L.r0, c) = bcast(0.f);
    *tile_at(X, L.r0 + 8, c) = bcast(0.f);
  }
}

// m1 = silu(z1) for the thread's rows into X (all H columns).
template <int H>
__device__ void first_layer(const Blk& s, const Wg& w, const Lane& L,
                            bf16* X) {
  if (L.live) {
#pragma unroll 8
    for (int p = 0; p < H / 4; ++p) {
      const int r = L.r0 + 8 * (p & 1), c = 8 * (p >> 1) + 2 * L.q;
      *tile_at(X, r, c) = silu2(z1_pair<H>(s, w, L.rw[p & 1], c));
    }
  } else {
    zero_rows<H>(X, L, 0, H);
  }
}

// The chunk's accumulator pair p as bf16 (the rounding of a product).
__device__ __forceinline__ bf2 acc2(const float (&d)[16], int p) {
  return to_bf2(d[2 * p], d[2 * p + 1]);
}

// ---- node sums

// The A fragments of the 0/1 matrix S [64 atoms, 64 rows], S[s][r] = 1
// where seg[r] == base + s.
__device__ __forceinline__ void seg_frags(uint32_t (&af)[4][4],
                                          const short* seg, int base,
                                          const Lane& L) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = base + L.r0 + 8 * (u & 1);
      const int r = 16 * kk + 2 * L.q + 8 * (u >> 1);
      const short2 g = *reinterpret_cast<const short2*>(seg + r);
      af[kk][u] = (g.x == s ? 0x3F80u : 0u) | (g.y == s ? 0x3F800000u : 0u);
    }
}

// acc[base + s] += (S T)[s] for the thread's rows s < ns of S: T the tile
// of bf16 rows (64-column chunks, MN-major) and the transposed 3-vectors.
template <int H>
__device__ void seg_sum(const Wg& w, const bf16* T, float* acc,
                        const short* seg, int base, int ns, const Lane& L) {
  const int C = H + 4;
  uint32_t af[4][4];
  seg_frags(af, seg, base, L);
  float v[4];
  fence_regs(v);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs8(v, af[kk], smem_desc(smem_addr(w.vec) + 32 * kk, 16, 1024),
              kk > 0);
  wgmma_wait();
  fence_regs(v);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int s = L.r0 + 8 * k;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (s < ns && 2 * L.q + e < 3)
        acc[(base + s) * C + H + 2 * L.q + e] += v[2 * k + e];
  }
#pragma unroll 1
  for (int n0 = 0; n0 < H; n0 += 64) {
    float d[32];
    fence_regs(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs64(d, af[kk],
                 smem_desc(smem_addr(T) + (n0 / 64) * (128 * kTile) +
                               2048 * kk, 128 * kTile, 1024),
                 kk > 0);
    wgmma_wait();
    fence_regs(d);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = L.r0 + 8 * k;
      if (s >= ns) continue;
      float* dst = acc + (base + s) * C + n0 + 2 * L.q;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float2* o = reinterpret_cast<float2*>(dst + 8 * j);
        const float2 old = *o;
        *o = make_float2(old.x + d[4 * j + 2 * k],
                         old.y + d[4 * j + 2 * k + 1]);
      }
    }
  }
}

// The quad leader's rows: their 3-vectors (bf16 values) into the
// transposed tile, and their atoms for the node sums (row r < nr, a row of
// the molecule, sums into atom segi on the i side and segj on the j
// side; -1 sums nowhere).
__device__ __forceinline__ void store_rows(const Wg& w, const Lane& L,
                                           const float (&v)[2][3], int nr) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = L.r0 + 8 * k;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      w.vec[(128 * d + 16 * ((r / 8) ^ d) + 2 * (r % 8)) / 2] =
          __float2bfloat16_rn(v[k][d]);
    w.segi[r] = r < nr ? L.rw[k].i : -1;
    w.segj[r] = r < nr ? L.rw[k].j : -1;
  }
}

// The tile's node sums once T (its bf16 rows), the 3-vectors and the
// segments are stored: the i side (the tile's rows hold i atoms i0 .. i0 +
// ns - 1, at most 64) and, for the backward, the j side (every j atom, 64
// at a time).
template <int H, bool BWD>
__device__ void node_sums(const Wg& w, const bf16* T, const Pairs& P,
                          int row0, int nr, const Lane& L, int wg) {
  wg_publish(wg);
  const int i0 = row0 / P.ncol;
  seg_sum<H>(w, T, w.acci, w.segi, i0, (row0 + nr - 1) / P.ncol - i0 + 1,
             L);
  if constexpr (BWD)
    for (int jb = 0; jb < P.nj; jb += kTile)
      seg_sum<H>(w, T, w.accj, w.segj, jb, min(kTile, P.nj - jb), L);
  wg_sync(wg);
}

// ---- parameter gradients (the outer products in sm90_common.cuh)

// Row 16 w of the weight matrix S [64, 64 edge rows] of a row-weighted
// column sum, one row for each warp w of the warpgroup (the other rows are
// zero): kOnes row 0 all ones; kSplit rows 0, 16, 32 the three bf16
// pieces of an f32 weight per edge row (their sum is the weight exactly:
// the first piece takes 8 of its 24 significant bits, the second 8 of the
// at most 16 left, the third the at most 8 left); kOnesSplit ones in row
// 0, the pieces in rows 16, 32, 48. Every product of a piece and a bf16
// value is exact in f32, so S T sums the unrounded f32 weights' products.
enum { kOnes, kSplit, kOnesSplit };

template <int MODE>
__device__ __forceinline__ bool has_row(int warp) {
  return MODE == kOnes ? warp == 0 : MODE == kSplit ? warp < 3 : true;
}

template <int MODE>
__device__ __forceinline__ float weight_row(int warp, const float* wv,
                                            int r) {
  if (MODE != kSplit && warp == 0) return 1.f;
  const int k = MODE == kSplit ? warp : warp - 1;
  const float v = wv[r], p0 = rnd1(v), v1 = v - p0, p1 = rnd1(v1);
  return k == 0 ? p0 : k == 1 ? p1 : v1 - p1;
}

// The warps' rows of S T for the bf16 tile T [64, H] (MN-major) and the
// f32 row weights wv [64], added into [H] vectors of the warpgroup's
// vector sums by lanes 0..3 of each warp (one owner per element, a fixed
// order: deterministic): row 16 w into dst + w H (kOnes, kSplit); for
// kOnesSplit row 0 into ones and row 16 w into dst + (w - 1) H. The
// pieces' vectors are summed when the sums are written out.
template <int H, int MODE>
__device__ void col_sums(const bf16* T, const float* wv, float* dst,
                         float* ones, const Lane& L, int t) {
  const int warp = t >> 5, lane = t & 31;
  const bool mine = has_row<MODE>(warp) && lane < 4;
  float* out = MODE == kOnesSplit ? (warp == 0 ? ones : dst + (warp - 1) * H)
                                  : dst + warp * H;
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t v = 0u;
      if (mine && (u & 1) == 0) {           // row 16 w: lanes 0..3
        const int r = 16 * kk + 2 * L.q + 8 * (u >> 1);
        const bf2 p = to_bf2(weight_row<MODE>(warp, wv, r),
                             weight_row<MODE>(warp, wv, r + 1));
        v = Bf2{p}.u;
      }
      af[kk][u] = v;
    }
#pragma unroll 1
  for (int n0 = 0; n0 < H; n0 += 64) {
    float d[32];
    fence_regs(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs64(d, af[kk],
                 smem_desc(smem_addr(T) + (n0 / 64) * (128 * kTile) +
                               2048 * kk, 128 * kTile, 1024),
                 kk > 0);
    wgmma_wait();
    fence_regs(d);
    if (mine)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) out[n0 + 8 * j + 2 * lane + e] += d[4 * j + e];
  }
}

// Tiles of a molecule's E edge rows.
__device__ __forceinline__ int tiles_of(int E) {
  return (E + kTile - 1) / kTile;
}

template <int H>
__device__ void fwd_tile(const Blk& s, const Wg& w, Ring& rg, const Pairs& P,
                         int row0, int t, int wg) {
  const int nr = min(kTile, P.E - row0);
  Lane L;
  lane_of(L, w, P, row0, t);
  const uint32_t W2 = smem_addr(s.W2), W3 = smem_addr(s.W3);
  const uint32_t X0 = smem_addr(w.X0), X1 = smem_addr(w.X1);

  first_layer<H>(s, w, L, w.X0);                // m1
  wg_publish(wg);
  // m2 = silu(z2) * valid
  product<H, 1>(rg, X0, W2, t, wg, [&](const float (&d)[16], int n0) {
    if (L.live) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int r = L.r0 + 8 * (p & 1), c = n0 + 8 * (p >> 1) + 2 * L.q;
        const bf2 z = add2(acc2(d, p), vec_at(s.b2, c));
        *tile_at(w.X1, r, c) = mul2(silu2(z), L.valid2[p & 1]);
      }
    } else {
      zero_rows<H>(w.X1, L, n0, n0 + kChunk);
    }
  });
  wg_publish(wg);
  float gate[2] = {0.f, 0.f};                   // silu(z3) . w4
  product<H, 1>(rg, X1, W3, t, wg, [&](const float (&d)[16], int n0) {
    if (L.live) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int c = n0 + 8 * (p >> 1) + 2 * L.q;
        const bf2 z = add2(acc2(d, p), vec_at(s.b3, c));
        gate[p & 1] = dot2(silu2(z), load_f2(s.w4f + c), gate[p & 1]);
      }
    }
  });
  gate[0] = quad_sum(gate[0]);
  gate[1] = quad_sum(gate[1]);
  if (L.q == 0) {
    float tr[2][3];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        tr[k][d] = rnd1(fminf(fmaxf(L.rw[k].cd[d] * gate[k], -100.f), 100.f) *
                        L.rw[k].valid);
    store_rows(w, L, tr, nr);
  }
  node_sums<H, false>(w, w.X1, P, row0, nr, L, wg);
}

// The backward of one tile. Tiles: X0 m1 -> dsilu(z3) -> dz3 (in place)
// -> dz1; X1 m2 -> dz2; D2 dsilu(z2) (and with PARAMS g1, then m1). With
// PARAMS the tile adds its parameter gradients into the warpgroup's slice
// `part` (and its vector sums into w.vacc): dW3 = m2^T dz3 while m2 is in
// X1, db3 from dz3; g1 goes to the slice's scratch tile when the
// recompute makes it and comes back into D2 once dsilu(z2) is consumed,
// for dw4 = g1^T dgate (unrounded dgate) and db2 from dz2; the dz1 pass
// recomputes m1 into D2 from the sigmoid that its dsilu(z1) takes, for
// dW2 = m1^T dz2; dw1r (unrounded r2) and db1 from dz1.
template <int H, bool PARAMS>
__device__ void bwd_tile(const Blk& s, const Wg& w, Ring& rg, const Pairs& P,
                         int row0, int t, int wg, float* part, bf16* g1t,
                         bool fresh) {
  const int nr = min(kTile, P.E - row0);
  Lane L;
  lane_of(L, w, P, row0, t);
  const uint32_t W2 = smem_addr(s.W2), W3 = smem_addr(s.W3);
  const uint32_t X0 = smem_addr(w.X0), X1 = smem_addr(w.X1),
                 D2 = smem_addr(w.D2);

  // -- the forward, recomputed: m1 -> X0; m2 -> X1 and dsilu(z2) -> D2;
  // dsilu(z3) -> X0 (each SiLU derivative from the SiLU's sigmoid)
  first_layer<H>(s, w, L, w.X0);
  wg_publish(wg);
  product<H, 1>(rg, X0, W2, t, wg, [&](const float (&d)[16], int n0) {
    if (L.live) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int r = L.r0 + 8 * (p & 1), c = n0 + 8 * (p >> 1) + 2 * L.q;
        const bf2 z = add2(acc2(d, p), vec_at(s.b2, c));
        bf2 m, ds;
        silu_dsilu2(z, m, ds);
        *tile_at(w.D2, r, c) = ds;
        *tile_at(w.X1, r, c) = mul2(m, L.valid2[p & 1]);
      }
    } else {
      zero_rows<H>(w.X1, L, n0, n0 + kChunk);
    }
  });
  wg_publish(wg);
  float gate[2] = {0.f, 0.f};
  product<H, 1>(rg, X1, W3, t, wg, [&](const float (&d)[16], int n0) {
    if (L.live) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int r = L.r0 + 8 * (p & 1), c = n0 + 8 * (p >> 1) + 2 * L.q;
        const bf2 z = add2(acc2(d, p), vec_at(s.b3, c));
        bf2 g, ds;
        silu_dsilu2(z, g, ds);
        *tile_at(w.X0, r, c) = ds;
        if constexpr (PARAMS) *tile_at(g1t, r, c) = g;
        gate[p & 1] = dot2(g, load_f2(s.w4f + c), gate[p & 1]);
      }
    } else if constexpr (PARAMS) {
      zero_rows<H>(g1t, L, n0, n0 + kChunk);
    }
  });
  // -- the geometry-side cotangents per row (f32)
  float dcd[2][3], dgr[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    gate[k] = quad_sum(gate[k]);
    const Row& r = L.rw[k];
    float dgate = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float raw = r.cd[d] * gate[k];
      const float inside = (raw >= -100.f && raw <= 100.f) ? 1.f : 0.f;
      const float dt = w.dfs[r.i * 3 + d] * inside * r.valid;
      dgate = fmaf(r.cd[d], dt, dgate);
      dcd[k][d] = gate[k] * dt;
    }
    dgr[k] = dgate;
  }
  if constexpr (PARAMS)
    if (L.q == 0)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = L.r0 + 8 * k;
        w.wrow[r] = L.rw[k].r2;                 // dw1r's weight: r2 in f32
        w.wrow[kTile + r] = dgr[k];             // dw4's: dgate in f32
      }
  const bf2 dg2[2] = {bcast(dgr[0]), bcast(dgr[1])};

  // -- the hidden-wide chain backwards: dz3 -> X0 (in place), dz2 -> X1,
  // dz1 -> X0
  if (L.live) {
#pragma unroll 8
    for (int p = 0; p < H / 4; ++p) {
      const int r = L.r0 + 8 * (p & 1), c = 8 * (p >> 1) + 2 * L.q;
      const bf2 dg1 = mul2(dg2[p & 1], vec_at(s.w4, c));
      *tile_at(w.X0, r, c) = mul2(dg1, *tile_at(w.X0, r, c));
    }
  } else {
    zero_rows<H>(w.X0, L, 0, H);
  }
  wg_publish(wg);
  if constexpr (PARAMS) {
    outer_acc<H>(X1, X0, part + H * H, L, fresh);  // m2^T dz3
    col_sums<H, kOnes>(w.X0, nullptr, w.vacc + kVdb3 * H, nullptr, L, t);
    wg_sync(wg);                                // m2 read by all
  }
  // dz3 W3^T -> dz2
  product<H, 0>(rg, X0, W3, t, wg, [&](const float (&d)[16], int n0) {
    if (L.live) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int r = L.r0 + 8 * (p & 1), c = n0 + 8 * (p >> 1) + 2 * L.q;
        const Row& rw = L.rw[p & 1];
        const bf2 da =
            *reinterpret_cast<const bf2*>(w.dagg + rw.i * w.dstride + c);
        const bf2 dm = mul2(add2(acc2(d, p), da), L.valid2[p & 1]);
        *tile_at(w.X1, r, c) = mul2(dm, *tile_at(w.D2, r, c));
      }
    } else {
      zero_rows<H>(w.X1, L, n0, n0 + kChunk);
    }
  });
  wg_publish(wg);
  if constexpr (PARAMS) {
    // g1 back from the scratch tile into D2 (dsilu(z2) is consumed)
    for (int k = t; k < kTile * H / 8; k += kWG)
      reinterpret_cast<uint4*>(w.D2)[k] =
          reinterpret_cast<const uint4*>(g1t)[k];
    wg_publish(wg);
    col_sums<H, kSplit>(w.D2, w.wrow + kTile, w.vacc + kVdw4 * H, nullptr,
                        L, t);                  // dw4 = g1^T dgate
    col_sums<H, kOnes>(w.X1, nullptr, w.vacc + kVdb2 * H, nullptr, L, t);
    wg_sync(wg);                                // g1 read by all
  }
  float dr2[2] = {0.f, 0.f};
  // dz2 W2^T -> dz1
  product<H, 0>(rg, X1, W2, t, wg, [&](const float (&d)[16], int n0) {
    if (L.live) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int r = L.r0 + 8 * (p & 1), c = n0 + 8 * (p >> 1) + 2 * L.q;
        const bf2 z = z1_pair<H>(s, w, L.rw[p & 1], c);
        bf2 ds;
        if constexpr (PARAMS) {
          bf2 m1;
          silu_dsilu2(z, m1, ds);
          *tile_at(w.D2, r, c) = m1;
        } else {
          ds = dsilu2(z);
        }
        const bf2 m = mul2(acc2(d, p), ds);
        *tile_at(w.X0, r, c) = m;
        dr2[p & 1] = dot2(m, load_f2(s.w1rf + c), dr2[p & 1]);
      }
    } else {
      zero_rows<H>(w.X0, L, n0, n0 + kChunk);
      if constexpr (PARAMS) zero_rows<H>(w.D2, L, n0, n0 + kChunk);
    }
  });
  dr2[0] = quad_sum(dr2[0]);
  dr2[1] = quad_sum(dr2[1]);
  if (L.q == 0) {
    float v[2][3];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        v[k][d] = rnd1(dcd[k][d] + 2.f * L.rw[k].cd[d] * dr2[k]);
    store_rows(w, L, v, nr);
  }
  node_sums<H, true>(w, w.X0, P, row0, nr, L, wg);
  if constexpr (PARAMS) {
    outer_acc<H>(D2, X1, part, L, fresh);                      // m1^T dz2
    col_sums<H, kOnesSplit>(w.X0, w.wrow, w.vacc + kVdw1r * H,
                            w.vacc + kVdb1 * H, L,
                            t);                 // db1, dw1r = dz1^T r2
    wg_sync(wg);                                // the tiles read by all
  }
}

// The end of a parameter-gradient kernel's slice: dW2 and dW3 zeroed if
// the warpgroup visited no tile, then its vector sums v (kVdw1r ...; the
// pieces of dw1r and dw4 summed).
template <int H>
__device__ void end_slice(float* part, const PartLayout& PL, const float* v,
                          bool fresh, int t, int wg) {
  if (fresh)                                    // no tile: dW2, dW3 zero
    for (int k = t; k < PL.dW1a; k += kWG) part[k] = 0.f;
  for (int c = t; c < H; c += kWG) {
    part[PL.dw1r + c] = (v[c] + v[H + c]) + v[2 * H + c];
    part[PL.db1 + c] = v[kVdb1 * H + c];
    part[PL.db2 + c] = v[kVdb2 * H + c];
    part[PL.db3 + c] = v[kVdb3 * H + c];
    part[PL.dw4 + c] = (v[kVdw4 * H + c] + v[(kVdw4 + 1) * H + c]) +
                       v[(kVdw4 + 2) * H + c];
  }
}

// ---- the kernels: persistent blocks, one molecule per warpgroup at a time

template <int H>
__global__ void __launch_bounds__(kMaxWGFwd * kWG, 1)
    egcl_sm90_fwd_kernel(Args a) {
  extern __shared__ char smem_raw[];
  const int nwg = blockDim.x / kWG, wg = threadIdx.x / kWG,
            t = threadIdx.x % kWG;
  Bump m{(char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023), 0};
  Blk s;
  carve_blk(m, s, a.nf, H);
  Wg w;
  for (int k = 0; k <= wg; ++k) carve_wg(m, w, a.N, a.nf, H, kFwd);
  load_weights<H>(a, s, w, t, kFwd);
  const int N = a.N, C = H + 4;
  const Pairs P = pairs_of(N, N, true);
  Ring rg{};                                    // unused: W2, W3 resident
  for (int b = blockIdx.x * nwg + wg; b < a.B; b += gridDim.x * nwg) {
    load_molecule<H>(a, s, w, b, t, wg, kFwd);
    for (int k = 0; k < tiles_of(P.E); ++k)
      fwd_tile<H>(s, w, rg, P, k * kTile, t, wg);
    const size_t nb = (size_t)b * N;
    for (int idx = t; idx < N * H; idx += kWG)
      a.agg[nb * H + idx] =
          __float2bfloat16_rn(w.acci[(idx / H) * C + idx % H]);
    for (int idx = t; idx < N * 3; idx += kWG)
      a.fsum[nb * 3 + idx] =
          __float2bfloat16_rn(w.acci[(idx / 3) * C + H + idx % 3]);
    wg_sync(wg);
  }
}

// The backward; with PARAMS each warpgroup owns slice blockIdx.x * nwg +
// wg of a.part: it zeroes dW1a .. dw4, stores dW2 and dW3 on its first
// tile and adds into them after, adds dW1a and dW1b per molecule (h times
// the node sums of dz1), and stores its vector sums at the end.
template <int H, bool PARAMS>
__global__ void __launch_bounds__(kMaxWGBwd * kWG, 1)
    egcl_sm90_bwd_kernel(Args a) {
  extern __shared__ char smem_raw[];
  const int nwg = blockDim.x / kWG, wg = threadIdx.x / kWG,
            t = threadIdx.x % kWG;
  const int kind = PARAMS ? kBwdParams : kBwd;
  Bump m{(char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023), 0};
  Blk s;
  carve_blk(m, s, a.nf, H);
  Wg w;
  for (int k = 0; k <= wg; ++k) carve_wg(m, w, a.N, a.nf, H, kind);
  load_weights<H>(a, s, w, t, kind);
  const int N = a.N, nf = a.nf, C = H + 4;
  const Pairs P = pairs_of(N, N, true);
  const PartLayout PL(nf, H);
  float* const part =
      PARAMS ? a.part + (size_t)(blockIdx.x * nwg + wg) * slice_floats(nf, H)
             : nullptr;
  bf16* const g1t = PARAMS ? (bf16*)(part + PL.P) : nullptr;
  if constexpr (PARAMS)
    for (int k = PL.dW1a + t; k < PL.P; k += kWG) part[k] = 0.f;
  bool fresh = true;
  Ring rg{};                                    // unused: W2, W3 resident
  for (int b = blockIdx.x * nwg + wg; b < a.B; b += gridDim.x * nwg) {
    const size_t nb = (size_t)b * N;
    if constexpr (PARAMS) w.dagg = a.dagg + nb * H;
    load_molecule<H>(a, s, w, b, t, wg, kind);
    for (int k = 0; k < tiles_of(P.E); ++k) {
      bwd_tile<H, PARAMS>(s, w, rg, P, k * kTile, t, wg, part, g1t, fresh);
      fresh = false;
    }
    // dh = rnd(dz1_i) W1a^T + rnd(dz1_j) W1b^T: one thread per (i, k),
    // four partial sums over the columns in a fixed order
    for (int item = t; item < N * nf; item += kWG) {
      const int i = item / nf, k = item % nf;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < H; c += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int cu = c + u;
          acc[u] = fmaf(rnd1(w.acci[i * C + cu]), s.W1a[k * H + cu], acc[u]);
          acc[u] = fmaf(rnd1(w.accj[i * C + cu]), s.W1b[k * H + cu], acc[u]);
        }
      a.dh[nb * nf + item] =
          __float2bfloat16_rn((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
    for (int idx = t; idx < N * 3; idx += kWG) {
      const int i = idx / 3, d = idx % 3;
      a.dpos[nb * 3 + idx] = w.acci[i * C + H + d] - w.accj[i * C + H + d];
    }
    if constexpr (PARAMS)
      // dW1a = sum_i h_i (x) dz1_i and dW1b = sum_j h_j (x) dz1_j, the
      // node sums of dz1 (f32) in atom order; dW1b follows dW1a
      for (int item = t; item < 2 * nf * H; item += kWG) {
        const int side = item / (nf * H), kc = item - side * nf * H;
        const int k = kc / H, c = kc - k * H;
        const float* acc = side ? w.accj : w.acci;
        float v = 0.f;
        for (int i = 0; i < N; ++i) v = fmaf(w.h[i * nf + k], acc[i * C + c], v);
        part[PL.dW1a + item] += v;
      }
    wg_sync(wg);
  }
  if constexpr (PARAMS) end_slice<H>(part, PL, w.vacc, fresh, t, wg);
}

// ---- the block-pair kernels: molecules past one warpgroup's shared memory
//
// The unit of work is a (molecule, i-block) pair: a warpgroup keeps the
// i-block's atoms (hA, the i-side sums; for the backward dfsum and dagg)
// in shared memory and walks the j-blocks in order, loading each one's
// atoms (hB, positions, mask) over the last and visiting the block pair's
// edge rows with the tile code above. The i-side sums are whole when the
// walk ends. The backward's j-side sums of a block pair go to its own row
// of the partials pj [B, nI, N, H+4]; a second kernel sums them over the
// i-blocks in order and forms dh and dpos. Every sum has one owner and a
// fixed order.

// Atoms a0 .. a0+n-1 of molecule b as the warpgroup's i atoms: h, pos,
// mask, box, hA = rnd(h W1a) (load_molecule's arithmetic), zeroed i-side
// sums; for the backward dfsum, and dagg where it is staged. hA is written
// after the barrier; load_jblock's barriers publish it. With PROJ (nf 0)
// hA's rows are copied from the projections.
template <int H, bool PROJ = false>
__device__ void load_iblock(const Args& a, const Blk& s, const Wg& w, int b,
                            int a0, int n, int t, int wg, int kind) {
  const int nf = a.nf, HP = H + 8, C = H + 4;
  const size_t nb = (size_t)b * a.N + a0;
  const int nh = n * nf, np = nh + 3 * n, nm = np + n;
  for (int k = t; k < nm + 3; k += kWG) {
    if (k < nh)
      w.h[k] = __bfloat162float(a.h[nb * nf + k]);
    else if (k < np)
      w.pos[k - nh] = a.pos[nb * 3 + k - nh];
    else if (k < nm)
      w.mask[k - np] = __bfloat162float(a.mask[nb + k - np]);
    else
      w.box[k - nm] = a.box[(size_t)b * 3 + k - nm];
  }
  for (int k = t; k < n * C; k += kWG) w.acci[k] = 0.f;
  if (kind != kFwd) {
    if (kind == kBwd)
      for (int k = t; k < n * H / 8; k += kWG) {
        const int i = k / (H / 8), c = 8 * (k % (H / 8));
        *reinterpret_cast<uint4*>((bf16*)w.dagg + i * HP + c) =
            *reinterpret_cast<const uint4*>(a.dagg + (nb + i) * H + c);
      }
    for (int k = t; k < n * 3; k += kWG)
      w.dfs[k] = __bfloat162float(a.dfsum[nb * 3 + k]);
  }
  wg_sync(wg);
  if constexpr (PROJ) {
    for (int k = t; k < n * H / 8; k += kWG) {
      const int i = k / (H / 8), c = 8 * (k % (H / 8));
      *reinterpret_cast<uint4*>(w.hA + i * HP + c) =
          *reinterpret_cast<const uint4*>(a.proj + (nb + i) * 2 * H + c);
    }
    return;
  }
  for (int idx = t; idx < n * H; idx += kWG) {
    const int i = idx / H, c = idx % H;
    float pa = 0.f;
    for (int k = 0; k < nf; ++k)
      pa = fmaf(w.h[i * nf + k], s.W1a[k * H + c], pa);
    w.hA[i * HP + c] = __float2bfloat16_rn(pa);
  }
}

// Atoms a0 .. a0+n-1 of molecule b as the warpgroup's j atoms: h, pos,
// mask, hB = rnd(h W1b) (with PROJ copied from the projections), and for
// the backward zeroed j-side sums. Ends with the warpgroup's barrier.
template <int H, bool PROJ = false>
__device__ void load_jblock(const Args& a, const Blk& s, const Wg& w, int b,
                            int a0, int n, int t, int wg, bool bwd) {
  const int nf = a.nf, HP = H + 8, C = H + 4;
  const size_t nb = (size_t)b * a.N + a0;
  const int nh = n * nf, np = nh + 3 * n, nm = np + n;
  for (int k = t; k < nm; k += kWG) {
    if (k < nh)
      w.hj[k] = __bfloat162float(a.h[nb * nf + k]);
    else if (k < np)
      w.posj[k - nh] = a.pos[nb * 3 + k - nh];
    else
      w.maskj[k - np] = __bfloat162float(a.mask[nb + k - np]);
  }
  if (bwd)
    for (int k = t; k < n * C; k += kWG) w.accj[k] = 0.f;
  wg_sync(wg);
  if constexpr (PROJ) {
    for (int k = t; k < n * H / 8; k += kWG) {
      const int i = k / (H / 8), c = 8 * (k % (H / 8));
      *reinterpret_cast<uint4*>(w.hB + i * HP + c) =
          *reinterpret_cast<const uint4*>(a.proj + (nb + i) * 2 * H + H + c);
    }
  } else {
    for (int idx = t; idx < n * H; idx += kWG) {
      const int i = idx / H, c = idx % H;
      float pb = 0.f;
      for (int k = 0; k < nf; ++k)
        pb = fmaf(w.hj[i * nf + k], s.W1b[k * H + c], pb);
      w.hB[i * HP + c] = __float2bfloat16_rn(pb);
    }
  }
  wg_sync(wg);
}

// Atoms a block's n atoms from a0 (the last block of a molecule may be
// short).
__device__ __forceinline__ int block_len(int N, int A, int k) {
  return min(A, N - k * A);
}

// part[k H + c] += sum over the n atoms of h[., k] acc[., c] (dW1a from
// the i-side sums, dW1b from a block pair's j-side sums), one thread an
// element, the atoms in order.
template <int H>
__device__ void add_h_outer(float* part, const float* h, const float* acc,
                            int n, int nf, int t) {
  const int C = H + 4;
  for (int item = t; item < nf * H; item += kWG) {
    const int k = item / H, c = item - k * H;
    float v = 0.f;
    for (int i = 0; i < n; ++i) v = fmaf(h[i * nf + k], acc[i * C + c], v);
    part[item] += v;
  }
}

// n rows of C floats from shared memory to global memory, 16 bytes a
// thread at a time.
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int n, int C, int t) {
  for (int k = t; k < n * C / 4; k += kWG)
    reinterpret_cast<float4*>(dst)[k] =
        reinterpret_cast<const float4*>(src)[k];
}

template <int H, bool PROJ = false>
__global__ void __launch_bounds__(max_wg(true, H) * kWG, 1)
    egcl_sm90_blocks_fwd_kernel(Args a) {
  extern __shared__ char smem_raw[];
  const int nwg = blockDim.x / kWG, wg = threadIdx.x / kWG,
            t = threadIdx.x % kWG;
  Bump m{(char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023), 0};
  Blk s;
  carve_blk(m, s, a.nf, H);
  Wg w;
  for (int k = 0; k <= wg; ++k) carve_wg(m, w, a.A, a.nf, H, kFwd, true);
  load_weights<H>(a, s, w, t, kFwd);
  const int N = a.N, A = a.A, nI = a.nI, C = H + 4;
  Ring rg{};
  if constexpr (streamed(H)) rg = start_ring<H>(a, w, 2, t);
  const long long items = (long long)a.B * nI;
  for (long long it = (long long)blockIdx.x * nwg + wg; it < items;
       it += (long long)gridDim.x * nwg) {
    const int b = (int)(it / nI), ib = (int)(it % nI);
    const int ni = block_len(N, A, ib);
    load_iblock<H, PROJ>(a, s, w, b, ib * A, ni, t, wg, kFwd);
    for (int jb = 0; jb < nI; ++jb) {
      const int nj = block_len(N, A, jb);
      load_jblock<H, PROJ>(a, s, w, b, jb * A, nj, t, wg, false);
      const Pairs P = pairs_of(ni, nj, ib == jb);
      for (int k = 0; k < tiles_of(P.E); ++k)
        fwd_tile<H>(s, w, rg, P, k * kTile, t, wg);
    }
    const size_t nb = (size_t)b * N + ib * A;
    for (int idx = t; idx < ni * H; idx += kWG)
      a.agg[nb * H + idx] =
          __float2bfloat16_rn(w.acci[(idx / H) * C + idx % H]);
    for (int idx = t; idx < ni * 3; idx += kWG)
      a.fsum[nb * 3 + idx] =
          __float2bfloat16_rn(w.acci[(idx / 3) * C + H + idx % 3]);
    wg_sync(wg);
  }
  if constexpr (streamed(H)) cp_async_wait<0>();   // the slabs issued ahead
}

// The backward over block pairs; with PARAMS each warpgroup owns slice
// blockIdx.x * nwg + wg of a.part as in egcl_sm90_bwd_kernel, and adds
// dW1b per block pair (h_j times its j-side sums) and dW1a per (molecule,
// i-block) (h_i times the whole i-side sums; neither with PROJ, nf 0).
template <int H, bool PARAMS, bool PROJ = false>
__global__ void __launch_bounds__(max_wg(false, H) * kWG, 1)
    egcl_sm90_blocks_bwd_kernel(Args a) {
  extern __shared__ char smem_raw[];
  const int nwg = blockDim.x / kWG, wg = threadIdx.x / kWG,
            t = threadIdx.x % kWG;
  const int kind = PARAMS ? kBwdParams : kBwd;
  Bump m{(char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023), 0};
  Blk s;
  carve_blk(m, s, a.nf, H);
  Wg w;
  for (int k = 0; k <= wg; ++k) carve_wg(m, w, a.A, a.nf, H, kind, true);
  load_weights<H>(a, s, w, t, kind);
  const int N = a.N, A = a.A, nI = a.nI, nf = a.nf, C = H + 4;
  const PartLayout PL(nf, H);
  float* const part =
      PARAMS ? a.part + (size_t)(blockIdx.x * nwg + wg) * slice_floats(nf, H)
             : nullptr;
  bf16* const g1t = PARAMS ? (bf16*)(part + PL.P) : nullptr;
  if constexpr (PARAMS)
    for (int k = PL.dW1a + t; k < PL.P; k += kWG) part[k] = 0.f;
  bool fresh = true;
  Ring rg{};
  if constexpr (streamed(H)) rg = start_ring<H>(a, w, 4, t);
  const long long items = (long long)a.B * nI;
  for (long long it = (long long)blockIdx.x * nwg + wg; it < items;
       it += (long long)gridDim.x * nwg) {
    const int b = (int)(it / nI), ib = (int)(it % nI);
    const int ni = block_len(N, A, ib);
    const size_t ni0 = (size_t)b * N + ib * A;
    if constexpr (PARAMS) w.dagg = a.dagg + ni0 * H;
    load_iblock<H, PROJ>(a, s, w, b, ib * A, ni, t, wg, kind);
    for (int jb = 0; jb < nI; ++jb) {
      const int nj = block_len(N, A, jb);
      load_jblock<H, PROJ>(a, s, w, b, jb * A, nj, t, wg, true);
      const Pairs P = pairs_of(ni, nj, ib == jb);
      for (int k = 0; k < tiles_of(P.E); ++k) {
        bwd_tile<H, PARAMS>(s, w, rg, P, k * kTile, t, wg, part, g1t, fresh);
        fresh = false;
      }
      // this block pair's j-side sums: row (b, ib) of the partials
      copy_rows(a.pj + (((size_t)b * nI + ib) * N + jb * A) * C, w.accj, nj,
                C, t);
      if constexpr (PARAMS)
        add_h_outer<H>(part + PL.dW1b, w.hj, w.accj, nj, nf, t);
      wg_sync(wg);
    }
    copy_rows(a.si + ni0 * C, w.acci, ni, C, t);
    if constexpr (PARAMS)
      add_h_outer<H>(part + PL.dW1a, w.h, w.acci, ni, nf, t);
    wg_sync(wg);
  }
  if constexpr (streamed(H)) cp_async_wait<0>();   // the slabs issued ahead
  if constexpr (PARAMS) end_slice<H>(part, PL, w.vacc, fresh, t, wg);
}

// The block route's dh and dpos: one warp an atom, lane l the columns l,
// l + 32, ...; the j-side sums are the atom's partials summed over the
// i-blocks in order, dh = rnd(dz1_i) W1a^T + rnd(dz1_j) W1b^T as f32 sums
// (a fixed butterfly over the lanes), dpos the 3-vector sums' difference.
constexpr int kFinishThreads = 256;

template <int H>
__global__ void __launch_bounds__(kFinishThreads)
    egcl_sm90_blocks_finish_kernel(Args a) {
  constexpr int C = H + 4, U = H / 32;
  const int lane = threadIdx.x & 31, nf = a.nf, N = a.N, nI = a.nI;
  const long long rows = (long long)a.B * N;
  const long long step = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       row < rows; row += step) {
    const long long b = row / N, i = row - b * N;
    const float* si = a.si + row * C;
    const float* pj = a.pj + (b * nI * N + i) * C;   // block ib: + ib N C
    float ai[U], aj[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = lane + 32 * u;
      ai[u] = rnd1(si[c]);
      float v = 0.f;
      for (int ib = 0; ib < nI; ++ib) v += pj[(size_t)ib * N * C + c];
      aj[u] = rnd1(v);
    }
    for (int k = 0; k < nf; ++k) {
      float v = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = lane + 32 * u;
        v = fmaf(ai[u], __bfloat162float(a.W1a[k * H + c]), v);
        v = fmaf(aj[u], __bfloat162float(a.W1b[k * H + c]), v);
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) a.dh[row * nf + k] = __float2bfloat16_rn(v);
    }
    if (lane < 3) {
      float v = 0.f;
      for (int ib = 0; ib < nI; ++ib) v += pj[(size_t)ib * N * C + H + lane];
      a.dpos[row * 3 + lane] = si[H + lane] - v;
    }
  }
}

bool takes(int N, int nf, int H) {
  return N >= 1 && nf >= 1 && (H == 64 || H == 128);
}

// The widths of the block-pair kernels: the resident ones and the streamed.
bool takes_wide(int N, int nf, int H) {
  return N >= 1 && nf >= 1 && (resident(H) || streamed(H));
}

// The most warpgroups whose block fits, or 0.
int warpgroups(int N, int nf, int H, int kind) {
  for (int nwg = kind == kFwd ? kMaxWGFwd : kMaxWGBwd; nwg >= 1; --nwg)
    if (smem_bytes(N, nf, H, kind, nwg) <= kMaxSmem) return nwg;
  return 0;
}

// The grid of a launch: at most `blocks`, no more than the molecules need.
int grid_of(int B, int nwg, int blocks) {
  return min(blocks, (B + nwg - 1) / nwg);
}

template <int H>
int launch_h(const Args& a, int kind, int blocks, cudaStream_t stream) {
  const int nwg = warpgroups(a.N, a.nf, H, kind);
  if (nwg == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.N, a.nf, H, kind, nwg);
  void (*kernel)(Args) = kind == kFwd   ? egcl_sm90_fwd_kernel<H>
                         : kind == kBwd ? egcl_sm90_bwd_kernel<H, false>
                                        : egcl_sm90_bwd_kernel<H, true>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(a.B, nwg, blocks), nwg * kWG, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// A block-pair launch: A atoms a block, nwg warpgroups a block of
// threads; the backward's second kernel after it on the same stream.
template <int H>
int launch_blocks_h(const Args& a, int kind, int nwg, int blocks,
                    cudaStream_t stream) {
  const size_t smem = smem_bytes(a.A, a.nf, H, kind, nwg, true);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  void (*kernel)(Args) = kind == kFwd   ? egcl_sm90_blocks_fwd_kernel<H>
                         : kind == kBwd ? egcl_sm90_blocks_bwd_kernel<H, false>
                                        : egcl_sm90_blocks_bwd_kernel<H, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(a.B * a.nI, nwg, blocks), nwg * kWG, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || kind == kFwd) return (int)err;
  const long long warps = (long long)a.B * a.N;
  const int per = kFinishThreads / 32;
  const long long grid = std::min<long long>((warps + per - 1) / per,
                                             16LL * blocks);
  egcl_sm90_blocks_finish_kernel<H><<<(int)grid, kFinishThreads, 0, stream>>>(
      a);
  return (int)cudaGetLastError();
}

// The sizes a block-pair launch takes: nI blocks of A atoms cover the
// molecule, nwg within the kernel's warpgroups.
bool takes_blocks(const Args& a, int kind, int nwg, int blocks) {
  return a.B >= 1 && blocks >= 1 && takes_wide(a.N, a.nf, a.H) &&
         a.A >= 1 && a.nI == (a.N + a.A - 1) / a.A && nwg >= 1 &&
         nwg <= max_wg(kind == kFwd, a.H);
}

int launch_blocks(const Args& a, int kind, int nwg, int blocks,
                  void* stream) {
  if (!takes_blocks(a, kind, nwg, blocks)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.H) {
    case 64: return launch_blocks_h<64>(a, kind, nwg, blocks, st);
    case 128: return launch_blocks_h<128>(a, kind, nwg, blocks, st);
    case 192: return launch_blocks_h<192>(a, kind, nwg, blocks, st);
    default: return launch_blocks_h<256>(a, kind, nwg, blocks, st);
  }
}

// A wide_nf launch (a.nf the caller's): the projections, the block pairs
// with PROJ at nf 0, and for the backward egcl_wide_nf.cuh's sums, dh and
// (with parameter gradients) dW1's partials, all on one stream.
template <int H>
int launch_wide_nf_h(const Args& a, int kind, int nwg, int blocks,
                     cudaStream_t stream) {
  Args p = a;
  p.nf = 0;
  const size_t smem = smem_bytes(p.A, 0, H, kind, nwg, true);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = wide_nf::launch_proj<bf16>(
      a.B * a.N, a.nf, H, a.h, a.W1a, a.W1b, (bf16*)a.proj, stream);
  if (err != cudaSuccess) return (int)err;
  void (*kernel)(Args) = kind == kFwd ? egcl_sm90_blocks_fwd_kernel<H, true>
                         : kind == kBwd
                             ? egcl_sm90_blocks_bwd_kernel<H, false, true>
                             : egcl_sm90_blocks_bwd_kernel<H, true, true>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(a.B * a.nI, nwg, blocks), nwg * kWG, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || kind == kFwd) return (int)err;
  return (int)wide_nf::launch_first_layer_bwd<bf16>(
      a.B, a.N, a.nI, a.nf, H, blocks, a.h, a.W1a, a.W1b, a.si, a.pj, a.sj,
      a.dpos, a.dh, kind == kBwdParams ? a.dw1 : nullptr, a.splits, stream);
}

int launch_wide_nf(const Args& a, int kind, int nwg, int blocks,
                   void* stream) {
  if (!takes_blocks(a, kind, nwg, blocks) ||
      (kind == kBwdParams && a.splits < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.H) {
    case 64: return launch_wide_nf_h<64>(a, kind, nwg, blocks, st);
    case 128: return launch_wide_nf_h<128>(a, kind, nwg, blocks, st);
    case 192: return launch_wide_nf_h<192>(a, kind, nwg, blocks, st);
    default: return launch_wide_nf_h<256>(a, kind, nwg, blocks, st);
  }
}

int launch(const Args& a, int kind, int blocks, void* stream) {
  if (a.B < 1 || blocks < 1 || !takes(a.N, a.nf, a.H))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return a.H == 128 ? launch_h<128>(a, kind, blocks, st)
                    : launch_h<64>(a, kind, blocks, st);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block with one warpgroup (the least a launch
// needs) for these sizes, or -1 for sizes the kernels do not take (H other
// than 64 or 128). kind: 0 the forward, 1 the input-gradient backward, 2
// the backward with parameter gradients. A launch needs at most
// egcl_sm90_smem_limit() bytes.
long long egcl_sm90_smem_bytes(int N, int nf, int H, int kind) {
  if (kind < kFwd || kind > kBwdParams || !takes(N, nf, H)) return -1;
  return (long long)smem_bytes(N, nf, H, kind, 1);
}

long long egcl_sm90_smem_limit() { return (long long)kMaxSmem; }

// The parameter-gradient partials: floats in one warpgroup's slice (the P
// of the nine gradients, egcl_part_size, then its scratch tile), and the
// slices a launch with these sizes writes (one per warpgroup of its grid;
// -1 for sizes it does not take). The caller sums the slices' first P
// floats.
int egcl_sm90_slice_floats(int nf, int H) { return slice_floats(nf, H); }
int egcl_sm90_param_slices(int B, int N, int nf, int H, int blocks) {
  if (B < 1 || blocks < 1 || !takes(N, nf, H)) return -1;
  const int nwg = warpgroups(N, nf, H, kBwdParams);
  return nwg ? grid_of(B, nwg, blocks) * nwg : -1;
}

// The forward (agg, fsum) and the input-gradient backward (dh; dpos in
// float32) for bf16 h, mask and weights; pos and box are float32. blocks:
// the grid's largest size (one block per SM). Returns the cudaError_t of
// the launch (0 on success).
int egcl_sm90_fwd(int B, int N, int nf, int H, int blocks, const void* h,
                  const void* pos, const void* box, const void* mask,
                  const void* W1a, const void* W1b, const void* w1r,
                  const void* b1, const void* W2, const void* b2,
                  const void* W3, const void* b3, const void* w4, void* agg,
                  void* fsum, void* stream) {
  using cb = const bf16*;
  Args a{B, N, nf, H, (cb)h, (const float*)pos, (const float*)box, (cb)mask,
         (cb)W1a, (cb)W1b, (cb)w1r, (cb)b1, (cb)W2, (cb)b2, (cb)W3, (cb)b3,
         (cb)w4, nullptr, nullptr, (bf16*)agg, (bf16*)fsum, nullptr,
         nullptr, nullptr};
  return launch(a, kFwd, blocks, stream);
}

int egcl_sm90_bwd(int B, int N, int nf, int H, int blocks, const void* h,
                  const void* pos, const void* box, const void* mask,
                  const void* W1a, const void* W1b, const void* w1r,
                  const void* b1, const void* W2, const void* b2,
                  const void* W3, const void* b3, const void* w4,
                  const void* dagg, const void* dfsum, void* dh, void* dpos,
                  void* stream) {
  using cb = const bf16*;
  Args a{B, N, nf, H, (cb)h, (const float*)pos, (const float*)box, (cb)mask,
         (cb)W1a, (cb)W1b, (cb)w1r, (cb)b1, (cb)W2, (cb)b2, (cb)W3, (cb)b3,
         (cb)w4, (cb)dagg, (cb)dfsum, nullptr, nullptr, (bf16*)dh,
         (float*)dpos, nullptr};
  return launch(a, kBwd, blocks, stream);
}

// The backward with the nine parameter gradients: part is a float32
// buffer of egcl_sm90_param_slices(...) rows of egcl_sm90_slice_floats
// floats; every warpgroup fills its row (the caller need not zero it).
int egcl_sm90_bwd_params(int B, int N, int nf, int H, int blocks,
                         const void* h, const void* pos, const void* box,
                         const void* mask, const void* W1a, const void* W1b,
                         const void* w1r, const void* b1, const void* W2,
                         const void* b2, const void* W3, const void* b3,
                         const void* w4, const void* dagg, const void* dfsum,
                         void* dh, void* dpos, void* part, void* stream) {
  using cb = const bf16*;
  Args a{B, N, nf, H, (cb)h, (const float*)pos, (const float*)box, (cb)mask,
         (cb)W1a, (cb)W1b, (cb)w1r, (cb)b1, (cb)W2, (cb)b2, (cb)W3, (cb)b3,
         (cb)w4, (cb)dagg, (cb)dfsum, nullptr, nullptr, (bf16*)dh,
         (float*)dpos, (float*)part};
  return launch(a, kBwdParams, blocks, stream);
}

// ---- the block-pair kernels (molecules past one warpgroup's shared
// memory; any N at H = 64 or 128; every N at H = 192 or 256, with W2 and
// W3 streamed)

// Dynamic shared memory of a block of nwg warpgroups, A atoms a block, or
// -1 for sizes the kernels do not take (at H = 192 or 256 one warpgroup,
// its ring of kRing weight slabs included).
long long egcl_sm90_blocks_smem_bytes(int A, int nf, int H, int kind,
                                      int nwg) {
  if (kind < kFwd || kind > kBwdParams || !takes_wide(A, nf, H) ||
      nwg < 1 || nwg > max_wg(kind == kFwd, H))
    return -1;
  return (long long)smem_bytes(A, nf, H, kind, nwg, true);
}

// The parameter-gradient slices of a block-pair launch (one per
// warpgroup of its grid; egcl_sm90_slice_floats floats each).
int egcl_sm90_blocks_param_slices(int B, int N, int A, int nwg, int blocks) {
  if (B < 1 || N < 1 || A < 1 || nwg < 1 || blocks < 1) return -1;
  return grid_of(B * ((N + A - 1) / A), nwg, blocks) * nwg;
}

// The block-pair forward, input-gradient backward and backward with the
// parameter gradients: the contract of egcl_sm90_fwd / _bwd / _bwd_params,
// with A atoms a block (nI = ceil(N / A) blocks a molecule) and nwg
// warpgroups a block of threads. The backward takes two float32 scratch
// buffers that it fills itself: si [B, N, H+4] and pj [B, nI, N, H+4].
int egcl_sm90_blocks_fwd(int B, int N, int nf, int H, int A, int nwg,
                         int blocks, const void* h, const void* pos,
                         const void* box, const void* mask, const void* W1a,
                         const void* W1b, const void* w1r, const void* b1,
                         const void* W2, const void* b2, const void* W3,
                         const void* b3, const void* w4, void* agg,
                         void* fsum, void* stream) {
  using cb = const bf16*;
  Args a{B, N, nf, H, (cb)h, (const float*)pos, (const float*)box, (cb)mask,
         (cb)W1a, (cb)W1b, (cb)w1r, (cb)b1, (cb)W2, (cb)b2, (cb)W3, (cb)b3,
         (cb)w4, nullptr, nullptr, (bf16*)agg, (bf16*)fsum, nullptr,
         nullptr, nullptr, A, (N + A - 1) / A, nullptr, nullptr};
  return launch_blocks(a, kFwd, nwg, blocks, stream);
}

int egcl_sm90_blocks_bwd(int B, int N, int nf, int H, int A, int nwg,
                         int blocks, const void* h, const void* pos,
                         const void* box, const void* mask, const void* W1a,
                         const void* W1b, const void* w1r, const void* b1,
                         const void* W2, const void* b2, const void* W3,
                         const void* b3, const void* w4, const void* dagg,
                         const void* dfsum, void* dh, void* dpos, void* si,
                         void* pj, void* stream) {
  using cb = const bf16*;
  Args a{B, N, nf, H, (cb)h, (const float*)pos, (const float*)box, (cb)mask,
         (cb)W1a, (cb)W1b, (cb)w1r, (cb)b1, (cb)W2, (cb)b2, (cb)W3, (cb)b3,
         (cb)w4, (cb)dagg, (cb)dfsum, nullptr, nullptr, (bf16*)dh,
         (float*)dpos, nullptr, A, (N + A - 1) / A, (float*)si, (float*)pj};
  return launch_blocks(a, kBwd, nwg, blocks, stream);
}

int egcl_sm90_blocks_bwd_params(int B, int N, int nf, int H, int A, int nwg,
                                int blocks, const void* h, const void* pos,
                                const void* box, const void* mask,
                                const void* W1a, const void* W1b,
                                const void* w1r, const void* b1,
                                const void* W2, const void* b2,
                                const void* W3, const void* b3,
                                const void* w4, const void* dagg,
                                const void* dfsum, void* dh, void* dpos,
                                void* si, void* pj, void* part,
                                void* stream) {
  using cb = const bf16*;
  Args a{B, N, nf, H, (cb)h, (const float*)pos, (const float*)box, (cb)mask,
         (cb)W1a, (cb)W1b, (cb)w1r, (cb)b1, (cb)W2, (cb)b2, (cb)W3, (cb)b3,
         (cb)w4, (cb)dagg, (cb)dfsum, nullptr, nullptr, (bf16*)dh,
         (float*)dpos, (float*)part, A, (N + A - 1) / A, (float*)si,
         (float*)pj};
  return launch_blocks(a, kBwdParams, nwg, blocks, stream);
}

// ---- the wide_nf route (any nf; egcl_wide_nf.cuh): the block pairs with
// the first layer's projections precomputed

// Dynamic shared memory of a block-pair block of nwg warpgroups at A atoms
// a block with PROJ (nothing in it grows with nf), or -1 for sizes the
// kernels do not take.
long long egcl_sm90_wide_nf_smem_bytes(int A, int H, int kind, int nwg) {
  if (kind < kFwd || kind > kBwdParams || !takes_wide(A, 1, H) || nwg < 1 ||
      nwg > max_wg(kind == kFwd, H))
    return -1;
  return (long long)smem_bytes(A, 0, H, kind, nwg, true);
}

// dW1's row splits of a launch (rows = B N atoms): the first dimension of
// its dw1 buffer [splits, 2, nf, H].
int egcl_sm90_wide_nf_splits(int rows, int nf, int H, int blocks) {
  return wide_nf::dw1_splits(rows, nf, H, blocks);
}

// The contract of egcl_sm90_blocks_fwd / _bwd / _bwd_params at any nf, with
// float32 scratch that the kernels fill themselves: proj [B, N, 2H] (bf16),
// si [B, N, H+4], pj [B, nI, N, H+4], sj [B, N, H]; with parameter
// gradients dw1 [splits, 2, nf, H] (summed by the caller beside the
// slices of part, each egcl_sm90_slice_floats(0, H) floats: dW1a and dW1b
// are not in them).
int egcl_sm90_wide_nf_fwd(int B, int N, int nf, int H, int A, int nwg,
                          int blocks, const void* h, const void* pos,
                          const void* box, const void* mask, const void* W1a,
                          const void* W1b, const void* w1r, const void* b1,
                          const void* W2, const void* b2, const void* W3,
                          const void* b3, const void* w4, void* proj,
                          void* agg, void* fsum, void* stream) {
  using cb = const bf16*;
  Args a{B, N, nf, H, (cb)h, (const float*)pos, (const float*)box, (cb)mask,
         (cb)W1a, (cb)W1b, (cb)w1r, (cb)b1, (cb)W2, (cb)b2, (cb)W3, (cb)b3,
         (cb)w4, nullptr, nullptr, (bf16*)agg, (bf16*)fsum, nullptr,
         nullptr, nullptr, A, (N + A - 1) / A, nullptr, nullptr, (cb)proj};
  return launch_wide_nf(a, kFwd, nwg, blocks, stream);
}

int egcl_sm90_wide_nf_bwd(int B, int N, int nf, int H, int A, int nwg,
                          int blocks, const void* h, const void* pos,
                          const void* box, const void* mask, const void* W1a,
                          const void* W1b, const void* w1r, const void* b1,
                          const void* W2, const void* b2, const void* W3,
                          const void* b3, const void* w4, const void* dagg,
                          const void* dfsum, void* proj, void* dh, void* dpos,
                          void* si, void* pj, void* sj, void* stream) {
  using cb = const bf16*;
  Args a{B, N, nf, H, (cb)h, (const float*)pos, (const float*)box, (cb)mask,
         (cb)W1a, (cb)W1b, (cb)w1r, (cb)b1, (cb)W2, (cb)b2, (cb)W3, (cb)b3,
         (cb)w4, (cb)dagg, (cb)dfsum, nullptr, nullptr, (bf16*)dh,
         (float*)dpos, nullptr, A, (N + A - 1) / A, (float*)si, (float*)pj,
         (cb)proj, (float*)sj};
  return launch_wide_nf(a, kBwd, nwg, blocks, stream);
}

int egcl_sm90_wide_nf_bwd_params(int B, int N, int nf, int H, int A, int nwg,
                                 int blocks, int splits, const void* h,
                                 const void* pos, const void* box,
                                 const void* mask, const void* W1a,
                                 const void* W1b, const void* w1r,
                                 const void* b1, const void* W2,
                                 const void* b2, const void* W3,
                                 const void* b3, const void* w4,
                                 const void* dagg, const void* dfsum,
                                 void* proj, void* dh, void* dpos, void* si,
                                 void* pj, void* sj, void* dw1, void* part,
                                 void* stream) {
  using cb = const bf16*;
  Args a{B, N, nf, H, (cb)h, (const float*)pos, (const float*)box, (cb)mask,
         (cb)W1a, (cb)W1b, (cb)w1r, (cb)b1, (cb)W2, (cb)b2, (cb)W3, (cb)b3,
         (cb)w4, (cb)dagg, (cb)dfsum, nullptr, nullptr, (bf16*)dh,
         (float*)dpos, (float*)part, A, (N + A - 1) / A, (float*)si,
         (float*)pj, (cb)proj, (float*)sj, (float*)dw1, splits};
  return launch_wide_nf(a, kBwdParams, nwg, blocks, stream);
}

const char* egcl_sm90_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
