// Gathered-edge EGCL pipeline in bf16, designed for Hopper (sm_90a): the
// forward (K5) and the backward with input and all seven parameter
// gradients (K6), at H = 64, 128, 192 or 256.
//
// Replaces the Pallas TPU kernels of enflow_tpu/ops/edge_kernel.py for the
// bf16 compute dtype:
//   forward  -> the pallas_call of _edge_fwd (:219), _fwd_kernel (:88)
//   backward -> the pallas_call of _edge_bwd_impl (:246), _bwd_kernel (:116)
// and computes the contract of edge_pipeline.cu:7-18 on pre-gathered rows
// e [A,K,C], cd [A,K,3], em [A,K]: every product is bf16 x bf16 with f32
// accumulation, as the TPU kernel's (the weights arrive in bf16); m1, m,
// g1, tr, agg and F_sum are rounded to bf16, and pre1-pre3, gate, dtr,
// dgate and the dpre* stay f32; the left operands dpre*.astype(dt) of the
// backward's products, de and dcd are rounded; the clip mask of the
// backward is strict (-100 < x < 100). The f32 kernels are in
// edge_pipeline.cu; the wrapper zero-pads every other width up to the next
// of these four (ops/edge_pipeline.py).
//
// What bounds it on this card. At the top-k sampler's shape (A = 2048 x 13
// atoms, K = 8, C = 11, H = 128) a forward does ~15 GFLOP and a backward
// ~45 GFLOP of bf16 products: 0.015 and 0.045 ms at the tensor cores' peak.
// Every element of the H-wide activations also passes SiLU's sigmoid (an
// ex2 and a rcp on the MUFU, 16 a clock an SM): 3 sigmoids forward, 6
// backward (the recompute's three, then pre3, pre2 and pre1 once more for
// the derivatives: f32 values that do not fit shared memory beside the
// tiles), ~0.04 and ~0.08 ms over the 27.3 M elements; around them the
// adds, products and roundings at the TPU kernel's rounding points.
// chip_smoke.py prints these floors (edge_sfu_alu_floor) beside the times.
//
// Design:
// - Persistent blocks of up to 3 (forward) or 2 (backward) warpgroups, one
//   block per SM. A block stores W2 and W3 once, in bf16, in the
//   128-byte-swizzled layout that wgmma reads (sm90_common.cuh); the
//   forward reads it as an MN-major B operand (X W), the backward also as a
//   K-major one (X W^T). W1 [C, H] sits in the same layout with its rows
//   padded to kCP = 16 KC (KC = ceil(C / 16), at most 4), so that e W1 is
//   KC k16 steps and dpre1 W1^T KC m64n16 products.
// - Rows are walked in 64-row tiles (wgmma's M) of whole atoms where K <=
//   64 (8 atoms a tile at K = 8, 5 at K = 12: 60 rows, the last 4 zero
//   rows); an atom with K > 64 spans ceil(K / 64) tiles and its K-sums are
//   carried from tile to tile in shared memory. The wrapper's plan
//   (ops/edge_pipeline.py sm90_plan, sm90_tiles) deals the units (a tile
//   of atoms, or an atom's tiles) to the warpgroups in turn; each
//   warpgroup owns its atoms, so no state is shared between warpgroups
//   after the weights and no atomics are needed.
// - The first layer: e [64, C] is zero-padded to kCP columns in a
//   swizzled tile, KC wgmma k-steps a 32-column chunk (one at C <= 16, two
//   at C <= 32: nf = 8 to 15 one-hot features, C = 2 nf + 1); rows past the
//   tile's last row are zero rows with em = 0. Chosen over FMA, which was
//   not measured: the step leaves pre1 in the accumulator layout the
//   epilogue reads, costs the elementwise lanes nothing (FMA would spend C
//   multiply-adds an element there) and lets the backward recompute pre1
//   beside dm1's product.
// - Products run in 32-column chunks (m64n32k16, f32 accumulators), two at
//   a time: one chunk's epilogue (bias, SiLU, the mask, the bf16 rounding,
//   the store into the next swizzled activation tile) runs while the
//   tensor cores compute the other. The epilogues round as the plain
//   version does (torch.sigmoid's expf and correctly rounded reciprocal,
//   no contracted multiply-adds; see recip below). The backward's two-product passes issue both products of a
//   chunk in one group.
// - Sums: agg = sum_K m and F_sum = sum_K tr by one thread an (atom,
//   column pair) in row order, from the m tile and the tile's tr rows; the
//   gate g1 . w4 is an in-thread f32 sum plus quad shuffles. Each element
//   has one owner and a fixed order: two launches give identical bits.
// - Backward (the forward recomputed from the inputs, the only residuals):
//   pass C makes the gate, dtr, dgate, dcd and rnd(dgate); pass D
//   recomputes pre3 for g1 and dsilu(pre3): dpre3 -> D2, dw4 and db3;
//   dW3 = m^T rnd(dpre3); pass E issues dpre3 W3^T and m1 W2 together:
//   dpre2 -> X1, db2; dW2 = m1^T rnd(dpre2); pass F issues dpre2 W2^T and
//   e W1 together: dpre1 -> X0, db1; then de = rnd(dpre1 W1^T) (m64n16)
//   and dW1^T += rnd(dpre1)^T e (m64n16, both operands MN-major, the 64
//   rows as K), each of KC 16-column chunks of e and W1. At C <= 16 dW1^T
//   is held in registers across the warpgroup's tiles; at C > 16 (KC times
//   the registers) each tile's product goes into the warpgroup's f32 slice
//   in global memory, as dW2 and dW3 do. (These and the column sums below
//   were not measured against other forms.)
// - Wide hidden widths (H = 192, 256; one warpgroup a block). W2 + W3 are
//   4 H^2 bytes, 262,144 at H = 256, more than a block may use beside the
//   tiles, so they stay in global memory (L2-resident) and pass through a
//   ring of kRing = 2 slabs in the warpgroup's shared memory, as the
//   all-pairs kernels of egcl_allpairs_sm90.cu stream them: a slab is 64
//   output columns of one product in the resident copy's swizzled layout,
//   [H, 64] of W for X W (MN-major) or [64, H] of W's rows for X W^T
//   (K-major), 128 H bytes either way, one slab for each pair of 32-column
//   chunks. A tile uses the slabs in a fixed stream (forward W2, W3;
//   backward W2, W3, W3 again for dpre3, then W3^T and W2 in pairs for
//   pass E, whose two products a chunk read both, then W2^T: 6 H / 64
//   slabs); each output element's K-sum runs the same k16 steps in the
//   same order as from a resident copy, and the epilogues are the resident
//   kernels' own. The warpgroup copies the next slab with 16-byte cp.async
//   into the slot the slab before the current one used while the tensor
//   cores work on the current one; pass E takes both slots at once, so its
//   slabs are copied while no product runs (ring_take). dW1 goes to the
//   slice at every C (the registers go to the wider accumulators). At H =
//   256 the backward's three [64, 256] tiles (96 KB), the ring (64 KB) and
//   the column sums (16 KB) leave room for e W1 in up to 3 k16 steps (C <=
//   48); the forward takes C <= 64.
// - dW2 and dW3: wgmma with the tile's 64 rows as K, both operands the
//   activation tiles read MN-major (sm90_common.cuh outer_acc), added per
//   m64n32 chunk into the warpgroup's own f32 slice of a [slices, P]
//   buffer in global memory (stored on its first tile; ~256 KB of L2
//   traffic a tile at H = 128). The bias and dw4 column sums: a thread's
//   two rows added, then summed over the warp's rows by a reduce-scatter
//   of shuffles (7 a chunk), one lane a column adding into its warp's row
//   of a [4 warps, H] shared array a vector; written to the slice at the
//   end in warp order. The wrapper sums the slices in a fixed order.
// - The next tile's e, cd and em rows arrive by cp.async into the other
//   half of a double buffer while the current tile computes; dagg and dfs
//   are read from global memory (L1) in the epilogues that need them.
// - Shared memory at H = 128: W2 + W3 64 KB, W1 4 KB KC; a warpgroup's
//   m1, m (and the backward's D2) tiles 16 KB each, the e tile 8 KB, the
//   staging buffers 5 KB KC, the backward's column sums 8 KB: at KC = 1
//   217 KB forward (3 warpgroups), 216 KB backward (2); a KC whose block
//   does not fit takes fewer warpgroups (edge_sm90_warpgroups).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kMaxWGFwd = 3, kMaxWGBwd = 2;
constexpr int kMaxKC = 4;                 // e's k16 steps at most (the e
                                          // tile's 64 columns)
constexpr size_t kMaxSmem = 232448;
constexpr int kRing = 2;                  // weight slabs a warpgroup's ring
                                          // holds (H = 192, 256)

// The widths whose W2 and W3 a block holds whole (resident), and those it
// streams through a ring of slabs (one warpgroup a block).
__host__ __device__ constexpr bool resident(int H) {
  return H == 64 || H == 128;
}
__host__ __device__ constexpr int max_wg(bool bwd, int H) {
  return resident(H) ? (bwd ? kMaxWGBwd : kMaxWGFwd) : 1;
}

// One stage of a tile's staged rows: e (at most 64 x 16 KC bf16), cd, em,
// each as the aligned words that hold its bytes (2 words of slack).
__host__ __device__ constexpr int st_cd(int KC) { return 2048 * KC + 16; }
__host__ __device__ constexpr int st_em(int KC) { return st_cd(KC) + 400; }
__host__ __device__ constexpr int st_size(int KC) { return st_em(KC) + 144; }

struct Args {
  int A, K, C, H;
  int apt;                // atoms a tile (K <= 64), or 0: an atom spans tiles
  int tpa;                // tiles an atom (1 when K <= 64)
  int units;              // tiles of atoms, or atoms (apt = 0)
  const bf16* e;          // [A, K, C]
  const bf16* cd;         // [A, K, 3]
  const bf16* em;         // [A, K] (0/1)
  const bf16* W1;         // [C, H]
  const bf16* b1;         // [H]
  const bf16* W2;         // [H, H]
  const bf16* b2;         // [H]
  const bf16* W3;         // [H, H]
  const bf16* b3;         // [H]
  const bf16* w4;         // [H]
  const bf16* dagg;       // [A, H]     (backward)
  const bf16* dfs;        // [A, 3]     (backward)
  bf16* agg;              // [A, H]     (forward)
  bf16* fs;               // [A, 3]     (forward)
  bf16* de;               // [A, K, C]  (backward)
  bf16* dcd;              // [A, K, 3]  (backward)
  float* part;            // [slices, P] (backward)
};

// Offsets of the parameter gradients in a warpgroup's slice of `part`, as
// edge_pipeline.cu lays out a block's: dW1 [C,H], dW2 [H,H], dW3 [H,H],
// dw4, db1, db2, db3 [H].
struct PartLayout {
  int dW1, dW2, dW3, dw4, db1, db2, db3, P;
  __host__ __device__ PartLayout(int C, int H) {
    dW1 = 0;
    dW2 = C * H;
    dW3 = dW2 + H * H;
    dw4 = dW3 + H * H;
    db1 = dw4 + H;
    db2 = db1 + H;
    db3 = db2 + H;
    P = db3 + H;
  }
};

// The backward's column sums in a warpgroup's [4, 4 warps, H] array.
enum { kVdw4 = 0, kVdb3 = 1, kVdb2 = 2, kVdb1 = 3 };

// ---- elementwise arithmetic, rounded where the plain version rounds
//
// SiLU's sigmoid as torch.sigmoid computes it in f32: expf, then 1 / d
// correctly rounded. The reciprocal is rcp.approx and one Newton step of
// fused multiply-adds, which equals the correctly rounded one (__frcp_rn)
// for every d in [1, 2^126) (edge_sm90_recip_check, run by chip_smoke.py,
// compares all 1.06e9 of them) without __frcp_rn's out-of-line slow path,
// whose call sites in the unrolled epilogues slowed the kernels far more
// than the arithmetic. Past 2^126 (x below -87.3) it gives 0 where torch
// keeps a subnormal. The derivative s (1 + x (1 - s)) rounds each product
// and sum on its own (no fused multiply-add). So given the same
// pre-activation, every activation, derivative and rounding point equals
// the plain version's bit for bit, and the two differ only where the
// tensor cores' f32 sums of a product differ from cuBLAS's. (A sigmoid of
// __expf and __fdividef, a few f32 ulps off, moved enough bf16 roundings
// that chip_smoke.py's checks read a bf16 ulp at an output's largest
// element, above TOL_EDGE.)
__device__ __forceinline__ float recip(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  r = __fmaf_rn(r, __fmaf_rn(-d, r, 1.0f), r);
  return d < 0x1p126f ? r : 0.0f;
}
__device__ __forceinline__ float sigmoid(float x) {
  return recip(1.0f + expf(-x));
}
__device__ __forceinline__ float silu_t(float x) { return x * sigmoid(x); }
__device__ __forceinline__ float dsilu_t(float x, float s) {
  return s * (1.0f + __fmul_rn(x, 1.0f - s));
}

// ---- wgmma at N = 16 (de and dW1)

// D[64, 16] (+)= A[64, 16] B[16, 16], both in shared memory, A K-major, B
// K-major (B = W^T)
__device__ __forceinline__ void wgmma_ss16(float (&d)[8], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64, 16] (+)= A[64, 16] B[16, 16], both in shared memory MN-major (A
// read as the transpose of a tile whose rows are K)
__device__ __forceinline__ void wgmma_tt16(float (&d)[8], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- cp.async staging

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The words of global memory that hold the bytes [src, src + nbytes),
// copied into dst by the warpgroup's thread t; the first byte lands at
// dst + (src & 3) (rows of e, cd and em start at any element).
__device__ __forceinline__ void stage_words(char* dst, const void* src,
                                            size_t nbytes, int t) {
  const uintptr_t p = (uintptr_t)src, w0 = p & ~uintptr_t(3);
  const int nw = (int)((p + nbytes - w0 + 3) >> 2);
  for (int k = t; k < nw; k += kWG)
    cp_async4(dst + 4 * k, (const char*)w0 + 4 * k);
}
__device__ __forceinline__ const uint16_t* staged(const char* dst,
                                                  const void* src) {
  return (const uint16_t*)(dst + ((uintptr_t)src & 3));
}
__device__ __forceinline__ float bf_bits(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}

// ---- shared memory

// The block's weights: W2, W3 [H, H] (the resident widths) and W1 [16 KC,
// H] swizzled bf16, the vectors as f32.
struct Blk {
  bf16 *W2, *W3, *W1;
  float *b1, *b2, *b3, *w4;
};

// One warpgroup's tiles (bf16 [64, H] swizzled: X0, X1 and the backward's
// D2; the e tile [64, 64] of which 16 KC columns are used), the two stages of
// staged rows, the forward's tr rows [64, 3] and K-sum carry [H + 3], the
// backward's column sums [4, 4 warps, H]; at the streamed widths its ring
// of kRing weight slabs (128 H bytes each) first.
struct Wg {
  bf16 *ring, *X0, *X1, *D2, *E;
  char* stage;
  float *tr, *carry, *vs;
};

__host__ __device__ inline void carve_blk(Bump& m, Blk& s, int H, int KC) {
  s.W2 = s.W3 = nullptr;
  if (resident(H)) {
    s.W2 = (bf16*)m.take(sizeof(bf16) * H * H, 1024);
    s.W3 = (bf16*)m.take(sizeof(bf16) * H * H, 1024);
  }
  s.W1 = (bf16*)m.take(sizeof(bf16) * 16 * KC * H, 1024);
  s.b1 = (float*)m.take(sizeof(float) * H);
  s.b2 = (float*)m.take(sizeof(float) * H);
  s.b3 = (float*)m.take(sizeof(float) * H);
  s.w4 = (float*)m.take(sizeof(float) * H);
}

__host__ __device__ inline void carve_wg(Bump& m, Wg& w, int H, bool bwd,
                                        int KC) {
  const size_t T = sizeof(bf16) * kTile * H;
  w.ring = resident(H) ? nullptr : (bf16*)m.take(kRing * T, 1024);
  w.X0 = (bf16*)m.take(T, 1024);
  w.X1 = (bf16*)m.take(T, 1024);
  w.D2 = bwd ? (bf16*)m.take(T, 1024) : nullptr;
  w.E = (bf16*)m.take(sizeof(bf16) * kTile * 64, 1024);
  w.stage = m.take(2 * st_size(KC));
  w.tr = bwd ? nullptr : (float*)m.take(sizeof(float) * kTile * 3);
  w.carry = bwd ? nullptr : (float*)m.take(sizeof(float) * (H + 3));
  w.vs = bwd ? (float*)m.take(sizeof(float) * 4 * 4 * H) : nullptr;
}

// Bytes of dynamic shared memory of a block of nwg warpgroups (with 1024
// bytes to align the base).
size_t smem_bytes(int H, bool bwd, int nwg, int KC) {
  Bump m{nullptr, 0};
  Blk s;
  carve_blk(m, s, H, KC);
  for (int k = 0; k < nwg; ++k) {
    Wg w;
    carve_wg(m, w, H, bwd, KC);
  }
  return m.off + 1024;
}

// The block's weights into shared memory (all threads; W2 and W3 at the
// resident widths only), W1's rows past C zero; then the fence that makes
// them visible to wgmma and a block barrier.
template <int H, int KC>
__device__ void load_weights(const Args& a, const Blk& s) {
  constexpr int kCP = 16 * KC;
  if constexpr (resident(H))
    for (int idx = threadIdx.x; idx < H * H / 8; idx += blockDim.x) {
      const int k = idx / (H / 8), c = 8 * (idx % (H / 8));
      const uint4 v2 = *reinterpret_cast<const uint4*>(a.W2 + k * H + c);
      const uint4 v3 = *reinterpret_cast<const uint4*>(a.W3 + k * H + c);
      *reinterpret_cast<uint4*>((char*)s.W2 + swz(k, c, H)) = v2;
      *reinterpret_cast<uint4*>((char*)s.W3 + swz(k, c, H)) = v3;
    }
  for (int idx = threadIdx.x; idx < kCP * H / 8; idx += blockDim.x) {
    const int k = idx / (H / 8), c = 8 * (idx % (H / 8));
    const uint4 v = k < a.C
                        ? *reinterpret_cast<const uint4*>(a.W1 + k * H + c)
                        : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>((char*)s.W1 + swz(k, c, kCP)) = v;
  }
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    s.b1[k] = __bfloat162float(a.b1[k]);
    s.b2[k] = __bfloat162float(a.b2[k]);
    s.b3[k] = __bfloat162float(a.b3[k]);
    s.w4[k] = __bfloat162float(a.w4[k]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// ---- tiles

// A tile: atoms [a0, a0 + na), rows [g0, g0 + nr) of the flattened A*K;
// first / last: the first / last tile of its atoms (differ only when an
// atom spans tiles).
struct Tile {
  int a0, na, g0, nr;
  bool first, last;
};

// Tile t of unit u (sm90_plan's units: a tile of apt atoms, or atom u's
// tpa tiles).
__device__ __forceinline__ Tile tile_of(const Args& a, int u, int t) {
  Tile T;
  if (a.apt > 0) {
    T.a0 = u * a.apt;
    T.na = min(a.apt, a.A - T.a0);
    T.g0 = T.a0 * a.K;
    T.nr = T.na * a.K;
    T.first = T.last = true;
  } else {
    T.a0 = u;
    T.na = 1;
    T.g0 = u * a.K + kTile * t;
    T.nr = min(kTile, a.K - kTile * t);
    T.first = t == 0;
    T.last = t == a.tpa - 1;
  }
  return T;
}

// The warpgroup in slot g of S walks units g, g + S, ..., each unit's tpa
// tiles in order (sm90_tiles): its i-th tile, and how many it has.
__device__ __forceinline__ Tile walk(const Args& a, int g, int S, int i) {
  return tile_of(a, g + (i / a.tpa) * S, i % a.tpa);
}
__device__ __forceinline__ int walk_len(const Args& a, int g, int S) {
  return g < a.units ? ((a.units - 1 - g) / S + 1) * a.tpa : 0;
}

// The tile's e, cd and em rows into stage buffer st (cp.async, uncommitted).
template <int KC>
__device__ __forceinline__ void stage_tile(const Args& a, char* st,
                                           const Tile& T, int t) {
  stage_words(st, a.e + (size_t)T.g0 * a.C, (size_t)T.nr * a.C * 2, t);
  stage_words(st + st_cd(KC), a.cd + (size_t)T.g0 * 3, (size_t)T.nr * 6, t);
  stage_words(st + st_em(KC), a.em + T.g0, (size_t)T.nr * 2, t);
}

// A thread's place in the accumulator layout and its two rows r0, r0 + 8
// of the tile: inside the tile's rows or not, em, cd (zero outside) and
// the atom (a valid one outside, read under em = 0).
struct Lane {
  int q, r0, lane, warp;
  bool in[2];
  int atom[2];
  float em[2], cd[2][3];
};

template <int KC>
__device__ __forceinline__ void lane_of(Lane& L, const Args& a,
                                        const char* st, const Tile& T,
                                        int t) {
  L.warp = t >> 5;
  L.lane = t & 31;
  L.q = L.lane & 3;
  L.r0 = 16 * L.warp + (L.lane >> 2);
  const uint16_t* scd = staged(st + st_cd(KC), a.cd + (size_t)T.g0 * 3);
  const uint16_t* sem = staged(st + st_em(KC), a.em + T.g0);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = L.r0 + 8 * k;
    L.in[k] = r < T.nr;
    L.em[k] = L.in[k] ? bf_bits(sem[r]) : 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      L.cd[k][d] = L.in[k] ? bf_bits(scd[3 * r + d]) : 0.f;
    L.atom[k] = T.a0 + (a.apt > 0 ? min(r, T.nr - 1) / a.K : 0);
  }
}

// The tile's e rows into the e tile's first 16 KC columns (zero past C
// and past the tile's rows).
template <int KC>
__device__ __forceinline__ void build_e(const Args& a, const Wg& w,
                                        const char* st, const Tile& T,
                                        int t) {
  constexpr int kCP = 16 * KC;
  const uint16_t* se = staged(st, a.e + (size_t)T.g0 * a.C);
  const int C = a.C;
  for (int k = t; k < kTile * kCP / 2; k += kWG) {
    const int r = k / (kCP / 2), c = 2 * (k % (kCP / 2));
    uint32_t v = 0u;
    if (r < T.nr) {
      if (c < C) v = se[r * C + c];
      if (c + 1 < C) v |= (uint32_t)se[r * C + c + 1] << 16;
    }
    *reinterpret_cast<uint32_t*>(tile_at(w.E, r, c)) = v;
  }
}

// ---- the streamed widths' weight slabs

// A warpgroup's place in its stream of weight slabs. Slab x of the stream
// is slab x % per of a tile's stream (slab_of; per = 2 H / 64 forward, 6
// H / 64 backward) and lands in slot x % kRing of the ring. Every thread
// of the warpgroup keeps the same copy. (The resident widths carry an
// unused one.)
struct Ring {
  bf16* slots;             // the ring in shared memory
  const bf16 *W2, *W3;     // [H, H] in global memory
  int s;                   // the next slab to use
  int issued;              // the next slab to copy
  int per;                 // slabs a tile
};

// Slab j of a tile's stream: W2 or W3, read by X W (MN-major, [H, 64]) or
// by X W^T (K-major, [64, H] of W's rows), its 64-column group g. Forward:
// m1 W2, m W3 (the gate); backward: those, m W3 again (dpre3), then
// dpre3 W3^T and m1 W2 in pairs a group (pass E), then dpre2 W2^T.
struct Slab {
  bool w3, kmajor;
  int g;
};

template <int H>
__device__ __forceinline__ Slab slab_of(int j) {
  constexpr int G = H / 64;
  if (j < G) return Slab{false, false, j};
  if (j < 3 * G) return Slab{true, false, j % G};
  if (j < 5 * G) {
    const int u = j - 3 * G;
    return (u & 1) ? Slab{false, false, u >> 1} : Slab{true, true, u >> 1};
  }
  return Slab{false, true, j - 5 * G};
}

// The warpgroup's copies of slab x into its slot, one commit group (thread
// t of 128; 16-byte pieces in the resident copy's swizzled layout).
template <int H>
__device__ void issue_slab(const Ring& rg, int x, int t) {
  const Slab sl = slab_of<H>(x % rg.per);
  const bf16* W = sl.w3 ? rg.W3 : rg.W2;
  char* dst = (char*)rg.slots + (size_t)(x % kRing) *
                                    (sizeof(bf16) * kTile * H);
  if (!sl.kmajor)
    for (int idx = t; idx < 8 * H; idx += kWG) {
      const int k = idx >> 3, c = 8 * (idx & 7);
      cp_async16(dst + swz(k, c, H), W + (size_t)k * H + 64 * sl.g + c);
    }
  else
    for (int idx = t; idx < 8 * H; idx += kWG) {
      const int r = idx / (H / 8), c = 8 * (idx % (H / 8));
      cp_async16(dst + swz(r, c, kTile), W + (size_t)(64 * sl.g + r) * H + c);
    }
  cp_async_commit();
}

// Slabs rg.s .. rg.s + n - 1 (n <= kRing) once they have landed, their
// slots' shared addresses into at: this thread's copies waited for, then
// everyone's published to wgmma (the barrier also tells that every reader
// of the slabs before is done); a slab not yet copied is copied and waited
// for first; then every later slab whose slot no slab in use holds is
// issued, to land while these are in use.
template <int H>
__device__ __forceinline__ void ring_take(Ring& rg, int n, uint32_t (&at)[2],
                                          int t, int wg) {
  constexpr uint32_t kSlot = sizeof(bf16) * kTile * H;
  cp_async_wait<0>();
  wg_publish(wg);
  if (rg.issued < rg.s + n) {
    for (; rg.issued < rg.s + n; ++rg.issued)
      issue_slab<H>(rg, rg.issued, t);
    cp_async_wait<0>();
    wg_publish(wg);
  }
  for (int k = 0; k < n; ++k)
    at[k] = smem_addr(rg.slots) + ((rg.s + k) % kRing) * kSlot;
  for (; rg.issued < rg.s + kRing; ++rg.issued)
    issue_slab<H>(rg, rg.issued, t);
  rg.s += n;
}

// One weight product's wgmma steps of a 32-column chunk: from the block's
// [H, H] copy W at the resident widths, from the slab at the streamed ones
// (its R rows: H MN-major, 64 K-major; the chunk's columns within the
// slab's 64).
template <int H, int TB>
__device__ __forceinline__ void wmma_chunk(float (&d)[16], uint32_t x,
                                           uint32_t W, uint32_t slab,
                                           int n0) {
  if constexpr (resident(H))
    mma_chunk<H / 16, TB>(d, x, W, H, n0);
  else
    mma_chunk<H / 16, TB>(d, x, slab, TB ? H : kTile, n0 % 64);
}

// row_chunks / row_chunks2 whose products read W2 or W3: at the streamed
// widths each pair of chunks first takes its NS slabs from the ring (into
// sl, which issue reads).
template <int H, int NS, typename Issue, typename Epi>
__device__ __forceinline__ void slab_chunks(Ring& rg, uint32_t (&sl)[2],
                                            int t, int wg, Issue&& issue,
                                            Epi&& epi) {
  if constexpr (resident(H)) {
    row_chunks<H>(issue, epi);
  } else {
#pragma unroll 1
    for (int n0 = 0; n0 < H; n0 += 2 * kChunk) {
      ring_take<H>(rg, NS, sl, t, wg);
      float dA[16], dB[16];
      fence_regs(dA);
      wgmma_fence();
      issue(dA, n0);
      wgmma_commit();
      fence_regs(dB);
      wgmma_fence();
      issue(dB, n0 + kChunk);
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

template <int H, int NS, typename Issue, typename Epi>
__device__ __forceinline__ void slab_chunks2(Ring& rg, uint32_t (&sl)[2],
                                             int t, int wg, Issue&& issue,
                                             Epi&& epi) {
  if constexpr (resident(H)) {
    row_chunks2<H>(issue, epi);
  } else {
#pragma unroll 1
    for (int n0 = 0; n0 < H; n0 += 2 * kChunk) {
      ring_take<H>(rg, NS, sl, t, wg);
      float aA[16], bA[16], aB[16], bB[16];
      fence_regs(aA);
      fence_regs(bA);
      wgmma_fence();
      issue(aA, bA, n0);
      wgmma_commit();
      fence_regs(aB);
      fence_regs(bB);
      wgmma_fence();
      issue(aB, bB, n0 + kChunk);
      wgmma_commit();
      wgmma_wait_for<1>();
      fence_regs(aA);
      fence_regs(bA);
      epi(aA, bA, n0);
      wgmma_wait_for<0>();
      fence_regs(aB);
      fence_regs(bB);
      epi(aB, bB, n0 + kChunk);
    }
  }
}

// ---- column sums (backward)

// v: a chunk's accumulators (columns n0 .. n0+31). The sums of its columns
// over the warp's 16 rows: each thread's two rows added, then a
// reduce-scatter over the 8 lanes of each column quad (xor 16, 8, 4: 4 +
// 2 + 1 shuffles), after which lane l holds column n0 + 8 (g / 2) + 2 q +
// g % 2, g = l / 4, and adds it into its warp's row of vs [4 warps, H].
// Every element has one owner and a fixed order.
template <int H>
__device__ __forceinline__ void col_sum(float* vs, const float (&v)[16],
                                        const Lane& L, int n0) {
  float x[8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) x[2 * j + e] = v[4 * j + e] + v[4 * j + 2 + e];
  const bool b4 = L.lane & 16, b3 = L.lane & 8, b2 = L.lane & 4;
  float y[4], z[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b4 ? x[i] : x[i + 4], keep = b4 ? x[i + 4] : x[i];
    y[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b3 ? y[i] : y[i + 2], keep = b3 ? y[i + 2] : y[i];
    z[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = b2 ? z[0] : z[1], keep = b2 ? z[1] : z[0];
  const float s = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  const int g = L.lane >> 2;
  vs[L.warp * H + n0 + 8 * (g >> 1) + 2 * L.q + (g & 1)] += s;
}

// ---- the passes shared by both directions

// m1 = rnd(silu(e W1 + b1)) into X0 (all 64 rows).
template <int H, int KC>
__device__ __forceinline__ void pass_m1(const Blk& s, const Wg& w,
                                        const Lane& L) {
  const uint32_t E = smem_addr(w.E), W1 = smem_addr(s.W1);
  row_chunks<H>(
      [&](float (&d)[16], int n0) {
        mma_chunk<KC, 1>(d, E, W1, 16 * KC, n0);
      },
      [&](const float (&d)[16], int n0) {
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int r = L.r0 + 8 * (p & 1), c = n0 + 8 * (p >> 1) + 2 * L.q;
          const float2 b = load_f2(s.b1 + c);
          *tile_at(w.X0, r, c) =
              to_bf2(silu_t(d[2 * p] + b.x), silu_t(d[2 * p + 1] + b.y));
        }
      });
}

// The shared address of the block's W2 or W3 (0 at the streamed widths).
template <int H>
__device__ __forceinline__ uint32_t w_addr(const bf16* W) {
  return resident(H) ? smem_addr(W) : 0u;
}

// m = rnd(silu(m1 W2 + b2) em) into X1.
template <int H>
__device__ __forceinline__ void pass_m(const Blk& s, const Wg& w,
                                       const Lane& L, Ring& rg, int t,
                                       int wg) {
  const uint32_t X0 = smem_addr(w.X0), W2 = w_addr<H>(s.W2);
  uint32_t sl[2] = {0u, 0u};
  slab_chunks<H, 1>(
      rg, sl, t, wg,
      [&](float (&d)[16], int n0) { wmma_chunk<H, 1>(d, X0, W2, sl[0], n0); },
      [&](const float (&d)[16], int n0) {
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int r = L.r0 + 8 * (p & 1), c = n0 + 8 * (p >> 1) + 2 * L.q;
          const float2 b = load_f2(s.b2 + c);
          const float em = L.em[p & 1];
          *tile_at(w.X1, r, c) = to_bf2(silu_t(d[2 * p] + b.x) * em,
                                        silu_t(d[2 * p + 1] + b.y) * em);
        }
      });
}

// gate = rnd(silu(m W3 + b3)) . w4 (f32) of the thread's two rows.
template <int H>
__device__ __forceinline__ void pass_gate(const Blk& s, const Wg& w,
                                          const Lane& L, float (&gate)[2],
                                          Ring& rg, int t, int wg) {
  const uint32_t X1 = smem_addr(w.X1), W3 = w_addr<H>(s.W3);
  uint32_t sl[2] = {0u, 0u};
  gate[0] = gate[1] = 0.f;
  slab_chunks<H, 1>(
      rg, sl, t, wg,
      [&](float (&d)[16], int n0) { wmma_chunk<H, 1>(d, X1, W3, sl[0], n0); },
      [&](const float (&d)[16], int n0) {
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int c = n0 + 8 * (p >> 1) + 2 * L.q;
          const float2 b = load_f2(s.b3 + c), w4 = load_f2(s.w4 + c);
          float& g = gate[p & 1];
          g = fmaf(rnd1(silu_t(d[2 * p] + b.x)), w4.x, g);
          g = fmaf(rnd1(silu_t(d[2 * p + 1] + b.y)), w4.y, g);
        }
      });
  gate[0] = quad_sum(gate[0]);
  gate[1] = quad_sum(gate[1]);
}

// ---- forward

// agg and F_sum of the tile's atoms, one thread an (atom, column pair) or
// (atom, coordinate), summed over the atom's rows in order from the m tile
// and the tr rows; an atom that spans tiles adds each tile's sum into the
// carry and is written at its last tile.
template <int H>
__device__ void k_sums(const Args& a, const Wg& w, const Tile& T, int t) {
  const int K = a.K;
  if (a.apt > 0) {
    for (int it = t; it < T.na * (H / 2 + 3); it += kWG) {
      const int j = it / (H / 2 + 3), c = it % (H / 2 + 3);
      if (c < H / 2) {
        float sx = 0.f, sy = 0.f;
        for (int k = 0; k < K; ++k) {
          const float2 v = __bfloat1622float2(*tile_at(w.X1, j * K + k,
                                                        2 * c));
          sx += v.x;
          sy += v.y;
        }
        *reinterpret_cast<bf2*>(a.agg + (size_t)(T.a0 + j) * H + 2 * c) =
            to_bf2(sx, sy);
      } else {
        const int d = c - H / 2;
        float v = 0.f;
        for (int k = 0; k < K; ++k) v += w.tr[3 * (j * K + k) + d];
        a.fs[(size_t)(T.a0 + j) * 3 + d] = __float2bfloat16_rn(v);
      }
    }
    return;
  }
  for (int c = t; c < H / 2 + 3; c += kWG) {
    if (c < H / 2) {
      float sx = 0.f, sy = 0.f;
      for (int r = 0; r < T.nr; ++r) {
        const float2 v = __bfloat1622float2(*tile_at(w.X1, r, 2 * c));
        sx += v.x;
        sy += v.y;
      }
      if (!T.first) {
        sx = w.carry[2 * c] + sx;
        sy = w.carry[2 * c + 1] + sy;
      }
      w.carry[2 * c] = sx;
      w.carry[2 * c + 1] = sy;
      if (T.last)
        *reinterpret_cast<bf2*>(a.agg + (size_t)T.a0 * H + 2 * c) =
            to_bf2(sx, sy);
    } else {
      const int d = c - H / 2;
      float v = 0.f;
      for (int r = 0; r < T.nr; ++r) v += w.tr[3 * r + d];
      if (!T.first) v = w.carry[H + d] + v;
      w.carry[H + d] = v;
      if (T.last) a.fs[(size_t)T.a0 * 3 + d] = __float2bfloat16_rn(v);
    }
  }
}

template <int H, int KC>
__device__ void fwd_tile(const Args& a, const Blk& s, const Wg& w,
                         const Tile& T, const char* st, int t, int wg,
                         Ring& rg) {
  Lane L;
  lane_of<KC>(L, a, st, T, t);
  build_e<KC>(a, w, st, T, t);
  wg_publish(wg);
  pass_m1<H, KC>(s, w, L);
  wg_publish(wg);
  pass_m<H>(s, w, L, rg, t, wg);
  wg_publish(wg);
  float gate[2];
  pass_gate<H>(s, w, L, gate, rg, t, wg);
  // tr = rnd(clip(cd gate, +-100) em), the quad leader's rows
  if (L.q == 0)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        w.tr[3 * (L.r0 + 8 * k) + d] =
            rnd1(fminf(fmaxf(L.cd[k][d] * gate[k], -100.f), 100.f) *
                 L.em[k]);
  wg_sync(wg);
  k_sums<H>(a, w, T, t);
}

// ---- backward

// dW1^T's m64n16 accumulators (chunk cc of e's columns, rows 64 mm + r
// of H) into the slice's dW1 [C, H] by the thread that holds each element:
// stored, or with `add` added to what is there.
template <int H, int KC>
__device__ __forceinline__ void store_dw1(float* dW1, int C,
                                          const float (&dw1)[KC][H / 64][8],
                                          int t, bool add) {
  const int warp = t >> 5, lane = t & 31, q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
  for (int cc = 0; cc < KC; ++cc)
#pragma unroll
    for (int mm = 0; mm < H / 64; ++mm)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 16 * cc + 8 * j + 2 * q + e,
                      h = 64 * mm + r0 + 8 * k;
            if (c < C) {
              float* p = dW1 + c * H + h;
              const float v = dw1[cc][mm][4 * j + 2 * k + e];
              *p = add ? *p + v : v;
            }
          }
}

// de = rnd(rnd(dpre1) W1^T) into a.de and dW1^T += rnd(dpre1)^T e into
// dw, chunk cc of KC: e's and W1's columns / rows 16 cc .. 16 cc + 15 (W1's
// rows 2048 cc bytes on, e's columns 32 cc bytes into its rows); dpre1 in
// X0.
template <int H, int KC>
__device__ __forceinline__ void de_dw1(const Args& a, const Wg& w,
                                       const Blk& s, const Lane& L,
                                       const Tile& T,
                                       float (&dw)[KC][H / 64][8]) {
  constexpr int kCP = 16 * KC;
  const uint32_t E = smem_addr(w.E), X0 = smem_addr(w.X0),
                 W1 = smem_addr(s.W1);
  float dd[KC][8];
#pragma unroll
  for (int cc = 0; cc < KC; ++cc) {
    fence_regs(dd[cc]);
#pragma unroll
    for (int m = 0; m < H / 64; ++m) fence_regs(dw[cc][m]);
  }
  wgmma_fence();
#pragma unroll
  for (int cc = 0; cc < KC; ++cc) {
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk)
      wgmma_ss16(dd[cc],
                 smem_desc(X0 + (kk / 4) * (128 * kTile) + (kk % 4) * 32, 16,
                           1024),
                 smem_desc(W1 + 2048 * cc + (kk / 4) * (128 * kCP) +
                               (kk % 4) * 32, 16, 1024),
                 kk > 0);
#pragma unroll
    for (int m = 0; m < H / 64; ++m)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tt16(dw[cc][m],
                   smem_desc(X0 + m * (128 * kTile) + 2048 * kk, 128 * kTile,
                             1024),
                   smem_desc(E + 32 * cc + 2048 * kk, 128 * kTile, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait_for<0>();
#pragma unroll
  for (int cc = 0; cc < KC; ++cc) {
    fence_regs(dd[cc]);
#pragma unroll
    for (int m = 0; m < H / 64; ++m) fence_regs(dw[cc][m]);
  }
#pragma unroll
  for (int cc = 0; cc < KC; ++cc)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = L.r0 + 8 * k, c = 16 * cc + 8 * j + 2 * L.q + e;
          if (r < T.nr && c < a.C)
            a.de[(size_t)(T.g0 + r) * a.C + c] =
                __float2bfloat16_rn(dd[cc][4 * j + 2 * k + e]);
        }
}

// One tile's backward (the forward recomputed; see the header for the
// passes). Tiles: X0 m1 -> dpre1; X1 m -> dpre2; D2 dpre3. dW3 and dW2 go
// into the warpgroup's slice `part` (stored when fresh), the column sums
// into w.vs, dW1^T (rows m 64 + r of the m64n16 accumulators, columns the
// C of e) into the registers dw1 at KC = 1 (resident widths), else into
// the slice.
template <int H, int KC>
__device__ void bwd_tile(const Args& a, const Blk& s, const Wg& w,
                         const Tile& T, const char* st, int t, int wg,
                         float* part, bool fresh,
                         float (&dw1)[KC][H / 64][8], Ring& rg) {
  constexpr int kCP = 16 * KC;
  const PartLayout PL(a.C, H);
  Lane L;
  lane_of<KC>(L, a, st, T, t);
  build_e<KC>(a, w, st, T, t);
  wg_publish(wg);
  const uint32_t E = smem_addr(w.E), X0 = smem_addr(w.X0),
                 X1 = smem_addr(w.X1), D2 = smem_addr(w.D2);
  const uint32_t W1 = smem_addr(s.W1), W2 = w_addr<H>(s.W2),
                 W3 = w_addr<H>(s.W3);
  uint32_t sl[2] = {0u, 0u};

  pass_m1<H, KC>(s, w, L);                      // m1 -> X0
  wg_publish(wg);
  pass_m<H>(s, w, L, rg, t, wg);                // m -> X1
  wg_publish(wg);
  float gate[2];
  pass_gate<H>(s, w, L, gate, rg, t, wg);

  // -- the gate's branch per row (f32; strict clip mask): dcd, rnd(dgate)
  float dgr[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = L.r0 + 8 * k;
    float pr[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float c = L.cd[k][d], raw = c * gate[k];
      const float inside = (raw > -100.f && raw < 100.f) ? 1.f : 0.f;
      const float dtr =
          __bfloat162float(a.dfs[(size_t)L.atom[k] * 3 + d]) * inside *
          L.em[k];
      pr[d] = __fmul_rn(c, dtr);
      if (L.q == 0 && L.in[k])
        a.dcd[(size_t)(T.g0 + r) * 3 + d] = __float2bfloat16_rn(gate[k] * dtr);
    }
    dgr[k] = rnd1((pr[0] + pr[1]) + pr[2]);
  }

  // -- pre3 again: dpre3 = rnd(dgate) w4 dsilu(pre3) -> D2; dw4 (g1
  // rnd(dgate)) and db3 (dpre3) column sums
  slab_chunks<H, 1>(
      rg, sl, t, wg,
      [&](float (&d)[16], int n0) { wmma_chunk<H, 1>(d, X1, W3, sl[0], n0); },
      [&](const float (&d)[16], int n0) {
        float vw4[16], vb3[16];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int k = p & 1, r = L.r0 + 8 * k,
                    c = n0 + 8 * (p >> 1) + 2 * L.q;
          const float2 b = load_f2(s.b3 + c), w4 = load_f2(s.w4 + c);
          float dp[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pre = d[2 * p + e] + (e ? b.y : b.x);
            const float sg = sigmoid(pre);
            dp[e] = (dgr[k] * (e ? w4.y : w4.x)) * dsilu_t(pre, sg);
            vw4[2 * p + e] = rnd1(pre * sg) * dgr[k];
            vb3[2 * p + e] = dp[e];
          }
          *tile_at(w.D2, r, c) = to_bf2(dp[0], dp[1]);
        }
        col_sum<H>(w.vs + kVdw4 * 4 * H, vw4, L, n0);
        col_sum<H>(w.vs + kVdb3 * 4 * H, vb3, L, n0);
      });
  wg_publish(wg);
  outer_acc<H>(X1, D2, part + PL.dW3, L, fresh);   // m^T rnd(dpre3)
  wg_sync(wg);

  // -- dm_gate = rnd(dpre3) W3^T with pre2 = m1 W2 again: dpre2 = (dagg +
  // dm_gate) em dsilu(pre2) -> X1; db2
  slab_chunks2<H, 2>(
      rg, sl, t, wg,
      [&](float (&dA)[16], float (&dB)[16], int n0) {
        wmma_chunk<H, 0>(dA, D2, W3, sl[0], n0);
        wmma_chunk<H, 1>(dB, X0, W2, sl[1], n0);
      },
      [&](const float (&dA)[16], const float (&dB)[16], int n0) {
        float vb2[16];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int k = p & 1, r = L.r0 + 8 * k,
                    c = n0 + 8 * (p >> 1) + 2 * L.q;
          const float2 b = load_f2(s.b2 + c);
          const float2 da = __bfloat1622float2(
              *reinterpret_cast<const bf2*>(a.dagg + (size_t)L.atom[k] * H + c));
          float dp[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pre = dB[2 * p + e] + (e ? b.y : b.x);
            const float dm = ((e ? da.y : da.x) + dA[2 * p + e]) * L.em[k];
            dp[e] = dm * dsilu_t(pre, sigmoid(pre));
            vb2[2 * p + e] = dp[e];
          }
          *tile_at(w.X1, r, c) = to_bf2(dp[0], dp[1]);
        }
        col_sum<H>(w.vs + kVdb2 * 4 * H, vb2, L, n0);
      });
  wg_publish(wg);
  outer_acc<H>(X0, X1, part + PL.dW2, L, fresh);   // m1^T rnd(dpre2)
  wg_sync(wg);

  // -- dm1 = rnd(dpre2) W2^T with pre1 = e W1 again: dpre1 = dm1
  // dsilu(pre1) -> X0; db1
  slab_chunks2<H, 1>(
      rg, sl, t, wg,
      [&](float (&dA)[16], float (&dB)[16], int n0) {
        wmma_chunk<H, 0>(dA, X1, W2, sl[0], n0);
        mma_chunk<KC, 1>(dB, E, W1, kCP, n0);
      },
      [&](const float (&dA)[16], const float (&dB)[16], int n0) {
        float vb1[16];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int r = L.r0 + 8 * (p & 1), c = n0 + 8 * (p >> 1) + 2 * L.q;
          const float2 b = load_f2(s.b1 + c);
          float dp[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pre = dB[2 * p + e] + (e ? b.y : b.x);
            dp[e] = dA[2 * p + e] * dsilu_t(pre, sigmoid(pre));
            vb1[2 * p + e] = dp[e];
          }
          *tile_at(w.X0, r, c) = to_bf2(dp[0], dp[1]);
        }
        col_sum<H>(w.vs + kVdb1 * 4 * H, vb1, L, n0);
      });
  wg_publish(wg);

  // -- de = rnd(rnd(dpre1) W1^T) and dW1^T += rnd(dpre1)^T e
  if constexpr (KC == 1 && resident(H)) {
    de_dw1<H, KC>(a, w, s, L, T, dw1);
  } else {
    float tw[KC][H / 64][8];        // this tile's dW1^T
#pragma unroll
    for (int cc = 0; cc < KC; ++cc)
#pragma unroll
      for (int m = 0; m < H / 64; ++m)
#pragma unroll
        for (int k = 0; k < 8; ++k) tw[cc][m][k] = 0.f;
    de_dw1<H, KC>(a, w, s, L, T, tw);
    store_dw1<H, KC>(part + PL.dW1, a.C, tw, t, !fresh);
  }
}

// ---- the kernels: persistent blocks, each warpgroup its own tiles

// The prologue of both kernels: the warpgroup's first tile staged, the
// weights loaded. Then each tile waits for its staged rows while the next
// tile's are copied.
template <int H, bool BWD, int KC>
__device__ __forceinline__ void edge_sm90_body(const Args& a,
                                               char* smem_raw) {
  const int nwg = blockDim.x / kWG, wg = threadIdx.x / kWG,
            t = threadIdx.x % kWG;
  Bump m{(char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023), 0};
  Blk s;
  carve_blk(m, s, H, KC);
  Wg w;
  for (int k = 0; k <= wg; ++k) carve_wg(m, w, H, BWD, KC);
  const int S = gridDim.x * nwg, g = blockIdx.x * nwg + wg;
  const int n = walk_len(a, g, S);
  if (n > 0) stage_tile<KC>(a, w.stage, walk(a, g, S, 0), t);
  cp_async_commit();
  // the streamed widths' ring, its first slab copied from here on
  Ring rg{w.ring, a.W2, a.W3, 0, 0, (BWD ? 6 : 2) * (H / 64)};
  if constexpr (!resident(H)) issue_slab<H>(rg, rg.issued++, t);
  const PartLayout PL(a.C, H);
  float* const part = BWD ? a.part + (size_t)g * PL.P : nullptr;
  if constexpr (BWD)
    for (int k = t; k < 4 * 4 * H; k += kWG) w.vs[k] = 0.f;
  load_weights<H, KC>(a, s);

  // dW1^T across the warpgroup's tiles (KC = 1 at the resident widths;
  // else zeros, stored where the warpgroup has no tile)
  float dw1[KC][H / 64][8];
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int i = 0; i < H / 64; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) dw1[c][i][k] = 0.f;
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n)
      stage_tile<KC>(a, w.stage + ((i + 1) & 1) * st_size(KC),
                     walk(a, g, S, i + 1), t);
    cp_async_commit();
    cp_async_wait<1>();
    wg_sync(wg);
    const Tile T = walk(a, g, S, i);
    const char* st = w.stage + (i & 1) * st_size(KC);
    if constexpr (BWD)
      bwd_tile<H, KC>(a, s, w, T, st, t, wg, part, i == 0, dw1, rg);
    else
      fwd_tile<H, KC>(a, s, w, T, st, t, wg, rg);
  }
  if constexpr (!resident(H)) cp_async_wait<0>();    // the slab issued ahead
  if constexpr (BWD) {
    // the slice's other gradients: dW2, dW3 zero without a tile; the
    // column sums in warp order; dW1 from the registers
    if (n == 0)
      for (int k = t; k < 2 * H * H; k += kWG) part[PL.dW2 + k] = 0.f;
    wg_sync(wg);
    const int off[4] = {PL.dw4, PL.db3, PL.db2, PL.db1};
    for (int c = t; c < H; c += kWG)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float* x = w.vs + v * 4 * H + c;
        part[off[v] + c] = ((x[0] + x[H]) + x[2 * H]) + x[3 * H];
      }
    if ((KC == 1 && resident(H)) || n == 0)
      store_dw1<H, KC>(part + PL.dW1, a.C, dw1, t, false);
  }
}

template <int H, int KC>
__global__ void __launch_bounds__(max_wg(false, H) * kWG, 1)
    edge_sm90_fwd_kernel(Args a) {
  extern __shared__ char smem_raw[];
  edge_sm90_body<H, false, KC>(a, smem_raw);
}

template <int H, int KC>
__global__ void __launch_bounds__(max_wg(true, H) * kWG, 1)
    edge_sm90_bwd_kernel(Args a) {
  extern __shared__ char smem_raw[];
  edge_sm90_body<H, true, KC>(a, smem_raw);
}

// recip against __frcp_rn at every float in [1, 2^126): the mismatches
// added into *bad.
__global__ void recip_check_kernel(unsigned long long* bad) {
  unsigned long long n = 0;
  for (uint32_t ex = 127; ex < 127 + 126; ++ex)
    for (uint32_t m = blockIdx.x * blockDim.x + threadIdx.x; m < (1u << 23);
         m += gridDim.x * blockDim.x) {
      const float d = __uint_as_float((ex << 23) | m);
      n += __float_as_uint(recip(d)) != __float_as_uint(__frcp_rn(d));
    }
  atomicAdd(bad, n);
}

bool takes(int C, int H) {
  return C >= 1 && C <= 16 * kMaxKC &&
         (H == 64 || H == 128 || H == 192 || H == 256);
}

// e's k16 steps: C's columns in 16-column chunks.
int k_steps(int C) { return (C + 15) / 16; }

// The most warpgroups whose block fits, or 0.
int warpgroups(int C, int H, bool bwd) {
  if (!takes(C, H)) return 0;
  for (int nwg = max_wg(bwd, H); nwg >= 1; --nwg)
    if (smem_bytes(H, bwd, nwg, k_steps(C)) <= kMaxSmem) return nwg;
  return 0;
}

// The plan the wrapper computed (sm90_plan) must be the one this kernel
// walks.
bool plan_ok(const Args& a, int blocks, int nwg) {
  if (a.A < 1 || a.K < 1 || blocks < 1 || nwg < 1) return false;
  if (a.K <= kTile)
    return a.apt == kTile / a.K && a.tpa == 1 &&
           a.units == (a.A + a.apt - 1) / a.apt;
  return a.apt == 0 && a.tpa == (a.K + kTile - 1) / kTile && a.units == a.A;
}

template <int H, int KC>
int launch_h(const Args& a, bool bwd, int blocks, int nwg,
             cudaStream_t stream) {
  const size_t smem = smem_bytes(H, bwd, nwg, KC);
  void (*kernel)(Args) =
      bwd ? edge_sm90_bwd_kernel<H, KC> : edge_sm90_fwd_kernel<H, KC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, nwg * kWG, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int H>
int launch_kc(const Args& a, bool bwd, int blocks, int nwg,
              cudaStream_t st) {
  switch (k_steps(a.C)) {
    case 1: return launch_h<H, 1>(a, bwd, blocks, nwg, st);
    case 2: return launch_h<H, 2>(a, bwd, blocks, nwg, st);
    case 3: return launch_h<H, 3>(a, bwd, blocks, nwg, st);
    default: return launch_h<H, 4>(a, bwd, blocks, nwg, st);
  }
}

int launch(const Args& a, bool bwd, int blocks, int nwg, void* stream) {
  if (!takes(a.C, a.H) || !plan_ok(a, blocks, nwg) ||
      nwg > warpgroups(a.C, a.H, bwd))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.H) {
    case 64: return launch_kc<64>(a, bwd, blocks, nwg, st);
    case 128: return launch_kc<128>(a, bwd, blocks, nwg, st);
    case 192: return launch_kc<192>(a, bwd, blocks, nwg, st);
    default: return launch_kc<256>(a, bwd, blocks, nwg, st);
  }
}

}  // namespace

extern "C" {

// The most warpgroups a block holds (the launch's nwg; at C <= 16 3
// forward and 2 backward at H = 64 and 128, 1 at 192 and 256), or 0 for a
// C or H the kernels do not take (C > 64, or no block of one warpgroup
// fits).
int edge_sm90_warpgroups(int C, int H, int bwd) {
  return warpgroups(C, H, bwd != 0);
}

// Dynamic shared memory of a block of nwg warpgroups at C edge features,
// or -1 for a C or H the kernels do not take (C > 64; H other than 64,
// 128, 192 and 256).
long long edge_sm90_smem_bytes(int C, int H, int bwd, int nwg) {
  if (!takes(C, H) || nwg < 1) return -1;
  return (long long)smem_bytes(H, bwd != 0, nwg, k_steps(C));
}

// The most edge features a row the kernels take (e's columns in at most
// kMaxKC k16 steps).
int edge_sm90_c_max() { return 16 * kMaxKC; }

// bf16 tensors throughout (the partials f32). apt, tpa, units: the plan of
// ops/edge_pipeline.py sm90_plan; blocks x nwg warpgroups, the backward's
// `part` one slice of C H + 2 H^2 + 4 H floats (PartLayout) a warpgroup,
// every one written (the caller need not zero it). Returns the cudaError_t of the
// launch (0 on success).
int edge_sm90_fwd(int A, int K, int C, int H, int apt, int tpa, int units,
                  int blocks, int nwg, const void* e, const void* cd,
                  const void* em, const void* W1, const void* b1,
                  const void* W2, const void* b2, const void* W3,
                  const void* b3, const void* w4, void* agg, void* fs,
                  void* stream) {
  using cb = const bf16*;
  Args a{A, K, C, H, apt, tpa, units, (cb)e, (cb)cd, (cb)em, (cb)W1, (cb)b1,
         (cb)W2, (cb)b2, (cb)W3, (cb)b3, (cb)w4, nullptr, nullptr,
         (bf16*)agg, (bf16*)fs, nullptr, nullptr, nullptr};
  return launch(a, false, blocks, nwg, stream);
}

int edge_sm90_bwd(int A, int K, int C, int H, int apt, int tpa, int units,
                  int blocks, int nwg, const void* e, const void* cd,
                  const void* em, const void* W1, const void* b1,
                  const void* W2, const void* b2, const void* W3,
                  const void* b3, const void* w4, const void* dagg,
                  const void* dfs, void* de, void* dcd, void* part,
                  void* stream) {
  using cb = const bf16*;
  Args a{A, K, C, H, apt, tpa, units, (cb)e, (cb)cd, (cb)em, (cb)W1, (cb)b1,
         (cb)W2, (cb)b2, (cb)W3, (cb)b3, (cb)w4, (cb)dagg, (cb)dfs, nullptr,
         nullptr, (bf16*)de, (bf16*)dcd, (float*)part};
  return launch(a, true, blocks, nwg, stream);
}

// The kernels' reciprocal against the correctly rounded one at all
// 126 * 2^23 floats in [1, 2^126): the number that differ is added into
// *bad (one unsigned 64-bit integer on the card, zeroed by the caller).
int edge_sm90_recip_check(void* bad, void* stream) {
  recip_check_kernel<<<1056, 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)bad);
  return (int)cudaGetLastError();
}

const char* edge_sm90_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
