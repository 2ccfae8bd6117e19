// The product engines of the column-chunked EGCL kernels past H = 256,
// shared by egcl_allpairs_xwide.cu (the all-pairs EGCL) and
// edge_pipeline_xwide.cu (the gathered-edge EGCL): a tile of 64 edge rows
// times a weight matrix, or the outer product of two tiles, in 64 x 64
// output chunks over 64-row k-chunks, the activation chunk and the weight
// chunk staged in shared memory two steps deep (the next step's loads
// issued while the current step computes). Nothing in shared memory or
// registers grows with the width or with k: both enter as loop counts.
//
// - EngBf (bf16): one warpgroup, the operands in the 128-byte swizzle of
//   sm90_common.cuh, wgmma m64n32k16 (two accumulators of 16 f32 a
//   thread). X W reads the weight chunk MN-major, X W^T K-major, and the
//   outer products A^T B read both tiles MN-major with the 64 edge rows as
//   K. A product run with PART (the gathered-edge first layer, whose k is C)
//   issues only the k16 steps of its last chunk that hold any k (the
//   operands are zero past k); the others issue four a chunk.
// - EngF32 (float32): 256 threads, each 4 x 4 of the 64 x 64 output chunk,
//   k in chunks of 16 staged as f32 (egcl_wide_nf.cuh's tile loop), one
//   FMA chain in k order per output.
// - RingBf (bf16, the all-pairs K1 and K2 only): a producer thread's TMA
//   copies into a ring of stages that two consumer warpgroups read, one
//   64 x 128 weight chunk a stage for both of their tiles (its note below).
//
// The shapes of a product (Dims): X and Y row-major with leading
// dimensions lx and ly; MODE 0 X [64, K] Y [K, 64 no], MODE 1 X [64, K]
// Y^T with Y [64 no, K], MODE 2 X^T Y with X [64, 64 mo], Y [64, 64 no]
// and K = 64 (the tile's rows). K is a multiple of 16, and the memory of
// X and Y holds every k of the last 64-chunk (zero past K).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "egcl_wide_nf.cuh"
#include "sm90_common.cuh"

namespace {
namespace xwide {

constexpr int kRows = 64;      // edge rows a tile
constexpr int kCol = 64;       // output columns a chunk, and k a chunk
constexpr int kMaxH = 11520;   // 2 H^2 floats of a parameter slice under 1 GiB
constexpr size_t kMaxSmem = 232448;
constexpr double kMaxPartBytes = 1073741824.0;   // the slices of a launch

struct Dims {
  int lx, ly;   // leading dimensions of X and Y
  int mo, no;   // output chunks: MODE 2 mo x no, else no (mo 1)
  int K;        // k of the product, a multiple of 16 (MODE 2: kRows)
};

// The dims of the [64, H] x [H, H] products (MODE 0, 1) and of the [H, H]
// outer products of two [64, H] tiles (MODE 2).
__device__ __forceinline__ Dims square(int H, int mode) {
  const int G = H / kCol;
  return Dims{H, H, mode == 2 ? G : 1, G, mode == 2 ? kRows : H};
}

// ---- the bf16 engine: one warpgroup, wgmma on staged 64 x 64 chunks

struct EngBf {
  using T = bf16;
  static constexpr int kThreads = kWG;
  static constexpr int kSlots = 2;   // rows a thread holds in an output
  static constexpr size_t kStageBytes = 4 * sizeof(bf16) * kRows * kCol;
  struct Acc {
    float d0[16], d1[16];
  };
  struct Sm {
    bf16* a[2];
    bf16* b[2];
  };
  __device__ static Sm carve(char* base) {
    const size_t S = sizeof(bf16) * kRows * kCol;
    return Sm{{(bf16*)base, (bf16*)(base + S)},
              {(bf16*)(base + 2 * S), (bf16*)(base + 3 * S)}};
  }
  // f(slot, row, column of the chunk, value) over the thread's elements:
  // warp w's lane l holds rows 16 w + l / 4 (slot 0) and + 8 (slot 1),
  // columns 32 half + 8 j + 2 (l % 4) + e.
  template <class F>
  __device__ static void each(const Acc& c, F&& f) {
    const int t = threadIdx.x, l = t & 31, q = l & 3;
    const int r0 = 16 * (t >> 5) + (l >> 2);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            f(k, r0 + 8 * k, 32 * half + 8 * j + 2 * q + e,
              (half ? c.d1 : c.d0)[4 * j + 2 * k + e]);
  }
  __device__ static int slot_row(int k) {
    const int t = threadIdx.x;
    return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * k;
  }
  __device__ static float row_sum(float v) { return quad_sum(v); }
  __device__ static bool row_lead() { return (threadIdx.x & 3) == 0; }

  // A 64 x 64 chunk of a row-major matrix (ld columns) from global memory
  // into registers (16 bytes a piece) and from there into a swizzled stage.
  struct Chunk {
    const bf16* p;
    int ld, row0, col0;
  };
  __device__ static void fetch(const Chunk& c, uint4 (&r)[4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = threadIdx.x + kWG * u, rho = idx >> 3, g = idx & 7;
      r[u] = *reinterpret_cast<const uint4*>(
          c.p + (size_t)(c.row0 + rho) * c.ld + c.col0 + 8 * g);
    }
  }
  __device__ static void put(bf16* dst, const uint4 (&r)[4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = threadIdx.x + kWG * u, rho = idx >> 3, g = idx & 7;
      *reinterpret_cast<uint4*>((char*)dst + swz(rho, 8 * g, kTile)) = r[u];
    }
  }
  // d (+)= the 32 output columns from n0 of one staged step, its first NKK
  // k16 steps: MODE 0 X W (W MN-major), 1 X W^T (W K-major), 2 A^T B (both
  // MN-major, the 64 rows K).
  template <int MODE, int NKK = 4>
  __device__ static void mma(float (&d)[16], uint32_t a, uint32_t b, int n0,
                             bool acc) {
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) {
      const uint64_t da = MODE == 2
                              ? smem_desc(a + 2048 * kk, 128 * kTile, 1024)
                              : smem_desc(a + 32 * kk, 16, 1024);
      const uint64_t db =
          MODE == 1 ? smem_desc(b + 128 * n0 + 32 * kk, 16, 1024)
                    : smem_desc(b + 2 * n0 + 2048 * kk, 128 * kTile, 1024);
      const int sc = (acc || kk > 0) ? 1 : 0;
      if constexpr (MODE == 0)
        wgmma_ss32<1>(d, da, db, sc);
      else if constexpr (MODE == 1)
        wgmma_ss32<0>(d, da, db, sc);
      else
        wgmma_tt32(d, da, db, sc);
    }
  }
  // Both accumulators' steps of one staged step with nkk k16 steps.
  template <int MODE>
  __device__ static void mma_step(Acc& acc, uint32_t a, uint32_t b, bool more,
                                  int nkk) {
    if (nkk == 4) {
      mma<MODE>(acc.d0, a, b, 0, more);
      mma<MODE>(acc.d1, a, b, kChunk, more);
    } else if (nkk == 3) {
      mma<MODE, 3>(acc.d0, a, b, 0, more);
      mma<MODE, 3>(acc.d1, a, b, kChunk, more);
    } else if (nkk == 2) {
      mma<MODE, 2>(acc.d0, a, b, 0, more);
      mma<MODE, 2>(acc.d1, a, b, kChunk, more);
    } else {
      mma<MODE, 1>(acc.d0, a, b, 0, more);
      mma<MODE, 1>(acc.d1, a, b, kChunk, more);
    }
  }
  // The product of X and Y of dims d (see the header): epi(o, acc) takes
  // each 64 x 64 output chunk o (MODE 2: row block o / no, column block o
  // % no). PART: d.K need not be a multiple of 64 (the last k-chunk's k16
  // steps past K are skipped). Ends with a block barrier.
  template <int MODE, bool PART = false, class Epi>
  __device__ static void run(const Sm& sm, const bf16* X, const bf16* Y,
                             const Dims& d, Epi&& epi) {
    const int nk = MODE == 2 ? 1 : (d.K + kCol - 1) / kCol;
    const int kl = PART ? (d.K - kCol * (nk - 1)) / 16 : 4;
    const int S = d.mo * d.no * nk;
    uint4 ra[4], rb[4];
    auto load = [&](int s) {
      const int o = s / nk, k = s % nk;
      Chunk ca, cb;
      if constexpr (MODE == 2) {
        ca = Chunk{X, d.lx, 0, kCol * (o / d.no)};
        cb = Chunk{Y, d.ly, 0, kCol * (o % d.no)};
      } else {
        ca = Chunk{X, d.lx, 0, kCol * k};
        cb = MODE == 0 ? Chunk{Y, d.ly, kCol * k, kCol * o}
                       : Chunk{Y, d.ly, kCol * o, kCol * k};
      }
      fetch(ca, ra);
      fetch(cb, rb);
    };
    load(0);
    put(sm.a[0], ra);
    put(sm.b[0], rb);
    Acc acc;
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      const int buf = s & 1, o = s / nk, k = s % nk;
      // the stage's stores visible to wgmma; every thread is done with the
      // step before (it waited for its products), so its stage is free
      wg_publish(0);
      const uint32_t a = smem_addr(sm.a[buf]), b = smem_addr(sm.b[buf]);
      fence_regs(acc.d0);
      fence_regs(acc.d1);
      wgmma_fence();
      if constexpr (PART) {
        mma_step<MODE>(acc, a, b, k > 0, k == nk - 1 ? kl : 4);
      } else {
        mma<MODE>(acc.d0, a, b, 0, k > 0);
        mma<MODE>(acc.d1, a, b, kChunk, k > 0);
      }
      wgmma_commit();
      if (s + 1 < S) load(s + 1);
      wgmma_wait_for<0>();
      fence_regs(acc.d0);
      fence_regs(acc.d1);
      if (s + 1 < S) {
        put(sm.a[buf ^ 1], ra);
        put(sm.b[buf ^ 1], rb);
      }
      if (k == nk - 1) epi(o, acc);
    }
    __syncthreads();
  }
  // The product of the [64, H] tile X and the [H, H] matrix Y (MODE 0: X
  // Y, 1: X Y^T) or X^T Y for a [64, H] Y (MODE 2).
  template <int MODE, class Epi>
  __device__ static void run(const Sm& sm, const bf16* X, const bf16* Y,
                             int H, Epi&& epi) {
    run<MODE>(sm, X, Y, square(H, MODE), epi);
  }
};

// ---- the float32 engine: 256 threads, 4 x 4 register tiles, FMA

struct EngF32 {
  using T = float;
  static constexpr int kThreads = wide_nf::kThreads;
  static constexpr int kSlots = 4;
  static constexpr size_t kStageBytes = sizeof(wide_nf::Stage);
  struct Acc {
    float v[4][4];
  };
  using Sm = wide_nf::Stage*;
  __device__ static Sm carve(char* base) { return (wide_nf::Stage*)base; }
  // thread t holds rows 4 (t / 16) + i (slot i), columns 4 (t % 16) + j
  template <class F>
  __device__ static void each(const Acc& c, F&& f) {
    const int t = threadIdx.x, tm = t / 16, tn = t % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(i, 4 * tm + i, 4 * tn + j, c.v[i][j]);
  }
  __device__ static int slot_row(int i) { return 4 * (threadIdx.x / 16) + i; }
  __device__ static float row_sum(float v) {
#pragma unroll
    for (int m = 1; m < 16; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
  }
  __device__ static bool row_lead() { return (threadIdx.x & 15) == 0; }

  // As EngBf::run; k in chunks of 16 (the last one cut at d.K): A[k][m],
  // B[k][n] staged as f32. PART: as EngBf's (tile_loop takes any K).
  template <int MODE, bool PART = false, class Epi>
  __device__ static void run(Sm st, const float* X, const float* Y,
                             const Dims& d, Epi&& epi) {
    const int t = threadIdx.x;
    const int n_out = d.mo * d.no, K = d.K;
    Acc acc;
#pragma unroll 1
    for (int o = 0; o < n_out; ++o) {
      const int ma = MODE == 2 ? kCol * (o / d.no) : 0;
      const int nb = kCol * (MODE == 2 ? o % d.no : o);
      // element u of the thread's four: A's (k, m) and B's (k, n)
      auto a_at = [&](int u, int& k, int& m) {
        const int e = t + kThreads * u;
        if (MODE == 2) {
          k = e >> 6;
          m = e & 63;
        } else {
          k = e & 15;
          m = e >> 4;
        }
      };
      auto b_at = [&](int u, int& k, int& n) {
        const int e = t + kThreads * u;
        if (MODE == 1) {
          k = e & 15;
          n = e >> 4;
        } else {
          k = e >> 6;
          n = e & 63;
        }
      };
      auto load = [&](int c, float (&ra)[4], float (&rb)[4]) {
        const int k0 = c * wide_nf::kBK;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          int k, m, n;
          a_at(u, k, m);
          ra[u] = MODE == 2 ? X[(size_t)(k0 + k) * d.lx + ma + m]
                            : X[(size_t)m * d.lx + k0 + k];
          b_at(u, k, n);
          rb[u] = MODE == 1 ? Y[(size_t)(nb + n) * d.ly + k0 + k]
                            : Y[(size_t)(k0 + k) * d.ly + nb + n];
        }
      };
      auto put = [&](wide_nf::Stage& s, int buf, const float (&ra)[4],
                     const float (&rb)[4]) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          int k, m, n;
          a_at(u, k, m);
          s.a[buf][k][m] = ra[u];
          b_at(u, k, n);
          s.b[buf][k][n] = rb[u];
        }
      };
      wide_nf::tile_loop(*st, 0, K, load, put, acc.v);
      epi(o, acc);
    }
    __syncthreads();
  }
  template <int MODE, class Epi>
  __device__ static void run(Sm st, const float* X, const float* Y, int H,
                             Epi&& epi) {
    run<MODE>(st, X, Y, square(H, MODE), epi);
  }
};

// ---- the ring engine (bf16): a producer thread and two consumer warpgroups
//
// The all-pairs bf16 K1 / K2 past 256 (egcl_allpairs_xwide.cu's ring
// kernels). A block holds two 64-row tiles, one a consumer warpgroup, and
// one producer thread that copies every operand with TMA into a ring of
// kStages stages (the 128-byte swizzle that wgmma reads; a "full" and an
// "empty" mbarrier a stage). A stage is one k-chunk of a 128-column output
// chunk: the weight chunk (64 x 128, two 64 x 64 boxes) that both
// consumers read, and each consumer's 64 x 64 activation chunk. A consumer
// waits for a stage, issues its four k16 steps of wgmma m64n128k16 (one
// accumulator of 64 f32 a thread), and frees the stage one step later,
// when those products are done; it never waits on a copy of its own. The
// activation tiles live in global memory (L2), written by the consumers
// with plain stores: before the producer's first copy of a product's
// activations, each consumer fences its stores against the copies' proxy
// and arrives on its "ready" barrier. k runs over 64-row chunks and k16
// steps in order, each accumulated in f32, as in EngBf: the products'
// values are EngBf's.
struct RingBf {
  static constexpr int kStages = 6;
  static constexpr int kCons = 2;                     // consumer warpgroups
  static constexpr int kThreads = (kCons + 1) * kWG;  // and the producer's
  static constexpr int kNC = 128;                     // output columns a chunk
  static constexpr uint32_t kBox = sizeof(bf16) * kRows * kCol;  // 64 x 64
  static constexpr size_t kStageBytes = (2 + kCons) * (size_t)kBox;
  static constexpr size_t kRingBytes = kStages * kStageBytes;
  struct Bars {
    uint64_t full[kStages], empty[kStages], ready[kCons];
  };
  // a walk over the ring: the stage and the parity of its phase
  struct Pipe {
    int s = 0;
    uint32_t ph = 0;
    __device__ void next() {
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
  };
  // one thread, before the block's first barrier
  __device__ static void init(Bars& b) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&b.full[s], 1);
      mbar_init(&b.empty[s], kCons * kWG);
    }
    for (int c = 0; c < kCons; ++c) mbar_init(&b.ready[c], kWG);
    mbar_init_fence();
  }
  // every thread of consumer c after its stores of the next product's
  // activation tile (an idle consumer too: the producer waits on both)
  __device__ static void publish(Bars& b, int c) {
    fence_async_global();
    mbar_arrive(&b.ready[c]);
  }

  // The producer's copies of one product (MODE 0: X W, 1: X W^T of the
  // [H, H] weight in wmap) for the tiles at rows xrow[c] of xmap, c < nact
  // (the other consumer idles): 128-column output chunks o, each over the
  // 64-row k-chunks in order, a stage each.
  template <int MODE>
  __device__ static void produce(Bars& b, char* ring, const void* wmap,
                                 const void* xmap, const int (&xrow)[kCons],
                                 int nact, int H, Pipe& p, uint32_t& rph) {
    const int nk = H / kCol, no = (H + kNC - 1) / kNC;
#pragma unroll 1
    for (int o = 0; o < no; ++o) {
      const int nb = min(kNC, H - kNC * o) / kCol;   // weight boxes: 2, 1
#pragma unroll 1
      for (int k = 0; k < nk; ++k) {
        mbar_wait(&b.empty[p.s], p.ph ^ 1);
        char* st = ring + (size_t)p.s * kStageBytes;
        uint64_t* full = &b.full[p.s];
        mbar_arrive_tx(full, (nb + nact) * kBox);
        // the weight chunk (needs no consumer): MODE 0 W's rows k x
        // columns o as 64-column boxes, MODE 1 W's rows o x columns k as
        // 64-row boxes
        for (int h = 0; h < nb; ++h) {
          if (MODE == 0)
            tma_load_2d(st + h * kBox, wmap, full, kNC * o + kCol * h,
                        kCol * k);
          else
            tma_load_2d(st + h * kBox, wmap, full, kCol * k,
                        kNC * o + kCol * h);
        }
        if (o == 0 && k == 0) {
          for (int c = 0; c < kCons; ++c) mbar_wait(&b.ready[c], rph);
          rph ^= 1;
        }
        for (int c = 0; c < nact; ++c)
          tma_load_2d(st + (2 + c) * kBox, xmap, full, kCol * k, xrow[c]);
        p.next();
      }
    }
  }

  // The four k16 steps of one stage into d: A consumer c's activation
  // chunk (K-major), B the weight chunk (MODE 0 MN-major, its halves kBox
  // apart; MODE 1 K-major, 128 rows); 128 output columns, or 64 (WIDE
  // false: the last chunk where H / 64 is odd).
  template <int MODE, bool WIDE>
  __device__ static void mma(float (&d)[64], uint32_t a, uint32_t w,
                             bool acc) {
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = smem_desc(a + 32 * kk, 16, 1024);
      const uint64_t db = MODE == 0 ? smem_desc(w + 2048 * kk, kBox, 1024)
                                    : smem_desc(w + 32 * kk, 16, 1024);
      const int sc = (acc || kk > 0) ? 1 : 0;
      if constexpr (WIDE)
        wgmma_ss128<MODE == 0>(d, da, db, sc);
      else
        wgmma_ss64<MODE == 0>(d, da, db, sc);
    }
    wgmma_commit();
  }

  // One output chunk of consumer c into d: its nk stages in order, each
  // stage freed once the products on it are done (one group left in
  // flight while the next stage is awaited).
  template <int MODE, bool WIDE>
  __device__ static void chunk(Bars& b, const char* ring, int c, int nk,
                               Pipe& p, float (&d)[64]) {
    int held = -1;
#pragma unroll 1
    for (int k = 0; k < nk; ++k) {
      mbar_wait(&b.full[p.s], p.ph);
      const uint32_t st = smem_addr(ring + (size_t)p.s * kStageBytes);
      mma<MODE, WIDE>(d, st + (2 + c) * kBox, st, k > 0);
      if (held >= 0) {
        wgmma_wait_for<1>();
        fence_regs(d);
        mbar_arrive(&b.empty[held]);
      }
      held = p.s;
      p.next();
    }
    wgmma_wait_for<0>();
    fence_regs(d);
    mbar_arrive(&b.empty[held]);
  }

  // Consumer c's side of one product: epi(o, d, nj) takes each 64 x 128
  // output chunk o (its 8 nj columns: an integral_constant of 16, or 8 for
  // a last chunk of 64); pre(o) runs before chunk o's products, so that
  // the loads of its epilogue's operands are in flight while they run. An
  // idle consumer (act false) frees each stage as it arrives. act must be
  // the same over the warpgroup and known so to the compiler (a wgmma on
  // a path it takes for divergent is serialised).
  template <int MODE, class Pre, class Epi>
  __device__ static void consume(Bars& b, const char* ring, int c, bool act,
                                 int H, Pipe& p, Pre&& pre, Epi&& epi) {
    const int nk = H / kCol, no = (H + kNC - 1) / kNC;
    if (!act) {
#pragma unroll 1
      for (int s = 0; s < no * nk; ++s) {
        mbar_wait(&b.full[p.s], p.ph);
        mbar_arrive(&b.empty[p.s]);
        p.next();
      }
      return;
    }
#pragma unroll 1
    for (int o = 0; o < no; ++o) {
      float d[64];
      pre(o);
      if (H - kNC * o >= kNC) {
        chunk<MODE, true>(b, ring, c, nk, p, d);
        epi(o, d, std::integral_constant<int, 16>{});
      } else {
        chunk<MODE, false>(b, ring, c, nk, p, d);
        epi(o, d, std::integral_constant<int, 8>{});
      }
    }
  }

  // f(j, column of the chunk) over thread t's column pairs of a chunk of
  // 8 NJ columns in increasing order: warp w's lane l holds rows row0(t)
  // = 16 w + l / 4 (slot 0) and + 8 (slot 1), columns 8 j + 2 (l % 4) and
  // the next, j < NJ; accumulator d[4 j + 2 slot + e] is (row0 + 8 slot,
  // column + e).
  template <int NJ, class F>
  __device__ static void each_col(int t, F&& f) {
    const int q = t & 3;
#pragma unroll
    for (int j = 0; j < NJ; ++j) f(j, 8 * j + 2 * q);
  }
  __device__ static int row0(int t) { return 16 * (t >> 5) + ((t & 31) >> 2); }
  // the thread's two row partials reduced over the row's four threads
  // into dst (one writer a row)
  __device__ static void rows_out(const float (&v)[2], float* dst, int t) {
    const int r0 = 16 * (t >> 5) + ((t & 31) >> 2);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float s = quad_sum(v[k]);
      if ((t & 3) == 0) dst[r0 + 8 * k] = s;
    }
  }
};

// A row-major [rows, cols] bf16 matrix as a 2-D tensor map of 64 x 64 boxes
// in the 128-byte swizzle (host). cuTensorMapEncodeTiled lives in libcuda;
// it is looked up through the runtime, so the library needs no link to it.
inline cudaError_t box_map(CUtensorMap* m, const void* p, long long rows,
                           int cols) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
      const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorSymbolNotFound;
    encode = (Encode)fn;
  }
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kCol, (cuuint32_t)kRows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dim,
      stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- helpers on the engines' thread layouts

// The thread's row partials reduced over the threads that hold each row,
// into dst (one writer a row).
template <class E>
__device__ void rows_out(float (&v)[E::kSlots], float* dst) {
#pragma unroll
  for (int k = 0; k < E::kSlots; ++k) {
    const float s = E::row_sum(v[k]);
    if (E::row_lead()) dst[E::slot_row(k)] = s;
  }
}

// dst[c] += sum over the tile's rows of X[r][c] (times w[r] where given),
// one thread a column, rows in order.
template <class T>
__device__ void col_sums(const T* X, const float* w, float* dst, int H,
                         int nthreads) {
  using wide_nf::to_f;
  for (int c = threadIdx.x; c < H; c += nthreads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r)
      s = fmaf(to_f(X[(size_t)r * H + c]), w ? w[r] : 1.f, s);
    dst[c] += s;
  }
}

// dst [H, H] += A^T B over the tile's rows (A, B [64, H]), chunk by chunk.
template <class E>
__device__ void outer_add(typename E::Sm sm, const typename E::T* A,
                          const typename E::T* Bt, float* dst, int H) {
  const int G = H / kCol;
  E::template run<2>(sm, A, Bt, H, [&](int o, const typename E::Acc& acc) {
    float* d = dst + (size_t)kCol * (o / G) * H + kCol * (o % G);
    E::each(acc, [&](int, int r, int c, float v) {
      d[(size_t)r * H + c] += v;
    });
  });
}

}  // namespace xwide
}  // namespace
