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
//
// The shapes of a product (Dims): X and Y row-major with leading
// dimensions lx and ly; MODE 0 X [64, K] Y [K, 64 no], MODE 1 X [64, K]
// Y^T with Y [64 no, K], MODE 2 X^T Y with X [64, 64 mo], Y [64, 64 no]
// and K = 64 (the tile's rows). K is a multiple of 16, and the memory of
// X and Y holds every k of the last 64-chunk (zero past K).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

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
