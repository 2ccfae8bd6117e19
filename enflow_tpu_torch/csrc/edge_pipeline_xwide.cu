// The gathered-edge EGCL at any hidden width H that is a multiple of 64
// and any number C >= 1 of edge features, in bf16 (wgmma) and float32
// (FMA): the forward (K5) and the backward with the input and all seven
// parameter gradients (K6), with nothing in shared memory or registers
// that grows with H or with C.
//
// Replaces the Pallas TPU kernels of enflow_tpu/ops/edge_kernel.py:
//   forward  -> the pallas_call of _edge_fwd (:219), _fwd_kernel (:88)
//   backward -> the pallas_call of _edge_bwd_impl (:246), _bwd_kernel (:116)
// where the wrapper's size rule (ops/edge_pipeline.py kernel_for) sends a
// launch: every padded width past 256, and a launch at 64 .. 256 whose C
// the block of that width's route does not hold (routes "xwide", bf16, and
// "f32_xwide", float32). The contract and its rounding points are those of
// edge_pipeline_plain{,_bwd}: m1, m, g1, tr, agg, F_sum, dcd and de rounded
// to the compute dtype; pre1 .. pre3, the gate, dgate and the dpre* in
// f32; the left operands of the backward's products (rnd(dgate),
// rnd(dpre*)) rounded; every product accumulated in f32; the backward's
// clip mask strict (-100 < x < 100). SiLU's sigmoid is torch.sigmoid's
// arithmetic, as in edge_pipeline_sm90.cu.
//
// Design (that of egcl_allpairs_xwide.cu, on the product engines of
// xwide_engine.cuh):
// - Tiles of 64 edge rows on the Hopper kernels' plan (ops/edge_pipeline.py
//   sm90_plan): where K <= 64 a tile holds floor(64 / K) whole atoms and a
//   work item is a tile; where K > 64 an atom spans ceil(K / 64) tiles and a
//   work item is the atom. Persistent blocks stride over the work items, so
//   an atom's sums have one owner.
// - The first layer pre1 = e W1 + b1 runs on the engine as the hidden
//   layers do: the tile's rows of e are copied into a [64, Cp] scratch tile
//   (Cp: C rounded up to 64, zero past C) and W1 arrives zero-padded to
//   [Cp, H] from the wrapper; the product's k is C rounded up to 16 (bf16:
//   the k16 steps that hold a feature; f32: chunks of 16). de = rnd(dpre1)
//   W1^T runs in 64-column output chunks of Cp over 64-row k-chunks of H,
//   and dW1 += e^T rnd(dpre1) is an outer product over the tile's rows. So
//   C enters only as a loop count and W1 is never resident.
// - The tile's H-wide activations live in per-block scratch in global
//   memory: four [64, H] tiles of the compute dtype, X0 = m1, X1 = m, X2 =
//   g1 and later rnd(dpre2), X3 = rnd(dpre3) and later rnd(dpre1); for the
//   backward three f32 [64, H] tiles F0 .. F2 that hold pre1 .. pre3 and
//   then, in place, dpre1 .. dpre3 (whose column sums are db1 .. db3).
// - The gate g1 . w4 is reduced over the output chunks in each thread's
//   registers, then over the threads that hold a row (a fixed order).
//   agg and F_sum: one thread an (atom, column) over the atom's rows in
//   order; an atom spanning tiles adds them into an f32 row of the block
//   (acc) and writes the sum after its last tile. dagg and dfs are read
//   per row from the row's atom.
// - Parameter gradients: each block owns one f32 slice of the partials in
//   the layout that ops/edge_pipeline.py _split_part reads (dW1 [C, H],
//   dW2 and dW3 [H, H], dw4, db1, db2, db3 [H]); the outer products are
//   read, added to and written once a tile in 64 x 64 chunks, the vectors
//   are column sums. The grid is capped so that the slices stay under 1
//   GiB. The wrapper sums the slices in order: no atomics, so a second
//   launch gives the same bits.
//
// What bounds it on this card: at the top-k sampler's shape (A = 26,624
// atoms, K = 12, C = 11) and H = 512 a K5 does ~0.34 TFLOP of products and
// a K6 ~1 TFLOP (the valid rows'), 0.34 and 1.0 ms at the bf16 tensor-core
// peak; one warpgroup a block staging both operands of every 64 x 64 x 64
// step, and the activations' round trips through global memory between
// the products, keep this simple design far from that (PERF.md has the
// times).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "egcl_wide_nf.cuh"
#include "sm90_common.cuh"
#include "xwide_engine.cuh"

namespace {
namespace edge_xw {

using xwide::col_sums;
using xwide::Dims;
using xwide::EngBf;
using xwide::EngF32;
using xwide::kCol;
using xwide::kMaxH;
using xwide::kMaxPartBytes;
using xwide::kMaxSmem;
using xwide::kRows;
using xwide::outer_add;
using xwide::rows_out;
using wide_nf::from_f;
using wide_nf::rnd;
using wide_nf::to_f;

constexpr int kTiles = 4;      // [64, H] tiles of the compute dtype a block
constexpr int kFTiles = 3;     // [64, H] f32 tiles a block (backward)

// ---- elementwise arithmetic, rounded where the plain version rounds
//
// torch.sigmoid's f32 arithmetic: expf, then the correctly rounded
// reciprocal (rcp.approx and one Newton step; edge_pipeline_sm90.cu's
// recip, checked there against __frcp_rn at every float in [1, 2^126)).
__device__ __forceinline__ float recip(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  r = __fmaf_rn(r, __fmaf_rn(-d, r, 1.0f), r);
  return d < 0x1p126f ? r : 0.0f;
}
__device__ __forceinline__ float sigmoid(float x) {
  return recip(1.0f + expf(-x));
}
__device__ __forceinline__ float silu_e(float x) {
  return __fmul_rn(x, sigmoid(x));
}
__device__ __forceinline__ float dsilu_e(float x) {
  const float s = sigmoid(x);
  return s * (1.0f + __fmul_rn(x, 1.0f - s));
}

// The offsets of one block's slice of the parameter gradients (floats):
// ops/edge_pipeline.py _split_part's order.
struct PartLayout {
  size_t dW1, dW2, dW3, dw4, db1, db2, db3, P;
  __host__ __device__ PartLayout(int C, int H) {
    const size_t h = (size_t)H;
    dW1 = 0;
    dW2 = (size_t)C * h;
    dW3 = dW2 + h * h;
    dw4 = dW3 + h * h;
    db1 = dw4 + h;
    db2 = db1 + h;
    db3 = db2 + h;
    P = db3 + h;
  }
};

template <class T>
struct Args {
  int A, K, C, Cp, H, apt, tpa, units;
  const T *e, *cd, *em;                        // [A, K, C], [A, K, 3], [A, K]
  const T *W1, *b1, *W2, *b2, *W3, *b3, *w4;   // W1 [Cp, H], zero past C
  const T *dagg, *dfs;                         // [A, H], [A, 3] (backward)
  T *agg, *fs;                                 // [A, H], [A, 3] (forward)
  T *de, *dcd;                                 // [A, K, C], [A, K, 3]
  T* scr;        // [grid, 4 * 64 * H + 64 * Cp] the blocks' tiles
  float* fscr;   // [grid, 3 * 64 * H] (backward)
  float* acc;    // [grid, H + 3] (forward, K > 64)
  float* part;   // [grid, P] (backward)
};

// The tile's rows in shared memory: the displacements, the mask, the gate,
// rnd(dgate), and each row's atom (-1 for a row past the tile's rows).
struct Rows {
  float cd[kRows][3];
  float em[kRows], gate[kRows], dg[kRows];
  int atom[kRows];
};

// One tile: its first atom and atoms, its first edge row and rows, and
// whether it is its work item's first and last.
struct Tile {
  int a0, na, g0, nr;
  bool first, last;
};

template <class E>
__device__ void load_tile(const Args<typename E::T>& a, Rows& R,
                          typename E::T* ep, const Tile& tl) {
  using T = typename E::T;
  for (int r = threadIdx.x; r < kRows; r += E::kThreads) {
    const bool in = r < tl.nr;
    const size_t g = (size_t)tl.g0 + r;
#pragma unroll
    for (int d = 0; d < 3; ++d) R.cd[r][d] = in ? to_f(a.cd[g * 3 + d]) : 0.f;
    R.em[r] = in ? to_f(a.em[g]) : 0.f;
    R.atom[r] = in ? (a.apt ? tl.a0 + r / a.K : tl.a0) : -1;
  }
  // e's rows zero-padded to Cp columns, the rows past the tile's zero
  for (int idx = threadIdx.x; idx < kRows * a.Cp; idx += E::kThreads) {
    const int r = idx / a.Cp, c = idx - r * a.Cp;
    ep[idx] = r < tl.nr && c < a.C ? a.e[((size_t)tl.g0 + r) * a.C + c]
                                   : from_f<T>(0.f);
  }
  __syncthreads();
}

// The forward of one tile: m1 -> X0, m -> X1, the gate -> R.gate; for the
// backward also pre1 .. pre3 -> F0 .. F2 and g1 -> X2.
template <class E, bool BWD>
__device__ void forward_tile(const Args<typename E::T>& a, typename E::Sm sm,
                             Rows& R, typename E::T* const (&X)[kTiles],
                             float* const (&F)[kFTiles],
                             const typename E::T* ep) {
  using T = typename E::T;
  using Acc = typename E::Acc;
  const int H = a.H;
  const Dims first{a.Cp, H, 1, H / kCol, 16 * ((a.C + 15) / 16)};
  E::template run<0, true>(sm, ep, a.W1, first, [&](int o, const Acc& acc) {
    E::each(acc, [&](int, int r, int cc, float v) {
      const int c = kCol * o + cc;
      const size_t i = (size_t)r * H + c;
      const float pre = __fadd_rn(v, to_f(a.b1[c]));
      X[0][i] = from_f<T>(silu_e(pre));
      if (BWD) F[0][i] = pre;
    });
  });
  E::template run<0>(sm, X[0], a.W2, H, [&](int o, const Acc& acc) {
    E::each(acc, [&](int, int r, int cc, float v) {
      const int c = kCol * o + cc;
      const size_t i = (size_t)r * H + c;
      const float pre = __fadd_rn(v, to_f(a.b2[c]));
      X[1][i] = from_f<T>(__fmul_rn(silu_e(pre), R.em[r]));
      if (BWD) F[1][i] = pre;
    });
  });
  float gp[E::kSlots];
#pragma unroll
  for (int k = 0; k < E::kSlots; ++k) gp[k] = 0.f;
  E::template run<0>(sm, X[1], a.W3, H, [&](int o, const Acc& acc) {
    E::each(acc, [&](int k, int r, int cc, float v) {
      const int c = kCol * o + cc;
      const size_t i = (size_t)r * H + c;
      const float pre = __fadd_rn(v, to_f(a.b3[c]));
      const float g = rnd<T>(silu_e(pre));
      gp[k] = fmaf(g, to_f(a.w4[c]), gp[k]);
      if (BWD) {
        F[2][i] = pre;
        X[2][i] = from_f<T>(g);
      }
    });
  });
  rows_out<E>(gp, R.gate);
  __syncthreads();
}

// tr = rnd(clip(cd gate, +-100) em) of row r, coordinate d
template <class T>
__device__ __forceinline__ float tr_at(const Rows& R, int r, int d) {
  const float x = fminf(fmaxf(__fmul_rn(R.cd[r][d], R.gate[r]), -100.f),
                        100.f);
  return rnd<T>(__fmul_rn(x, R.em[r]));
}

// The forward's node sums of a tile: agg = sum_K m and F_sum = sum_K tr,
// one thread an (atom, column), the atom's rows in order.
template <class E>
__device__ void forward_sums(const Args<typename E::T>& a, const Rows& R,
                             const typename E::T* X1, float* acc,
                             const Tile& tl) {
  using T = typename E::T;
  const int H = a.H, t = threadIdx.x;
  if (a.apt) {
    for (int idx = t; idx < tl.na * (H + 3); idx += E::kThreads) {
      const int l = idx / (H + 3), c = idx - l * (H + 3);
      float s = 0.f;
      for (int k = 0; k < a.K; ++k) {
        const int r = l * a.K + k;
        s += c < H ? to_f(X1[(size_t)r * H + c]) : tr_at<T>(R, r, c - H);
      }
      const size_t at = (size_t)tl.a0 + l;
      if (c < H)
        a.agg[at * H + c] = from_f<T>(s);
      else
        a.fs[at * 3 + c - H] = from_f<T>(s);
    }
  } else {
    // an atom over several tiles: its sums carried in acc
    for (int c = t; c < H + 3; c += E::kThreads) {
      float s = tl.first ? 0.f : acc[c];
      for (int r = 0; r < tl.nr; ++r)
        s += c < H ? to_f(X1[(size_t)r * H + c]) : tr_at<T>(R, r, c - H);
      if (!tl.last)
        acc[c] = s;
      else if (c < H)
        a.agg[(size_t)tl.a0 * H + c] = from_f<T>(s);
      else
        a.fs[(size_t)tl.a0 * 3 + c - H] = from_f<T>(s);
    }
  }
  __syncthreads();
}

// The backward of one tile after forward_tile: dcd and de written, the
// tile's parameter gradients added into the block's slice `part`.
template <class E>
__device__ void backward_tile(const Args<typename E::T>& a,
                              typename E::Sm sm, Rows& R,
                              typename E::T* const (&X)[kTiles],
                              float* const (&F)[kFTiles],
                              const typename E::T* ep, float* part,
                              const Tile& tl) {
  using T = typename E::T;
  using Acc = typename E::Acc;
  const int H = a.H, t = threadIdx.x;
  const PartLayout PL(a.C, H);
  // the force branch per row: dtr = dfs_a clip em, dgate = cd . dtr, dcd
  for (int r = t; r < kRows; r += E::kThreads) {
    const int at = R.atom[r];
    const float g = R.gate[r];
    float dg = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float c = R.cd[r][d], raw = __fmul_rn(c, g);
      const float inside = (raw > -100.f && raw < 100.f) ? 1.f : 0.f;
      const float dt =
          at >= 0
              ? __fmul_rn(__fmul_rn(to_f(a.dfs[(size_t)at * 3 + d]), inside),
                          R.em[r])
              : 0.f;
      dg = __fadd_rn(dg, __fmul_rn(c, dt));
      if (at >= 0)
        a.dcd[((size_t)tl.g0 + r) * 3 + d] = from_f<T>(__fmul_rn(g, dt));
    }
    R.dg[r] = rnd<T>(dg);
  }
  __syncthreads();
  // dpre3 = (rnd(dgate) w4) dsilu(pre3): in place of pre3, rounded -> X3
  for (int idx = t; idx < kRows * H; idx += E::kThreads) {
    const int r = idx / H, c = idx - r * H;
    const float v = __fmul_rn(__fmul_rn(R.dg[r], to_f(a.w4[c])),
                              dsilu_e(F[2][idx]));
    F[2][idx] = v;
    X[3][idx] = from_f<T>(v);
  }
  __syncthreads();
  col_sums(F[2], nullptr, part + PL.db3, H, E::kThreads);
  col_sums(X[2], R.dg, part + PL.dw4, H, E::kThreads);   // g1^T rnd(dgate)
  outer_add<E>(sm, X[1], X[3], part + PL.dW3, H);         // m^T rnd(dpre3)
  // dpre2 = (rnd(dagg_a) + rnd(dpre3) W3^T) em dsilu(pre2): in place of
  // pre2, rounded -> X2
  E::template run<1>(sm, X[3], a.W3, H, [&](int o, const Acc& acc) {
    E::each(acc, [&](int, int r, int cc, float v) {
      const int c = kCol * o + cc, at = R.atom[r];
      const size_t i = (size_t)r * H + c;
      const float da = at >= 0 ? to_f(a.dagg[(size_t)at * H + c]) : 0.f;
      const float dm = __fmul_rn(__fadd_rn(da, v), R.em[r]);
      const float dp = __fmul_rn(dm, dsilu_e(F[1][i]));
      F[1][i] = dp;
      X[2][i] = from_f<T>(dp);
    });
  });
  col_sums(F[1], nullptr, part + PL.db2, H, E::kThreads);
  outer_add<E>(sm, X[0], X[2], part + PL.dW2, H);         // m1^T rnd(dpre2)
  // dpre1 = (rnd(dpre2) W2^T) dsilu(pre1): in place of pre1, rounded -> X3
  E::template run<1>(sm, X[2], a.W2, H, [&](int o, const Acc& acc) {
    E::each(acc, [&](int, int r, int cc, float v) {
      const size_t i = (size_t)r * H + kCol * o + cc;
      const float dp = __fmul_rn(v, dsilu_e(F[0][i]));
      F[0][i] = dp;
      X[3][i] = from_f<T>(dp);
    });
  });
  col_sums(F[0], nullptr, part + PL.db1, H, E::kThreads);
  // dW1 += e^T rnd(dpre1): [Cp, H] in 64 x 64 chunks, the rows of C kept
  const Dims outer{a.Cp, H, a.Cp / kCol, H / kCol, kRows};
  E::template run<2>(sm, ep, X[3], outer, [&](int o, const Acc& acc) {
    const int m0 = kCol * (o / outer.no), n0 = kCol * (o % outer.no);
    float* const d = part + PL.dW1 + (size_t)m0 * H + n0;
    E::each(acc, [&](int, int r, int c, float v) {
      if (m0 + r < a.C) d[(size_t)r * H + c] += v;
    });
  });
  // de = rnd(rnd(dpre1) W1^T): Cp / 64 output chunks over H / 64 k-chunks
  const Dims back{H, H, 1, a.Cp / kCol, H};
  E::template run<1>(sm, X[3], a.W1, back, [&](int o, const Acc& acc) {
    E::each(acc, [&](int, int r, int cc, float v) {
      const int c = kCol * o + cc;
      if (r < tl.nr && c < a.C)
        a.de[((size_t)tl.g0 + r) * a.C + c] = from_f<T>(v);
    });
  });
}

// ---- the kernels: persistent blocks over the work items

template <class E>
size_t smem_bytes() {
  return 1024 + E::kStageBytes + sizeof(Rows);
}

template <class E, bool BWD>
__global__ void __launch_bounds__(E::kThreads, 1)
    edge_xwide_kernel(Args<typename E::T> a) {
  using T = typename E::T;
  extern __shared__ char smem_raw[];
  char* base = (char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const typename E::Sm sm = E::carve(base);
  Rows& R = *reinterpret_cast<Rows*>(base + E::kStageBytes);
  const int H = a.H;
  const size_t TE = (size_t)kRows * H;
  T* const x0 =
      a.scr + (size_t)blockIdx.x * (kTiles * TE + (size_t)kRows * a.Cp);
  T* const X[kTiles] = {x0, x0 + TE, x0 + 2 * TE, x0 + 3 * TE};
  T* const ep = x0 + kTiles * TE;
  float* const f0 = BWD ? a.fscr + (size_t)blockIdx.x * kFTiles * TE
                        : nullptr;
  float* const F[kFTiles] = {f0, BWD ? f0 + TE : nullptr,
                             BWD ? f0 + 2 * TE : nullptr};
  const PartLayout PL(a.C, H);
  float* const part = BWD ? a.part + (size_t)blockIdx.x * PL.P : nullptr;
  float* const acc = BWD ? nullptr : a.acc + (size_t)blockIdx.x * (H + 3);
  if (BWD) {
    for (size_t k = threadIdx.x; k < PL.P; k += E::kThreads) part[k] = 0.f;
    __syncthreads();
  }
  const int tiles = a.apt ? 1 : a.tpa;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    for (int k = 0; k < tiles; ++k) {
      Tile tl;
      if (a.apt) {
        tl.a0 = u * a.apt;
        tl.na = min(a.apt, a.A - tl.a0);
        tl.g0 = tl.a0 * a.K;
        tl.nr = tl.na * a.K;
      } else {
        tl.a0 = u;
        tl.na = 1;
        tl.g0 = u * a.K + kRows * k;
        tl.nr = min(kRows, a.K - kRows * k);
      }
      tl.first = k == 0;
      tl.last = k == tiles - 1;
      load_tile<E>(a, R, ep, tl);
      forward_tile<E, BWD>(a, sm, R, X, F, ep);
      if constexpr (BWD)
        backward_tile<E>(a, sm, R, X, F, ep, part, tl);
      else
        forward_sums<E>(a, R, X[1], acc, tl);
    }
  }
}

bool takes(int A, int K, int C, int H) {
  return A >= 1 && K >= 1 && C >= 1 && H >= kCol && H <= kMaxH &&
         H % kCol == 0;
}

// The plan is sm90_plan's: apt atoms a tile (K <= 64) or tpa tiles an atom.
bool plan_ok(int A, int K, int apt, int tpa, int units) {
  if (apt >= 1)
    return tpa == 1 && apt * K <= kRows && units == (A + apt - 1) / apt;
  return apt == 0 && K > kRows && tpa == (K + kRows - 1) / kRows &&
         units == A;
}

// The grid of a launch: at most `blocks` blocks and one per work item;
// the backward also at most as many slices as fit in 1 GiB.
int grid_of(int units, int C, int H, int bwd, int blocks) {
  long long g = std::min<long long>(blocks, units);
  if (bwd)
    g = std::min<long long>(
        g, (long long)(kMaxPartBytes / (4.0 * PartLayout(C, H).P)));
  return (int)std::max<long long>(1, g);
}

struct Ptrs {
  const void *e, *cd, *em, *W1, *b1, *W2, *b2, *W3, *b3, *w4, *dagg, *dfs;
  void *agg, *fs, *de, *dcd, *scr, *fscr, *acc, *part;
};

template <class E>
int launch(int A, int K, int C, int H, int apt, int tpa, int units,
           int blocks, const Ptrs& p, bool bwd, cudaStream_t st) {
  using T = typename E::T;
  using cT = const T*;
  if (!takes(A, K, C, H) || !plan_ok(A, K, apt, tpa, units) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  Args<T> a{A,         K,          C,          (C + kCol - 1) / kCol * kCol,
            H,         apt,        tpa,        units,
            (cT)p.e,   (cT)p.cd,   (cT)p.em,   (cT)p.W1,
            (cT)p.b1,  (cT)p.W2,   (cT)p.b2,   (cT)p.W3,
            (cT)p.b3,  (cT)p.w4,   (cT)p.dagg, (cT)p.dfs,
            (T*)p.agg, (T*)p.fs,   (T*)p.de,   (T*)p.dcd,
            (T*)p.scr, (float*)p.fscr, (float*)p.acc, (float*)p.part};
  const size_t smem = smem_bytes<E>();
  void (*kernel)(Args<T>) =
      bwd ? edge_xwide_kernel<E, true> : edge_xwide_kernel<E, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(units, C, H, bwd, blocks), E::kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

int launch_code(int code, int A, int K, int C, int H, int apt, int tpa,
                int units, int blocks, const Ptrs& p, bool bwd,
                void* stream) {
  if (code == 1)
    return launch<EngBf>(A, K, C, H, apt, tpa, units, blocks, p, bwd,
                         (cudaStream_t)stream);
  if (code == 0)
    return launch<EngF32>(A, K, C, H, apt, tpa, units, blocks, p, bwd,
                          (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace edge_xw
}  // namespace

extern "C" {

// Dynamic shared memory of a launch (the same at every C and H: nothing in
// it grows with either), or -1 for sizes the kernels do not take (H not a
// multiple of 64 in 64 .. 11,520, C < 1, another dtype code). code: 1
// bf16, 0 float32; bwd: 0 forward, 1 backward.
long long edge_xwide_smem_bytes(int code, int C, int H, int bwd) {
  using namespace edge_xw;
  if (bwd < 0 || bwd > 1 || !takes(1, 1, C, H)) return -1;
  if (code == 1) return (long long)smem_bytes<EngBf>();
  if (code == 0) return (long long)smem_bytes<EngF32>();
  return -1;
}

long long edge_xwide_smem_limit() { return (long long)edge_xw::kMaxSmem; }

// Threads a block of the dtype's kernels (128 bf16, 256 float32).
int edge_xwide_threads(int code) {
  return code == 1 ? edge_xw::EngBf::kThreads
                   : code == 0 ? edge_xw::EngF32::kThreads : -1;
}

// The widest H the kernels take.
int edge_xwide_max_width() { return edge_xw::kMaxH; }

// Floats of one block's slice of the parameter gradients (C H + 2 H^2 +
// 4 H).
long long edge_xwide_part_floats(int C, int H) {
  return (long long)edge_xw::PartLayout(C, H).P;
}

// The blocks of a launch of `units` work items: the first dimension of its
// scratch [grid, 4 * 64 * H + 64 * Cp] (compute dtype), the forward's
// sums [grid, H + 3] and the backward's f32 tiles [grid, 3 * 64 * H] and
// slices [grid, edge_xwide_part_floats(C, H)].
int edge_xwide_grid(int units, int C, int H, int bwd, int blocks) {
  if (units < 1 || blocks < 1 || !edge_xw::takes(1, 1, C, H)) return -1;
  return edge_xw::grid_of(units, C, H, bwd, blocks);
}

// The forward (agg, F_sum) and the backward (de, dcd and the slices of the
// seven parameter gradients; the caller sums the slices in order) for
// compute-dtype inputs and weights (code 1 bf16, 0 float32), W1 zero-padded
// to [Cp, H] (Cp: C rounded up to 64); the plan (apt, tpa, units) that
// ops/edge_pipeline.py sm90_plan gives at one warpgroup a block. Returns
// the cudaError_t of the launch (0 on success).
int edge_xwide_fwd(int code, int A, int K, int C, int H, int apt, int tpa,
                   int units, int blocks, const void* e, const void* cd,
                   const void* em, const void* W1, const void* b1,
                   const void* W2, const void* b2, const void* W3,
                   const void* b3, const void* w4, void* scr, void* acc,
                   void* agg, void* fs, void* stream) {
  edge_xw::Ptrs p{e,   cd,  em,      W1,      b1,  W2,      b2,
                  W3,  b3,  w4,      nullptr, nullptr, agg, fs,
                  nullptr, nullptr, scr, nullptr, acc, nullptr};
  return edge_xw::launch_code(code, A, K, C, H, apt, tpa, units, blocks, p,
                              false, stream);
}

int edge_xwide_bwd(int code, int A, int K, int C, int H, int apt, int tpa,
                   int units, int blocks, const void* e, const void* cd,
                   const void* em, const void* W1, const void* b1,
                   const void* W2, const void* b2, const void* W3,
                   const void* b3, const void* w4, const void* dagg,
                   const void* dfs, void* scr, void* fscr, void* de,
                   void* dcd, void* part, void* stream) {
  edge_xw::Ptrs p{e,       cd,      em,  W1,   b1,   W2,      b2,
                  W3,      b3,      w4,  dagg, dfs,  nullptr, nullptr,
                  de,      dcd,     scr, fscr, nullptr, part};
  return edge_xw::launch_code(code, A, K, C, H, apt, tpa, units, blocks, p,
                              true, stream);
}

const char* edge_xwide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
