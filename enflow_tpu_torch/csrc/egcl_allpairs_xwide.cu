// The fused all-pairs EGCL past H = 256, in bf16 (wgmma) and float32
// (FMA): the forward, the input-gradient backward, and the backward with
// the nine parameter gradients, at any hidden width H that is a multiple
// of 64, with nothing in shared memory or registers that grows with H.
//
// Replaces the Pallas TPU kernels of enflow_tpu/ops/egcl_fused_v3.py:
//   forward  -> the pallas_call of _fused_fwd (:365), _fwd_kernel
//   backward -> the pallas_call of _fused_bwd (:414), _bwd_kernel, in its
//               input-gradient form (dh, dpos) and with the parameter
//               gradients of _bwd_kernel:256-273
// where the wrapper's size rule (ops/egcl_allpairs.py kernel_for) sends a
// launch of H > 256: routes "xwide" (bf16) and "f32_xwide" (float32); other
// widths past 256 are zero-padded to the next multiple of 64. The contract
// and its rounding points are those of egcl_allpairs_sm90.cu: z1, m1, z2,
// m2 and z3 rounded to the compute dtype, every product accumulated in f32
// (the plain version allpairs_edges_plain{,_bwd} repeats them).
//
// Why the other routes stop at 256: their block pairs keep [64, H]
// activation tiles and weight slabs in shared memory (three tiles and two
// slabs in the bf16 K2 p: 395,776 bytes at H = 512), a [64, H] f32 wgmma
// accumulator (256 registers a thread at 512), or 2H threads a block (f32).
// Here H enters only through loop counts:
// - The first layer comes from the per-atom projections P = [rnd(h W1a) |
//   rnd(h W1b)] of egcl_wide_nf.cuh's egcl_nf_proj_kernel, so W1 is never
//   resident: z1 of a pair is elementwise in P's rows.
// - A tile is a block pair of 8 i atoms x 8 j atoms of one molecule, 64
//   edge rows (row r: i = 8 ib + r / 8, j = 8 jb + r % 8; self-pairs and
//   atoms past N have valid 0, which zeroes every contribution, and padded
//   atoms read no memory). A work item, (molecule, i-block), walks the
//   j-blocks; persistent blocks stride over the items.
// - The tile's H-wide activations live in global memory, five [64, H]
//   tiles of the compute dtype per block (L2-resident at the sizes of the
//   main paths): X3 = m1; X0 = m2, later dz1; X1 = dsilu(z2), then dz2 in
//   place; X2 = dsilu(z3), then dz3 in place; X4 = g1 (parameter
//   gradients).
// - The bf16 forward (K1) and input-gradient backward (K2) run on the
//   ring kernels below (egcl_xwide_kernel_ring, xwide_engine.cuh's
//   RingBf): two consumer warpgroups, one tile each, and a producer
//   thread whose TMA copies keep a ring of six stages full; each staged
//   64 x 128 weight chunk feeds both tiles through wgmma m64n128k16. The
//   note before them says what they change and why.
// - K2 p and every float32 launch run egcl_xwide_kernel: each H x H
//   product on the engines of xwide_engine.cuh (shared with
//   edge_pipeline_xwide.cu) in 64-column output chunks (a runtime count),
//   each over 64-row k-chunks of the weight: a chunk of the activation and
//   one of the weight are staged in shared memory per step, two steps
//   deep (the next step's loads issued while the current step computes).
//   bf16: one warpgroup, the operands in the 128-byte swizzle, wgmma
//   m64n32k16 (two accumulators of 16 f32 a thread); X W reads the weight
//   chunk MN-major, X W^T K-major, and the outer products A^T B of the
//   parameter gradients read both tiles MN-major with the 64 edge rows as
//   K. float32: 256 threads, each 4 x 4 of the 64 x 64 output chunk, k in
//   chunks of 16 staged as f32 (egcl_wide_nf.cuh's tile loop), one FMA
//   chain in k order per output.
// - The gate (silu(z3) . w4) and dr2 (dz1 . w1r) are reduced over the
//   output chunks in each thread's registers, then over the threads that
//   hold a row (shuffles, a fixed order). The node sums are plain loops
//   over a tile's rows in global memory: the forward's i-side sums (agg,
//   f_sum) per work item in an f32 [8, H + 4] buffer of the block; the
//   backward's i-side dz1 and d_cd sums into si [B, N, H + 4] (accumulated
//   over the j-blocks by the one owner) and its j-side sums into pj [B, nI,
//   N, H + 4] (one writer a block pair); egcl_wide_nf.cuh's kernels then
//   form dpos, dh = rnd(dz1_i) W1a^T + rnd(dz1_j) W1b^T and dW1a / dW1b.
// - Parameter gradients: each block owns one f32 slice [P] of the
//   partials (PartLayout at nf 0: dW2, dW3, then the vectors): dW3 += m2^T
//   dz3 and dW2 += m1^T dz2 in 64 x 64 chunks read, added to and written
//   once a tile; db1, db2, db3 column sums, dw1r and dw4 with the f32 row
//   weights r2 and dgate. The grid is capped so that the slices stay under
//   1 GiB (2 H^2 floats each: 2 MiB at H = 512). The wrapper sums the
//   slices in order; no atomics anywhere, so two launches give the same
//   bits.
//
// What bounds it on this card: at the reference's H = 512 shape (B=1024
// molecules of N=13) K1's products are ~0.26 TFLOP a launch (the 8 x 8
// tiles of a 13-atom molecule hold 256 rows for its 169 pairs), ~0.27 ms at
// the bf16 tensor-core peak. egcl_xwide_kernel (K2 p, float32) stages both
// operands through shared memory for every 64 x 64 x 64 step with one
// warpgroup a block and no overlap, far from that; the ring kernels (bf16
// K1 and K2) are bound by their elementwise epilogues' transcendentals and
// conversions instead (PERF.md has the times).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "egcl_part_layout.cuh"
#include "egcl_wide_nf.cuh"
#include "sm90_common.cuh"
#include "xwide_engine.cuh"

namespace {
namespace xwide {

using wide_nf::from_f;
using wide_nf::rnd;
using wide_nf::to_f;

constexpr int kAtoms = 8;      // atoms a block (8 x 8 = kRows)
constexpr int kTiles = 5;      // [64, H] activation tiles a block

enum Kind { kFwd = 0, kBwd = 1, kBwdParams = 2 };

template <class T>
struct Args {
  int B, N, nf, H, nI;
  const T* h;         // [B, N, nf]
  const float* pos;   // [B, N, 3]
  const float* box;   // [B, 3]
  const T* mask;      // [B, N]
  const T *W1a, *W1b, *w1r, *b1, *W2, *b2, *W3, *b3, *w4;
  const T* dagg;      // [B, N, H]  (backward)
  const T* dfsum;     // [B, N, 3]  (backward)
  T* agg;             // [B, N, H]  (forward)
  T* fsum;            // [B, N, 3]  (forward)
  T* dh;              // [B, N, nf] (backward)
  float* dpos;        // [B, N, 3]  (backward)
  T* proj;            // [B, N, 2H] the projections (scratch)
  T* scr;             // [grid, kTiles, 64, H] the blocks' tiles (scratch)
  float* acc;         // [grid, 8, H + 4] the forward's i-side sums
  float* si;          // [B, N, H + 4] (backward)
  float* pj;          // [B, nI, N, H + 4] (backward)
  float* sj;          // [B, N, H] (backward)
  float* dw1;         // [splits, 2, nf, H] (parameter gradients)
  float* part;        // [grid, P] (parameter gradients)
  int splits;
};

// The tile's rows in shared memory: geometry, the atoms' global rows (-1
// for an atom past N), the gate and the backward's per-row cotangents, and
// a work item's force sums.
struct Rows {
  float cd[kRows][3];
  float dcd[kRows][3];
  float r2[kRows], valid[kRows], gate[kRows], dgate[kRows], dr2[kRows];
  int ri[kRows], rj[kRows];
  float fs[kAtoms][3];
};

// ---- one tile's elementwise work

// threads t0, t0 + nt, ... over the rows
template <class T>
__device__ void load_rows(const Args<T>& a, Rows& R, int b, int ib, int jb,
                          int t0, int nt) {
  for (int r = t0; r < kRows; r += nt) {
    const int i = ib * kAtoms + r / kAtoms, j = jb * kAtoms + r % kAtoms;
    const bool in = i < a.N && j < a.N;
    const int gi = b * a.N + i, gj = b * a.N + j;
    float r2 = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float c = 0.f;
      if (in) {
        c = a.pos[(size_t)gi * 3 + d] - a.pos[(size_t)gj * 3 + d];
        const float bx = a.box[(size_t)b * 3 + d];
        c = c - rintf(c / bx) * bx;     // round half to even, as jnp.round
      }
      R.cd[r][d] = c;
      r2 += c * c;
    }
    R.r2[r] = r2;
    R.valid[r] = in && i != j ? to_f(a.mask[gi]) * to_f(a.mask[gj]) : 0.f;
    R.ri[r] = in ? gi : -1;
    R.rj[r] = in ? gj : -1;
  }
}

// z1 = hA_i + hB_j + b1 + r2 w1r at row r, column c, rounded where
// _fwd_block rounds (one rounding an operation).
template <class T>
__device__ __forceinline__ float z1_at(const Args<T>& a, const Rows& R, int r,
                                       int c) {
  const size_t H2 = 2 * (size_t)a.H;
  const float ha = R.ri[r] >= 0 ? to_f(a.proj[R.ri[r] * H2 + c]) : 0.f;
  const float hb = R.rj[r] >= 0 ? to_f(a.proj[R.rj[r] * H2 + a.H + c]) : 0.f;
  const float z =
      rnd<T>(__fadd_rn(rnd<T>(__fadd_rn(ha, hb)), to_f(a.b1[c])));
  return rnd<T>(
      __fadd_rn(z, rnd<T>(__fmul_rn(rnd<T>(R.r2[r]), to_f(a.w1r[c])))));
}

// The force branch of row r (f32): dgate and d_cd from dfsum.
template <class T>
__device__ __forceinline__ void force_row(const Args<T>& a, Rows& R, int r) {
  const float g = R.gate[r];
  float dg = 0.f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float raw = R.cd[r][d] * g;
    const float inside = (raw >= -100.f && raw <= 100.f) ? 1.f : 0.f;
    const float dt = R.ri[r] >= 0
                         ? to_f(a.dfsum[(size_t)R.ri[r] * 3 + d]) * inside *
                               R.valid[r]
                         : 0.f;
    dg = fmaf(R.cd[r][d], dt, dg);
    R.dcd[r][d] = g * dt;
  }
  R.dgate[r] = dg;
}

// Row r's d_cd + 2 cd dr2, rounded to the compute dtype.
template <class T>
__device__ __forceinline__ void dcd_row(Rows& R, int r) {
#pragma unroll
  for (int d = 0; d < 3; ++d)
    R.dcd[r][d] = rnd<T>(__fadd_rn(
        R.dcd[r][d], __fmul_rn(__fmul_rn(2.f, R.cd[r][d]), R.dr2[r])));
}

// The forward of one tile (block pair ib, jb of molecule b): m1 -> X3, m2
// -> X0 (and for the backward dsilu(z2) -> X1), then z3's chunks: the gate
// (R.gate) and for the backward dsilu(z3) -> X2, g1 -> X4 (PARAMS).
template <class E, bool BWD, bool PARAMS>
__device__ void forward_tile(const Args<typename E::T>& a,
                             typename E::Sm sm, Rows& R,
                             typename E::T* const (&X)[kTiles]) {
  using T = typename E::T;
  const int H = a.H;
  for (int idx = threadIdx.x; idx < kRows * H; idx += E::kThreads) {
    const int r = idx / H, c = idx - r * H;
    X[3][idx] = from_f<T>(silu(z1_at(a, R, r, c)));
  }
  __syncthreads();
  E::template run<0>(sm, X[3], a.W2, H, [&](int o, const typename E::Acc& acc) {
    E::each(acc, [&](int, int r, int cc, float v) {
      const int c = kCol * o + cc;
      const float z = rnd<T>(__fadd_rn(rnd<T>(v), to_f(a.b2[c])));
      X[0][(size_t)r * H + c] =
          from_f<T>(__fmul_rn(rnd<T>(silu(z)), R.valid[r]));
      if (BWD) X[1][(size_t)r * H + c] = from_f<T>(dsilu(z));
    });
  });
  float gp[E::kSlots];
#pragma unroll
  for (int k = 0; k < E::kSlots; ++k) gp[k] = 0.f;
  E::template run<0>(sm, X[0], a.W3, H, [&](int o, const typename E::Acc& acc) {
    E::each(acc, [&](int k, int r, int cc, float v) {
      const int c = kCol * o + cc;
      const float z = rnd<T>(__fadd_rn(rnd<T>(v), to_f(a.b3[c])));
      const float g = rnd<T>(silu(z));
      gp[k] = fmaf(g, to_f(a.w4[c]), gp[k]);
      if (BWD) X[2][(size_t)r * H + c] = from_f<T>(dsilu(z));
      if (PARAMS) X[4][(size_t)r * H + c] = from_f<T>(g);
    });
  });
  rows_out<E>(gp, R.gate);
  __syncthreads();
}

// The backward of one tile after forward_tile: dz3 -> X2, dz2 -> X1, dz1
// -> X0, the per-row cotangents in R, and with PARAMS the tile's parameter
// gradients added into the block's slice `part`.
template <class E, bool PARAMS>
__device__ void backward_tile(const Args<typename E::T>& a,
                              typename E::Sm sm, Rows& R,
                              typename E::T* const (&X)[kTiles],
                              float* part) {
  using T = typename E::T;
  const int H = a.H, t = threadIdx.x;
  const PartLayout PL(0, H);
  // the force branch per row (f32): dgate and d_cd from dfsum
  for (int r = t; r < kRows; r += E::kThreads) force_row(a, R, r);
  __syncthreads();
  // dz3 = rnd(rnd(dgate) w4) dsilu(z3), in place of dsilu(z3)
  for (int idx = t; idx < kRows * H; idx += E::kThreads) {
    const int r = idx / H, c = idx - r * H;
    const float dg1 = rnd<T>(__fmul_rn(rnd<T>(R.dgate[r]), to_f(a.w4[c])));
    X[2][idx] = from_f<T>(__fmul_rn(dg1, to_f(X[2][idx])));
  }
  __syncthreads();
  if (PARAMS) {
    outer_add<E>(sm, X[0], X[2], part + PL.dW3, H);     // m2^T dz3
    col_sums(X[2], nullptr, part + PL.db3, H, E::kThreads);
    col_sums(X[4], R.dgate, part + PL.dw4, H, E::kThreads);  // g1^T dgate
    __syncthreads();
  }
  // dz2 = rnd((dz3 W3^T + dagg_i) valid) dsilu(z2), in place of dsilu(z2)
  E::template run<1>(sm, X[2], a.W3, H, [&](int o, const typename E::Acc& acc) {
    E::each(acc, [&](int, int r, int cc, float v) {
      const int c = kCol * o + cc;
      const float da =
          R.ri[r] >= 0 ? to_f(a.dagg[(size_t)R.ri[r] * H + c]) : 0.f;
      const float dm =
          rnd<T>(__fmul_rn(rnd<T>(__fadd_rn(rnd<T>(v), da)), R.valid[r]));
      T* x = X[1] + (size_t)r * H + c;
      *x = from_f<T>(__fmul_rn(dm, to_f(*x)));
    });
  });
  if (PARAMS) {
    outer_add<E>(sm, X[3], X[1], part + PL.dW2, H);     // m1^T dz2
    col_sums(X[1], nullptr, part + PL.db2, H, E::kThreads);
    __syncthreads();
  }
  // dz1 = rnd(dz2 W2^T) dsilu(z1) -> X0, dr2 = dz1 . w1r
  float dp[E::kSlots];
#pragma unroll
  for (int k = 0; k < E::kSlots; ++k) dp[k] = 0.f;
  E::template run<1>(sm, X[1], a.W2, H, [&](int o, const typename E::Acc& acc) {
    E::each(acc, [&](int k, int r, int cc, float v) {
      const int c = kCol * o + cc;
      const float ds = rnd<T>(dsilu(z1_at(a, R, r, c)));
      const float dz = rnd<T>(__fmul_rn(rnd<T>(v), ds));
      X[0][(size_t)r * H + c] = from_f<T>(dz);
      dp[k] = fmaf(dz, to_f(a.w1r[c]), dp[k]);
    });
  });
  rows_out<E>(dp, R.dr2);
  __syncthreads();
  // d_cd + 2 cd dr2, rounded to the compute dtype (the node sums' terms)
  for (int r = t; r < kRows; r += E::kThreads) dcd_row<T>(R, r);
  if (PARAMS) {
    col_sums(X[0], nullptr, part + PL.db1, H, E::kThreads);
    col_sums(X[0], R.r2, part + PL.dw1r, H, E::kThreads);  // dz1^T r2
  }
  __syncthreads();
}

// The backward's node sums of a tile: over its j atoms into si (the i
// atoms' rows, accumulated over the j-blocks by their one owner) and over
// its i atoms into pj (this block pair's row); columns H .. H+2 the d_cd
// sums, H+3 zero.
template <class E>
__device__ void bwd_sums(const Args<typename E::T>& a, const Rows& R,
                         const typename E::T* X0, int b, int ib, int jb) {
  const int H = a.H, C = H + 4, N = a.N;
  for (int idx = threadIdx.x; idx < kAtoms * C; idx += E::kThreads) {
    const int l = idx / C, c = idx - l * C;
    auto term = [&](int r) {
      return c < H ? to_f(X0[(size_t)r * H + c])
                   : c < H + 3 ? R.dcd[r][c - H] : 0.f;
    };
    const int i = ib * kAtoms + l, j = jb * kAtoms + l;
    if (i < N) {
      float s = 0.f;
      for (int m = 0; m < kAtoms; ++m) s += term(l * kAtoms + m);
      float* p = a.si + ((size_t)b * N + i) * C + c;
      *p = (jb == 0 ? 0.f : *p) + s;
    }
    if (j < N) {
      float s = 0.f;
      for (int m = 0; m < kAtoms; ++m) s += term(m * kAtoms + l);
      a.pj[(((size_t)b * a.nI + ib) * N + j) * C + c] = s;
    }
  }
  __syncthreads();
}

// ---- the kernels: persistent blocks over (molecule, i-block) items

template <class E>
size_t smem_bytes() {
  return 1024 + E::kStageBytes + sizeof(Rows);
}

template <class E, int KIND>
__global__ void __launch_bounds__(E::kThreads, 1)
    egcl_xwide_kernel(Args<typename E::T> a) {
  using T = typename E::T;
  constexpr bool BWD = KIND != kFwd, PARAMS = KIND == kBwdParams;
  extern __shared__ char smem_raw[];
  char* base = (char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const typename E::Sm sm = E::carve(base);
  Rows& R = *reinterpret_cast<Rows*>(base + E::kStageBytes);
  const int H = a.H, C = H + 4, N = a.N, t = threadIdx.x;
  const size_t TE = (size_t)kRows * H;
  T* const x0 = a.scr + (size_t)blockIdx.x * kTiles * TE;
  T* const X[kTiles] = {x0, x0 + TE, x0 + 2 * TE, x0 + 3 * TE, x0 + 4 * TE};
  float* const acci = a.acc + (size_t)blockIdx.x * kAtoms * C;
  const PartLayout PL(0, H);
  float* const part = PARAMS ? a.part + (size_t)blockIdx.x * PL.P : nullptr;
  if (PARAMS) {
    for (int k = t; k < PL.P; k += E::kThreads) part[k] = 0.f;
    __syncthreads();
  }
  const int items = a.B * a.nI;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / a.nI, ib = it % a.nI;
    for (int jb = 0; jb < a.nI; ++jb) {
      load_rows(a, R, b, ib, jb, t, E::kThreads);
      __syncthreads();
      forward_tile<E, BWD, PARAMS>(a, sm, R, X);
      if constexpr (BWD) {
        backward_tile<E, PARAMS>(a, sm, R, X, part);
        bwd_sums<E>(a, R, X[0], b, ib, jb);
      } else {
        // the forward's i-side sums: m2 into acci, the forces into R.fs
        for (int idx = t; idx < kAtoms * H; idx += E::kThreads) {
          const int l = idx / H, c = idx - l * H;
          float s = 0.f;
          for (int m = 0; m < kAtoms; ++m)
            s += to_f(X[0][(size_t)(l * kAtoms + m) * H + c]);
          float* p = acci + l * C + c;
          *p = (jb == 0 ? 0.f : *p) + s;
        }
        if (t < kAtoms * 3) {
          const int l = t / 3, d = t % 3;
          float s = 0.f;
          for (int m = 0; m < kAtoms; ++m) {
            const int r = l * kAtoms + m;
            s += rnd<T>(fminf(fmaxf(R.cd[r][d] * R.gate[r], -100.f), 100.f) *
                        R.valid[r]);
          }
          R.fs[l][d] = (jb == 0 ? 0.f : R.fs[l][d]) + s;
        }
        __syncthreads();
      }
    }
    if constexpr (!BWD) {
      for (int idx = t; idx < kAtoms * H; idx += E::kThreads) {
        const int l = idx / H, c = idx - l * H, i = ib * kAtoms + l;
        if (i < N)
          a.agg[((size_t)b * N + i) * H + c] = from_f<T>(acci[l * C + c]);
      }
      if (t < kAtoms * 3) {
        const int l = t / 3, d = t % 3, i = ib * kAtoms + l;
        if (i < N)
          a.fsum[((size_t)b * N + i) * 3 + d] = from_f<T>(R.fs[l][d]);
      }
      __syncthreads();
    }
  }
}

// ---- the bf16 K1 and K2 on the ring (RingBf of xwide_engine.cuh)
//
// egcl_xwide_kernel runs one warpgroup a block and every 64 x 64 x 64 step
// in series: the next step's operands are fetched into registers only
// after the current step's wgmma is issued and stored into its stage only
// after it completes, so each step waits out an L2 round trip (~1.7 us a
// step at the reference's H = 512, for ~0.07 us of tensor work), and each
// staged weight chunk feeds 64 rows. Here:
// - A block is two consumer warpgroups and a producer warpgroup whose one
//   thread issues TMA copies (tensor maps of W2, W3 and the blocks'
//   activation tiles, encoded on the host per launch) into a ring of six
//   stages, a "full" and an "empty" mbarrier a stage; the producer gives
//   its registers to the consumers (setmaxnreg). TMA over cp.async: one
//   thread issues a 32 KiB stage in four instructions, the swizzle is the
//   hardware's, and no consumer waits on a copy of its own.
// - Consumer c takes j-block 2 r + c of its (molecule, i-block) item in
//   round r, so one staged 64 x 128 weight chunk feeds both tiles (128
//   rows) through wgmma m64n128k16 (m64n64k16 for a last chunk of 64
//   columns where H / 64 is odd): half the weight bytes a row of
//   egcl_xwide_kernel, and the activation chunk read once per 128 output
//   columns instead of 64. An odd last j-block leaves consumer 1 idle for
//   that round (it frees the stages as they come; at N = 13 an item has
//   exactly two, at N = 55 and 147 one round in four and ten idles it).
// - k runs over 64-row chunks and k16 steps in order, each product
//   accumulated in f32 and rounded where egcl_xwide_kernel rounds, so the
//   products, the activations and the node sums are its bits (the gate
//   and dr2 sum each thread's columns in increasing order, as EngBf's
//   layout does, then over the row's four threads).
// - The elementwise passes, not the tensor cores, bound these kernels on
//   this card: SiLU's ex2 and reciprocal and the conversions to bf16 at
//   every rounding point (removing the epilogues saves several times what
//   removing every wgmma does; PERF.md). So the epilogues round two
//   neighbouring columns with one packed conversion,
//   the operands an epilogue reads from memory (biases, dagg, dsilu(z2),
//   rnd(dsilu(z1)) of the m1 pass) are loaded before its chunk's products
//   are issued, and the m1, dz3 and node-sum passes issue several rows'
//   loads before they use any. The m1 pass writes zeros for the rows
//   whose valid is 0 (100 of a 13-atom molecule's 256).
// - Each consumer keeps its [64, H] tiles in global memory (kRingTiles; the
//   scratch [grid, 2, 5, 64, H]) and its rows in shared memory. The
//   rounds' node sums run on both consumers' 256 threads after a barrier
//   of the pair, one owner a sum and in the j-blocks' order: the bits of
//   egcl_xwide_kernel's sequential walk.

// [64, H] tiles a consumer: X0 .. X3 as egcl_xwide_kernel's, and in the
// backward X4 = rnd(dsilu(z1)) from the m1 pass (the dz1 epilogue reads it
// in place of z1's operands)
constexpr int kRingTiles = 5;
constexpr int kPair = RingBf::kCons * kWG;   // the consumers' threads

struct RingSm {
  Rows R[RingBf::kCons];
  float fs[kAtoms][3];   // the forward's force sums of the item
  RingBf::Bars bars;
};

size_t ring_smem_bytes() {
  return 1024 + RingBf::kRingBytes + sizeof(RingSm);
}

// the two consumer warpgroups' barrier
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(kPair) : "memory");
}

// s[e] += the 8 bf16 at p (16 bytes), e in order
__device__ __forceinline__ void add8(float (&s)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf2* x = reinterpret_cast<const bf2*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(x[e]);
    s[2 * e] += f.x;
    s[2 * e + 1] += f.y;
  }
}
// v rounded to bf16 into the 8 bf16 at p
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  bf2* x = reinterpret_cast<bf2*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = to_bf2(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// x and y rounded to bf16 and back with one packed conversion (half the
// conversions of two rnd<bf16>, whose bits it gives)
__device__ __forceinline__ float2 rnd2(float x, float y) {
  return __bfloat1622float2(to_bf2(x, y));
}

// z1 = hA_i + hB_j + b1 + r2 w1r of two neighbouring columns, rounded as
// z1_at rounds (r2b: the row's r2 rounded)
__device__ __forceinline__ float2 z1_pair(float2 ha, float2 hb, float2 b1,
                                          float2 w1r, float r2b) {
  const float2 s = rnd2(__fadd_rn(ha.x, hb.x), __fadd_rn(ha.y, hb.y));
  const float2 z = rnd2(__fadd_rn(s.x, b1.x), __fadd_rn(s.y, b1.y));
  const float2 w = rnd2(__fmul_rn(r2b, w1r.x), __fmul_rn(r2b, w1r.y));
  return rnd2(__fadd_rn(z.x, w.x), __fadd_rn(z.y, w.y));
}

// silu(z1) of a consumer's tile into Xm (and with DS rnd(dsilu(z1)) into
// Xd), 8 columns an item, two items a step with their loads issued first
// (thread t of 128; 64 H / 8 items, a multiple of 2 x 128; two, not four:
// four leave the backward's registers spilling). A row whose
// valid is 0 (a self-pair or an atom past N) gets zeros: every output it
// feeds is multiplied by its valid (m2, and through dz2 the backward's
// rows), so its m1 only has to be finite, and the sums it enters are of
// zeros either way.
template <bool DS>
__device__ void ring_m1(const Args<bf16>& a, const Rows& R, bf16* Xm,
                        bf16* Xd, int t) {
  const int H = a.H, g8 = H / 8;
  const size_t H2 = 2 * (size_t)H;
  for (int i0 = t; i0 < kRows * g8; i0 += 2 * kWG) {
    uint4 ua[2], ub[2], uc[2], uw[2];
    int rr[2], cc[2];
    bool live[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int idx = i0 + s * kWG, r = idx / g8, c = 8 * (idx - r * g8);
      rr[s] = r;
      cc[s] = c;
      live[s] = R.valid[r] != 0.f;
      if (live[s]) {
        ua[s] = *reinterpret_cast<const uint4*>(a.proj + R.ri[r] * H2 + c);
        ub[s] = *reinterpret_cast<const uint4*>(a.proj + R.rj[r] * H2 + H +
                                                c);
        uc[s] = *reinterpret_cast<const uint4*>(a.b1 + c);
        uw[s] = *reinterpret_cast<const uint4*>(a.w1r + c);
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint4 om = make_uint4(0, 0, 0, 0), od = om;
      if (live[s]) {
        const float r2b = rnd<bf16>(R.r2[rr[s]]);
        const bf2 *xa = reinterpret_cast<const bf2*>(&ua[s]),
                  *xb = reinterpret_cast<const bf2*>(&ub[s]),
                  *xc = reinterpret_cast<const bf2*>(&uc[s]),
                  *xw = reinterpret_cast<const bf2*>(&uw[s]);
        bf2 *xm = reinterpret_cast<bf2*>(&om),
            *xd = reinterpret_cast<bf2*>(&od);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(xa[e]),
                       fb = __bfloat1622float2(xb[e]),
                       fc = __bfloat1622float2(xc[e]),
                       fw = __bfloat1622float2(xw[e]);
          const float2 z = z1_pair(fa, fb, fc, fw, r2b);
          xm[e] = to_bf2(silu(z.x), silu(z.y));
          if (DS) xd[e] = to_bf2(dsilu(z.x), dsilu(z.y));
        }
      }
      const size_t off = (size_t)rr[s] * H + cc[s];
      *reinterpret_cast<uint4*>(Xm + off) = om;
      if (DS) *reinterpret_cast<uint4*>(Xd + off) = od;
    }
  }
}

// The producer: one thread walks the consumers' products in the order
// they take them (m1 W2, m2 W3; backward dz3 W3^T, dz2 W2^T) for every
// round of every item of the block.
template <int KIND>
__device__ void ring_producer(const Args<bf16>& a, RingBf::Bars& bars,
                              char* ring, const CUtensorMap* wm2,
                              const CUtensorMap* wm3, const CUtensorMap* xm,
                              int tiles0) {
  const int nI = a.nI, items = a.B * nI, rounds = (nI + 1) / 2;
  RingBf::Pipe p;
  uint32_t rph = 0;
  int xr[RingBf::kCons];
  auto rows_of = [&](int x) {
    for (int c = 0; c < RingBf::kCons; ++c)
      xr[c] = (tiles0 + c * kRingTiles + x) * kRows;
  };
  for (int it = blockIdx.x; it < items; it += gridDim.x)
    for (int rr = 0; rr < rounds; ++rr) {
      const int nact = min(RingBf::kCons, nI - 2 * rr);
      rows_of(3);
      RingBf::produce<0>(bars, ring, wm2, xm, xr, nact, a.H, p, rph);
      rows_of(0);
      RingBf::produce<0>(bars, ring, wm3, xm, xr, nact, a.H, p, rph);
      if (KIND == kBwd) {
        rows_of(2);
        RingBf::produce<1>(bars, ring, wm3, xm, xr, nact, a.H, p, rph);
        rows_of(1);
        RingBf::produce<1>(bars, ring, wm2, xm, xr, nact, a.H, p, rph);
      }
    }
}

// Consumer wg's side: its tile of each round (j-block 2 r + wg), then the
// round's node sums with the other consumer. wg is a template argument so
// that whether a consumer is idle in a round is known to be uniform over
// its warpgroup.
template <int KIND, int wg>
__device__ void ring_consumer(const Args<bf16>& a, RingSm& S,
                              const char* ring, int tiles0, int t) {
  using T = bf16;
  constexpr bool BWD = KIND == kBwd;
  constexpr int kNC = RingBf::kNC;
  const int H = a.H, C = H + 4, N = a.N, nI = a.nI, g8 = H / 8;
  const int items = a.B * nI, rounds = (nI + 1) / 2;
  const size_t TE = (size_t)kRows * H;
  Rows& R = S.R[wg];
  auto tile_of = [&](int c, int x) {
    return a.scr + (size_t)(tiles0 + c * kRingTiles + x) * TE;
  };
  T* const X[kRingTiles] = {tile_of(wg, 0), tile_of(wg, 1), tile_of(wg, 2),
                            tile_of(wg, 3), tile_of(wg, 4)};
  bf2 pa[32], pb[32];   // a chunk's epilogue operands, loaded ahead
  float* const acci = a.acc + (size_t)blockIdx.x * kAtoms * C;
  const int u = wg * kWG + t;   // 0 .. 255 over the pair
  const int r0 = RingBf::row0(t);
  RingBf::Pipe p;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / nI, ib = it % nI;
    for (int rr = 0; rr < rounds; ++rr) {
      const int jb0 = 2 * rr;
      const bool act = jb0 + wg < nI, two = jb0 + 1 < nI;
      if (act) load_rows(a, R, b, ib, jb0 + wg, t, kWG);
      wg_sync(wg);
      if (act) ring_m1<BWD>(a, R, X[3], X[4], t);
      RingBf::publish(S.bars, wg);
      // z2 = rnd(m1 W2) + b2: m2 -> X0, dsilu(z2) -> X1 (backward)
      RingBf::consume<0>(
          S.bars, ring, wg, act, H, p,
          [&](int o) {
            RingBf::each_col<16>(t, [&](int j, int cc) {
              const int c = kNC * o + cc;
              if (c < H) pa[j] = *reinterpret_cast<const bf2*>(a.b2 + c);
            });
          },
          [&](int o, const float (&d)[64], auto nj) {
            RingBf::each_col<decltype(nj)::value>(t, [&](int j, int cc) {
              const int c = kNC * o + cc;
              const float2 bb = __bfloat1622float2(pa[j]);
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                const int r = r0 + 8 * k;
                const float2 v = rnd2(d[4 * j + 2 * k], d[4 * j + 2 * k + 1]);
                const float2 z = rnd2(__fadd_rn(v.x, bb.x),
                                      __fadd_rn(v.y, bb.y));
                const float2 m = rnd2(silu(z.x), silu(z.y));
                const float vr = R.valid[r];
                *reinterpret_cast<bf2*>(X[0] + (size_t)r * H + c) =
                    to_bf2(__fmul_rn(m.x, vr), __fmul_rn(m.y, vr));
                if (BWD)
                  *reinterpret_cast<bf2*>(X[1] + (size_t)r * H + c) =
                      to_bf2(dsilu(z.x), dsilu(z.y));
              }
            });
          });
      RingBf::publish(S.bars, wg);
      // z3 = rnd(m2 W3) + b3: the gate's row partials, dsilu(z3) -> X2
      float gp[2] = {0.f, 0.f};
      RingBf::consume<0>(
          S.bars, ring, wg, act, H, p,
          [&](int o) {
            RingBf::each_col<16>(t, [&](int j, int cc) {
              const int c = kNC * o + cc;
              if (c < H) {
                pa[j] = *reinterpret_cast<const bf2*>(a.b3 + c);
                pb[j] = *reinterpret_cast<const bf2*>(a.w4 + c);
              }
            });
          },
          [&](int o, const float (&d)[64], auto nj) {
            RingBf::each_col<decltype(nj)::value>(t, [&](int j, int cc) {
              const int c = kNC * o + cc;
              const float2 bb = __bfloat1622float2(pa[j]),
                           ww = __bfloat1622float2(pb[j]);
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                const int r = r0 + 8 * k;
                const float2 v = rnd2(d[4 * j + 2 * k], d[4 * j + 2 * k + 1]);
                const float2 z = rnd2(__fadd_rn(v.x, bb.x),
                                      __fadd_rn(v.y, bb.y));
                const float2 g = rnd2(silu(z.x), silu(z.y));
                gp[k] = fmaf(g.x, ww.x, gp[k]);
                gp[k] = fmaf(g.y, ww.y, gp[k]);
                if (BWD)
                  *reinterpret_cast<bf2*>(X[2] + (size_t)r * H + c) =
                      to_bf2(dsilu(z.x), dsilu(z.y));
              }
            });
          });
      if (act) RingBf::rows_out(gp, R.gate, t);
      wg_sync(wg);
      if constexpr (BWD) {
        if (act && t < kRows) force_row(a, R, t);
        wg_sync(wg);
        // dz3 = rnd(rnd(dgate) w4) dsilu(z3), in place of dsilu(z3): four
        // items of 8 columns a step, loads first
        if (act)
          for (int i0 = t; i0 < kRows * g8; i0 += 4 * kWG) {
            uint4 ux[4], uw[4];
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const int idx = i0 + s * kWG, r = idx / g8;
              const int c = 8 * (idx - r * g8);
              ux[s] = *reinterpret_cast<const uint4*>(X[2] + (size_t)r * H +
                                                      c);
              uw[s] = *reinterpret_cast<const uint4*>(a.w4 + c);
            }
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const int idx = i0 + s * kWG, r = idx / g8;
              const int c = 8 * (idx - r * g8);
              bf2* xx = reinterpret_cast<bf2*>(&ux[s]);
              const bf2* xw = reinterpret_cast<const bf2*>(&uw[s]);
              const float dg = rnd<T>(R.dgate[r]);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 ds = __bfloat1622float2(xx[e]),
                             ww = __bfloat1622float2(xw[e]);
                const float2 g = rnd2(__fmul_rn(dg, ww.x), __fmul_rn(dg, ww.y));
                xx[e] = to_bf2(__fmul_rn(g.x, ds.x), __fmul_rn(g.y, ds.y));
              }
              *reinterpret_cast<uint4*>(X[2] + (size_t)r * H + c) = ux[s];
            }
          }
        RingBf::publish(S.bars, wg);
        // dz2 = rnd((dz3 W3^T + dagg_i) valid) dsilu(z2) -> X1 in place
        RingBf::consume<1>(
            S.bars, ring, wg, act, H, p,
            [&](int o) {
              RingBf::each_col<16>(t, [&](int j, int cc) {
                const int c = kNC * o + cc;
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                  const int r = r0 + 8 * k;
                  pa[2 * j + k] = bcast(0.f);
                  if (c < H && R.ri[r] >= 0)
                    pa[2 * j + k] = *reinterpret_cast<const bf2*>(
                        a.dagg + (size_t)R.ri[r] * H + c);
                  if (c < H)
                    pb[2 * j + k] = *reinterpret_cast<const bf2*>(
                        X[1] + (size_t)r * H + c);
                }
              });
            },
            [&](int o, const float (&d)[64], auto nj) {
              RingBf::each_col<decltype(nj)::value>(t, [&](int j, int cc) {
                const int c = kNC * o + cc;
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                  const int r = r0 + 8 * k;
                  const float2 da = __bfloat1622float2(pa[2 * j + k]),
                               ds = __bfloat1622float2(pb[2 * j + k]);
                  const float vr = R.valid[r];
                  const float2 v =
                      rnd2(d[4 * j + 2 * k], d[4 * j + 2 * k + 1]);
                  const float2 q = rnd2(__fadd_rn(v.x, da.x),
                                        __fadd_rn(v.y, da.y));
                  const float2 m = rnd2(__fmul_rn(q.x, vr), __fmul_rn(q.y, vr));
                  *reinterpret_cast<bf2*>(X[1] + (size_t)r * H + c) =
                      to_bf2(__fmul_rn(m.x, ds.x), __fmul_rn(m.y, ds.y));
                }
              });
            });
        RingBf::publish(S.bars, wg);
        // dz1 = rnd(dz2 W2^T) rnd(dsilu(z1)) -> X0, dr2 = dz1 . w1r
        float dp[2] = {0.f, 0.f};
        RingBf::consume<1>(
            S.bars, ring, wg, act, H, p,
            [&](int o) {
              RingBf::each_col<16>(t, [&](int j, int cc) {
                const int c = kNC * o + cc;
                if (c < H) {
                  pb[j] = *reinterpret_cast<const bf2*>(a.w1r + c);
#pragma unroll
                  for (int k = 0; k < 2; ++k)
                    pa[2 * j + k] = *reinterpret_cast<const bf2*>(
                        X[4] + (size_t)(r0 + 8 * k) * H + c);
                }
              });
            },
            [&](int o, const float (&d)[64], auto nj) {
              RingBf::each_col<decltype(nj)::value>(t, [&](int j, int cc) {
                const int c = kNC * o + cc;
                const float2 wr = __bfloat1622float2(pb[j]);
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                  const int r = r0 + 8 * k;
                  const float2 ds = __bfloat1622float2(pa[2 * j + k]);
                  const float2 v =
                      rnd2(d[4 * j + 2 * k], d[4 * j + 2 * k + 1]);
                  const bf2 gb =
                      to_bf2(__fmul_rn(v.x, ds.x), __fmul_rn(v.y, ds.y));
                  const float2 g = __bfloat1622float2(gb);
                  *reinterpret_cast<bf2*>(X[0] + (size_t)r * H + c) = gb;
                  dp[k] = fmaf(g.x, wr.x, dp[k]);
                  dp[k] = fmaf(g.y, wr.y, dp[k]);
                }
              });
            });
        if (act) RingBf::rows_out(dp, R.dr2, t);
        wg_sync(wg);
        if (act && t < kRows) dcd_row<T>(R, t);
      }
      // the round's node sums over both tiles, one owner a sum, the
      // j-blocks in order, 8 columns a step
      pair_sync();
      const bool last = rr == rounds - 1;
      const int ntile = two ? 2 : 1;
      if constexpr (!BWD) {
        for (int idx = u; idx < kAtoms * g8; idx += kPair) {
          const int l = idx / g8, c = 8 * (idx - l * g8);
          float4* q = reinterpret_cast<float4*>(acci + l * C + c);
          float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (jb0 > 0) {
            const float4 x = q[0], y = q[1];
            v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
            v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
          }
          for (int cs = 0; cs < ntile; ++cs) {
            const T* x0 = tile_of(cs, 0) + (size_t)l * kAtoms * H + c;
            uint4 rows[kAtoms];
#pragma unroll
            for (int m = 0; m < kAtoms; ++m)
              rows[m] = *reinterpret_cast<const uint4*>(x0 + (size_t)m * H);
            float sm[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int m = 0; m < kAtoms; ++m)
              add8(sm, reinterpret_cast<const T*>(&rows[m]));
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = v[e] + sm[e];
          }
          q[0] = make_float4(v[0], v[1], v[2], v[3]);
          q[1] = make_float4(v[4], v[5], v[6], v[7]);
          const int i = ib * kAtoms + l;
          if (last && i < N) store8(a.agg + ((size_t)b * N + i) * H + c, v);
        }
        if (u < kAtoms * 3) {
          const int l = u / 3, dd = u % 3;
          float v = jb0 == 0 ? 0.f : S.fs[l][dd];
          for (int cs = 0; cs < ntile; ++cs) {
            const Rows& Q = S.R[cs];
            float sm = 0.f;
            for (int m = 0; m < kAtoms; ++m) {
              const int r = l * kAtoms + m;
              sm += rnd<T>(fminf(fmaxf(Q.cd[r][dd] * Q.gate[r], -100.f),
                                 100.f) *
                           Q.valid[r]);
            }
            v = v + sm;
          }
          S.fs[l][dd] = v;
          const int i = ib * kAtoms + l;
          if (last && i < N)
            a.fsum[((size_t)b * N + i) * 3 + dd] = from_f<T>(v);
        }
      } else {
        // si over the j atoms and pj over the i atoms of each tile: the
        // dz1 columns 8 a step, then the last step's four (the d_cd sums
        // and a zero)
        // sm[e] over the 8 rows r(m) of tile cs from column c
        // (the 8 rows' loads issued together, then added in order)
        auto rsum = [&](int cs, int c, int rb, int rs, float (&sm)[8]) {
#pragma unroll
          for (int e = 0; e < 8; ++e) sm[e] = 0.f;
          if (c < H) {
            const T* x0 = tile_of(cs, 0) + c;
            uint4 rows[kAtoms];
#pragma unroll
            for (int m = 0; m < kAtoms; ++m)
              rows[m] = *reinterpret_cast<const uint4*>(
                  x0 + (size_t)(rb + rs * m) * H);
#pragma unroll
            for (int m = 0; m < kAtoms; ++m)
              add8(sm, reinterpret_cast<const T*>(&rows[m]));
          } else {
            const Rows& Q = S.R[cs];
#pragma unroll
            for (int m = 0; m < kAtoms; ++m)
#pragma unroll
              for (int e = 0; e < 3; ++e) sm[e] += Q.dcd[rb + rs * m][e];
          }
        };
        for (int idx = u; idx < kAtoms * (g8 + 1); idx += kPair) {
          const int l = idx / (g8 + 1), c = 8 * (idx - l * (g8 + 1));
          const int nw = c < H ? 8 : 4;
          float sm[8];
          const int i = ib * kAtoms + l;
          if (i < N) {
            float* q = a.si + ((size_t)b * N + i) * C + c;
            float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (jb0 > 0)
              for (int e = 0; e < nw; ++e) v[e] = q[e];
            for (int cs = 0; cs < ntile; ++cs) {
              rsum(cs, c, l * kAtoms, 1, sm);
#pragma unroll
              for (int e = 0; e < 8; ++e) v[e] = v[e] + sm[e];
            }
            for (int e = 0; e < nw; ++e) q[e] = v[e];
          }
          for (int cs = 0; cs < ntile; ++cs) {
            const int j = (jb0 + cs) * kAtoms + l;
            if (j >= N) continue;
            rsum(cs, c, l, kAtoms, sm);
            float* q = a.pj + (((size_t)b * nI + ib) * N + j) * C + c;
            for (int e = 0; e < nw; ++e) q[e] = sm[e];
          }
        }
      }
      pair_sync();
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(RingBf::kThreads, 1)
    egcl_xwide_kernel_ring(const __grid_constant__ CUtensorMap wm2,
                           const __grid_constant__ CUtensorMap wm3,
                           const __grid_constant__ CUtensorMap xm,
                           Args<bf16> a) {
  extern __shared__ char smem_raw[];
  char* ring = (char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  RingSm& S = *reinterpret_cast<RingSm*>(ring + RingBf::kRingBytes);
  // the warpgroup index broadcast from lane 0: the compiler then knows it
  // is uniform over the warp, and keeps the wgmma under branches on it in
  // flight (a divergent path serialises them)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);
  const int t = threadIdx.x % kWG;
  if (threadIdx.x == 0) RingBf::init(S.bars);
  __syncthreads();
  const int tiles0 = blockIdx.x * RingBf::kCons * kRingTiles;
  if (wg == RingBf::kCons) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread of it issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (t == 0)
      ring_producer<KIND>(a, S.bars, ring, &wm2, &wm3, &xm, tiles0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    if (wg == 0)
      ring_consumer<KIND, 0>(a, S, ring, tiles0, t);
    else
      ring_consumer<KIND, 1>(a, S, ring, tiles0, t);
  }
}

bool takes(int B, int N, int nf, int H, int blocks) {
  return B >= 1 && N >= 1 && nf >= 1 && blocks >= 1 && H >= kCol &&
         H <= kMaxH && H % kCol == 0;
}

// The grid of a launch: at most `blocks` blocks and one per work item;
// with parameter gradients also at most as many slices as fit in 1 GiB.
int grid_of(int B, int N, int H, int kind, int blocks) {
  const long long items = (long long)B * ((N + kAtoms - 1) / kAtoms);
  long long g = std::min<long long>(blocks, items);
  if (kind == kBwdParams)
    g = std::min<long long>(
        g, (long long)(kMaxPartBytes / (4.0 * PartLayout(0, H).P)));
  return (int)std::max<long long>(1, g);
}

// The bf16 K1 and K2 run on the ring kernels; K2 p and every float32
// launch on egcl_xwide_kernel.
template <class E>
constexpr bool on_ring(int kind) {
  return std::is_same<E, EngBf>::value && kind != kBwdParams;
}

// A ring kernel's launch: the tensor maps of W2, W3 and the blocks' tiles
// [grid, 2, 5, 64, H] (as rows of H), then the kernel.
cudaError_t launch_ring(const Args<bf16>& a, int kind, int grid,
                        cudaStream_t st) {
  CUtensorMap wm2, wm3, xm;
  const long long rows =
      (long long)grid * RingBf::kCons * kRingTiles * kRows;
  cudaError_t err = box_map(&wm2, a.W2, a.H, a.H);
  if (err == cudaSuccess) err = box_map(&wm3, a.W3, a.H, a.H);
  if (err == cudaSuccess) err = box_map(&xm, a.scr, rows, a.H);
  if (err != cudaSuccess) return err;
  const size_t smem = ring_smem_bytes();
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, Args<bf16>) =
      kind == kFwd ? egcl_xwide_kernel_ring<kFwd>
                   : egcl_xwide_kernel_ring<kBwd>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, RingBf::kThreads, smem, st>>>(wm2, wm3, xm, a);
  return cudaGetLastError();
}

// An egcl_xwide_kernel launch.
template <class E>
cudaError_t launch_tile(void (*kernel)(Args<typename E::T>),
                        const Args<typename E::T>& a, int grid,
                        cudaStream_t st) {
  const size_t smem = smem_bytes<E>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, E::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The [64, H] scratch tiles a block of a launch uses.
template <class E>
int tiles_of(int kind) {
  return on_ring<E>(kind) ? RingBf::kCons * kRingTiles : kTiles;
}

template <class E>
int launch(Args<typename E::T> a, int kind, int blocks, cudaStream_t st) {
  using T = typename E::T;
  if (!takes(a.B, a.N, a.nf, a.H, blocks) ||
      (kind == kBwdParams && a.splits < 1))
    return (int)cudaErrorInvalidValue;
  a.nI = (a.N + kAtoms - 1) / kAtoms;
  cudaError_t err = wide_nf::launch_proj<T>(a.B * a.N, a.nf, a.H, a.h, a.W1a,
                                            a.W1b, a.proj, st);
  if (err != cudaSuccess) return (int)err;
  const int grid = grid_of(a.B, a.N, a.H, kind, blocks);
  if constexpr (std::is_same<E, EngBf>::value)
    err = kind == kBwdParams
              ? launch_tile<E>(egcl_xwide_kernel<E, kBwdParams>, a, grid, st)
              : launch_ring(a, kind, grid, st);
  else
    err = launch_tile<E>(kind == kFwd   ? egcl_xwide_kernel<E, kFwd>
                         : kind == kBwd ? egcl_xwide_kernel<E, kBwd>
                                        : egcl_xwide_kernel<E, kBwdParams>,
                         a, grid, st);
  if (err != cudaSuccess || kind == kFwd) return (int)err;
  return (int)wide_nf::launch_first_layer_bwd<T>(
      a.B, a.N, a.nI, a.nf, a.H, blocks, a.h, a.W1a, a.W1b, a.si, a.pj, a.sj,
      a.dpos, a.dh, kind == kBwdParams ? a.dw1 : nullptr, a.splits, st);
}

// One launch of either dtype (code 1 bf16, 0 float32) from the C entry
// points' untyped pointers.
struct Ptrs {
  const void *h, *pos, *box, *mask, *W1a, *W1b, *w1r, *b1, *W2, *b2, *W3,
      *b3, *w4, *dagg, *dfsum;
  void *agg, *fsum, *dh, *dpos, *proj, *scr, *acc, *si, *pj, *sj, *dw1, *part;
};

template <class E>
int launch_typed(int B, int N, int nf, int H, int blocks, int splits,
                 const Ptrs& p, int kind, void* stream) {
  using T = typename E::T;
  using cT = const T*;
  Args<T> a{B, N, nf, H, 0, (cT)p.h, (const float*)p.pos,
            (const float*)p.box, (cT)p.mask, (cT)p.W1a, (cT)p.W1b, (cT)p.w1r,
            (cT)p.b1, (cT)p.W2, (cT)p.b2, (cT)p.W3, (cT)p.b3, (cT)p.w4,
            (cT)p.dagg, (cT)p.dfsum, (T*)p.agg, (T*)p.fsum, (T*)p.dh,
            (float*)p.dpos, (T*)p.proj, (T*)p.scr, (float*)p.acc,
            (float*)p.si, (float*)p.pj, (float*)p.sj, (float*)p.dw1,
            (float*)p.part, splits};
  return launch<E>(a, kind, blocks, (cudaStream_t)stream);
}

int launch_code(int code, int B, int N, int nf, int H, int blocks,
                int splits, const Ptrs& p, int kind, void* stream) {
  if (code == 1)
    return launch_typed<EngBf>(B, N, nf, H, blocks, splits, p, kind, stream);
  if (code == 0)
    return launch_typed<EngF32>(B, N, nf, H, blocks, splits, p, kind,
                                stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace xwide
}  // namespace

extern "C" {

// Dynamic shared memory of a launch (the same at every H: nothing in it
// grows with the width), or -1 for sizes the kernels do not take (H not a
// multiple of 64 in 64 .. 11,520, another kind or dtype code). code: 1
// bf16, 0 float32; kind: 0 forward, 1 input-gradient backward, 2 with the
// parameter gradients.
long long egcl_xwide_smem_bytes(int code, int H, int kind) {
  using namespace xwide;
  if (kind < kFwd || kind > kBwdParams || !takes(1, 1, 1, H, 1)) return -1;
  if (code == 1)
    return (long long)(on_ring<EngBf>(kind) ? ring_smem_bytes()
                                            : smem_bytes<EngBf>());
  if (code == 0) return (long long)smem_bytes<EngF32>();
  return -1;
}

long long egcl_xwide_smem_limit() { return (long long)xwide::kMaxSmem; }

// Threads a block of the dtype's kernels of a kind (bf16: 384 on the
// ring, K1 and K2; 128 K2 p; float32 256).
int egcl_xwide_threads(int code, int kind) {
  using namespace xwide;
  if (kind < kFwd || kind > kBwdParams) return -1;
  return code == 1 ? (on_ring<EngBf>(kind) ? RingBf::kThreads
                                           : EngBf::kThreads)
                   : code == 0 ? EngF32::kThreads : -1;
}

// The [64, H] scratch tiles a block (the second dimension of scr): 10 on
// the ring (two consumers' five), else 5.
int egcl_xwide_tiles(int code, int kind) {
  using namespace xwide;
  if (kind < kFwd || kind > kBwdParams) return -1;
  return code == 1 ? tiles_of<EngBf>(kind)
                   : code == 0 ? tiles_of<EngF32>(kind) : -1;
}

// The widest H the kernels take (a K2 p slice of 2 H^2 floats under 1 GiB).
int egcl_xwide_max_width() { return xwide::kMaxH; }

// The blocks of a launch: the first dimension of its scratch tiles
// [grid, egcl_xwide_tiles(code, kind), 64, H], its forward sums [grid,
// 8, H + 4] and (kind 2) its slices [grid, egcl_part_size(0, H)].
int egcl_xwide_grid(int B, int N, int H, int kind, int blocks) {
  if (!xwide::takes(B, N, 1, H, blocks)) return -1;
  return xwide::grid_of(B, N, H, kind, blocks);
}

// dW1's row splits of a launch (rows = B N atoms): the first dimension of
// its dw1 buffer [splits, 2, nf, H].
int egcl_xwide_splits(int rows, int nf, int H, int blocks) {
  return wide_nf::dw1_splits(rows, nf, H, blocks);
}

// The forward (agg, fsum in the compute dtype), the input-gradient
// backward (dh; dpos in float32) and the backward with the parameter
// gradients for compute-dtype h, mask and weights (code 1 bf16, 0
// float32); pos and box are float32. Scratch that the kernels fill
// themselves: proj [B, N, 2H] and scr [grid, egcl_xwide_tiles(code,
// kind), 64, H] in the compute dtype, acc [grid, 8, H + 4] (forward), si [B, N, H + 4], pj [B, nI, N,
// H + 4], sj [B, N, H] (backward, nI = ceil(N / 8)), dw1 [splits, 2, nf,
// H] and part [grid, egcl_part_size(0, H)] (parameter gradients: the
// caller sums part's rows for dW2 .. dw4 and dw1's splits for dW1a,
// dW1b). Returns the cudaError_t of the launches (0 on success).
int egcl_xwide_fwd(int code, int B, int N, int nf, int H, int blocks,
                   const void* h, const void* pos, const void* box,
                   const void* mask, const void* W1a, const void* W1b,
                   const void* w1r, const void* b1, const void* W2,
                   const void* b2, const void* W3, const void* b3,
                   const void* w4, void* proj, void* scr, void* acc,
                   void* agg, void* fsum, void* stream) {
  xwide::Ptrs p{h,       pos,     box,  mask,    W1a,     W1b,     w1r,
                b1,      W2,      b2,   W3,      b3,      w4,      nullptr,
                nullptr, agg,     fsum, nullptr, nullptr, proj,    scr,
                acc,     nullptr, nullptr, nullptr, nullptr, nullptr};
  return xwide::launch_code(code, B, N, nf, H, blocks, 1, p, xwide::kFwd,
                            stream);
}

int egcl_xwide_bwd(int code, int B, int N, int nf, int H, int blocks,
                   const void* h, const void* pos, const void* box,
                   const void* mask, const void* W1a, const void* W1b,
                   const void* w1r, const void* b1, const void* W2,
                   const void* b2, const void* W3, const void* b3,
                   const void* w4, const void* dagg, const void* dfsum,
                   void* proj, void* scr, void* dh, void* dpos, void* si,
                   void* pj, void* sj, void* stream) {
  xwide::Ptrs p{h,       pos,     box,  mask, W1a,  W1b,     w1r,
                b1,      W2,      b2,   W3,   b3,   w4,      dagg,
                dfsum,   nullptr, nullptr, dh, dpos, proj,   scr,
                nullptr, si,      pj,   sj,   nullptr, nullptr};
  return xwide::launch_code(code, B, N, nf, H, blocks, 1, p, xwide::kBwd,
                            stream);
}

int egcl_xwide_bwd_params(int code, int B, int N, int nf, int H, int blocks,
                          int splits, const void* h, const void* pos,
                          const void* box, const void* mask, const void* W1a,
                          const void* W1b, const void* w1r, const void* b1,
                          const void* W2, const void* b2, const void* W3,
                          const void* b3, const void* w4, const void* dagg,
                          const void* dfsum, void* proj, void* scr, void* dh,
                          void* dpos, void* si, void* pj, void* sj, void* dw1,
                          void* part, void* stream) {
  xwide::Ptrs p{h,       pos,     box,  mask, W1a,  W1b,  w1r,
                b1,      W2,      b2,   W3,   b3,   w4,   dagg,
                dfsum,   nullptr, nullptr, dh, dpos, proj, scr,
                nullptr, si,      pj,   sj,   dw1,  part};
  return xwide::launch_code(code, B, N, nf, H, blocks, splits, p,
                            xwide::kBwdParams, stream);
}

const char* egcl_xwide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
