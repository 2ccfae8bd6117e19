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
// - Every H x H product runs on the engines of xwide_engine.cuh (shared
//   with edge_pipeline_xwide.cu) in 64-column output chunks (a runtime count),
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
// the bf16 tensor-core peak; the staging of both operands through shared
// memory for every 64 x 64 x 64 step, with one warpgroup a block and no
// overlap of one tile's elementwise passes with another's products, keeps
// this simple design far from that (PERF.md has the times).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include <algorithm>

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

template <class T>
__device__ void load_rows(const Args<T>& a, Rows& R, int b, int ib, int jb) {
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
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
  for (int r = t; r < kRows; r += E::kThreads) {
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
  for (int r = t; r < kRows; r += E::kThreads)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      R.dcd[r][d] = rnd<T>(__fadd_rn(
          R.dcd[r][d], __fmul_rn(__fmul_rn(2.f, R.cd[r][d]), R.dr2[r])));
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
      load_rows(a, R, b, ib, jb);
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
  const size_t smem = smem_bytes<E>();
  void (*kernel)(Args<T>) = kind == kFwd   ? egcl_xwide_kernel<E, kFwd>
                            : kind == kBwd ? egcl_xwide_kernel<E, kBwd>
                                           : egcl_xwide_kernel<E, kBwdParams>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(a.B, a.N, a.H, kind, blocks), E::kThreads, smem, st>>>(a);
  err = cudaGetLastError();
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
  if (code == 1) return (long long)smem_bytes<EngBf>();
  if (code == 0) return (long long)smem_bytes<EngF32>();
  return -1;
}

long long egcl_xwide_smem_limit() { return (long long)xwide::kMaxSmem; }

// Threads a block of the dtype's kernels (128 bf16, 256 float32).
int egcl_xwide_threads(int code) {
  return code == 1 ? xwide::EngBf::kThreads
                   : code == 0 ? xwide::EngF32::kThreads : -1;
}

// The widest H the kernels take (a K2 p slice of 2 H^2 floats under 1 GiB).
int egcl_xwide_max_width() { return xwide::kMaxH; }

// The blocks of a launch: the first dimension of its scratch tiles
// [grid, 5, 64, H], its forward sums [grid, 8, H + 4] and (kind 2) its
// slices [grid, egcl_part_size(0, H)].
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
// themselves: proj [B, N, 2H] and scr [grid, 5, 64, H] in the compute
// dtype, acc [grid, 8, H + 4] (forward), si [B, N, H + 4], pj [B, nI, N,
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
