// Blockwise Lennard-Jones pair energy and its analytic gradient in one pass,
// designed for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of enflow_tpu/ops/pairwise_kernel.py
// (_run_kernel / _kernel under the custom VJP _pair_energy) and computes the
// same contract over ordered pairs (i, j) of one molecule, halved:
//   E_b        = 0.5 * sum_{i,j valid} e(d2_ij)
//   dE/dx_i    = sum_{j valid} e'(d2_ij) * 2 * d_ij
// Form r2 (the NLL term):  e = 4((d2+s)^-6 - (d2+s)^-3), raw displacements.
// Form r  (the MD potential): e = 4((s+r)^-12 - (s+r)^-6), min-image
//   displacements d - rint(d / box) box (round half to even, as jnp.round,
//   the integer exactly that of the IEEE quotient), d2 < cutoff^2.
// valid = mask_i * mask_j * (d2 > 0) [* (d2 < cutoff^2)]; an invalid pair
// adds nothing (the TPU kernel evaluates it at d2 := 1 and drops it; here
// it is skipped, which gives the same sums). Form r takes a flag,
// `coincident`: with it and softening > 0, a pair of distinct real atoms at
// d2 = 0 inside the cutoff is counted too, at its finite energy
// 4(s^-12 - s^-6) and with a zero gradient, as the JAX package's dense MD
// potential counts it (enflow_tpu/sim/potentials.py). Without it (the TPU
// kernel's contract) such pairs are left out.
//
// What bounds it on this card: every ordered pair of real atoms needs its
// distance test (~8 f32 operations in form r2, ~20 with the min-image),
// and each valid one ~22 (r2) to ~27 (r) more for its terms and sums, on
// 16 bytes of position and mask per atom. At the training shapes (B=30
// molecules of N=13, or one molecule of 13 in the MD) a call is a few
// microseconds of work and is bound by the launch itself; at generate.yaml's
// 2,944 atoms (8.7 M ordered pairs, ~0.5% inside the cutoff) by the f32
// issue rate of the distance tests (~2.6 us at 67 TFLOP/s), never by bytes.
//
// Design: a block is 128 threads, rows x column lanes (a row's `lanes`
// threads, a power of two, are neighbouring lanes of one warp); a thread
// owns one row atom and every lanes-th column of the block's columns,
// which the block stages in shared memory as float4 (position, mask), and
// the lanes of a row are summed with xor shuffles in a fixed order.
// - Small molecules (N <= 32, the NLL term and the MD loop of train.yaml):
//   a block holds whole molecules, as many as its rows take (one at N=13:
//   13 rows x 8 lanes, two columns a thread; eight at N=4), so no thread
//   walks a chain of N pairs and no block idles 115 of 128 lanes. The
//   energy of each molecule is summed over its rows in row order and
//   written straight to E: one launch, no partials.
// - Large molecules (generate.yaml's 2,944 atoms at B=1): row tiles of 32
//   atoms x 4 lanes, and the columns split across blocks as well (about
//   eight blocks an SM over the 132), each split staged in chunks of 1,024
//   columns. Each block writes its gradient rows to a [B, splits, N, 3]
//   partial buffer (or straight to the gradient when there is one split)
//   and its energy to a [B, row tiles x splits] buffer; a second kernel
//   sums them in a fixed order (a block of 256 threads a molecule's
//   energies, strided, then a tree). No atomics: a second launch gives the
//   same bits.
// The plan (lanes, molecules a block, rows a tile, row tiles, splits,
// columns a split) is chosen by the wrapper (ops/pair_energy.py, pair_plan)
// and checked here.
// - The min-image integer: |d| <= box/2 gives 0 and box/2 (1 + 1e-6) <
//   |d| < 3 box/2 (1 - 1e-6) gives +-1, which is what rint of the IEEE
//   quotient gives there; every other d (near a half box, or beyond 3/2 of
//   one) takes the IEEE division itself. So no division runs in the common
//   case, and the integer is bit for bit rintf(d / box). Before it, form r
//   drops a pair whose lower bound of the min-image d2 (from min(|d|,
//   ||d| - box|) an axis) exceeds the cutoff^2 by 1e-4 of it: at 2,944
//   atoms in generate.yaml's box 99.5% of the pairs leave after ~15
//   operations, and the pairs that stay get the same bits as without it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // a block: rows x column lanes
constexpr int kStage = 1024;   // columns staged in shared memory at a time

enum { kFormR2 = 0, kFormR = 1 };

struct Args {
  const float* pos;    // [B, N, 3]
  const float* mask;   // [B, N] (0/1)
  const float* box;    // [B, 3]
  int B, N;
  int lg;              // log2 of the column lanes a row
  int mols;            // molecules a block
  int tile;            // rows (atoms) a row tile
  int row_tiles;       // row tiles a molecule, ceil(N / tile)
  int splits;          // column splits
  int cols;            // columns a split
  float softening, cutoff2;
  bool coincident;
  float* energy;       // [B]: written here when a molecule is one block
  float* grad;         // [B, N, 3]: written here when there is one split
  float* part_e;       // [B, row_tiles * splits] otherwise
  float* part_g;       // [B, splits, N, 3] otherwise
};

template <int FORM>
__device__ __forceinline__ void pair_terms(float d2, float s, float& e,
                                           float& de_dd2) {
  if (FORM == kFormR2) {
    const float a = 1.0f / (d2 + s);
    const float a3 = a * a * a;
    const float a6 = a3 * a3;
    e = 4.0f * (a6 - a3);
    de_dd2 = 4.0f * (-6.0f * a6 * a + 3.0f * a3 * a);
  } else {
    const float r = sqrtf(d2);
    const float inv = 1.0f / (s + r);
    const float inv3 = inv * inv * inv;
    const float inv6 = inv3 * inv3;
    const float inv12 = inv6 * inv6;
    e = 4.0f * (inv12 - inv6);
    const float de_dr = 4.0f * (-12.0f * inv12 * inv + 6.0f * inv6 * inv);
    de_dd2 = de_dr / (2.0f * r);
  }
}

// d - rint(d / bx) bx on each axis with the integer of the IEEE quotient
// (see the top): hb = bx / 2 (exact), lo = hb (1 + 1e-6) and hi = 3 hb
// (1 - 1e-6); one rare branch takes the divisions for all three axes
// where any of them is near a half box or beyond 3/2 of one.
__device__ __forceinline__ void min_image(float (&d)[3], const float* bx,
                                          const float* hb, const float* lo,
                                          const float* hi) {
  float n[3];
  bool exact = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = fabsf(d[k]);
    n[k] = a <= hb[k] ? 0.f : copysignf(1.f, d[k]);
    exact |= a > hb[k] && !(a > lo[k] && a < hi[k]);
  }
  if (exact) {
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = rintf(d[k] / bx[k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = d[k] - n[k] * bx[k];
}

template <int FORM>
__global__ void __launch_bounds__(kThreads) pair_energy_kernel(Args a) {
  __shared__ float4 col[kStage];
  __shared__ float erow[kThreads];
  const int CL = 1 << a.lg, RB = kThreads >> a.lg, N = a.N;
  const int tid = threadIdx.x, r = tid >> a.lg, c = tid & (CL - 1);
  const int units = a.row_tiles * a.splits;
  const int grp = blockIdx.x / units, u = blockIdx.x - grp * units;
  const int t = u / a.splits, s = u - t * a.splits;
  const int b0 = grp * a.mols, nm = min(a.mols, a.B - b0);
  // this thread's row: atom i of molecule b0 + m
  const int m = r / a.tile, i = t * a.tile + (r - m * a.tile);
  const bool live = r < a.mols * a.tile && m < nm && i < N;
  // the block's columns: whole molecules (one row tile, one split), or one
  // split of molecule b0; a row's are [lo, lo + n) of them, atom j0 first
  const int c_first = s * a.cols;
  const int count = a.splits == 1 ? nm * N : min(a.cols, N - c_first);
  const size_t start = (size_t)b0 * N + (a.splits == 1 ? 0 : c_first);
  const int lo = a.splits == 1 ? m * N : 0;
  const int n = a.splits == 1 ? N : count;
  const int j0 = a.splits == 1 ? 0 : c_first;

  const int b = b0 + min(m, nm - 1);
  float xi[3] = {0.f, 0.f, 0.f}, bx[3], hb[3], blo[3], bhi[3];
  float mi = 0.f;
  if (live) {
    const float* p = a.pos + ((size_t)b * N + i) * 3;
    for (int k = 0; k < 3; ++k) xi[k] = p[k];
    mi = a.mask[(size_t)b * N + i];
  }
  for (int k = 0; k < 3; ++k) {
    bx[k] = a.box[b * 3 + k];
    hb[k] = 0.5f * bx[k];
    blo[k] = hb[k] * 1.000001f;
    bhi[k] = 3.0f * hb[k] * 0.999999f;
  }
  // form r: the cutoff with a margin for the lower bound's rounding
  const float far2 = a.cutoff2 * 1.0001f;
  float acc_e = 0.f, g[3] = {0.f, 0.f, 0.f};
  for (int base = 0; base < count; base += kStage) {
    const int nc = min(kStage, count - base);
    __syncthreads();
    for (int k = tid; k < nc; k += kThreads) {
      const size_t at = start + base + k;
      col[k] = make_float4(a.pos[at * 3], a.pos[at * 3 + 1],
                           a.pos[at * 3 + 2], a.mask[at]);
    }
    __syncthreads();
    if (!live) continue;
    const int q1 = min(lo + n, base + nc);
#pragma unroll 2
    for (int q = max(lo, base) + c; q < q1; q += CL) {
      const float4 pc = col[q - base];
      float d[3] = {xi[0] - pc.x, xi[1] - pc.y, xi[2] - pc.z};
      if (FORM == kFormR) {
        // a lower bound of the min-image d2 (per axis min(|d|, ||d| - box|),
        // which is the min-image |d| or less while |d| < 3/2 box): a pair
        // past the cutoff by a margin leaves here, every other one takes
        // the exact path below
        float m[3];
        bool wide = false;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float ak = fabsf(d[k]);
          m[k] = fminf(ak, fabsf(ak - bx[k]));
          wide |= !(ak < bhi[k]);
        }
        if (!wide && m[0] * m[0] + m[1] * m[1] + m[2] * m[2] > far2)
          continue;
        min_image(d, bx, hb, blo, bhi);
      }
      const float d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      const bool real = mi * pc.w > 0.f;
      bool valid = real && d2 > 0.f;
      if (FORM == kFormR) {
        // a coincident pair of distinct real atoms (the flag, s > 0)
        if (a.coincident && d2 == 0.f && j0 + q - lo != i && real)
          valid = true;
        valid = valid && d2 < a.cutoff2;
      }
      if (valid) {
        float e, de;
        pair_terms<FORM>(d2, a.softening, e, de);
        acc_e += e;
        // at d2 = 0 the force is 0 (de/dd2 is infinite there, d is 0)
        if (d2 > 0.f)
          for (int k = 0; k < 3; ++k) g[k] += de * 2.0f * d[k];
      }
    }
  }
  // the row's lanes, xor butterfly (every lane ends with the same bits)
  for (int o = CL >> 1; o > 0; o >>= 1) {
    acc_e += __shfl_xor_sync(0xffffffffu, acc_e, o);
    for (int k = 0; k < 3; ++k) g[k] += __shfl_xor_sync(0xffffffffu, g[k], o);
  }
  if (c == 0) {
    erow[r] = live ? acc_e : 0.f;
    if (live) {
      float* dst = a.splits == 1
          ? a.grad + ((size_t)b * N + i) * 3
          : a.part_g + (((size_t)b * a.splits + s) * N + i) * 3;
      for (int k = 0; k < 3; ++k) dst[k] = g[k];
    }
  }
  __syncthreads();
  // each molecule's rows of the block, in row order
  if (tid < nm) {
    const int r0 = tid * a.tile, r1 = min(r0 + a.tile, RB);
    float sum = 0.f;
    for (int k = r0; k < r1; ++k) sum += erow[k];
    if (units == 1)
      a.energy[b0 + tid] = 0.5f * sum;              // ordered -> i < j
    else
      a.part_e[(size_t)(b0 + tid) * units + u] = sum;
  }
}

// The partials of the split plans, in a fixed order: block b < B sums
// molecule b's block energies (thread k those at k, k + 256, ..., then a
// tree over the threads); the blocks after it the gradient over the splits
// (when there are several), one element a thread.
constexpr int kReduce = 256;
__global__ void __launch_bounds__(kReduce)
    pair_reduce_kernel(int B, int N, int units, int splits,
                       const float* __restrict__ part_e,
                       const float* __restrict__ part_g,
                       float* __restrict__ energy, float* __restrict__ grad) {
  __shared__ float red[kReduce];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < B) {
    const size_t b = blockIdx.x;
    float sum = 0.f;
    for (int v = tid; v < units; v += kReduce) sum += part_e[b * units + v];
    red[tid] = sum;
    __syncthreads();
    for (int o = kReduce / 2; o > 0; o >>= 1) {
      if (tid < o) red[tid] += red[tid + o];
      __syncthreads();
    }
    if (tid == 0) energy[b] = 0.5f * red[0];        // ordered -> i < j
    return;
  }
  const long long k = (long long)(blockIdx.x - B) * kReduce + tid;
  if (k < (long long)B * N * 3) {
    const long long b = k / ((long long)N * 3), e = k - b * N * 3;
    float sum = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      sum += part_g[(b * splits + sp) * N * 3 + e];
    grad[k] = sum;
  }
}

}  // namespace

extern "C" {

// form: 0 = r2, 1 = r (the cutoff applies to form r only). pos [B,N,3],
// mask [B,N] (0/1), box [B,3], all float32 on the card; cutoff2 is the
// squared cutoff, rounded to float32 once by the caller; coincident != 0
// counts form r's coincident pairs when softening > 0 (see the top).
// The plan (ops/pair_energy.py pair_plan): 2^lg column lanes a row, mols
// molecules of tile rows each a block (mols > 1 only with one row tile),
// row_tiles = ceil(N / tile), splits column splits of cols columns. Writes
// energy [B] and grad [B,N,3]; part_e [B, row_tiles * splits] is needed
// when that is more than 1, part_g [B, splits, N, 3] when splits > 1 (a
// second kernel then sums them). Returns the cudaError_t of the launches
// (0 on success).
int pair_energy(int form, int B, int N, int lg, int mols, int tile,
                int row_tiles, int splits, int cols, const void* pos,
                const void* mask, const void* box, float softening,
                float cutoff2, int coincident, void* energy, void* grad,
                void* part_e, void* part_g, void* stream) {
  const int RB = kThreads >> (lg < 0 || lg > 5 ? 0 : lg);
  const int units = row_tiles * splits;
  if (B < 1 || N < 1 || (form != kFormR2 && form != kFormR) || lg < 0 ||
      lg > 5 || mols < 1 || tile < 1 || (long long)mols * tile > RB ||
      row_tiles != (N + tile - 1) / tile || (mols > 1 && row_tiles != 1) ||
      splits < 1 || cols < 1 || (long long)splits * cols < N ||
      (long long)(splits - 1) * cols >= N ||
      (units > 1 && part_e == nullptr) || (splits > 1 && part_g == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((B + mols - 1) / mols) * units;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  Args a{(const float*)pos, (const float*)mask, (const float*)box, B, N, lg,
         mols, tile, row_tiles, splits, cols, softening, cutoff2,
         coincident != 0 && form == kFormR && softening > 0.f,
         (float*)energy, (float*)grad, (float*)part_e, (float*)part_g};
  cudaStream_t st = (cudaStream_t)stream;
  if (form == kFormR2)
    pair_energy_kernel<kFormR2><<<(unsigned)blocks, kThreads, 0, st>>>(a);
  else
    pair_energy_kernel<kFormR><<<(unsigned)blocks, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || units == 1) return (int)err;
  const long long ng = splits > 1 ? (long long)B * N * 3 : 0;
  pair_reduce_kernel<<<(unsigned)(B + (ng + kReduce - 1) / kReduce),
                       kReduce, 0, st>>>(B, N, units, splits, a.part_e,
                                         a.part_g, a.energy, a.grad);
  return (int)cudaGetLastError();
}

const char* pair_energy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
