// Fused all-pairs EGCL edge pipeline for Hopper (sm_90a): forward, the
// input-gradient backward, and the backward with parameter gradients.
// At H = 64 or 128 bf16 runs in egcl_allpairs_sm90.cu (wgmma, persistent
// warpgroups) and f32 in egcl_allpairs_f32.cu (register-tiled, persistent
// blocks), each in every direction; these chunked kernels serve every
// other width.
//
// Replaces the Pallas TPU kernels of enflow_tpu/ops/egcl_fused_v3.py:
//   forward  -> _fused_fwd / _fwd_kernel (via _fwd_block)
//   backward -> _fused_bwd / _bwd_kernel, in two variants: dh and dpos
//               only (what sampling asks for), or dh, dpos and the nine
//               parameter gradients dW1a ... dw4 of _bwd_kernel:256-273
//               (what training asks for)
// and computes the same contract. For all pairs i != j of real atoms of
// one molecule:
//   cd   = minimg(pos_i - pos_j)                          (f32, round half to even)
//   z1   = h_i W1a + h_j W1b + b1 + |cd|^2 w1r            (compute dtype)
//   m2   = silu(silu(z1) W2 + b2) * valid                 (compute dtype)
//   gate = silu(m2 W3 + b3) w4                            (f32)
//   agg_i  = sum_j m2,   f_sum_i = sum_j clip(cd*gate, +-100) * valid
// valid = mask_i * mask_j * (i != j). The compute dtype is float or bf16;
// values are rounded to it at the points where the TPU kernel rounds, and
// every product accumulates in f32.
//
// What bounds it on this card: at the main-path shape (B=1024 molecules,
// N=13, nf=5, H=128) a forward does ~10.6 GFLOP over < 5 MB of inputs and
// outputs: per valid pair (156 per molecule) 4H^2 + 6H = 66,304 FLOP (the
// two H x H products, the first layer's adds, the gate), per real atom
// 4 nf H = 2,560 FLOP (h W1a and h W1b, computed once per atom). So it is
// compute bound: ~11 us at the 989 TFLOP/s bf16 tensor-core peak. The
// backward does about twice the work (it recomputes the forward, then two
// transposed H x H products).
//
// Design (the simple, correct first version): one thread block per
// molecule, no atomics, no cross-block state. The TPU design's 0/1
// replication matrices, sublane padding and grid-carried sums do not exist
// here: a block walks its N*N i-major edge rows in chunks of kRows, keeps
// W2 and W3 in shared memory (row stride padded against bank conflicts),
// and runs the hidden-wide products per chunk on the tensor cores in bf16
// (wmma 16x16x16 tiles, f32 accumulation; the backward's W^T is read as a
// column-major operand) or as f32 FMA loops for the f32 compute dtype
// (TF32 tiles would round the inputs). The SiLU passes, the geometry and
// the node sums are plain per-thread loops. All i- and j-side sums
// accumulate in a fixed order, so results are deterministic. The per-atom
// arrays (h, h W1a, h W1b, the node sums) sit in shared memory beside the
// weights, which bounds N (at H=128: 30 for the bf16 backward, 22 for the
// f32 backward); a larger molecule is refused at launch
// (egcl_allpairs_smem_bytes says what a launch needs).
//
// Parameter gradients (egcl_bwd_kernel<T, true>): the TPU kernel carries
// them across its sequential grid; here blocks run in parallel, so about
// one block per SM walks the molecules (grid stride) and adds each chunk's
// outer products and column sums into its own slice of a [blocks, P] f32
// partial buffer in global memory (read-modify-write, L2-resident: ~18 MB
// at 132 blocks, H=128); the wrapper sums the slices. No atomics: every
// partial element has one owner thread or warp, so the result is
// deterministic. The chunk loop reuses its activation buffers (m1 -> m2 ->
// dz3, z3 -> dz3 W3^T -> dz2, z1 -> dz1), so each outer product is taken
// while its operands exist: m2 is staged before dz3 overwrites it, m1 is
// recomputed from z1 for dW2 (z1 lives until dz1), and dw4 reads g1 from
// z3 before dz3 W3^T overwrites it. bf16 products run on wmma tiles (both
// operands are bf16 values, staged as bf16); f32 ones as FMA loops. As in
// _bwd_kernel, dw1r takes the unrounded f32 r2 and dw4 the unrounded f32
// dgate, while the forward rounds r2 and d_g1 takes the rounded dgate.
// The staging buffers lower the largest N (egcl_allpairs_smem_bytes with
// kind 2; at H=128 about 27 for bf16 and 19 for f32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <stddef.h>

#include "egcl_part_layout.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRowGroup = 8;    // rows per thread in the FMA products
// Edge rows per chunk: 32 for bf16 (two wmma row tiles), 16 for f32, whose
// larger weights leave less shared memory for the activation buffers.
template <typename T> constexpr int kRows = sizeof(T) == 2 ? 32 : 16;
constexpr size_t kMaxSmem = 232448;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

// Round an f32 value to the compute dtype (and hold it as f32).
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return Cvt<T>::to_f(Cvt<T>::from_f(x));
}

// idx / H for the [rows, H] loops: a shift when H is a power of two (the
// condition and the shift are loop invariant).
__device__ __forceinline__ int row_of(int idx, int H) {
  return (H & (H - 1)) == 0 ? idx >> (__ffs(H) - 1) : idx / H;
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ float silu_f(float x) { return x * sigmoid_f(x); }
__device__ __forceinline__ float dsilu_f(float x) {
  const float s = sigmoid_f(x);
  return s * (1.0f + x * (1.0f - s));
}

// Node sums of one chunk of i-major edge rows e0 .. e0+nrows-1 (row r is
// edge e0+r, i = e / N, j = e % N): dst[i or j][c] += sum of src[r][c].
// Each (atom, column) item sums its rows in a register in row order, so
// the work is independent across threads and deterministic.
__device__ __forceinline__ void sum_i_side(float* dst, const float* src,
                                           int ncols, int e0, int nrows,
                                           int N) {
  const int i0 = e0 / N, ni = (e0 + nrows - 1) / N - i0 + 1;
  for (int w = threadIdx.x; w < ncols * ni; w += kThreads) {
    const int i = i0 + w / ncols, c = w % ncols;
    const int lo = max(i * N, e0) - e0, hi = min((i + 1) * N, e0 + nrows) - e0;
    float acc = 0.f;
    for (int r = lo; r < hi; ++r) acc += src[r * ncols + c];
    dst[i * ncols + c] += acc;
  }
}
__device__ __forceinline__ void sum_j_side(float* dst, const float* src,
                                           int ncols, int e0, int nrows,
                                           int N) {
  const int nq = min(N, nrows);       // rows q, q+N, ... share one j
  for (int w = threadIdx.x; w < ncols * nq; w += kThreads) {
    const int q = w / ncols, c = w % ncols;
    float acc = 0.f;
    for (int r = q; r < nrows; r += N) acc += src[r * ncols + c];
    dst[((e0 + q) % N) * ncols + c] += acc;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  int B, N, nf, H;
  const void* h;      // [B, N, nf]  T
  const float* pos;   // [B, N, 3]
  const float* box;   // [B, 3]
  const void* mask;   // [B, N]     T (0/1)
  const void* W1a;    // [nf, H]    T
  const void* W1b;    // [nf, H]
  const void* w1r;    // [H]
  const void* b1;     // [H]
  const void* W2;     // [H, H]
  const void* b2;     // [H]
  const void* W3;     // [H, H]
  const void* b3;     // [H]
  const void* w4;     // [H]
  const void* dagg;   // [B, N, H]  T   (backward)
  const void* dfsum;  // [B, N, 3]  T   (backward)
  void* agg;          // [B, N, H]  T   (forward)
  void* fsum;         // [B, N, 3]  T   (forward)
  void* dh;           // [B, N, nf] T   (backward)
  float* dpos;        // [B, N, 3]      (backward)
  float* part;        // [gridDim.x, P] parameter-gradient partials
};

// Row stride of W2/W3 in shared memory. f32 (FMA products): odd in 32-bit
// words, so a warp reading one column (W^T) touches 32 different banks.
// bf16 (tensor-core tiles): a multiple of 8 elements, as wmma loads need,
// padded by 16 bytes so the 8 rows of a tile fragment hit different banks.
template <typename T> __host__ __device__ int weight_stride(int H) {
  return sizeof(T) == 4 ? H + 1 : H + 8;
}

struct Bump {
  char* base;
  size_t off;
  __host__ __device__ char* take(size_t bytes) {
    off = (off + 31) & ~size_t(31);   // wmma tiles need 32-byte alignment
    char* p = base ? base + off : nullptr;
    off += bytes;
    return p;
  }
};

template <typename T> struct Smem {
  T *W2, *W3;
  __nv_bfloat16* xb;                  // [kRows, H+8] bf16 product input
  __nv_bfloat16* xb2;                 // the same, outer products' right side
  float* S;                           // [kRows, H] f32 outer products' left
  float *W1a, *W1b, *w1r, *b1, *b2, *b3, *w4, *box;
  float* buf[4];                      // [kRows, H] activations
  float *cd, *r2, *valid, *gate;      // per edge row of the chunk
  float *aux1, *aux2, *aux3;          // [kRows], [kRows], [kRows, 3]
  float* colred;                      // column-sum partials
  int *ri, *rj;
  float *h, *pos, *mask;              // the molecule's atoms
  float *hA, *hB;                     // [N, H] per-atom h W1a, h W1b
  float* accH[3];                     // [N, H]
  float* acc3[3];                     // [N, 3]
};

// Carve the block's shared memory with m; with a null base m only sizes
// it. The fixed-size buffers (weights, one chunk's rows) come first, then
// the per-atom arrays. Forward: 2 activation buffers, accH = {agg},
// acc3 = {fsum}. Backward: 4 activation buffers, accH = {dz1_i, dz1_j,
// dagg}, acc3 = {dpos_i, dpos_j, dfsum}; with parameter gradients also the
// outer products' staging (xb2 for bf16, S for f32), the unrounded dgate
// (aux2) and the column-sum partials.
template <typename T>
__host__ __device__ void carve(Bump& m, Smem<T>& s, int N, int nf, int H,
                               bool bwd, bool params) {
  const size_t WS = weight_stride<T>(H);
  const bool bf16 = sizeof(T) == 2;
  const size_t xbytes = sizeof(__nv_bfloat16) * kRows<T> * (H + 8);
  s.W2 = (T*)m.take(sizeof(T) * H * WS);
  s.W3 = (T*)m.take(sizeof(T) * H * WS);
  s.xb = bf16 ? (__nv_bfloat16*)m.take(xbytes) : nullptr;
  s.xb2 = bf16 && params ? (__nv_bfloat16*)m.take(xbytes) : nullptr;
  const size_t fH = sizeof(float) * H;
  s.S = !bf16 && params ? (float*)m.take(fH * kRows<T>) : nullptr;
  s.aux2 = params ? (float*)m.take(sizeof(float) * kRows<T>) : nullptr;
  s.colred = params ? (float*)m.take(sizeof(float) *
                                     (H > kThreads ? H : kThreads))
                    : nullptr;
  s.W1a = (float*)m.take(fH * nf);
  s.W1b = (float*)m.take(fH * nf);
  s.w1r = (float*)m.take(fH);
  s.b1 = (float*)m.take(fH);
  s.b2 = (float*)m.take(fH);
  s.b3 = (float*)m.take(fH);
  s.w4 = (float*)m.take(fH);
  s.box = (float*)m.take(sizeof(float) * 3);
  const int nbuf = bwd ? 4 : 2;
  for (int k = 0; k < 4; ++k)
    s.buf[k] = k < nbuf ? (float*)m.take(fH * kRows<T>) : nullptr;
  s.cd = (float*)m.take(sizeof(float) * kRows<T> * 3);
  s.r2 = (float*)m.take(sizeof(float) * kRows<T>);
  s.valid = (float*)m.take(sizeof(float) * kRows<T>);
  s.gate = (float*)m.take(sizeof(float) * kRows<T>);
  s.aux1 = (float*)m.take(sizeof(float) * kRows<T>);
  s.aux3 = (float*)m.take(sizeof(float) * kRows<T> * 3);
  s.ri = (int*)m.take(sizeof(int) * kRows<T>);
  s.rj = (int*)m.take(sizeof(int) * kRows<T>);
  s.h = (float*)m.take(sizeof(float) * N * nf);
  s.pos = (float*)m.take(sizeof(float) * N * 3);
  s.mask = (float*)m.take(sizeof(float) * N);
  s.hA = (float*)m.take(fH * N);
  s.hB = (float*)m.take(fH * N);
  const int nacc = bwd ? 3 : 1;
  for (int k = 0; k < 3; ++k) {
    s.accH[k] = k < nacc ? (float*)m.take(fH * N) : nullptr;
    s.acc3[k] = k < nacc ? (float*)m.take(sizeof(float) * N * 3) : nullptr;
  }
}

// Four consecutive weights from global memory into shared memory.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
__device__ __forceinline__ void copy4(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src) {
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
}

template <typename T>
__device__ void load_f(float* dst, const void* src, int n) {
  const T* p = (const T*)src;
  for (int k = threadIdx.x; k < n; k += kThreads) dst[k] = Cvt<T>::to_f(p[k]);
}

// The weights into shared memory.
template <typename T>
__device__ void load_weights(const Args& a, Smem<T>& s) {
  const int nf = a.nf, H = a.H, WS = weight_stride<T>(H);
  const T* W2 = (const T*)a.W2;
  const T* W3 = (const T*)a.W3;
  const int H4 = H / 4;               // H % 4 == 0, rows 16-byte aligned
  for (int k = threadIdx.x; k < H * H4; k += kThreads) {
    const int r = k / H4, c = (k - r * H4) * 4;
    copy4(s.W2 + r * WS + c, W2 + r * H + c);
    copy4(s.W3 + r * WS + c, W3 + r * H + c);
  }
  load_f<T>(s.W1a, a.W1a, nf * H);
  load_f<T>(s.W1b, a.W1b, nf * H);
  load_f<T>(s.w1r, a.w1r, H);
  load_f<T>(s.b1, a.b1, H);
  load_f<T>(s.b2, a.b2, H);
  load_f<T>(s.b3, a.b3, H);
  load_f<T>(s.w4, a.w4, H);
}

// Molecule b's atom state into shared memory; zero the sums.
template <typename T>
__device__ void load_molecule(const Args& a, Smem<T>& s, int b, bool bwd) {
  const int N = a.N, nf = a.nf, H = a.H;
  load_f<T>(s.h, (const T*)a.h + (size_t)b * N * nf, N * nf);
  load_f<T>(s.mask, (const T*)a.mask + (size_t)b * N, N);
  for (int k = threadIdx.x; k < N * 3; k += kThreads)
    s.pos[k] = a.pos[(size_t)b * N * 3 + k];
  if (threadIdx.x < 3) s.box[threadIdx.x] = a.box[b * 3 + threadIdx.x];
  const int nacc = bwd ? 2 : 1;
  for (int q = 0; q < nacc; ++q) {
    for (int k = threadIdx.x; k < N * H; k += kThreads) s.accH[q][k] = 0.f;
    for (int k = threadIdx.x; k < N * 3; k += kThreads) s.acc3[q][k] = 0.f;
  }
  if (bwd) {
    load_f<T>(s.accH[2], (const T*)a.dagg + (size_t)b * N * H, N * H);
    load_f<T>(s.acc3[2], (const T*)a.dfsum + (size_t)b * N * 3, N * 3);
  }
}

// Per edge row of the chunk: (i, j), min-image cd, r2 and valid.
template <typename T>
__device__ void row_geometry(Smem<T>& s, int N, int e0, int E) {
  const int r = threadIdx.x;
  if (r >= kRows<T>) return;
  const int e = e0 + r;
  if (e < E) {
    const int i = e / N, j = e - i * N;
    float r2 = 0.f;
    for (int d = 0; d < 3; ++d) {
      float c = s.pos[i * 3 + d] - s.pos[j * 3 + d];
      const float bx = s.box[d];
      c = c - rintf(c / bx) * bx;   // round half to even, as jnp.round
      s.cd[r * 3 + d] = c;
      r2 += c * c;
    }
    s.r2[r] = r2;
    s.valid[r] = s.mask[i] * s.mask[j] * (i != j ? 1.f : 0.f);
    s.ri[r] = i;
    s.rj[r] = j;
  } else {
    for (int d = 0; d < 3; ++d) s.cd[r * 3 + d] = 0.f;
    s.r2[r] = 0.f;
    s.valid[r] = 0.f;
    s.ri[r] = 0;
    s.rj[r] = 0;
  }
}

// Per-atom first-layer projections hA = h W1a, hB = h W1b, each rounded to
// the compute dtype as the TPU kernel rounds its dots.
template <typename T>
__device__ void atom_projections(Smem<T>& s, int N, int nf, int H) {
  for (int idx = threadIdx.x; idx < N * H; idx += kThreads) {
    const int i = idx / H, c = idx - i * H;
    float pa = 0.f, pb = 0.f;
    for (int k = 0; k < nf; ++k) {
      pa = fmaf(s.h[i * nf + k], s.W1a[k * H + c], pa);
      pb = fmaf(s.h[i * nf + k], s.W1b[k * H + c], pb);
    }
    s.hA[idx] = rnd<T>(pa);
    s.hB[idx] = rnd<T>(pb);
  }
}

// z1 = h_i W1a + h_j W1b + b1 + r2 w1r (rounded as the TPU kernel does);
// m1 = silu(z1). Stores z1 when z1_out is given.
template <typename T>
__device__ void first_layer(const Smem<T>& s, int H, int e0, int E,
                            float* m1_out, float* z1_out) {
  #pragma unroll 4
  for (int idx = threadIdx.x; idx < kRows<T> * H; idx += kThreads) {
    const int r = row_of(idx, H), c = idx - r * H;
    float z = 0.f;
    if (e0 + r < E) {
      z = rnd<T>(s.hA[s.ri[r] * H + c] + s.hB[s.rj[r] * H + c]);
      z = rnd<T>(z + s.b1[c]);
      z = rnd<T>(z + rnd<T>(rnd<T>(s.r2[r]) * s.w1r[c]));
    }
    if (z1_out) z1_out[idx] = z;
    m1_out[idx] = rnd<T>(silu_f(z));
  }
}

// Y[r, n] = sum_k X[r, k] * W[k, n]  (TRANS: W[n, k]) over the kRows rows,
// f32 accumulation, as FMA loops (the f32 compute dtype). Each thread owns
// one column n and kRowGroup rows.
template <typename T, bool TRANS>
__device__ void row_gemm_fma(const float* __restrict__ X,
                             const T* __restrict__ W, float* __restrict__ Y,
                             int H) {
  const int WS = weight_stride<T>(H);
  constexpr int groups = kRows<T> / kRowGroup;
  for (int w = threadIdx.x; w < H * groups; w += kThreads) {
    const int n = w % H, g = w / H;
    const float* x = X + g * kRowGroup * H;
    float acc[kRowGroup];
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) acc[q] = 0.f;
    for (int k = 0; k < H; k += 4) {
      float wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wv[u] = Cvt<T>::to_f(TRANS ? W[n * WS + k + u] : W[(k + u) * WS + n]);
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
        const float4 xv = *reinterpret_cast<const float4*>(x + q * H + k);
        acc[q] = fmaf(xv.x, wv[0], acc[q]);
        acc[q] = fmaf(xv.y, wv[1], acc[q]);
        acc[q] = fmaf(xv.z, wv[2], acc[q]);
        acc[q] = fmaf(xv.w, wv[3], acc[q]);
      }
    }
    float* y = Y + g * kRowGroup * H;
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) y[q * H + n] = acc[q];
  }
}

// The same product on the tensor cores (bf16 compute dtype): X, whose
// values are already bf16, is staged as bf16 in xb; each warp computes
// 16x16 output tiles with wmma bf16 16x16x16 steps and f32 accumulation.
// TRANS reads W as a column-major B operand, i.e. W^T, without a copy.
// Needs H % 16 == 0 (checked at launch). Synchronizes the block once.
template <bool TRANS>
__device__ void row_gemm_tc(const float* __restrict__ X,
                            __nv_bfloat16* __restrict__ xb,
                            const __nv_bfloat16* __restrict__ W,
                            float* __restrict__ Y, int H) {
  using namespace nvcuda;
  const int XS = H + 8, WS = weight_stride<__nv_bfloat16>(H);
  #pragma unroll 4
  for (int idx = threadIdx.x; idx < kRows<__nv_bfloat16> * H; idx += kThreads) {
    const int r = row_of(idx, H), c = idx - r * H;
    xb[r * XS + c] = __float2bfloat16_rn(X[idx]);
  }
  __syncthreads();
  const int ncol = H / 16, ntiles = (kRows<__nv_bfloat16> / 16) * ncol;
  for (int t = threadIdx.x >> 5; t < ntiles; t += kThreads / 32) {
    const int tr = t / ncol, tc = t - tr * ncol;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < H; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, xb + tr * 16 * XS + k, XS);
      if constexpr (TRANS) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(b, W + tc * 16 * WS + k, WS);
        wmma::mma_sync(acc, a, b, acc);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, W + k * WS + tc * 16, WS);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    wmma::store_matrix_sync(Y + tr * 16 * H + tc * 16, acc, H,
                            wmma::mem_row_major);
  }
}

// Y = X W (TRANS: X W^T) over the chunk's rows: tensor cores for bf16,
// FMA loops for f32 (whose tensor-core path, TF32, would round the inputs).
template <typename T, bool TRANS>
__device__ void row_gemm(const Smem<T>& s, const float* X, const T* W,
                         float* Y, int H) {
  if constexpr (sizeof(T) == 2)
    row_gemm_tc<TRANS>(X, s.xb, W, Y, H);
  else
    row_gemm_fma<T, TRANS>(X, W, Y, H);
}

// gate[r] = sum_c silu(z3[r, c]) w4[c] in f32, one warp per row. z3 is
// either final (Z3_FINAL) or the raw product m2 W3 (bias added here).
template <typename T, bool Z3_FINAL>
__device__ void gate_rows(Smem<T>& s, const float* z3buf, int H) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows<T>; r += kThreads / 32) {
    float acc = 0.f;
    for (int c = lane; c < H; c += 32) {
      float z3 = z3buf[r * H + c];
      if (!Z3_FINAL) z3 = rnd<T>(rnd<T>(z3) + s.b3[c]);
      acc = fmaf(rnd<T>(silu_f(z3)), s.w4[c], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) s.gate[r] = acc;
  }
}

// ---- parameter gradients: per-chunk sums into the block's partial slice

// dst[c] += sum over the chunk's rows r of f(r, c), for c < H. Each column's
// rows are split into G groups (G = kThreads / H, 1 when H >= kThreads)
// summed in registers, then the G partials in group order; the same thread
// adds to the same column every time, so the sums are deterministic.
// Synchronizes the block twice.
template <typename T, typename F>
__device__ void col_sum(float* __restrict__ dst, float* red, int H, F f) {
  constexpr int R = kRows<T>;
  const int G = H >= kThreads ? 1 : kThreads / H;
  const int per = (R + G - 1) / G;
  for (int w = threadIdx.x; w < G * H; w += kThreads) {
    const int g = w / H, c = w - g * H;
    float acc = 0.f;
    for (int r = g * per; r < min(R, (g + 1) * per); ++r) acc += f(r, c);
    red[w] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += red[g * H + c];
    dst[c] += acc;
  }
  __syncthreads();
}

// The left operand of the next outer product, f(idx) for each (row, column)
// idx of the chunk (a value already in the compute dtype): into xb as bf16,
// or into S for f32.
template <typename T, typename F>
__device__ void stage_left(Smem<T>& s, int H, F f) {
  #pragma unroll 4
  for (int idx = threadIdx.x; idx < kRows<T> * H; idx += kThreads) {
    if constexpr (sizeof(T) == 2) {
      const int r = row_of(idx, H), c = idx - r * H;
      s.xb[r * (H + 8) + c] = __float2bfloat16_rn(f(idx));
    } else {
      s.S[idx] = f(idx);
    }
  }
}

// The right operand (bf16 only; f32 reads its f32 buffer directly).
template <typename T>
__device__ void stage_right(Smem<T>& s, const float* src, int H) {
  if constexpr (sizeof(T) == 2) {
    #pragma unroll 4
    for (int idx = threadIdx.x; idx < kRows<T> * H; idx += kThreads) {
      const int r = row_of(idx, H), c = idx - r * H;
      s.xb2[r * (H + 8) + c] = __float2bfloat16_rn(src[idx]);
    }
  }
}

// dst[k, n] += sum_r left[r, k] right[r, n] over the chunk's rows, for
// k, n < H, in the block's slice of the partials (global memory, read-
// modify-write). bf16: wmma 16x16x16 tiles, left^T read from xb as a
// column-major A operand, right from xb2, f32 accumulation in fragments
// loaded from and stored back to dst. f32: FMA loops on S and `right`, a
// 4x4 (k, n) tile per work item. Each tile has one owner.
template <typename T>
__device__ void outer_add(const Smem<T>& s, float* __restrict__ dst,
                          const float* __restrict__ right, int H) {
  if constexpr (sizeof(T) == 2) {
    using namespace nvcuda;
    const int XS = H + 8, ncol = H / 16;
    for (int t = threadIdx.x >> 5; t < ncol * ncol; t += kThreads / 32) {
      const int tm = t / ncol, tn = t - tm * ncol;
      float* d = dst + tm * 16 * H + tn * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, d, H, wmma::mem_row_major);
      for (int k = 0; k < kRows<T>; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fa;
        wmma::load_matrix_sync(fa, s.xb + k * XS + tm * 16, XS);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, s.xb2 + k * XS + tn * 16, XS);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(d, acc, H, wmma::mem_row_major);
    }
  } else {
    const int H4 = H / 4;
    for (int w = threadIdx.x; w < H4 * H4; w += kThreads) {
      const int kt = w / H4, nt = w - kt * H4;
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
      for (int r = 0; r < kRows<T>; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(s.S + r * H + 4 * kt);
        const float4 g = *reinterpret_cast<const float4*>(right + r * H + 4 * nt);
        const float xa[4] = {x.x, x.y, x.z, x.w}, ga[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xa[u], ga[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4* p = reinterpret_cast<float4*>(dst + (4 * kt + u) * H + 4 * nt);
        float4 v = *p;
        v.x += acc[u][0];
        v.y += acc[u][1];
        v.z += acc[u][2];
        v.w += acc[u][3];
        *p = v;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) egcl_fwd_kernel(Args a) {
  extern __shared__ __align__(128) char smem_raw[];
  const int b = blockIdx.x, tid = threadIdx.x;
  Smem<T> s;
  Bump m{smem_raw, 0};
  carve<T>(m, s, a.N, a.nf, a.H, false, false);
  const int N = a.N, H = a.H, E = N * N;
  float* agg = s.accH[0];
  float* fsum = s.acc3[0];
  load_weights<T>(a, s);
  load_molecule<T>(a, s, b, false);
  __syncthreads();
  atom_projections<T>(s, N, a.nf, H);

  for (int e0 = 0; e0 < E; e0 += kRows<T>) {
    row_geometry<T>(s, N, e0, E);
    __syncthreads();
    first_layer<T>(s, H, e0, E, s.buf[0], nullptr);
    __syncthreads();
    row_gemm<T, false>(s, s.buf[0], s.W2, s.buf[1], H);
    __syncthreads();
    #pragma unroll 4
    for (int idx = tid; idx < kRows<T> * H; idx += kThreads) {
      const int r = row_of(idx, H), c = idx - r * H;
      const float z2 = rnd<T>(rnd<T>(s.buf[1][idx]) + s.b2[c]);
      s.buf[1][idx] = rnd<T>(rnd<T>(silu_f(z2)) * s.valid[r]);   // m2
    }
    __syncthreads();
    const int nrows = min(kRows<T>, E - e0);
    sum_i_side(agg, s.buf[1], H, e0, nrows, N);
    row_gemm<T, false>(s, s.buf[1], s.W3, s.buf[0], H);
    __syncthreads();
    gate_rows<T, false>(s, s.buf[0], H);
    __syncthreads();
    if (tid < kRows<T> * 3) {
      const int r = tid / 3;
      float t = s.cd[tid] * s.gate[r];
      t = fminf(fmaxf(t, -100.f), 100.f) * s.valid[r];
      s.aux3[tid] = rnd<T>(t);
    }
    __syncthreads();
    sum_i_side(fsum, s.aux3, 3, e0, nrows, N);
    __syncthreads();
  }

  T* agg_out = (T*)a.agg + (size_t)b * N * H;
  T* fsum_out = (T*)a.fsum + (size_t)b * N * 3;
  for (int k = tid; k < N * H; k += kThreads) agg_out[k] = Cvt<T>::from_f(agg[k]);
  for (int k = tid; k < N * 3; k += kThreads) fsum_out[k] = Cvt<T>::from_f(fsum[k]);
}

// The backward of molecule b, recomputing the forward per chunk; with
// PARAMS it also adds the parameter gradients into `part`, the block's
// slice of the partials.
template <typename T, bool PARAMS>
__device__ void bwd_molecule(const Args& a, Smem<T>& s, int b,
                             float* part) {
  const int tid = threadIdx.x;
  const int N = a.N, nf = a.nf, H = a.H, E = N * N;
  float *dz1i = s.accH[0], *dz1j = s.accH[1], *dagg = s.accH[2];
  float *dposi = s.acc3[0], *dposj = s.acc3[1], *dfsum = s.acc3[2];
  float *A = s.buf[0], *Z1 = s.buf[1], *Z2 = s.buf[2], *Z3 = s.buf[3];
  const PartLayout L(nf, H);
  load_molecule<T>(a, s, b, true);
  __syncthreads();
  atom_projections<T>(s, N, nf, H);

  for (int e0 = 0; e0 < E; e0 += kRows<T>) {
    // -- recompute the forward for this chunk (inputs are the residuals)
    row_geometry<T>(s, N, e0, E);
    __syncthreads();
    first_layer<T>(s, H, e0, E, A, Z1);
    __syncthreads();
    row_gemm<T, false>(s, A, s.W2, Z2, H);
    __syncthreads();
    #pragma unroll 4
    for (int idx = tid; idx < kRows<T> * H; idx += kThreads) {
      const int r = row_of(idx, H), c = idx - r * H;
      const float z2 = rnd<T>(rnd<T>(Z2[idx]) + s.b2[c]);
      Z2[idx] = z2;
      A[idx] = rnd<T>(rnd<T>(silu_f(z2)) * s.valid[r]);          // m2
    }
    __syncthreads();
    row_gemm<T, false>(s, A, s.W3, Z3, H);
    __syncthreads();
    #pragma unroll 4
    for (int idx = tid; idx < kRows<T> * H; idx += kThreads) {
      const int c = idx - row_of(idx, H) * H;
      Z3[idx] = rnd<T>(rnd<T>(Z3[idx]) + s.b3[c]);
    }
    __syncthreads();
    gate_rows<T, true>(s, Z3, H);
    __syncthreads();

    // -- geometry-side cotangents, per edge row (f32)
    if (tid < kRows<T>) {
      const int r = tid;
      const int i = s.ri[r];
      const float gate = s.gate[r], valid = s.valid[r];
      float dgate = 0.f;
      for (int d = 0; d < 3; ++d) {
        const float c = s.cd[r * 3 + d];
        const float raw = c * gate;
        const float inside = (raw >= -100.f && raw <= 100.f) ? 1.f : 0.f;
        const float dt = dfsum[i * 3 + d] * inside * valid;
        dgate = fmaf(c, dt, dgate);
        s.aux3[r * 3 + d] = gate * dt;                            // d_cd
      }
      s.aux1[r] = rnd<T>(dgate);
      if constexpr (PARAMS) s.aux2[r] = dgate;
    }
    __syncthreads();

    if constexpr (PARAMS) {
      // dw4 += g1^T dgate with the unrounded dgate, g1 from z3 (Z3) before
      // dz3 W3^T overwrites it; m2 (A) staged before dz3 overwrites it
      col_sum<T>(part + L.dw4, s.colred, H, [&](int r, int c) {
        return rnd<T>(silu_f(Z3[r * H + c])) * s.aux2[r];
      });
      stage_left<T>(s, H, [&](int idx) { return A[idx]; });      // m2
      __syncthreads();
    }

    // -- the hidden-wide chain backwards
    #pragma unroll 4
    for (int idx = tid; idx < kRows<T> * H; idx += kThreads) {
      const int r = row_of(idx, H), c = idx - r * H;
      const float dg1 = rnd<T>(s.aux1[r] * s.w4[c]);
      A[idx] = rnd<T>(dg1 * rnd<T>(dsilu_f(Z3[idx])));            // dz3
    }
    __syncthreads();
    if constexpr (PARAMS) {
      stage_right<T>(s, A, H);
      col_sum<T>(part + L.db3, s.colred, H,
                 [&](int r, int c) { return A[r * H + c]; });
      outer_add<T>(s, part + L.dW3, A, H);                           // m2^T dz3
      __syncthreads();
    }
    row_gemm<T, true>(s, A, s.W3, Z3, H);                            // dz3 W3^T
    __syncthreads();
    #pragma unroll 4
    for (int idx = tid; idx < kRows<T> * H; idx += kThreads) {
      const int r = row_of(idx, H), c = idx - r * H;
      const float dm2 =
          rnd<T>(rnd<T>(rnd<T>(Z3[idx]) + dagg[s.ri[r] * H + c]) * s.valid[r]);
      Z3[idx] = rnd<T>(dm2 * rnd<T>(dsilu_f(Z2[idx])));           // dz2
    }
    __syncthreads();
    if constexpr (PARAMS) {
      // m1 recomputed from z1 (Z1 holds z1 until dz1 overwrites it)
      stage_left<T>(s, H, [&](int idx) { return rnd<T>(silu_f(Z1[idx])); });
      stage_right<T>(s, Z3, H);
      col_sum<T>(part + L.db2, s.colred, H,
                 [&](int r, int c) { return Z3[r * H + c]; });
      outer_add<T>(s, part + L.dW2, Z3, H);                          // m1^T dz2
      __syncthreads();
    }
    row_gemm<T, true>(s, Z3, s.W2, A, H);                            // dz2 W2^T
    __syncthreads();
    #pragma unroll 4
    for (int idx = tid; idx < kRows<T> * H; idx += kThreads)
      Z1[idx] = rnd<T>(rnd<T>(A[idx]) * rnd<T>(dsilu_f(Z1[idx])));  // dz1
    __syncthreads();
    {
      const int warp = tid >> 5, lane = tid & 31;
      for (int r = warp; r < kRows<T>; r += kThreads / 32) {
        float dr2 = 0.f;
        for (int c = lane; c < H; c += 32) dr2 = fmaf(Z1[r * H + c], s.w1r[c], dr2);
        dr2 = warp_sum(dr2);
        if (lane == 0)
          for (int d = 0; d < 3; ++d) {
            const float dcd = s.aux3[r * 3 + d] + 2.f * s.cd[r * 3 + d] * dr2;
            s.aux3[r * 3 + d] = rnd<T>(dcd);
          }
      }
    }
    __syncthreads();
    if constexpr (PARAMS) {
      // db1, dw1r (with the unrounded f32 r2), dW1a = h_i^T dz1 and
      // dW1b = h_j^T dz1 (dW1b follows dW1a in the slice)
      col_sum<T>(part + L.db1, s.colred, H,
                 [&](int r, int c) { return Z1[r * H + c]; });
      col_sum<T>(part + L.dw1r, s.colred, H,
                 [&](int r, int c) { return s.r2[r] * Z1[r * H + c]; });
      for (int w = tid; w < 2 * nf * H; w += kThreads) {
        const int side = w / (nf * H), kc = w - side * nf * H;
        const int k = kc / H, c = kc - k * H;
        const int* atom = side ? s.rj : s.ri;
        float acc = 0.f;
        for (int r = 0; r < kRows<T>; ++r)
          acc = fmaf(s.h[atom[r] * nf + k], Z1[r * H + c], acc);
        part[L.dW1a + w] += acc;
      }
    }

    // -- node sums, i side and j side, in a fixed order
    const int nrows = min(kRows<T>, E - e0);
    sum_i_side(dz1i, Z1, H, e0, nrows, N);
    sum_j_side(dz1j, Z1, H, e0, nrows, N);
    sum_i_side(dposi, s.aux3, 3, e0, nrows, N);
    sum_j_side(dposj, s.aux3, 3, e0, nrows, N);
    __syncthreads();
  }

  T* dh_out = (T*)a.dh + (size_t)b * N * nf;
  for (int idx = tid; idx < N * nf; idx += kThreads) {
    const int i = idx / nf, k = idx - i * nf;
    float si = 0.f, sj = 0.f;
    for (int c = 0; c < H; ++c) {
      si = fmaf(rnd<T>(dz1i[i * H + c]), s.W1a[k * H + c], si);
      sj = fmaf(rnd<T>(dz1j[i * H + c]), s.W1b[k * H + c], sj);
    }
    dh_out[idx] = Cvt<T>::from_f(si + sj);
  }
  float* dpos_out = a.dpos + (size_t)b * N * 3;
  for (int k = tid; k < N * 3; k += kThreads) dpos_out[k] = dposi[k] - dposj[k];
}

// Input gradients: one block per molecule (the grid is B). PARAMS: about
// one block per SM strides over the molecules, zeroing its own slice of
// a.part and adding the parameter gradients into it.
template <typename T, bool PARAMS>
__global__ void __launch_bounds__(kThreads) egcl_bwd_kernel(Args a) {
  extern __shared__ __align__(128) char smem_raw[];
  Smem<T> s;
  Bump m{smem_raw, 0};
  carve<T>(m, s, a.N, a.nf, a.H, true, PARAMS);
  float* part = nullptr;
  if constexpr (PARAMS) {
    const int P = PartLayout(a.nf, a.H).P;
    part = a.part + (size_t)blockIdx.x * P;
    for (int k = threadIdx.x; k < P; k += kThreads) part[k] = 0.f;
  }
  load_weights<T>(a, s);
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    __syncthreads();                  // the previous molecule is written out
    bwd_molecule<T, PARAMS>(a, s, b, part);
  }
}

// What a launch runs: the forward, the input-gradient backward, or the
// backward with parameter gradients.
enum Kind { kFwd = 0, kBwd = 1, kBwdParams = 2 };

// Dynamic shared memory of one block.
template <typename T>
size_t smem_bytes(int N, int nf, int H, int kind) {
  Smem<T> s;
  Bump m{nullptr, 0};
  carve<T>(m, s, N, nf, H, kind != kFwd, kind == kBwdParams);
  return m.off;
}

bool valid_dims(int B, int N, int nf, int H, int h_mult) {
  return B >= 1 && N >= 1 && nf >= 1 && H >= h_mult && H % h_mult == 0;
}

template <typename T> constexpr int kHMult = sizeof(T) == 2 ? 16 : 4;

// The grid: B blocks, or min(B, blocks) for the parameter gradients (the
// rows of a.part).
template <typename T>
int launch(const Args& a, int kind, int blocks, cudaStream_t stream) {
  if (!valid_dims(a.B, a.N, a.nf, a.H, kHMult<T>))   // wmma tiles / float4 rows
    return (int)cudaErrorInvalidValue;
  if (kind == kBwdParams && blocks < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(a.N, a.nf, a.H, kind);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  void (*kernel)(Args) = kind == kFwd   ? egcl_fwd_kernel<T>
                         : kind == kBwd ? egcl_bwd_kernel<T, false>
                                        : egcl_bwd_kernel<T, true>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = kind == kBwdParams ? min(a.B, blocks) : a.B;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, const Args& a, int kind, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, kind, blocks, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, kind, blocks, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory that one block of a launch with these sizes needs,
// or -1 for sizes the kernel does not take (dtype, H multiple). kind: 0 the
// forward, 1 the input-gradient backward, 2 the backward with parameter
// gradients. A launch needs at most egcl_allpairs_smem_limit() bytes.
long long egcl_allpairs_smem_bytes(int dtype, int N, int nf, int H,
                                   int kind) {
  if (kind < kFwd || kind > kBwdParams) return -1;
  if (dtype == 0 && valid_dims(1, N, nf, H, kHMult<float>))
    return (long long)smem_bytes<float>(N, nf, H, kind);
  if (dtype == 1 && valid_dims(1, N, nf, H, kHMult<__nv_bfloat16>))
    return (long long)smem_bytes<__nv_bfloat16>(N, nf, H, kind);
  return -1;
}

long long egcl_allpairs_smem_limit() { return (long long)kMaxSmem; }

// dtype: 0 = float32, 1 = bfloat16 (the compute dtype of h, mask, weights,
// agg/fsum/dagg/dfsum/dh). pos, box and dpos are float32. Returns the
// cudaError_t of the launch (0 on success).
int egcl_allpairs_fwd(int dtype, int B, int N, int nf, int H, const void* h,
                      const void* pos, const void* box, const void* mask,
                      const void* W1a, const void* W1b, const void* w1r,
                      const void* b1, const void* W2, const void* b2,
                      const void* W3, const void* b3, const void* w4,
                      void* agg, void* fsum, void* stream) {
  Args a{B, N, nf, H, h, (const float*)pos, (const float*)box, mask,
         W1a, W1b, w1r, b1, W2, b2, W3, b3, w4,
         nullptr, nullptr, agg, fsum, nullptr, nullptr, nullptr};
  return dispatch(dtype, a, kFwd, 0, stream);
}

int egcl_allpairs_bwd(int dtype, int B, int N, int nf, int H, const void* h,
                      const void* pos, const void* box, const void* mask,
                      const void* W1a, const void* W1b, const void* w1r,
                      const void* b1, const void* W2, const void* b2,
                      const void* W3, const void* b3, const void* w4,
                      const void* dagg, const void* dfsum, void* dh,
                      void* dpos, void* stream) {
  Args a{B, N, nf, H, h, (const float*)pos, (const float*)box, mask,
         W1a, W1b, w1r, b1, W2, b2, W3, b3, w4,
         dagg, dfsum, nullptr, nullptr, dh, (float*)dpos, nullptr};
  return dispatch(dtype, a, kBwd, 0, stream);
}

// The backward with parameter gradients: part is a [min(B, blocks), P]
// float32 buffer (P = egcl_part_size); each of the min(B, blocks)
// blocks zeroes its row and adds its molecules' parameter gradients into
// it, and the caller sums the rows.
int egcl_allpairs_bwd_params(int dtype, int B, int N, int nf, int H,
                             int blocks, const void* h, const void* pos,
                             const void* box, const void* mask,
                             const void* W1a, const void* W1b,
                             const void* w1r, const void* b1, const void* W2,
                             const void* b2, const void* W3, const void* b3,
                             const void* w4, const void* dagg,
                             const void* dfsum, void* dh, void* dpos,
                             void* part, void* stream) {
  Args a{B, N, nf, H, h, (const float*)pos, (const float*)box, mask,
         W1a, W1b, w1r, b1, W2, b2, W3, b3, w4,
         dagg, dfsum, nullptr, nullptr, dh, (float*)dpos, (float*)part};
  return dispatch(dtype, a, kBwdParams, blocks, stream);
}

const char* egcl_allpairs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
