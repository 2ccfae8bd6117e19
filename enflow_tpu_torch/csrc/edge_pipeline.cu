// Gathered-edge EGCL pipeline for Hopper (sm_90a): forward, and the backward
// with input and parameter gradients.
//
// Replaces the Pallas TPU kernels of enflow_tpu/ops/edge_kernel.py:
//   forward  -> _edge_fwd / _fwd_kernel
//   backward -> _edge_bwd_impl / _bwd_kernel (de, dcd and dW1 ... dw4)
// and computes the same contract on pre-gathered rows. For every edge row
// (atom a, slot k) of e [A,K,C], cd [A,K,3], em [A,K]:
//   pre1 = e W1 + b1                 m1 = silu(pre1)            (rounded)
//   pre2 = m1 W2 + b2                m  = silu(pre2) * em       (rounded)
//   pre3 = m W3 + b3                 g1 = silu(pre3)            (rounded)
//   gate = g1 w4 (f32)               tr = clip(cd gate, +-100) * em (rounded)
//   agg_a = sum_k m,  F_sum_a = sum_k tr                        (rounded)
// Rounding to the compute dtype (float or bf16) happens where the TPU kernel
// rounds; every product and sum accumulates in f32. The backward recomputes
// the forward from its inputs and follows _bwd_kernel line by line: gate,
// dtr, dgate and the dpre* stay f32; de, dcd and the products' left operands
// dpre*.astype(dt) are rounded; the clip mask is strict (-100 < x < 100).
//
// What bounds it on this card: at the training shape (A = 30*13 = 390
// atoms, K = 32 slots, C = 3, H = 128, f32) a forward does ~1.1 GFLOP (two
// H x H products per row) and a backward ~2.7 GFLOP (two recomputed, two
// transposed and two parameter-gradient products per row) on ~0.6 MB of
// inputs: compute bound, ~16 and ~40 us at the 67 TFLOP/s f32 rate (f32
// products run on FMA units; TF32 tensor cores would round the inputs).
//
// Design (the simple, correct first version): a block owns tiles of TA
// consecutive atoms (grid-stride over tiles). An atom's K rows are
// contiguous, so each block walks its rows in chunks of kRows and sums over
// K as runs of equal atom in a fixed order: no atomics, deterministic. W2
// and W3 sit in shared memory (row stride H+1 against bank conflicts), the
// chunk's activations too, in f32. Products are FMA loops: a thread owns one
// output column and kRowGroup rows in the row products, and a 4x4 tile of
// the parameter gradient in the outer products. Each block adds its
// parameter-gradient partials into its own slice of a [blocks, P] f32
// buffer (read-modify-write in L2, once per chunk); the wrapper sums the
// slices. None of the TPU blocking carries over: no 0/1 summation matrix,
// no atom padding, no per-tile parameter outputs beyond one slice per block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 32;       // edge rows per chunk
constexpr int kRowGroup = 8;    // rows per thread in the row products
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

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ float silu_f(float x) { return x * sigmoid_f(x); }
__device__ __forceinline__ float dsilu_f(float x) {
  const float s = sigmoid_f(x);
  return s * (1.0f + x * (1.0f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  int A, K, C, H, TA, n_tiles;
  const void* e;      // [A, K, C]  T
  const void* cd;     // [A, K, 3]  T
  const void* em;     // [A, K]     T (0/1)
  const void* W1;     // [C, H]     T
  const void* b1;     // [H]
  const void* W2;     // [H, H]
  const void* b2;     // [H]
  const void* W3;     // [H, H]
  const void* b3;     // [H]
  const void* w4;     // [H]
  const void* dagg;   // [A, H]     T (backward)
  const void* dfs;    // [A, 3]     T (backward)
  void* agg;          // [A, H]     T (forward)
  void* fs;           // [A, 3]     T (forward)
  void* de;           // [A, K, C]  T (backward)
  void* dcd;          // [A, K, 3]  T (backward)
  float* part;        // [gridDim.x, P] parameter-gradient partials
};

// Offsets of the parameter gradients in one block's slice of `part`:
// dW1 [C,H], dW2 [H,H], dW3 [H,H], dw4 [H], db1, db2, db3 [H].
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

__host__ __device__ inline int weight_stride(int H) { return H + 1; }

struct Bump {
  char* base;
  size_t off;
  __host__ __device__ char* take(size_t bytes) {
    off = (off + 15) & ~size_t(15);   // float4 reads need 16-byte alignment
    char* p = base ? base + off : nullptr;
    off += bytes;
    return p;
  }
};

template <typename T> struct Smem {
  T *W2, *W3;                         // [H, H+1]
  float *W1, *b1, *b2, *b3, *w4;      // [C, H], [H] ...
  float* buf[4];                      // [kRows, H]: X, P1, P2, P3
  float *e, *cd, *em, *gate, *dgr, *aux3;   // per chunk row
  int* la;                            // local atom of each chunk row
  float *accH, *acc3;                 // [TA, H], [TA, 3]: agg / fs or
                                      // the tile's dagg / dfs (backward)
};

template <typename T>
__host__ __device__ void carve(Bump& m, Smem<T>& s, int C, int H, int TA,
                               bool bwd) {
  const size_t WS = weight_stride(H), fH = sizeof(float) * H;
  s.W2 = (T*)m.take(sizeof(T) * H * WS);
  s.W3 = (T*)m.take(sizeof(T) * H * WS);
  s.W1 = (float*)m.take(fH * C);
  s.b1 = (float*)m.take(fH);
  s.b2 = (float*)m.take(fH);
  s.b3 = (float*)m.take(fH);
  s.w4 = (float*)m.take(fH);
  const int nbuf = bwd ? 4 : 2;
  for (int k = 0; k < 4; ++k)
    s.buf[k] = k < nbuf ? (float*)m.take(fH * kRows) : nullptr;
  s.e = (float*)m.take(sizeof(float) * kRows * C);
  s.cd = (float*)m.take(sizeof(float) * kRows * 3);
  s.em = (float*)m.take(sizeof(float) * kRows);
  s.gate = (float*)m.take(sizeof(float) * kRows);
  s.dgr = (float*)m.take(sizeof(float) * kRows);
  s.aux3 = (float*)m.take(sizeof(float) * kRows * 3);
  s.la = (int*)m.take(sizeof(int) * kRows);
  s.accH = (float*)m.take(fH * TA);
  s.acc3 = (float*)m.take(sizeof(float) * TA * 3);
}

template <typename T>
__device__ void load_f(float* dst, const void* src, int n) {
  const T* p = (const T*)src;
  for (int k = threadIdx.x; k < n; k += kThreads) dst[k] = Cvt<T>::to_f(p[k]);
}

template <typename T>
__device__ void load_weights(const Args& a, Smem<T>& s) {
  const int H = a.H, WS = weight_stride(H);
  const T* W2 = (const T*)a.W2;
  const T* W3 = (const T*)a.W3;
  for (int k = threadIdx.x; k < H * H; k += kThreads) {
    const int r = k / H, c = k - r * H;
    s.W2[r * WS + c] = W2[k];
    s.W3[r * WS + c] = W3[k];
  }
  load_f<T>(s.W1, a.W1, a.C * H);
  load_f<T>(s.b1, a.b1, H);
  load_f<T>(s.b2, a.b2, H);
  load_f<T>(s.b3, a.b3, H);
  load_f<T>(s.w4, a.w4, H);
}

// One chunk's rows g0 .. g0+kRows-1 of the block's row range [g0, g_end):
// e, cd, em as f32 (zero past the end) and each row's atom within the tile.
template <typename T>
__device__ void load_chunk(const Args& a, Smem<T>& s, int g0, int g_end,
                           int a0) {
  const int C = a.C;
  const T* E = (const T*)a.e;
  const T* CD = (const T*)a.cd;
  const T* EM = (const T*)a.em;
  for (int k = threadIdx.x; k < kRows * C; k += kThreads) {
    const int r = k / C, g = g0 + r;
    s.e[k] = g < g_end ? Cvt<T>::to_f(E[(size_t)g * C + (k - r * C)]) : 0.f;
  }
  for (int k = threadIdx.x; k < kRows * 3; k += kThreads) {
    const int g = g0 + k / 3;
    s.cd[k] = g < g_end ? Cvt<T>::to_f(CD[(size_t)g0 * 3 + k]) : 0.f;
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int g = g0 + r;
    s.em[r] = g < g_end ? Cvt<T>::to_f(EM[g]) : 0.f;
    s.la[r] = g < g_end ? g / a.K - a0 : 0;
  }
}

// pre1 = e W1 + b1 (f32); X = rnd(silu(pre1)); P1 = pre1 when given.
template <typename T>
__device__ void first_layer(const Smem<T>& s, int C, int H, float* X,
                            float* P1) {
  for (int idx = threadIdx.x; idx < kRows * H; idx += kThreads) {
    const int r = idx / H, c = idx - r * H;
    float z = 0.f;
    for (int j = 0; j < C; ++j) z = fmaf(s.e[r * C + j], s.W1[j * H + c], z);
    z += s.b1[c];
    if (P1) P1[idx] = z;
    X[idx] = rnd<T>(silu_f(z));
  }
}

// Y[r, n] = sum_k X[r, k] W[k, n] (TRANS: W[n, k]) + bias[n] over the
// chunk's rows, f32 accumulation. A thread owns one column n and kRowGroup
// rows; X is read as float4 (H % 4 == 0).
template <typename T, bool TRANS>
__device__ void row_gemm(const float* __restrict__ X,
                         const T* __restrict__ W,
                         const float* __restrict__ bias,
                         float* __restrict__ Y, int H) {
  const int WS = weight_stride(H);
  constexpr int groups = kRows / kRowGroup;
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
    const float bn = bias ? bias[n] : 0.f;
    float* y = Y + g * kRowGroup * H;
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) y[q * H + n] = acc[q] + bn;
  }
}

// dst[k, n] += sum_r Xs[r, k] G[r, n] over the chunk's rows, for k, n < H:
// one 4x4 (k, n) tile per work item, added into the block's slice of the
// partials in global memory.
__device__ void outer_add(float* __restrict__ dst,
                          const float* __restrict__ Xs,
                          const float* __restrict__ G, int H) {
  const int H4 = H / 4;
  for (int w = threadIdx.x; w < H4 * H4; w += kThreads) {
    const int kt = w / H4, nt = w - kt * H4;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    for (int r = 0; r < kRows; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(Xs + r * H + 4 * kt);
      const float4 g = *reinterpret_cast<const float4*>(G + r * H + 4 * nt);
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

// gate[r] = sum_c rnd(silu(pre3[r, c])) w4[c] in f32, one warp per row.
template <typename T>
__device__ void gate_rows(Smem<T>& s, const float* P3, int H) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float acc = 0.f;
    for (int c = lane; c < H; c += 32)
      acc = fmaf(rnd<T>(silu_f(P3[r * H + c])), s.w4[c], acc);
    acc = warp_sum(acc);
    if (lane == 0) s.gate[r] = acc;
  }
}

// Sums over K as runs of equal atom: dst[la][c] += sum of src[r][c] over
// the chunk's rows r of that atom, in row order.
template <typename T>
__device__ void sum_runs(const Smem<T>& s, float* dst, const float* src,
                         int ncols, int nrows) {
  const int l0 = s.la[0], nl = s.la[nrows - 1] - l0 + 1;
  for (int w = threadIdx.x; w < nl * ncols; w += kThreads) {
    const int l = l0 + w / ncols, c = w % ncols;
    float acc = 0.f;
    for (int r = 0; r < nrows; ++r)
      if (s.la[r] == l) acc += src[r * ncols + c];
    dst[l * ncols + c] += acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) edge_fwd_kernel(Args a) {
  extern __shared__ __align__(128) char smem_raw[];
  const int tid = threadIdx.x, K = a.K, C = a.C, H = a.H, TA = a.TA;
  Smem<T> s;
  Bump m{smem_raw, 0};
  carve<T>(m, s, C, H, TA, false);
  float *X = s.buf[0], *Y = s.buf[1];
  load_weights<T>(a, s);

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int a0 = tile * TA, a1 = min(a0 + TA, a.A);
    const int g_begin = a0 * K, g_end = a1 * K;
    for (int k = tid; k < TA * H; k += kThreads) s.accH[k] = 0.f;
    for (int k = tid; k < TA * 3; k += kThreads) s.acc3[k] = 0.f;
    for (int g0 = g_begin; g0 < g_end; g0 += kRows) {
      const int nrows = min(kRows, g_end - g0);
      __syncthreads();
      load_chunk<T>(a, s, g0, g_end, a0);
      __syncthreads();
      first_layer<T>(s, C, H, X, nullptr);                    // m1
      __syncthreads();
      row_gemm<T, false>(X, s.W2, s.b2, Y, H);                // pre2
      __syncthreads();
      for (int idx = tid; idx < kRows * H; idx += kThreads)
        X[idx] = rnd<T>(silu_f(Y[idx]) * s.em[idx / H]);      // m
      __syncthreads();
      sum_runs<T>(s, s.accH, X, H, nrows);                    // agg
      row_gemm<T, false>(X, s.W3, s.b3, Y, H);                // pre3
      __syncthreads();
      gate_rows<T>(s, Y, H);
      __syncthreads();
      for (int k = tid; k < kRows * 3; k += kThreads) {
        const int r = k / 3;
        const float t = fminf(fmaxf(s.cd[k] * s.gate[r], -100.f), 100.f);
        s.aux3[k] = rnd<T>(t * s.em[r]);                      // tr
      }
      __syncthreads();
      sum_runs<T>(s, s.acc3, s.aux3, 3, nrows);               // F_sum
    }
    __syncthreads();
    T* agg = (T*)a.agg + (size_t)a0 * H;
    T* fs = (T*)a.fs + (size_t)a0 * 3;
    for (int k = tid; k < (a1 - a0) * H; k += kThreads)
      agg[k] = Cvt<T>::from_f(s.accH[k]);
    for (int k = tid; k < (a1 - a0) * 3; k += kThreads)
      fs[k] = Cvt<T>::from_f(s.acc3[k]);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) edge_bwd_kernel(Args a) {
  extern __shared__ __align__(128) char smem_raw[];
  const int tid = threadIdx.x, K = a.K, C = a.C, H = a.H, TA = a.TA;
  Smem<T> s;
  Bump m{smem_raw, 0};
  carve<T>(m, s, C, H, TA, true);
  float *X = s.buf[0], *P1 = s.buf[1], *P2 = s.buf[2], *P3 = s.buf[3];
  const PartLayout L(C, H);
  float* part = a.part + (size_t)blockIdx.x * L.P;
  load_weights<T>(a, s);
  const T* DAGG = (const T*)a.dagg;
  const T* DFS = (const T*)a.dfs;
  T* DE = (T*)a.de;
  T* DCD = (T*)a.dcd;

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int a0 = tile * TA, a1 = min(a0 + TA, a.A);
    const int g_begin = a0 * K, g_end = a1 * K;
    __syncthreads();
    for (int k = tid; k < (a1 - a0) * H; k += kThreads)
      s.accH[k] = Cvt<T>::to_f(DAGG[(size_t)a0 * H + k]);
    for (int k = tid; k < (a1 - a0) * 3; k += kThreads)
      s.acc3[k] = Cvt<T>::to_f(DFS[(size_t)a0 * 3 + k]);
    for (int g0 = g_begin; g0 < g_end; g0 += kRows) {
      __syncthreads();
      load_chunk<T>(a, s, g0, g_end, a0);
      __syncthreads();
      // -- recompute the forward (the inputs are the only residuals)
      first_layer<T>(s, C, H, X, P1);                         // m1, pre1
      __syncthreads();
      row_gemm<T, false>(X, s.W2, s.b2, P2, H);               // pre2
      __syncthreads();
      for (int idx = tid; idx < kRows * H; idx += kThreads)
        X[idx] = rnd<T>(silu_f(P2[idx]) * s.em[idx / H]);     // m
      __syncthreads();
      row_gemm<T, false>(X, s.W3, s.b3, P3, H);               // pre3
      __syncthreads();
      gate_rows<T>(s, P3, H);
      __syncthreads();

      // -- gate / force branch, per row (f32; strict clip mask)
      for (int r = tid; r < kRows; r += kThreads) {
        const int g = g0 + r;
        const float gate = s.gate[r], em = s.em[r];
        float dgate = 0.f;
        for (int d = 0; d < 3; ++d) {
          const float c = s.cd[r * 3 + d];
          const float pre = c * gate;
          const float inside = (pre > -100.f && pre < 100.f) ? 1.f : 0.f;
          const float dtr = s.acc3[s.la[r] * 3 + d] * inside * em;
          dgate = fmaf(c, dtr, dgate);
          if (g < g_end) DCD[(size_t)g * 3 + d] = Cvt<T>::from_f(gate * dtr);
        }
        s.dgr[r] = rnd<T>(dgate);
      }
      __syncthreads();

      // -- dw4, dpre3 (into P3, rounded) and db3, one thread per column
      for (int c = tid; c < H; c += kThreads) {
        float aw4 = 0.f, ab3 = 0.f;
        for (int r = 0; r < kRows; ++r) {
          const float p = P3[r * H + c];
          aw4 = fmaf(rnd<T>(silu_f(p)), s.dgr[r], aw4);
          const float d = (s.dgr[r] * s.w4[c]) * dsilu_f(p);
          ab3 += d;
          P3[r * H + c] = rnd<T>(d);
        }
        part[L.dw4 + c] += aw4;
        part[L.db3 + c] += ab3;
      }
      __syncthreads();
      outer_add(part + L.dW3, X, P3, H);                      // m^T dpre3
      __syncthreads();
      row_gemm<T, true>(P3, s.W3, nullptr, X, H);             // dpre3 W3^T
      __syncthreads();

      // -- dm, dpre2 (into P2, rounded), db2; X becomes m1 again
      for (int c = tid; c < H; c += kThreads) {
        float ab2 = 0.f;
        for (int r = 0; r < kRows; ++r) {
          const int idx = r * H + c;
          const float dm = (s.accH[s.la[r] * H + c] + X[idx]) * s.em[r];
          const float d = dm * dsilu_f(P2[idx]);
          ab2 += d;
          P2[idx] = rnd<T>(d);
          X[idx] = rnd<T>(silu_f(P1[idx]));                   // m1
        }
        part[L.db2 + c] += ab2;
      }
      __syncthreads();
      outer_add(part + L.dW2, X, P2, H);                      // m1^T dpre2
      __syncthreads();
      row_gemm<T, true>(P2, s.W2, nullptr, X, H);             // dpre2 W2^T
      __syncthreads();

      // -- dpre1 (into P1, rounded) and db1
      for (int c = tid; c < H; c += kThreads) {
        float ab1 = 0.f;
        for (int r = 0; r < kRows; ++r) {
          const int idx = r * H + c;
          const float d = X[idx] * dsilu_f(P1[idx]);
          ab1 += d;
          P1[idx] = rnd<T>(d);
        }
        part[L.db1 + c] += ab1;
      }
      __syncthreads();

      // -- de = rnd(dpre1 W1^T), one warp per row; dW1 = e^T dpre1
      {
        const int warp = tid >> 5, lane = tid & 31;
        for (int r = warp; r < kRows; r += kThreads / 32) {
          const int g = g0 + r;
          for (int j = 0; j < C; ++j) {
            float acc = 0.f;
            for (int c = lane; c < H; c += 32)
              acc = fmaf(P1[r * H + c], s.W1[j * H + c], acc);
            acc = warp_sum(acc);
            if (lane == 0 && g < g_end)
              DE[(size_t)g * C + j] = Cvt<T>::from_f(acc);
          }
        }
      }
      for (int w = tid; w < C * H; w += kThreads) {
        const int j = w / H, c = w - j * H;
        float acc = 0.f;
        for (int r = 0; r < kRows; ++r)
          acc = fmaf(s.e[r * C + j], P1[r * H + c], acc);
        part[L.dW1 + w] += acc;
      }
    }
  }
}

template <typename T>
size_t smem_bytes(int C, int H, int TA, bool bwd) {
  Smem<T> s;
  Bump m{nullptr, 0};
  carve<T>(m, s, C, H, TA, bwd);
  return m.off;
}

template <typename T> constexpr int kHMult = sizeof(T) == 2 ? 16 : 4;

template <typename T> bool valid_dims(int C, int H, int TA) {
  return C >= 1 && TA >= 1 && H >= kHMult<T> && H % kHMult<T> == 0;
}

template <typename T>
int launch(const Args& a, bool bwd, int blocks, cudaStream_t stream) {
  if (!valid_dims<T>(a.C, a.H, a.TA) || a.A < 1 || a.K < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(a.C, a.H, a.TA, bwd);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  void (*kernel)(Args) = bwd ? edge_bwd_kernel<T> : edge_fwd_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, const Args& a, bool bwd, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, bwd, blocks, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, bwd, blocks, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, or -1 for sizes the kernel does not
// take (dtype, H multiple). A launch needs at most edge_pipeline_smem_limit().
long long edge_pipeline_smem_bytes(int dtype, int C, int H, int TA, int bwd) {
  if (dtype == 0 && valid_dims<float>(C, H, TA))
    return (long long)smem_bytes<float>(C, H, TA, bwd != 0);
  if (dtype == 1 && valid_dims<__nv_bfloat16>(C, H, TA))
    return (long long)smem_bytes<__nv_bfloat16>(C, H, TA, bwd != 0);
  return -1;
}

long long edge_pipeline_smem_limit() { return (long long)kMaxSmem; }

// Floats in one block's slice of the parameter-gradient partials.
int edge_pipeline_part_size(int C, int H) { return PartLayout(C, H).P; }

// dtype: 0 = float32, 1 = bfloat16 (every tensor but the partials, which
// are float32 and zeroed by the caller). Atoms are taken in tiles of TA,
// tiles spread over `blocks` blocks. Returns the cudaError_t of the launch.
int edge_pipeline_fwd(int dtype, int A, int K, int C, int H, int TA,
                      int blocks, const void* e, const void* cd,
                      const void* em, const void* W1, const void* b1,
                      const void* W2, const void* b2, const void* W3,
                      const void* b3, const void* w4, void* agg, void* fs,
                      void* stream) {
  const int n_tiles = (A + TA - 1) / TA;
  Args a{A, K, C, H, TA, n_tiles, e, cd, em, W1, b1, W2, b2, W3, b3, w4,
         nullptr, nullptr, agg, fs, nullptr, nullptr, nullptr};
  return dispatch(dtype, a, false, blocks, stream);
}

int edge_pipeline_bwd(int dtype, int A, int K, int C, int H, int TA,
                      int blocks, const void* e, const void* cd,
                      const void* em, const void* W1, const void* b1,
                      const void* W2, const void* b2, const void* W3,
                      const void* b3, const void* w4, const void* dagg,
                      const void* dfs, void* de, void* dcd, void* part,
                      void* stream) {
  const int n_tiles = (A + TA - 1) / TA;
  Args a{A, K, C, H, TA, n_tiles, e, cd, em, W1, b1, W2, b2, W3, b3, w4,
         dagg, dfs, nullptr, nullptr, de, dcd, (float*)part};
  return dispatch(dtype, a, true, blocks, stream);
}

const char* edge_pipeline_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
