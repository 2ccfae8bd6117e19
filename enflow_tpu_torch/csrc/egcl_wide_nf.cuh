// The first layer of the all-pairs EGCL at any node-feature width: the
// kernels around the block-pair kernels of the "wide_nf" routes, shared by
// egcl_allpairs_sm90.cu (T = bf16) and egcl_allpairs_f32.cu (T = float).
//
// The other routes keep W1a and W1b [nf, H] whole in shared memory (and h
// per atom), which at a wide nf leaves no room for a block of 8 atoms: the
// bf16 block pairs at H = 256 take nf <= ~12 with parameter gradients, the
// f32 ones ~24. The wide_nf routes take the first layer out of the block
// pairs. z1 = hA_i + hB_j + b1 + r2 w1r is linear in the per-atom
// projections hA = h W1a and hB = h W1b, and the backward's dh and dW1a /
// dW1b are linear in each atom's dz1 summed over its partners, so:
// - egcl_nf_proj_kernel computes P = [rnd(h W1a) | rnd(h W1b)] [B N, 2H]
//   once per atom (rnd: the compute dtype's rounding, where _fwd_block
//   rounds its dots), each element an f32 FMA chain over k = 0 .. nf-1 in
//   order (the bits of the block pairs' own projection);
// - the block-pair kernels, built with their PROJ flag, read hA and hB rows
//   from P in global memory (L2) instead of forming them, and keep nothing
//   nf-wide in shared memory; their backward writes each atom's H-wide
//   dz1 sums and 3-vector sums, si [B, N, H+4] over its j partners and, per
//   i-block, pj [B, nI, N, H+4] over its i partners;
// - egcl_nf_jsum_kernel sums pj over the i-blocks in order into sj [B N,
//   H] and dpos = si[H..] - sum pj[H..];
// - egcl_nf_dh_kernel forms dh = rnd(si) W1a^T + rnd(sj) W1b^T (rnd as
//   above: the reference rounds the node sums before the product);
// - egcl_nf_dw1_kernel forms dW1a = h^T si and dW1b = h^T sj over the
//   rows of each of `splits` row ranges, one [2, nf, H] f32 partial each,
//   which the wrapper sums in order (no atomics: the same bits every
//   launch).
// The three products run on one tiled kernel body: 256 threads, a 64 x 64
// tile of the output, each thread 4 x 4 of it, the K dimension in chunks
// of kBK = 16 staged in shared memory as f32, two chunks in flight (the
// next chunk's loads issued before the current one's FMAs); each output is
// one f32 FMA chain in k order.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {
namespace wide_nf {

constexpr int kThreads = 256, kBM = 64, kBN = 64, kBK = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back (the identity for float)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// A tile's staged chunks: A [kBK][kBM] and B [kBK][kBN] (f32), two of each.
struct Stage {
  float a[2][kBK][kBM];
  float b[2][kBK][kBN];
};

// acc[i][j] += sum over the chunk's kn k of A[k][4 tm + i] B[k][4 tn + j],
// k in order.
__device__ __forceinline__ void chunk_fma(const float (&A)[kBK][kBM],
                                          const float (&Bm)[kBK][kBN], int kn,
                                          int tm, int tn,
                                          float (&acc)[4][4]) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&A[k][4 * tm]);
    const float4 b = *reinterpret_cast<const float4*>(&Bm[k][4 * tn]);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The tile loop over k in [k0, k1): load(c, ra, rb) fills a thread's four
// A and four B values of chunk c (from k0 + c kBK; its place in the stage
// is put(...)'s), the chunks staged two deep. acc holds the thread's 4 x 4.
template <typename Load, typename Put>
__device__ __forceinline__ void tile_loop(Stage& st, int k0, int k1,
                                          Load&& load, Put&& put,
                                          float (&acc)[4][4]) {
  const int t = threadIdx.x, tm = t / 16, tn = t % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int nc = (k1 - k0 + kBK - 1) / kBK;
  if (nc <= 0) return;
  float ra[4], rb[4];
  load(0, ra, rb);
  put(st, 0, ra, rb);
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    const bool more = c + 1 < nc;
    if (more) load(c + 1, ra, rb);
    chunk_fma(st.a[c & 1], st.b[c & 1], min(kBK, k1 - k0 - c * kBK), tm, tn,
              acc);
    if (more) put(st, (c + 1) & 1, ra, rb);
    __syncthreads();
  }
}

// P [rows, 2H] = [rnd(h W1a) | rnd(h W1b)]: grid (ceil(rows / 64), 2H / 64);
// a tile's columns lie in one side (H is a multiple of 64). A = h's rows
// (k = nf contiguous: thread e of a chunk loads row e / 16, k e % 16), B =
// the side's weight rows k of the chunk (its 64 columns contiguous).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    egcl_nf_proj_kernel(int rows, int nf, int H, const T* __restrict__ h,
                        const T* __restrict__ W1a, const T* __restrict__ W1b,
                        T* __restrict__ P) {
  __shared__ __align__(16) Stage st;
  const int t = threadIdx.x, tm = t / 16, tn = t % 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int side = n0 / H, c0 = n0 - side * H;
  const T* W = side ? W1b : W1a;
  auto load = [&](int c, float (&ra)[4], float (&rb)[4]) {
    const int kc = c * kBK;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = t + kThreads * u;
      const int m = m0 + e / kBK, k = kc + e % kBK;
      ra[u] = m < rows && k < nf ? to_f(h[(size_t)m * nf + k]) : 0.f;
      const int kb = kc + e / kBN, n = e % kBN;
      rb[u] = kb < nf ? to_f(W[(size_t)kb * H + c0 + n]) : 0.f;
    }
  };
  auto put = [&](Stage& s, int buf, const float (&ra)[4],
                 const float (&rb)[4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = t + kThreads * u;
      s.a[buf][e % kBK][e / kBK] = ra[u];
      s.b[buf][e / kBN][e % kBN] = rb[u];
    }
  };
  float acc[4][4];
  tile_loop(st, 0, nf, load, put, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tm + i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      P[(size_t)m * 2 * H + n0 + 4 * tn + j] = from_f<T>(acc[i][j]);
  }
}

// The j-side sums of atom row r = b N + l: sj[r][c] = sum over the
// i-blocks ib in order of pj[b][ib][l][c] (c < H), and dpos[r][d] =
// si[r][H + d] - the same sum of pj's column H + d. One thread an element.
__global__ void __launch_bounds__(kThreads)
    egcl_nf_jsum_kernel(int rows, int N, int nI, int H,
                        const float* __restrict__ si,
                        const float* __restrict__ pj, float* __restrict__ sj,
                        float* __restrict__ dpos) {
  const int C = H + 4, W = H + 3;
  const long long n = (long long)rows * W;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / W;
    const int c = (int)(e - r * W);
    const long long b = r / N, l = r - b * N;
    const float* p = pj + (b * nI * N + l) * C + c;
    float v = 0.f;
    for (int ib = 0; ib < nI; ++ib) v += p[(size_t)ib * N * C];
    if (c < H)
      sj[r * H + c] = v;
    else
      dpos[r * 3 + c - H] = si[r * C + c] - v;
  }
}

// dh [rows, nf] = rnd(si[:, :H]) W1a^T + rnd(sj) W1b^T, rounded to T: grid
// (ceil(rows / 64), ceil(nf / 64)); K = 2H, the first H from si and W1a,
// the rest from sj and W1b (a chunk lies in one). A = the sums' rows (k
// contiguous), B[k][n] = W1[n][k] (k contiguous: thread e loads n e / 16,
// k e % 16).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    egcl_nf_dh_kernel(int rows, int nf, int H, const float* __restrict__ si,
                      const float* __restrict__ sj, const T* __restrict__ W1a,
                      const T* __restrict__ W1b, T* __restrict__ dh) {
  __shared__ __align__(16) Stage st;
  const int t = threadIdx.x, tm = t / 16, tn = t % 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, C = H + 4;
  auto load = [&](int c, float (&ra)[4], float (&rb)[4]) {
    const int kc = c * kBK, side = kc / H, k0 = kc - side * H;
    const float* S = side ? sj : si;
    const int ld = side ? H : C;
    const T* W = side ? W1b : W1a;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = t + kThreads * u;
      const int m = m0 + e / kBK, k = k0 + e % kBK;
      ra[u] = m < rows ? rnd<T>(S[(size_t)m * ld + k]) : 0.f;
      const int n = n0 + e / kBK;
      rb[u] = n < nf ? to_f(W[(size_t)n * H + k]) : 0.f;
    }
  };
  auto put = [&](Stage& s, int buf, const float (&ra)[4],
                 const float (&rb)[4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = t + kThreads * u;
      s.a[buf][e % kBK][e / kBK] = ra[u];
      s.b[buf][e % kBK][e / kBK] = rb[u];
    }
  };
  float acc[4][4];
  tile_loop(st, 0, 2 * H, load, put, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tm + i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tn + j;
      if (n < nf) dh[(size_t)m * nf + n] = from_f<T>(acc[i][j]);
    }
  }
}

// The rows of split s of `splits`: [s per, (s + 1) per) cut at rows, per a
// multiple of kBK.
__host__ __device__ inline int split_rows(int rows, int splits) {
  return (rows + splits * kBK - 1) / (splits * kBK) * kBK;
}

// out[s][side][k][c] = sum over the rows r of split s, in order, of
// h[r][k] S[r][c] (side 0: S = si, ld H + 4; side 1: sj, ld H): grid
// (tiles, splits), tiles = 2 ceil(nf / 64) (H / 64). A[r][k] = h[r][k]
// (k contiguous: thread e loads k e % 64, r e / 64), B[r][c] = S[r][c].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    egcl_nf_dw1_kernel(int rows, int nf, int H, int splits,
                       const T* __restrict__ h, const float* __restrict__ si,
                       const float* __restrict__ sj, float* __restrict__ out) {
  __shared__ __align__(16) Stage st;
  const int t = threadIdx.x, tm = t / 16, tn = t % 16;
  const int nk = (nf + kBM - 1) / kBM, nc = H / kBN;
  const int side = blockIdx.x / (nk * nc), rest = blockIdx.x % (nk * nc);
  const int m0 = (rest / nc) * kBM, n0 = (rest % nc) * kBN;
  const int per = split_rows(rows, splits), s = blockIdx.y;
  const int r0 = min(rows, s * per), r1 = min(rows, r0 + per);
  const float* S = side ? sj : si;
  const int ld = side ? H : H + 4;
  auto load = [&](int c, float (&ra)[4], float (&rb)[4]) {
    const int rc = r0 + c * kBK;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = t + kThreads * u;
      const int r = rc + e / kBM, k = m0 + e % kBM;
      ra[u] = r < r1 && k < nf ? to_f(h[(size_t)r * nf + k]) : 0.f;
      rb[u] = r < r1 ? S[(size_t)r * ld + n0 + e % kBN] : 0.f;
    }
  };
  auto put = [&](Stage& st2, int buf, const float (&ra)[4],
                 const float (&rb)[4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = t + kThreads * u;
      st2.a[buf][e / kBM][e % kBM] = ra[u];
      st2.b[buf][e / kBN][e % kBN] = rb[u];
    }
  };
  float acc[4][4];
  tile_loop(st, r0, r1, load, put, acc);
  float* o = out + ((size_t)s * 2 + side) * nf * H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = m0 + 4 * tm + i;
    if (k >= nf) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[(size_t)k * H + n0 + 4 * tn + j] = acc[i][j];
  }
}

// Row splits of dW1 (egcl_nf_dw1_kernel): about two blocks an SM over the
// output's tiles, each split at least 512 rows.
inline int dw1_splits(int rows, int nf, int H, int blocks) {
  const int tiles = 2 * ((nf + kBM - 1) / kBM) * (H / kBN);
  const int want = std::max(1, (2 * blocks + tiles - 1) / tiles);
  return std::max(1, std::min(want, (rows + 511) / 512));
}

inline int grid_1d(long long n, int blocks) {
  return (int)std::max<long long>(
      1, std::min<long long>((n + kThreads - 1) / kThreads, 16LL * blocks));
}

// The projections P of rows atoms.
template <typename T>
cudaError_t launch_proj(int rows, int nf, int H, const T* h, const T* W1a,
                        const T* W1b, T* P, cudaStream_t st) {
  const dim3 grid((rows + kBM - 1) / kBM, 2 * H / kBN);
  egcl_nf_proj_kernel<T><<<grid, kThreads, 0, st>>>(rows, nf, H, h, W1a, W1b,
                                                    P);
  return cudaGetLastError();
}

// After a block-pair backward: sj and dpos, dh, and with dw1 (splits > 0)
// dW1's partials.
template <typename T>
cudaError_t launch_first_layer_bwd(int B, int N, int nI, int nf, int H,
                                   int blocks, const T* h, const T* W1a,
                                   const T* W1b, const float* si,
                                   const float* pj, float* sj, float* dpos,
                                   T* dh, float* dw1, int splits,
                                   cudaStream_t st) {
  const int rows = B * N;
  egcl_nf_jsum_kernel<<<grid_1d((long long)rows * (H + 3), blocks), kThreads,
                        0, st>>>(rows, N, nI, H, si, pj, sj, dpos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kBM - 1) / kBM, (nf + kBN - 1) / kBN);
  egcl_nf_dh_kernel<T><<<grid, kThreads, 0, st>>>(rows, nf, H, si, sj, W1a,
                                                  W1b, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess || dw1 == nullptr) return err;
  const dim3 g2(2 * ((nf + kBM - 1) / kBM) * (H / kBN), splits);
  egcl_nf_dw1_kernel<T><<<g2, kThreads, 0, st>>>(rows, nf, H, splits, h, si,
                                                 sj, dw1);
  return cudaGetLastError();
}

}  // namespace wide_nf
}  // namespace
