// Building blocks of the bf16 Hopper (sm_90a) kernels, shared by
// egcl_allpairs_sm90.cu and edge_pipeline_sm90.cu: bf16 rounding and
// bf16x2 arithmetic, SiLU in f32 with the fast ex2 and reciprocal, the
// warpgroup's barriers, the 128-byte-swizzled tile layout that wgmma
// reads, the wgmma instructions and their descriptors, the row products
// in 32-column chunks with one chunk's epilogue overlapping the next
// chunk's product, and the outer products A^T B over a tile's 64 rows
// added into an f32 slice in global memory. A thread's place in an
// accumulator (the Lane types of the kernels): warp w's lane l holds rows
// r0 = 16 w + l / 4 and r0 + 8, columns 8 j + 2 q and the next, q = l % 4.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf2 = __nv_bfloat162;

constexpr int kTile = 64;                 // edge rows per tile (wgmma M)
constexpr int kWG = 128;                  // threads per warpgroup
constexpr int kChunk = 32;                // output columns per product chunk

// ---- arithmetic

__device__ __forceinline__ float rnd1(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ bf2 to_bf2(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ bf2 bcast(float v) { return to_bf2(v, v); }
// bf16x2 add and product, each rounded once to nearest even; the explicit
// .rn keeps the compiler from contracting a product and a sum into one fma
// (which would skip the product's rounding)
union Bf2 {
  bf2 v;
  uint32_t u;
};
__device__ __forceinline__ bf2 add2(bf2 a, bf2 b) {
  Bf2 x{a}, y{b}, d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d.u) : "r"(x.u), "r"(y.u));
  return d.v;
}
__device__ __forceinline__ bf2 mul2(bf2 a, bf2 b) {
  Bf2 x{a}, y{b}, d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d.u) : "r"(x.u), "r"(y.u));
  return d.v;
}
__device__ __forceinline__ float2 load_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float sigm(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float silu(float x) { return x * sigm(x); }
__device__ __forceinline__ float dsilu(float x) {
  const float s = sigm(x);
  return s * (1.0f + x * (1.0f - s));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// One warpgroup's barrier (ids 1.. per warpgroup; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "n"(kWG) : "memory");
}
// Generic-proxy shared-memory writes made visible to wgmma (the async
// proxy), then the warpgroup's barrier.
__device__ __forceinline__ void wg_publish(int wg) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(wg);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- swizzled bf16 tiles
//
// A matrix of R rows and H columns is stored as H/64 halves of R rows of
// 128 bytes, each 8-row group a 1024-byte atom whose 16-byte chunks are
// XOR-swizzled by the row (128-byte swizzle): element (r, c) at byte
// (c / 64) 128 R + 128 r + 16 ((c % 64 / 8) ^ (r % 8)) + 2 (c % 8).
// Weights (R = H), activation tiles (R = 64) and the node-sum operands
// share it.
__device__ __forceinline__ int swz(int r, int c, int R) {
  return (c / 64) * (128 * R) + 128 * r + 16 * (((c % 64) / 8) ^ (r % 8)) +
         2 * (c % 8);
}
__device__ __forceinline__ bf2* tile_at(bf16* t, int r, int c) {
  return reinterpret_cast<bf2*>((char*)t + swz(r, c, kTile));
}

// ---- wgmma

// Shared-memory matrix descriptor, 128-byte swizzle (atoms 1024-byte
// aligned, base offset 0).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D[64, 32] (+)= A[64, 16] B[16, 32], A and B in shared memory (A K-major)
template <int TB>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D[64, 64] (+)= A[64, 16] B[16, 64], A in registers, B MN-major
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D[64, 8] (+)= A[64, 16] B[16, 8], A in registers, B K-major
__device__ __forceinline__ void wgmma_rs8(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D[64, 32] (+)= A[64, 16] B[16, 32], both in shared memory MN-major (A
// read as the transpose of a tile whose rows are K)
__device__ __forceinline__ void wgmma_tt32(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) asm volatile("" : "+f"(d[k])::"memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait_for() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The wgmma steps of d (+)= X[:, :16 KS] B[:16 KS, n0 : n0+32] (no fence,
// no commit): X the activation or e tile (K-major), B from the swizzled
// [R, *] matrix at w. TB = 1 reads it MN-major (B = W, its R rows the K:
// a k-step 16 rows, 2048 bytes on; the chunk starts 2 n0 bytes into the
// rows, inside a 64-column half), TB = 0 K-major (B = W^T: B's column n is
// W's row n; a k-step 32 bytes into a row, the next half 128 R bytes on).
template <int KS, int TB>
__device__ __forceinline__ void mma_chunk(float (&d)[16], uint32_t x,
                                          uint32_t w, int R, int n0) {
  const uint32_t wb = TB ? w + (n0 / 64) * (128 * R) + 2 * (n0 % 64)
                         : w + 128 * n0;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t da =
        smem_desc(x + (kk / 4) * (128 * kTile) + (kk % 4) * 32, 16, 1024);
    const uint64_t db =
        TB ? smem_desc(wb + kk * 2048, 128 * R, 1024)
           : smem_desc(wb + (kk / 4) * (128 * R) + (kk % 4) * 32, 16, 1024);
    wgmma_ss32<TB>(d, da, db, kk > 0);
  }
}

// A product in 32-column chunks, two in flight: issue(d, n0) adds chunk
// n0's wgmma steps, epi(d, n0) takes its accumulators while the next
// chunk's product runs. row_chunks2: two products a chunk (issue(dA, dB,
// n0), one group), for the backward's passes that need both.
template <int H, typename Issue, typename Epi>
__device__ __forceinline__ void row_chunks(Issue&& issue, Epi&& epi) {
#pragma unroll 1
  for (int n0 = 0; n0 < H; n0 += 2 * kChunk) {
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

template <int H, typename Issue, typename Epi>
__device__ __forceinline__ void row_chunks2(Issue&& issue, Epi&& epi) {
#pragma unroll 1
  for (int n0 = 0; n0 < H; n0 += 2 * kChunk) {
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

// The product X W (TB = 1) or X W^T (TB = 0) of the activation tile X and
// the swizzled [H, H] weight W in 32-column chunks, two in flight.
template <int H, int TB, typename Epi>
__device__ __forceinline__ void chunks(uint32_t x, uint32_t w, Epi&& epi) {
  row_chunks<H>(
      [&](float (&d)[16], int n0) { mma_chunk<H / 16, TB>(d, x, w, H, n0); },
      epi);
}

// ---- shared memory

struct Bump {
  char* base;
  size_t off;
  __host__ __device__ char* take(size_t bytes, size_t align = 16) {
    off = (off + align - 1) / align * align;
    char* p = base ? base + off : nullptr;
    off += bytes;
    return p;
  }
};

// ---- parameter gradients
//
// The chunk [m0, m0+64) x [n0, n0+32) of A^T B for the bf16 [64, H] tiles
// A and B (shared addresses) of one tile's edge rows, issued and
// committed: wgmma with the 64 rows as K and both operands read MN-major
// (A^T needs no transposed copy; a k-step is 16 rows, 2048 bytes on).
template <int H>
__device__ __forceinline__ void issue_outer(float (&d)[16], uint32_t A,
                                            uint32_t B, int m0, int n0) {
  fence_regs(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_tt32(d,
               smem_desc(A + (m0 / 64) * (128 * kTile) + 2048 * kk,
                         128 * kTile, 1024),
               smem_desc(B + (n0 / 64) * (128 * kTile) + 2 * (n0 % 64) +
                             2048 * kk, 128 * kTile, 1024),
               kk > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The old values of a chunk's accumulators in dst (zeros when fresh).
template <int H, typename Ln>
__device__ __forceinline__ void load_old(float2 (&o)[8], const float* dst,
                                         const Ln& L, int m0, int n0,
                                         bool fresh) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      o[2 * j + k] = fresh ? make_float2(0.f, 0.f)
                           : load_f2(dst + (m0 + L.r0 + 8 * k) * H + n0 +
                                     8 * j + 2 * L.q);
}

template <int H, typename Ln>
__device__ __forceinline__ void store_sum(float* dst, const float2 (&o)[8],
                                          const float (&d)[16], const Ln& L,
                                          int m0, int n0) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      *reinterpret_cast<float2*>(dst + (m0 + L.r0 + 8 * k) * H + n0 + 8 * j +
                                 2 * L.q) =
          make_float2(o[2 * j + k].x + d[4 * j + 2 * k],
                      o[2 * j + k].y + d[4 * j + 2 * k + 1]);
}

// dst [H, H] (+)= A^T B over one tile's rows, in m64n32 chunks issued two
// at a time. The H x H result (2H^2 f32 with dW2 and dW3, more than a
// warpgroup's registers) is added chunk by chunk into dst, f32 row-major
// in the warpgroup's slice in global memory (L2-resident), by the thread
// that holds each element; the old values load while the tensor cores
// run, and the first chunk's sum is stored while the second's product
// finishes. On the warpgroup's first tile (fresh) the sums are stored.
template <int H, typename Ln>
__device__ void outer_acc(uint32_t A, uint32_t B, float* dst, const Ln& L,
                          bool fresh) {
#pragma unroll 1
  for (int ch = 0; ch < (H / 64) * (H / 64); ++ch) {
    const int m0 = 64 * (ch / (H / 64)), n0 = 64 * (ch % (H / 64));
    float dA[16], dB[16];
    float2 oA[8], oB[8];
    issue_outer<H>(dA, A, B, m0, n0);
    issue_outer<H>(dB, A, B, m0, n0 + kChunk);
    load_old<H>(oA, dst, L, m0, n0, fresh);
    load_old<H>(oB, dst, L, m0, n0 + kChunk, fresh);
    wgmma_wait_for<1>();
    fence_regs(dA);
    store_sum<H>(dst, oA, dA, L, m0, n0);
    wgmma_wait_for<0>();
    fence_regs(dB);
    store_sum<H>(dst, oB, dB, L, m0, n0 + kChunk);
  }
}

}  // namespace
