// Gathered-edge EGCL pipeline in float32 for Hopper (sm_90a): forward, and
// the backward with input and parameter gradients, at H = 64, 128, 192 or
// 256.
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
// Rounding to the compute dtype happens where the TPU kernel rounds (in
// f32 every rounding is the identity; the type parameter T is float);
// every product and sum accumulates in f32. The backward recomputes the
// forward from its inputs and follows _bwd_kernel line by line: gate,
// dtr, dgate and the dpre* stay f32; the clip mask is strict (-100 < x <
// 100). bf16 runs in edge_pipeline_sm90.cu; the wrapper zero-pads every
// other width up to the next of these four (ops/edge_pipeline.py).
//
// What bounds it on this card: at the training shape (A = 30*13 = 390
// atoms, K = 24 slots, the auto capacity of example/train.yaml, C = 3,
// H = 128, f32) a forward does 0.635 GFLOP (two H x H products per row)
// and a backward 1.92 GFLOP (two recomputed, two transposed and two
// parameter-gradient products per row) on ~0.4 MB of inputs: compute
// bound, 9.5 and 28.6 us at the 67 TFLOP/s f32 rate (at H = 256 about 4x:
// 2.47 and 7.4 GFLOP). The f32 products stay on the FMA units: TF32
// tensor cores would round every input to 10 mantissa bits, where the f32
// reference keeps 23.
//
// Design:
// - 2H threads a block, one block an SM, atom tiles of TA whole atoms
//   strided over the blocks, so the per-atom K-sums need no atomics and
//   run in a fixed order. An atom tile's rows are cut into equal row tiles
//   of at most 72 (forward) / 40 (backward) rows, computed as a multiple of
//   8 rows with the padding masked (the wrapper's tile_rows): at the
//   training shape 72 rows a block, one forward tile and 40 + 32 backward.
//   Where a row tile ends inside an atom, that atom's sums carry to the
//   next row tile in shared memory, added in row order.
// - Register-tiled products: in X W and X W^T a thread owns 4 columns of
//   every 8th row of the tile (a warp: 4 rows x 8 column lanes, so each W
//   load is 8 distinct 16-byte chunks), reading 4 float4 of W and q
//   broadcast float4 of X for 16 q FMAs a 4-deep k step. In the outer
//   products m^T dpre3 and m1^T dpre2 (the tile's rows as the depth) a
//   thread owns an 8 x 4 (H / 64) tile of dW3 and dW2, held in registers
//   across all the block's rows at H = 64 and 128: two float4 of the left
//   and H / 64 of the right operand for 32 H / 64 FMAs a row. The products
//   run at about half the FMA rate: each k step issues one shared load per
//   ~11 FMAs, and the backward's 250 registers leave no room for a second
//   operand set.
// - At H = 64 and 128 W2 and W3 sit once in shared memory as f32, each
//   16-byte chunk kc of row r at kc ^ ((r / 4) % 8), so both orientations
//   read without bank conflicts; f32 copies them and W1 and the biases
//   with 16-byte cp.async, W2 and W3 landing while the first tile's first
//   layer computes. Activation tiles have row stride H + 4.
// - At H = 192 and 256 W2 + W3 are 8 H^2 bytes, 524,288 at 256, more than
//   a block may use: they stay in global memory (L2-resident) and pass
//   through a ring of kRing = 2 slabs in shared memory. A slab is one
//   K-split of a product, 64 of the sum's k: in X W 64 of W's rows
//   ([64, H]), in X W^T 64 of W's columns ([H, 64]), 256 H bytes either
//   way, in the same swizzle. The register tiles keep their accumulators
//   across a product's H / 64 slabs, so each output's K-sum runs the same
//   FMAs in the same order as from a resident copy. A row tile uses the
//   slabs in a fixed stream (W2, W3, and backward W3^T, W2^T; H / 64 slabs
//   each); the block copies the next slab with cp.async into the slot the
//   slab before the current one used, while the FMAs work on the current
//   one (after egcl_allpairs_f32.cu's wide kernels). dW2 and dW3 do not
//   fit in registers beside the rest (2 H^2 floats over 2H threads: 256 a
//   thread at 256), so each thread keeps its outer-product tile in the
//   block's slice of the partials in global memory and reads, adds to and
//   writes it once a row tile, one 64-column group at a time (outer_slice),
//   with the register tile's FMAs and order. The ring leaves about 90 KB
//   at H = 256: the wrapper plans the most rows a tile first (40 forward,
//   24 backward at the training shape), since every row tile streams the
//   weights once (512 KB of L2 reads forward, 1 MB backward at 256).
// - The next row tile's e, cd, em (and, at a new atom tile, its dagg and
//   dfs) are copied with cp.async into the other half of a double buffer
//   while the current tile computes.
// - The gate sums a row over 8 lanes by shuffles and over the row's H / 32
//   warps through shared memory; de = dpre1 W1^T is one (row, j) a
//   thread, the K-sums one (atom, column) a thread; the bias and dw4
//   column sums stay per thread in registers, reduced over the 8 row lanes
//   once at the end. Each block writes its slice of the [blocks, P]
//   partials with plain stores; the wrapper sums the slices in a fixed
//   order (a second launch gives the same bits).
// - SiLU in f32 uses the fast ex2 and reciprocal (a few ulp).
// - Shared memory at f32, H = 128, of the 227 KB (232,448 bytes) a block
//   may use: W2 + W3 128 KB; forward 2 activation tiles (72 rows: 74 KB),
//   backward 3 (40 rows: 62 KB); W1, biases, the staging buffers, the
//   gate partials and the atom tile's sums or dagg: 218,416 / 205,696
//   bytes at the training shape (C = 3, 3 atoms a tile), 229,728 /
//   221,696 at C = 11 and 8 atoms a tile.
//
// None of the TPU blocking carries over: no 0/1 summation matrix, no atom
// padding, no per-tile parameter outputs beyond one slice per block.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSmem = 232448;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

// Round an f32 value to the compute dtype (and hold it as f32).
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return Cvt<T>::to_f(Cvt<T>::from_f(x));
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
  int R;              // rows a tile (tiled kernels)
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

// ===========================================================================
// The tiled kernels (f32): see the header note.
// ===========================================================================

constexpr int kQmaxFwd = 9;   // at most 72 rows a tile (forward)
constexpr int kQmaxBwd = 5;   // at most 40 rows a tile (backward)
// weight slabs the ring holds, and the k of a product's sum a slab holds
// (H = 192 and 256)
constexpr int kRing = 2;
constexpr int kSlab = 64;

// The widths whose W2 and W3 a block holds whole; the others (192, 256)
// stream them through the ring.
__host__ __device__ constexpr bool resident(int H) {
  return H == 64 || H == 128;
}

// cp.async: 4-byte (any word) and 16-byte copies, global -> shared.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The words of global memory that hold the bytes [src, src + nbytes), copied
// into dst (16-byte aligned shared memory); the first byte lands at
// dst + (src & 3). Rows of e, cd, em and dfs start at any element, so the
// copy is by aligned words.
template <int NT>
__device__ __forceinline__ void stage_bytes(char* dst, const void* src,
                                            size_t nbytes) {
  const uintptr_t p = (uintptr_t)src, w0 = p & ~uintptr_t(3);
  const int nw = (int)((p + nbytes - w0 + 3) >> 2);
  for (int k = threadIdx.x; k < nw; k += NT)
    cp_async4(dst + 4 * k, (const char*)w0 + 4 * k);
}
__device__ __forceinline__ int byte_off(const void* src, size_t at) {
  return (int)(((uintptr_t)src + at) & 3);
}

// SiLU and its derivative in the tiled kernels: f32 with the fast ex2 and
// reciprocal (a few ulp, far inside the f32 tolerance).
template <typename T> __device__ __forceinline__ float sig_t(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
template <typename T> __device__ __forceinline__ float silu_t(float x) {
  return x * sig_t<T>(x);
}
template <typename T> __device__ __forceinline__ float dsilu_t(float x) {
  const float s = sig_t<T>(x);
  return s * (1.0f + x * (1.0f - s));
}

template <int W> __device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// W2, W3 [H, H] f32 in shared memory, 16-byte chunk kc of row r stored at
// chunk kc ^ ((r / 4) % 8): the row products read W[k][4cx..] (one row, 8
// consecutive chunks per quarter warp) and W[4cx+u][kc..] (8 rows four
// apart, one chunk) without bank conflicts.
template <int H>
__device__ __forceinline__ const float* wchunk(const float* W, int r, int kc) {
  return W + r * H + ((kc ^ ((r >> 2) & 7)) << 2);
}

struct TSmem {
  float *W2, *W3, *W1, *b1, *b2, *b3, *w4;
  float* ring;          // H = 192, 256: kRing slabs [kSlab H] (no W2, W3)
  float* X[3];          // activation tiles [R, H + 4]
  float* aux3;          // forward: tr [R, 3]
  float* gpart;         // the gate's partial sums [R, H / 32]
  float *accH, *acc3;   // forward: agg / F_sum of the atom tile [TA, H|3]
  float* dW1;           // backward: dW1 of the block [C, H]
  // two stages of a row tile's e, cd, em (raw bytes) and, backward, two of
  // an atom tile's dagg, dfs; addressed by arithmetic, so that the struct
  // stays in registers
  char *stage, *atoms;
  int st_bytes, st_cd, st_em, at_bytes, at_dfs;
  __device__ char* se(int st) const { return stage + st * st_bytes; }
  __device__ char* scd(int st) const { return se(st) + st_cd; }
  __device__ char* sem(int st) const { return se(st) + st_em; }
  __device__ char* sdagg(int ab) const { return atoms + ab * at_bytes; }
  __device__ char* sdfs(int ab) const { return sdagg(ab) + at_dfs; }
};

__host__ __device__ inline int align16(size_t n) {
  return (int)((n + 15) & ~size_t(15));
}

__host__ __device__ inline void tcarve(Bump& m, TSmem& s, int C, int H,
                                      int TA, int R, int tsz, bool bwd) {
  const size_t fH = sizeof(float) * H;
  s.W2 = s.W3 = s.ring = nullptr;
  if (resident(H)) {
    s.W2 = (float*)m.take(fH * H);
    s.W3 = (float*)m.take(fH * H);
  } else {
    s.ring = (float*)m.take(fH * kSlab * kRing);
  }
  s.W1 = (float*)m.take(fH * C);
  s.b1 = (float*)m.take(fH);
  s.b2 = (float*)m.take(fH);
  s.b3 = (float*)m.take(fH);
  s.w4 = (float*)m.take(fH);
  for (int k = 0; k < 3; ++k)
    s.X[k] = k < (bwd ? 3 : 2)
                 ? (float*)m.take(sizeof(float) * R * (H + 4)) : nullptr;
  s.aux3 = bwd ? nullptr : (float*)m.take(sizeof(float) * R * 3);
  s.gpart = (float*)m.take(sizeof(float) * R * (H / 32));
  s.accH = bwd ? nullptr : (float*)m.take(fH * TA);
  s.acc3 = bwd ? nullptr : (float*)m.take(sizeof(float) * TA * 3);
  s.dW1 = bwd ? (float*)m.take(fH * C) : nullptr;
  s.st_cd = align16((size_t)R * C * tsz + 8);
  s.st_em = s.st_cd + align16((size_t)R * 3 * tsz + 8);
  s.st_bytes = s.st_em + align16((size_t)R * tsz + 8);
  s.stage = (char*)m.take(2 * (size_t)s.st_bytes);
  s.at_dfs = align16((size_t)TA * H * tsz);
  s.at_bytes = s.at_dfs + align16((size_t)TA * 3 * tsz + 8);
  s.atoms = bwd ? (char*)m.take(2 * (size_t)s.at_bytes) : nullptr;
}

// W1, b1, b2, b3, w4 by 16-byte cp.async (committed by the caller).
template <typename T, int H>
__device__ void load_small(const Args& a, const TSmem& s) {
  constexpr int NT = 2 * H;
  const auto load = [&](float* dst, const void* src, int n) {
    for (int k = threadIdx.x; k < n / 4; k += NT)
      cp_async16(dst + 4 * k, (const float*)src + 4 * k);
  };
  load(s.W1, a.W1, a.C * H);
  load(s.b1, a.b1, H);
  load(s.b2, a.b2, H);
  load(s.b3, a.b3, H);
  load(s.w4, a.w4, H);
}

// W2, W3 (swizzled) by 16-byte cp.async (committed by the caller).
template <typename T, int H>
__device__ void load_tiled_weights(const Args& a, const TSmem& s) {
  constexpr int NT = 2 * H, CH = H / 4;
  for (int k = threadIdx.x; k < H * CH; k += NT) {
    const int r = k / CH, kc = k % CH;
    const int dst = r * H + ((kc ^ ((r >> 2) & 7)) << 2);
    cp_async16(s.W2 + dst, (const float*)a.W2 + 4 * k);
    cp_async16(s.W3 + dst, (const float*)a.W3 + 4 * k);
  }
}

// The streamed widths' place in their stream of weight slabs. Slab s of
// the stream is product (s / G) % nprod of a row tile, G = H / kSlab: W2
// (X W), W3 (X W), and for the backward W3 (X W^T), W2 (X W^T); within it
// the k 64 (s % G) ..; it lands in slot slot_of(s) of the ring. Every
// thread keeps the same copy. (The resident widths carry an unused one.)
struct Ring {
  float* slots;            // the ring in shared memory
  const float *W2, *W3;    // [H, H] in global memory
  int s;                   // the next slab to use
  int nprod;               // products a row tile: 2 forward, 4 backward
};

__device__ __forceinline__ int slot_of(int s) { return s % kRing; }

// The block's copies of slab s into its slot, one commit group: for X W
// W's rows 64 g .. 64 g + 63 as [kSlab, H], for X W^T W's columns 64 g ..
// 64 g + 63 as [H, kSlab], each 16-byte chunk kc of row r at chunk
// kc ^ ((r / 4) % 8) of its row.
template <int H>
__device__ void issue_slab(const Ring& rg, int s) {
  constexpr int NT = 2 * H, G = H / kSlab, CH = H / 4, CS = kSlab / 4;
  const int prod = (s / G) % rg.nprod, g = s % G;
  const float* W = prod == 0 || prod == 3 ? rg.W2 : rg.W3;
  float* dst = rg.slots + (size_t)slot_of(s) * (kSlab * H);
  if (prod < 2)
    for (int k = threadIdx.x; k < kSlab * CH; k += NT) {
      const int r = k / CH, kc = k % CH;
      cp_async16(dst + r * H + ((kc ^ ((r >> 2) & 7)) << 2),
                 W + (size_t)(kSlab * g + r) * H + 4 * kc);
    }
  else
    for (int k = threadIdx.x; k < H * CS; k += NT) {
      const int r = k / CS, kc = k % CS;
      cp_async16(dst + r * kSlab + ((kc ^ ((r >> 2) & 7)) << 2),
                 W + (size_t)r * H + kSlab * g + 4 * kc);
    }
  cp_async_commit();
}

// The ring of a kernel (nprod products a row tile): at the streamed widths
// the first kRing - 1 slabs issued, each its own commit group (where the
// resident widths commit W2 and W3).
template <int H>
__device__ Ring start_ring(const Args& a, const TSmem& s, int nprod) {
  Ring rg{s.ring, (const float*)a.W2, (const float*)a.W3, 0, nprod};
  if constexpr (!resident(H))
    for (int k = 0; k < kRing - 1; ++k) issue_slab<H>(rg, k);
  return rg;
}

// Slab rg.s once it has landed: this thread's copies waited for, then
// everyone's published (the barrier also tells that every reader of slab
// s - 1 is done), then slab s + kRing - 1 issued into slab s - 1's slot
// while slab s is in use.
template <int H>
__device__ __forceinline__ const float* next_slab(Ring& rg) {
  cp_async_wait<kRing - 2>();
  __syncthreads();
  issue_slab<H>(rg, rg.s + kRing - 1);
  return rg.slots + (size_t)slot_of(rg.s++) * (kSlab * H);
}

// A block's work: atom tiles blockIdx.x, + gridDim.x, ... of TA whole atoms
// each; an atom tile's rows [a0 K, a1 K) in row tiles of R rows, the last
// one holding the rest (computed as a multiple of 8 rows, the padding
// masked to zero).
struct Cursor {
  int tile, g0;
};
__device__ __forceinline__ int tile_end(const Args& a, int tile) {
  return min((tile + 1) * a.TA, a.A) * a.K;
}
__device__ __forceinline__ Cursor advance(const Args& a, Cursor c) {
  if (c.g0 + a.R < tile_end(a, c.tile)) return Cursor{c.tile, c.g0 + a.R};
  const int t = c.tile + gridDim.x;
  return Cursor{t, t * a.TA * a.K};
}

template <typename T, int H>
__device__ __forceinline__ void prefetch_rows(const Args& a, const TSmem& s,
                                              int st, Cursor c) {
  constexpr int NT = 2 * H;
  const size_t z = sizeof(T);
  const int nr = min(a.R, tile_end(a, c.tile) - c.g0);
  stage_bytes<NT>(s.se(st), (const char*)a.e + (size_t)c.g0 * a.C * z,
                  (size_t)nr * a.C * z);
  stage_bytes<NT>(s.scd(st), (const char*)a.cd + (size_t)c.g0 * 3 * z,
                  (size_t)nr * 3 * z);
  stage_bytes<NT>(s.sem(st), (const char*)a.em + (size_t)c.g0 * z,
                  (size_t)nr * z);
}

template <typename T, int H>
__device__ __forceinline__ void prefetch_atoms(const Args& a, const TSmem& s,
                                               int ab, int tile) {
  constexpr int NT = 2 * H;
  const size_t z = sizeof(T);
  const int a0 = tile * a.TA, na = min(a0 + a.TA, a.A) - a0;
  const char* dagg = (const char*)a.dagg + (size_t)a0 * H * z;
  for (int k = threadIdx.x; k < na * H * (int)z / 16; k += NT)
    cp_async16(s.sdagg(ab) + 16 * k, dagg + 16 * k);
  stage_bytes<NT>(s.sdfs(ab), (const char*)a.dfs + (size_t)a0 * 3 * z,
                  (size_t)na * 3 * z);
}

// A row tile's staged inputs as f32; rows past nr (the padding) read 0.
template <typename T> struct Rows {
  const char *e, *cd, *em;
  int C, nr;
  __device__ Rows(const Args& a, const TSmem& s, int st, int g0, int nr_)
      : C(a.C), nr(nr_) {
    const size_t z = sizeof(T);
    e = s.se(st) + byte_off(a.e, (size_t)g0 * a.C * z);
    cd = s.scd(st) + byte_off(a.cd, (size_t)g0 * 3 * z);
    em = s.sem(st) + byte_off(a.em, (size_t)g0 * z);
  }
  __device__ __forceinline__ float at(const char* p, int i) const {
    return Cvt<T>::to_f(*reinterpret_cast<const T*>(p + i * sizeof(T)));
  }
  __device__ __forceinline__ float E(int r, int j) const {
    return r < nr ? at(e, r * C + j) : 0.f;
  }
  __device__ __forceinline__ float CD(int r, int d) const {
    return r < nr ? at(cd, r * 3 + d) : 0.f;
  }
  __device__ __forceinline__ float EM(int r) const {
    return r < nr ? at(em, r) : 0.f;
  }
};

// pre1 = e W1 + b1 (f32) of row r, columns c0 .. c0 + 3.
template <typename T, int H>
__device__ __forceinline__ void pre1_row(const TSmem& s, const Rows<T>& v,
                                         int r, int c0, float (&z)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) z[u] = 0.f;
  for (int j = 0; j < v.C; ++j) {
    const float e = v.E(r, j);
    const float4 w = *reinterpret_cast<const float4*>(s.W1 + j * H + c0);
    z[0] = fmaf(e, w.x, z[0]);
    z[1] = fmaf(e, w.y, z[1]);
    z[2] = fmaf(e, w.z, z[2]);
    z[3] = fmaf(e, w.w, z[3]);
  }
  const float4 b = *reinterpret_cast<const float4*>(s.b1 + c0);
  z[0] += b.x;
  z[1] += b.y;
  z[2] += b.z;
  z[3] += b.w;
}

// X = rnd(silu(pre1)) over the thread's rows of the tile (padding
// included), in the row products' layout.
template <typename T, int H, int QM>
__device__ __forceinline__ void first_layer_tiled(const TSmem& s,
                                                  const Rows<T>& v, int q,
                                                  int ry, int c0, float* X) {
  constexpr int LD = H + 4;
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    float z[4];
    pre1_row<T, H>(s, v, r, c0, z);
    *reinterpret_cast<float4*>(X + r * LD + c0) = make_float4(
        rnd<T>(silu_t<T>(z[0])), rnd<T>(silu_t<T>(z[1])),
        rnd<T>(silu_t<T>(z[2])), rnd<T>(silu_t<T>(z[3])));
  }
}

// Waits until at most n of this thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n >= 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// acc[i][u] = sum_k X[ry + 8i, k] W[k, 4cx + u] (TRANS: W[4cx + u, k]) for
// the thread's Q rows and 4 columns, f32 FMAs in k order. Per 4-deep k
// step: 4 float4 loads of W and Q broadcast float4 loads of X for 16 Q
// FMAs.
template <int H, int Q, bool TRANS, int QM>
__device__ __forceinline__ void product(const float* __restrict__ X,
                                        const float* __restrict__ W, int ry,
                                        int cx, float (&acc)[QM][4]) {
  constexpr int LD = H + 4;
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
  const float* x0 = X + ry * LD;
#pragma unroll 1
  for (int kc = 0; kc < H / 4; ++kc) {
    float4 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = *reinterpret_cast<const float4*>(
          TRANS ? wchunk<H>(W, 4 * cx + j, kc) : wchunk<H>(W, 4 * kc + j, cx));
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(x0 + i * 8 * LD + 4 * kc);
      if constexpr (TRANS) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float t = acc[i][u];
          t = fmaf(x.x, w[u].x, t);
          t = fmaf(x.y, w[u].y, t);
          t = fmaf(x.z, w[u].z, t);
          acc[i][u] = fmaf(x.w, w[u].w, t);
        }
      } else {
        acc[i][0] = fmaf(x.w, w[3].x, fmaf(x.z, w[2].x,
                    fmaf(x.y, w[1].x, fmaf(x.x, w[0].x, acc[i][0]))));
        acc[i][1] = fmaf(x.w, w[3].y, fmaf(x.z, w[2].y,
                    fmaf(x.y, w[1].y, fmaf(x.x, w[0].y, acc[i][1]))));
        acc[i][2] = fmaf(x.w, w[3].z, fmaf(x.z, w[2].z,
                    fmaf(x.y, w[1].z, fmaf(x.x, w[0].z, acc[i][2]))));
        acc[i][3] = fmaf(x.w, w[3].w, fmaf(x.z, w[2].w,
                    fmaf(x.y, w[1].w, fmaf(x.x, w[0].w, acc[i][3]))));
      }
    }
  }
}

// product<> over slab g of a streamed product, added to acc: the k of
// 64 g .. 64 g + 63, W[k][4cx..] read from the [kSlab, H] slab S (TRANS:
// W[4cx + u][k..] from the [H, kSlab] slab), the FMAs of product<> in its
// k order.
template <int H, int Q, bool TRANS, int QM>
__device__ __forceinline__ void product_slab(const float* __restrict__ X,
                                             const float* __restrict__ S,
                                             int g, int ry, int cx,
                                             float (&acc)[QM][4]) {
  constexpr int LD = H + 4;
  const float* x0 = X + ry * LD + kSlab * g;
#pragma unroll 1
  for (int kc = 0; kc < kSlab / 4; ++kc) {
    float4 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = *reinterpret_cast<const float4*>(
          TRANS ? S + (4 * cx + j) * kSlab + ((kc ^ (cx & 7)) << 2)
                : S + (4 * kc + j) * H + ((cx ^ (kc & 7)) << 2));
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(x0 + i * 8 * LD + 4 * kc);
      if constexpr (TRANS) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float t = acc[i][u];
          t = fmaf(x.x, w[u].x, t);
          t = fmaf(x.y, w[u].y, t);
          t = fmaf(x.z, w[u].z, t);
          acc[i][u] = fmaf(x.w, w[u].w, t);
        }
      } else {
        acc[i][0] = fmaf(x.w, w[3].x, fmaf(x.z, w[2].x,
                    fmaf(x.y, w[1].x, fmaf(x.x, w[0].x, acc[i][0]))));
        acc[i][1] = fmaf(x.w, w[3].y, fmaf(x.z, w[2].y,
                    fmaf(x.y, w[1].y, fmaf(x.x, w[0].y, acc[i][1]))));
        acc[i][2] = fmaf(x.w, w[3].z, fmaf(x.z, w[2].z,
                    fmaf(x.y, w[1].z, fmaf(x.x, w[0].z, acc[i][2]))));
        acc[i][3] = fmaf(x.w, w[3].w, fmaf(x.z, w[2].w,
                    fmaf(x.y, w[1].w, fmaf(x.x, w[0].w, acc[i][3]))));
      }
    }
  }
}

// A streamed product: its H / kSlab slabs taken from the ring in the
// stream's order (the tile's order of products, so W is not named), the
// accumulators kept across them.
template <int H, int Q, bool TRANS, int QM>
__device__ __forceinline__ void product_stream(Ring& rg, const float* X,
                                               int ry, int cx,
                                               float (&acc)[QM][4]) {
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
#pragma unroll 1
  for (int g = 0; g < H / kSlab; ++g)
    product_slab<H, Q, TRANS, QM>(X, next_slab<H>(rg), g, ry, cx, acc);
}

// product<Q> (at the streamed widths product_stream<Q>) for the tile's
// runtime row count q = 1 .. QM (one unrolled copy each, so the
// accumulators stay in registers).
template <int H, bool TRANS, int QM, int Q = 1>
__device__ __forceinline__ void product_q(int q, Ring& rg, const float* X,
                                          const float* W, int ry, int cx,
                                          float (&acc)[QM][4]) {
  if (q == Q) {
    if constexpr (resident(H))
      product<H, Q, TRANS, QM>(X, W, ry, cx, acc);
    else
      product_stream<H, Q, TRANS, QM>(rg, X, ry, cx, acc);
  } else if constexpr (Q < QM) {
    product_q<H, TRANS, QM, Q + 1>(q, rg, X, W, ry, cx, acc);
  }
}

// acc[a][b] += sum_{r < nr} L[r, k_a] G[r, n_b]: the thread's 8 k
// (4ky + a%4 + (a/4) H/2) by 4 NG n (4nx + b%4 + (b/4) 64), two float4 of
// L and NG of G a row for 32 NG FMAs.
template <int H>
__device__ __forceinline__ void outer(const float* __restrict__ L,
                                      const float* __restrict__ G, int nr,
                                      int ky, int nx,
                                      float (&acc)[8][4 * (H / 64)]) {
  constexpr int LD = H + 4, NG = H / 64;
#pragma unroll 2
  for (int r = 0; r < nr; ++r) {
    const float* l = L + r * LD;
    const float* g = G + r * LD;
    const float4 la = *reinterpret_cast<const float4*>(l + 4 * ky);
    const float4 lb = *reinterpret_cast<const float4*>(l + H / 2 + 4 * ky);
    const float lv[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
    float gv[4 * NG];
#pragma unroll
    for (int b = 0; b < NG; ++b) {
      const float4 t = *reinterpret_cast<const float4*>(g + 64 * b + 4 * nx);
      gv[4 * b] = t.x;
      gv[4 * b + 1] = t.y;
      gv[4 * b + 2] = t.z;
      gv[4 * b + 3] = t.w;
    }
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int b = 0; b < 4 * NG; ++b)
        acc[p][b] = fmaf(lv[p], gv[b], acc[p][b]);
  }
}

// outer<H> at the streamed widths, into the block's slice dW [H, H] in
// global memory: per 64-column group b the thread's 8 k by 4 n (those of
// outer<H>'s tile) read, added to over the tile's rows in row order and
// written back, by this thread alone: the FMAs and order of the register
// tile.
template <int H>
__device__ __forceinline__ void outer_slice(const float* __restrict__ L,
                                            const float* __restrict__ G,
                                            int nr, int ky, int nx,
                                            float* dW) {
  constexpr int LD = H + 4;
#pragma unroll 1
  for (int b = 0; b < H / 64; ++b) {
    const int n = 64 * b + 4 * nx;
    float acc[8][4];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = 4 * ky + (q & 3) + (q >> 2) * (H / 2);
      const float4 t = *reinterpret_cast<const float4*>(dW + k * H + n);
      acc[q][0] = t.x;
      acc[q][1] = t.y;
      acc[q][2] = t.z;
      acc[q][3] = t.w;
    }
#pragma unroll 2
    for (int r = 0; r < nr; ++r) {
      const float* l = L + r * LD;
      const float4 la = *reinterpret_cast<const float4*>(l + 4 * ky);
      const float4 lb = *reinterpret_cast<const float4*>(l + H / 2 + 4 * ky);
      const float lv[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
      const float4 t = *reinterpret_cast<const float4*>(G + r * LD + n);
      const float gv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[q][u] = fmaf(lv[q], gv[u], acc[q][u]);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = 4 * ky + (q & 3) + (q >> 2) * (H / 2);
      *reinterpret_cast<float4*>(dW + k * H + n) =
          make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    }
  }
}

// The thread's elements of outer_slice's dW, zeroed (by the thread that
// adds into them).
template <int H>
__device__ __forceinline__ void zero_slice(int ky, int nx, float* dW) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int b = 0; b < H / 64; ++b)
      *reinterpret_cast<float4*>(
          dW + (4 * ky + (q & 3) + (q >> 2) * (H / 2)) * H + 64 * b + 4 * nx) =
          make_float4(0.f, 0.f, 0.f, 0.f);
}

// Sums over K of the tile's rows [g0, g0 + nr) as runs of equal atom, one
// (atom, column) a thread, in row order: dst[l][c] += sum src[r][c].
__device__ __forceinline__ void ksum_rows(float* dst, int ncols,
                                          const float* src, int ld, int a0,
                                          int g0, int nr, int K, int NT) {
  const int l0 = g0 / K - a0, l1 = (g0 + nr - 1) / K - a0;
  for (int w = threadIdx.x; w < (l1 - l0 + 1) * ncols; w += NT) {
    const int l = l0 + w / ncols, c = w % ncols;
    const int rs = max((a0 + l) * K - g0, 0);
    const int re = min((a0 + l + 1) * K - g0, nr);
    float acc = 0.f;
#pragma unroll 4
    for (int r = rs; r < re; ++r) acc += src[r * ld + c];
    dst[l * ncols + c] += acc;
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(2 * H, 1) edge_tiled_fwd_kernel(Args a) {
  constexpr int NT = 2 * H, CW = H / 32, LD = H + 4, QM = kQmaxFwd;
  extern __shared__ __align__(128) char smem_raw[];
  const int tid = threadIdx.x, K = a.K;
  TSmem s;
  Bump m{smem_raw, 0};
  tcarve(m, s, a.C, H, a.TA, a.R, sizeof(T), false);
  // a warp: 4 rows x 8 column lanes (32 columns); CW warps span a row
  const int lane = tid & 31, wp = tid >> 5;
  const int cx = 8 * (wp % CW) + (lane & 7), ry = 4 * (wp / CW) + (lane >> 3);
  const int c0 = 4 * cx;
  // the first tile's rows, then W2 and W3 (waited for after the first
  // layer, which needs neither) or, streamed, the ring's first slab
  Cursor cur{(int)blockIdx.x, (int)blockIdx.x * a.TA * K};
  int st = 0;
  if (cur.tile < a.n_tiles) prefetch_rows<T, H>(a, s, st, cur);
  load_small<T, H>(a, s);
  cp_async_commit();
  Ring rg = start_ring<H>(a, s, 2);
  if constexpr (resident(H)) {
    load_tiled_weights<T, H>(a, s);
    cp_async_commit();
  }
  bool first = true;
  float acc[QM][4];
  while (cur.tile < a.n_tiles) {
    const int a0 = cur.tile * a.TA, g_end = tile_end(a, cur.tile);
    const int g0 = cur.g0, nr = min(a.R, g_end - g0), q = (nr + 7) >> 3;
    const Cursor nxt = advance(a, cur);
    const int more = nxt.tile < a.n_tiles;
    if (more) {
      prefetch_rows<T, H>(a, s, st ^ 1, nxt);
      cp_async_commit();
    }
    cp_async_wait_n(first + more);
    __syncthreads();
    const Rows<T> v(a, s, st, g0, nr);
    if (g0 == a0 * K) {
      for (int k = tid; k < a.TA * H; k += NT) s.accH[k] = 0.f;
      for (int k = tid; k < a.TA * 3; k += NT) s.acc3[k] = 0.f;
    }
    first_layer_tiled<T, H, QM>(s, v, q, ry, c0, s.X[0]);             // m1
    if constexpr (resident(H))
      if (first) cp_async_wait_n(more);                       // W2, W3
    first = false;
    __syncthreads();
    product_q<H, false, QM>(q, rg, s.X[0], s.W2, ry, cx, acc); // pre2
#pragma unroll
    for (int i = 0; i < QM; ++i) {
      if (i >= q) break;
      const int r = ry + 8 * i;
      const float em = v.EM(r);
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        o[u] = rnd<T>(silu_t<T>(acc[i][u] + s.b2[c0 + u]) * em);  // m
      *reinterpret_cast<float4*>(s.X[1] + r * LD + c0) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
    ksum_rows(s.accH, H, s.X[1], LD, a0, g0, nr, K, NT);       // agg
    product_q<H, false, QM>(q, rg, s.X[1], s.W3, ry, cx, acc); // pre3
#pragma unroll
    for (int i = 0; i < QM; ++i) {
      if (i >= q) break;
      float p = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        p = fmaf(rnd<T>(silu_t<T>(acc[i][u] + s.b3[c0 + u])), s.w4[c0 + u], p);
      p = lane_sum<8>(p);
      if ((lane & 7) == 0) s.gpart[(ry + 8 * i) * CW + wp % CW] = p;
    }
    __syncthreads();
    for (int r = tid; r < 8 * q; r += NT) {
      float gate = 0.f;
      for (int w = 0; w < CW; ++w) gate += s.gpart[r * CW + w];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float t = fminf(fmaxf(v.CD(r, d) * gate, -100.f), 100.f);
        s.aux3[r * 3 + d] = rnd<T>(t * v.EM(r));                // tr
      }
    }
    __syncthreads();
    ksum_rows(s.acc3, 3, s.aux3, 3, a0, g0, nr, K, NT);        // F_sum
    if (g0 + nr == g_end) {
      __syncthreads();
      const int na = g_end / K - a0;
      T* agg = (T*)a.agg + (size_t)a0 * H;
      T* fs = (T*)a.fs + (size_t)a0 * 3;
      for (int k = tid; k < na * H; k += NT)
        agg[k] = Cvt<T>::from_f(s.accH[k]);
      for (int k = tid; k < na * 3; k += NT)
        fs[k] = Cvt<T>::from_f(s.acc3[k]);
    }
    __syncthreads();
    st ^= 1;
    cur = nxt;
  }
  if constexpr (!resident(H)) cp_async_wait<0>();    // the slab issued ahead
}

template <typename T, int H>
__global__ void __launch_bounds__(2 * H, 1) edge_tiled_bwd_kernel(Args a) {
  constexpr int NT = 2 * H, CW = H / 32, LD = H + 4, QM = kQmaxBwd;
  // the register tile of dW2 / dW3 (at the streamed widths unused: they
  // are added into the block's slice in place, outer_slice)
  constexpr int NG = resident(H) ? H / 64 : 1;
  extern __shared__ __align__(128) char smem_raw[];
  const int tid = threadIdx.x, K = a.K, C = a.C;
  TSmem s;
  Bump m{smem_raw, 0};
  tcarve(m, s, C, H, a.TA, a.R, sizeof(T), true);
  // a warp: 4 rows x 8 column lanes (32 columns); CW warps span a row
  const int lane = tid & 31, wp = tid >> 5;
  const int cx = 8 * (wp % CW) + (lane & 7), ry = 4 * (wp / CW) + (lane >> 3);
  const int c0 = 4 * cx;
  const int nx = tid % 16, ky = tid / 16;
  T* DE = (T*)a.de;
  T* DCD = (T*)a.dcd;
  const PartLayout L(C, H);
  float* part = a.part + (size_t)blockIdx.x * L.P;
  // the first tile's rows and atoms, then W2 and W3 (waited for after the
  // first layer, which needs neither) or, streamed, the ring's first slab
  Cursor cur{(int)blockIdx.x, (int)blockIdx.x * a.TA * K};
  int st = 0, ab = 0;
  if (cur.tile < a.n_tiles) {
    prefetch_rows<T, H>(a, s, st, cur);
    prefetch_atoms<T, H>(a, s, ab, cur.tile);
  }
  load_small<T, H>(a, s);
  cp_async_commit();
  Ring rg = start_ring<H>(a, s, 4);
  if constexpr (resident(H)) {
    load_tiled_weights<T, H>(a, s);
    cp_async_commit();
  } else {
    zero_slice<H>(ky, nx, part + L.dW2);
    zero_slice<H>(ky, nx, part + L.dW3);
  }
  for (int k = tid; k < C * H; k += NT) s.dW1[k] = 0.f;
  bool first = true;

  // the block's parameter-gradient sums: dW2, dW3 in registers (the
  // outer-product tile; streamed, in the slice), the column sums per thread
  // (its 4 columns, its rows), dW1 in shared memory
  float dW2[8][4 * NG], dW3[8][4 * NG];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int b = 0; b < 4 * NG; ++b) dW2[p][b] = dW3[p][b] = 0.f;
  float pw4[4] = {0.f, 0.f, 0.f, 0.f}, pb3[4] = {0.f, 0.f, 0.f, 0.f};
  float pb2[4] = {0.f, 0.f, 0.f, 0.f}, pb1[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[QM][4];

  while (cur.tile < a.n_tiles) {
    const int a0 = cur.tile * a.TA, g_end = tile_end(a, cur.tile);
    const int g0 = cur.g0, nr = min(a.R, g_end - g0), q = (nr + 7) >> 3;
    const Cursor nxt = advance(a, cur);
    const int more = nxt.tile < a.n_tiles;
    const bool new_atoms = more && nxt.tile != cur.tile;
    if (more) {
      prefetch_rows<T, H>(a, s, st ^ 1, nxt);
      if (new_atoms) prefetch_atoms<T, H>(a, s, ab ^ 1, nxt.tile);
      cp_async_commit();
    }
    cp_async_wait_n(first + more);
    __syncthreads();
    const Rows<T> v(a, s, st, g0, nr);
    const char* dagg = s.sdagg(ab);
    const char* dfs = s.sdfs(ab) + byte_off(a.dfs, (size_t)a0 * 3 * sizeof(T));
    float* X0 = s.X[0];
    float* X1 = s.X[1];
    float* X2 = s.X[2];

    // -- recompute the forward: m1 -> X0; pre2 -> X2, m -> X1
    first_layer_tiled<T, H, QM>(s, v, q, ry, c0, X0);
    if constexpr (resident(H))
      if (first) cp_async_wait_n(more);                       // W2, W3
    first = false;
    __syncthreads();
    product_q<H, false, QM>(q, rg, X0, s.W2, ry, cx, acc);
#pragma unroll
    for (int i = 0; i < QM; ++i) {
      if (i >= q) break;
      const int r = ry + 8 * i;
      const float em = v.EM(r);
      float p2[4], mm[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        p2[u] = acc[i][u] + s.b2[c0 + u];
        mm[u] = rnd<T>(silu_t<T>(p2[u]) * em);
      }
      *reinterpret_cast<float4*>(X2 + r * LD + c0) =
          make_float4(p2[0], p2[1], p2[2], p2[3]);
      *reinterpret_cast<float4*>(X1 + r * LD + c0) =
          make_float4(mm[0], mm[1], mm[2], mm[3]);
    }
    __syncthreads();

    // -- pre3 (in acc), g1 -> X0 and the gate's partial sums; then the
    //    force branch per row (f32; strict clip mask), dw4, db3 and dpre3
    //    (rounded) -> X0
    product_q<H, false, QM>(q, rg, X1, s.W3, ry, cx, acc);
#pragma unroll
    for (int i = 0; i < QM; ++i) {
      if (i >= q) break;
      const int r = ry + 8 * i;
      float g1[4], p = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[i][u] += s.b3[c0 + u];
        g1[u] = rnd<T>(silu_t<T>(acc[i][u]));
        p = fmaf(g1[u], s.w4[c0 + u], p);
      }
      *reinterpret_cast<float4*>(X0 + r * LD + c0) =
          make_float4(g1[0], g1[1], g1[2], g1[3]);
      p = lane_sum<8>(p);
      if ((lane & 7) == 0) s.gpart[r * CW + wp % CW] = p;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < QM; ++i) {
      if (i >= q) break;
      const int r = ry + 8 * i;
      const bool real = r < nr;
      const float em = v.EM(r);
      const int l = real ? (g0 + r) / K - a0 : 0;
      float gate = 0.f;
      for (int w = 0; w < CW; ++w) gate += s.gpart[r * CW + w];
      float dgate = 0.f, dcd = 0.f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float c = v.CD(r, d);
        const float pre = c * gate;
        const float inside = (pre > -100.f && pre < 100.f) ? 1.f : 0.f;
        const float dtr =
            Cvt<T>::to_f(*reinterpret_cast<const T*>(dfs + (l * 3 + d) *
                                                          sizeof(T))) *
            inside * em;
        dgate = fmaf(c, dtr, dgate);
        if (cx == d) dcd = gate * dtr;
      }
      if (cx < 3 && real) DCD[(size_t)(g0 + r) * 3 + cx] = Cvt<T>::from_f(dcd);
      const float dgr = rnd<T>(dgate);
      float4* x = reinterpret_cast<float4*>(X0 + r * LD + c0);
      const float4 gv = *x;
      const float g1[4] = {gv.x, gv.y, gv.z, gv.w};
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        pw4[u] = fmaf(g1[u], dgr, pw4[u]);
        const float d = (dgr * s.w4[c0 + u]) * dsilu_t<T>(acc[i][u]);
        pb3[u] += d;
        o[u] = rnd<T>(d);
      }
      *x = make_float4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();

    // -- dW3 += m^T dpre3; dm = dagg + dpre3 W3^T; dpre2 (rounded) -> X2
    if constexpr (resident(H))
      outer<H>(X1, X0, nr, ky, nx, dW3);
    else
      outer_slice<H>(X1, X0, nr, ky, nx, part + L.dW3);
    product_q<H, true, QM>(q, rg, X0, s.W3, ry, cx, acc);
#pragma unroll
    for (int i = 0; i < QM; ++i) {
      if (i >= q) break;
      const int r = ry + 8 * i;
      const float em = v.EM(r);
      const int l = r < nr ? (g0 + r) / K - a0 : 0;
      const T* da = reinterpret_cast<const T*>(dagg) + l * H + c0;
      float4* p2 = reinterpret_cast<float4*>(X2 + r * LD + c0);
      const float4 pv = *p2;
      const float pre2[4] = {pv.x, pv.y, pv.z, pv.w};
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float dm = (Cvt<T>::to_f(da[u]) + acc[i][u]) * em;
        const float d = dm * dsilu_t<T>(pre2[u]);
        pb2[u] += d;
        o[u] = rnd<T>(d);
      }
      *p2 = make_float4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
    first_layer_tiled<T, H, QM>(s, v, q, ry, c0, X1);         // m1 again
    __syncthreads();

    // -- dW2 += m1^T dpre2; dm1 = dpre2 W2^T; dpre1 (rounded) -> X0, db1
    if constexpr (resident(H))
      outer<H>(X1, X2, nr, ky, nx, dW2);
    else
      outer_slice<H>(X1, X2, nr, ky, nx, part + L.dW2);
    product_q<H, true, QM>(q, rg, X2, s.W2, ry, cx, acc);
#pragma unroll
    for (int i = 0; i < QM; ++i) {
      if (i >= q) break;
      const int r = ry + 8 * i;
      float z[4], o[4];
      pre1_row<T, H>(s, v, r, c0, z);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float d = acc[i][u] * dsilu_t<T>(z[u]);
        pb1[u] += d;
        o[u] = rnd<T>(d);
      }
      *reinterpret_cast<float4*>(X0 + r * LD + c0) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();

    // -- de = rnd(dpre1 W1^T), one (row, j) a thread; dW1 += e^T dpre1,
    //    one (j, c) a thread
    for (int w = tid; w < nr * C; w += NT) {
      const int r = w / C, j = w % C;
      const float* x = X0 + r * LD;
      const float* w1 = s.W1 + j * H;
      float t = 0.f;
#pragma unroll 4
      for (int c = 0; c < H; c += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(x + c);
        const float4 wv = *reinterpret_cast<const float4*>(w1 + c);
        t = fmaf(xv.w, wv.w, fmaf(xv.z, wv.z, fmaf(xv.y, wv.y,
            fmaf(xv.x, wv.x, t))));
      }
      DE[(size_t)(g0 + r) * C + j] = Cvt<T>::from_f(t);
    }
    for (int w = tid; w < C * H; w += NT) {
      const int j = w / H, c = w % H;
      float t = 0.f;
#pragma unroll 4
      for (int r = 0; r < nr; ++r) t = fmaf(v.E(r, j), X0[r * LD + c], t);
      s.dW1[w] += t;
    }
    __syncthreads();
    st ^= 1;
    if (new_atoms) ab ^= 1;
    cur = nxt;
  }

  // -- the block's slice of the partials, written once with plain stores
  // (the streamed widths wrote dW2 and dW3 in place, outer_slice)
  if constexpr (resident(H)) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int k = 4 * ky + (p & 3) + (p >> 2) * (H / 2);
#pragma unroll
      for (int b = 0; b < NG; ++b) {
        const int n = 64 * b + 4 * nx;
        *reinterpret_cast<float4*>(part + L.dW2 + k * H + n) = make_float4(
            dW2[p][4 * b], dW2[p][4 * b + 1], dW2[p][4 * b + 2],
            dW2[p][4 * b + 3]);
        *reinterpret_cast<float4*>(part + L.dW3 + k * H + n) = make_float4(
            dW3[p][4 * b], dW3[p][4 * b + 1], dW3[p][4 * b + 2],
            dW3[p][4 * b + 3]);
      }
    }
  }
  for (int k = tid; k < C * H; k += NT) part[L.dW1 + k] = s.dW1[k];
  // column sums: the 8 row lanes of each column, added in row-lane order
  float* red = s.X[0];
  const auto column_sums = [&](const float (&p)[4], int off) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u) red[ry * H + c0 + u] = p[u];
    __syncthreads();
    for (int c = tid; c < H; c += NT) {
      float t = 0.f;
      for (int y = 0; y < 8; ++y) t += red[y * H + c];
      part[off + c] = t;
    }
  };
  column_sums(pw4, L.dw4);
  column_sums(pb3, L.db3);
  column_sums(pb2, L.db2);
  column_sums(pb1, L.db1);
  if constexpr (!resident(H)) cp_async_wait<0>();    // the slab issued ahead
}

template <typename T, int H>
size_t tiled_smem_bytes(int C, int TA, int R, bool bwd) {
  TSmem s;
  Bump m{nullptr, 0};
  tcarve(m, s, C, H, TA, R, sizeof(T), bwd);
  return m.off;
}

bool tiled_dims(int H, int C, int TA, int R, bool bwd) {
  return (H == 64 || H == 128 || H == 192 || H == 256) && C >= 1 &&
         TA >= 1 && R >= 8 && R % 8 == 0 &&
         R <= 8 * (bwd ? kQmaxBwd : kQmaxFwd);
}

long long tiled_smem(int dtype, int C, int H, int TA, int R, bool bwd) {
  if (!tiled_dims(H, C, TA, R, bwd) || dtype != 0) return -1;
  switch (H) {
    case 64: return (long long)tiled_smem_bytes<float, 64>(C, TA, R, bwd);
    case 128: return (long long)tiled_smem_bytes<float, 128>(C, TA, R, bwd);
    case 192: return (long long)tiled_smem_bytes<float, 192>(C, TA, R, bwd);
    default: return (long long)tiled_smem_bytes<float, 256>(C, TA, R, bwd);
  }
}

template <typename T, int H>
int tiled_launch(const Args& a, bool bwd, int blocks, cudaStream_t stream) {
  // the attribute once per kernel: every launch stays under kMaxSmem
  static bool ready[2] = {false, false};
  void (*kernel)(Args) =
      bwd ? edge_tiled_bwd_kernel<T, H> : edge_tiled_fwd_kernel<T, H>;
  if (!ready[bwd]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    ready[bwd] = true;
  }
  const size_t smem = tiled_smem_bytes<T, H>(a.C, a.TA, a.R, bwd);
  kernel<<<blocks, 2 * H, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int tiled_dispatch(int dtype, const Args& a, bool bwd, int blocks,
                   void* stream) {
  const long long smem = tiled_smem(dtype, a.C, a.H, a.TA, a.R, bwd);
  if (smem < 0 || smem > (long long)kMaxSmem || a.A < 1 || a.K < 1 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.H) {
    case 64: return tiled_launch<float, 64>(a, bwd, blocks, st);
    case 128: return tiled_launch<float, 128>(a, bwd, blocks, st);
    case 192: return tiled_launch<float, 192>(a, bwd, blocks, st);
    default: return tiled_launch<float, 256>(a, bwd, blocks, st);
  }
}

}  // namespace

extern "C" {

long long edge_pipeline_smem_limit() { return (long long)kMaxSmem; }

// Dynamic shared memory of one block at R rows a tile (R % 8 == 0, at most
// 72 forward and 40 backward; float32: dtype 0; H = 64, 128, 192 or 256),
// or -1 for sizes the kernels do not take. A launch needs at most
// edge_pipeline_smem_limit().
long long edge_tiled_smem_bytes(int dtype, int C, int H, int TA, int R,
                                int bwd) {
  return tiled_smem(dtype, C, H, TA, R, bwd != 0);
}

// dtype 0 (float32) throughout. Atoms are taken in tiles of TA, tiles
// spread over `blocks` blocks, each atom tile's rows in row tiles of R.
// The backward's `part` is one slice of C H + 2 H^2 + 4 H floats
// (PartLayout) a block, every element written (no zeroing needed).
// Returns the cudaError_t of the launch (0 on success).
int edge_tiled_fwd(int dtype, int A, int K, int C, int H, int TA, int R,
                   int blocks, const void* e, const void* cd, const void* em,
                   const void* W1, const void* b1, const void* W2,
                   const void* b2, const void* W3, const void* b3,
                   const void* w4, void* agg, void* fs, void* stream) {
  const int n_tiles = (A + TA - 1) / TA;
  Args a{A, K, C, H, TA, n_tiles, e, cd, em, W1, b1, W2, b2, W3, b3, w4,
         nullptr, nullptr, agg, fs, nullptr, nullptr, nullptr, R};
  return tiled_dispatch(dtype, a, false, blocks, stream);
}

int edge_tiled_bwd(int dtype, int A, int K, int C, int H, int TA, int R,
                   int blocks, const void* e, const void* cd, const void* em,
                   const void* W1, const void* b1, const void* W2,
                   const void* b2, const void* W3, const void* b3,
                   const void* w4, const void* dagg, const void* dfs,
                   void* de, void* dcd, void* part, void* stream) {
  const int n_tiles = (A + TA - 1) / TA;
  Args a{A, K, C, H, TA, n_tiles, e, cd, em, W1, b1, W2, b2, W3, b3, w4,
         dagg, dfs, nullptr, nullptr, de, dcd, (float*)part, R};
  return tiled_dispatch(dtype, a, true, blocks, stream);
}

const char* edge_pipeline_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
