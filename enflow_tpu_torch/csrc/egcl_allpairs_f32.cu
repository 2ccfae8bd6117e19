// Fused all-pairs EGCL edge pipeline in float32, designed for Hopper
// (sm_90a): the forward (K1), the input-gradient backward (K2) and the
// backward with the nine parameter gradients (K2 p), at H = 64, 128, 192
// or 256.
//
// Replaces the Pallas TPU kernels of enflow_tpu/ops/egcl_fused_v3.py:
//   forward  -> the pallas_call of _fused_fwd (:365), _fwd_kernel
//   backward -> the pallas_call of _fused_bwd (:414), _bwd_kernel: dh and
//               dpos only (what sampling asks for), or with the parameter
//               gradients dW1a ... dw4 (:256-273; what training asks for)
// for the float32 compute dtype, one or more whole molecules a block of
// threads, and past one block's shared memory over pairs of atom blocks
// (below), and computes the contract in egcl_allpairs_sm90.cu's header.
// In f32 every rounding point of that contract is the identity, so this
// file has none; dw1r takes the f32 r2 and dw4 the f32 dgate, as
// _bwd_kernel does, and the backward's clip mask is _bwd_kernel's (-100
// <= cd gate <= 100). bf16 runs in egcl_allpairs_sm90.cu; the wrapper
// zero-pads every other width up to the next of these four
// (ops/egcl_allpairs.py padded_width).
//
// What bounds it on this card: per valid pair the forward does two H x H
// products, the input-gradient backward four (two recomputed, two
// transposed) and the parameter-gradient backward six (two outer products
// for dW2 and dW3 more), 4, 8 and 12 H^2 FLOP; the inputs are a few floats
// per atom. At vi_ala2.yaml's shape (B=256, N=22, nf=4, H=128, 118,272
// pairs) that is ~7.9, ~15.6 and ~23.5 GFLOP: 0.12, 0.23 and 0.35 ms at
// the 67 TFLOP/s f32 rate. At vi_dw4.yaml's (B=512, N=4, nf=2, H=64, 6,144
// pairs) it is 0.1 to 0.3 GFLOP, a few microseconds: there one wave of
// blocks, the weights' load and the barriers set the time. The products
// stay on the FMA units: TF32 tensor cores would round every input to 10
// mantissa bits, where the f32 reference keeps 23.
//
// Design (after the tiled kernels of edge_pipeline.cu):
// - 2H threads a block, one block an SM, persistent: molecule tiles of MT
//   whole molecules, strided over the blocks, so every node sum stays in
//   its block (no atomics) and runs in a fixed order. W2 and W3 are copied
//   once a block with cp.async, as f32 with each 16-byte chunk kc of row r
//   at kc ^ ((r / 4) % 8), so W (X W) and W^T (X W^T) read without bank
//   conflicts; they land while the first tile's first layer computes.
// - Only the rows i != j: a molecule's N(N-1) pairs in i-major order (row
//   q: i = q / (N-1), j the (q % (N-1))-th atom other than i); a molecule
//   tile's nm N(N-1) rows are cut into row tiles of R rows (a multiple of
//   8, at most 72 forward and input-gradient backward, 40 with parameter
//   gradients; the wrapper's tile_rows), the last holding the rest, with
//   the padding masked. Where N(N-1) is small the wrapper packs several
//   molecules into a tile (N=4: 12 rows a molecule, 4 molecules a block at
//   B=512), so a row tile may span molecules and a molecule may straddle
//   two row tiles; the sums are kept per molecule tile across its row
//   tiles.
// - z1 = h_i W1a + h_j W1b + b1 + r2 w1r is computed per row from the
//   staged h (nf FMAs a side) instead of staging h W1a and h W1b per atom,
//   and the backward reads dagg rows straight from global memory (L2; each
//   read N-1 times): the per-atom arrays are then only the node sums, so
//   at N=22, nf=4, H=128 the parameter-gradient backward keeps three
//   40-row activation tiles beside the weights: W2 + W3 131,072 bytes, the
//   tiles 63,360, the node sums 23,056 and the rest ~11 KB, of the 232,448
//   a block may use.
// - The input-gradient backward (egcl_f32_bwd_kernel) goes further: it
//   takes dh's node sums after the first layer's transposes, per row
//   (dz1_ij W1a^T on the i side, dz1_ij W1b^T on the j side, nf floats
//   each, from the thread's 4 columns and shuffles, about 4 nf H FMAs a
//   row beside its 8 H^2), so an atom keeps 2 (nf + 3) floats of sums
//   instead of 2 (H + 3), and it needs two activation tiles, not three
//   (no outer products): 64-row tiles at N=22, and N up to several
//   hundred at nf=5, H=128. dh = sum_j dz1_ij W1a^T + sum_i dz1_ij W1b^T
//   is the reference's (sum_j dz1_ij) W1a^T + ... in another order.
// - Register-tiled products as in edge_pipeline.cu: in X W and X W^T a
//   thread owns 4 columns of every 8th row of the tile (a warp: 4 rows x 8
//   column lanes), reading 4 float4 of W and q broadcast float4 of X for
//   16 q FMAs a 4-deep k step. In the outer products m2^T dz3 and m1^T dz2
//   (the tile's rows as depth) a thread owns an 8 x 4 (H / 64) tile of dW3
//   and dW2, held in registers across all of the block's rows; the column
//   sums (db2, db3, dw1r, dw4) stay per thread in registers too, reduced
//   over the 8 row lanes once at the end. Each block stores its slice of
//   the [blocks, P] partials (egcl_part_layout.cuh) once; dW1a = sum_i h_i
//   (x) dz1_i, dW1b likewise and db1 = sum_i dz1_i come from the node sums
//   once a molecule tile (as in egcl_allpairs_sm90.cu), added into the
//   slice by their owner threads. The wrapper sums the slices in a fixed
//   order: a second launch gives the same bits.
// - Node sums: the i side of a row tile (agg, dz1_i, dpos_i) as runs of
//   N-1 rows, one (atom, column) a thread in row order; the j side (dz1_j,
//   dpos_j) one (atom, column) a thread over the tile's rows of that j.
// - The next molecule tile's h, pos, mask, box (and dfsum) are copied with
//   cp.async into the other half of a double buffer while the current one
//   computes.
// - SiLU uses the fast ex2 and reciprocal (a few ulp, far inside the f32
//   tolerance), as the tiled edge kernels do.
//
// Larger molecules: the block-pair kernels (egcl_f32_blocks_*), every N,
// on the same row code (fwd_rows, bwd_in_rows, bwd_params_rows: the one-
// molecule kernels call them too, with their own geometry and sums). A
// molecule past one block's shared memory (at nf=5, H=128: N > 142
// forward, N > 519 input-gradient backward, N > 70 with parameter
// gradients) is cut into nI blocks of A atoms (the wrapper's plan,
// ops/egcl_allpairs.py f32_blocks_plan: the most atoms, at most 32, with
// a row tile beside them). The unit of work is a (molecule, i-block) item
// of a persistent block: the i-block's atoms and sums stay in shared
// memory, each j-block's atoms are loaded beside them in turn, and the
// block pair's rows i != j (Pairs: i-major, j = i skipped on the diagonal
// block pair) are walked in row tiles of R rows. The forward's sums are
// i-side only, so an item writes its atoms' agg and fsum: no partials, no
// second kernel. The backward keeps the input-gradient kernel's per-atom
// vectors: the j-side sums of a block pair, [dcd_j, dz1_j W1b^T] (nf + 3
// floats an atom), go to their own row of partials pj [B, nI, N, nf + 3],
// an item's i-side sums [dz1_i W1a^T, dcd_i] to si [B, N, nf + 3], and
// egcl_f32_blocks_finish_kernel sums pj over the i-blocks in order into dh
// and dpos. With parameter gradients a block pair keeps its j-block's
// H-wide dz1 sums (dW1b = sum_j h_j (x) sum_i dz1_ij is linear in them),
// adds h_j (x) them into the block's slice and projects them to its nf +
// 3 partials; an item adds h_i (x) its i-side dz1 sums into dW1a and their
// sum into db1; dW2, dW3 and the column sums are the one-molecule
// kernel's. At LJ147 (B=256, N=147) that is 1,280 items of 32-atom blocks
// over 132 blocks of threads. No atomics: a second launch gives the same
// bits.
//
// Wide hidden widths (H = 192, 256; the block-pair kernels only, at every
// N). W2 + W3 in f32 are 8 H^2 bytes, 524,288 at H = 256, more than a
// block may use, so they stay in global memory (L2-resident) and pass
// through a ring of kRing = 2 slabs in shared memory. A slab is one K-split
// of a product, 64 of the sum's k: in X W 64 of W's rows ([64, H]), in
// X W^T 64 of W's columns ([H, 64]), 256 H bytes either way, each 16-byte
// chunk kc of its row r at kc ^ ((r / 4) % 8) as in the resident copy. The
// register tiles keep their accumulators across a product's H / 64 slabs,
// so each output's K-sum runs the same FMAs in the same order as from a
// resident copy, and the row code around the products is unchanged. A row
// tile uses the slabs in a fixed stream (W2, W3, and backward W3^T, W2^T;
// H / 64 slabs each); the block copies the next slab with cp.async into the
// slot that the slab before the current one used, while the FMAs work on
// the current one. The K-split (and not 64 output columns a slab, as the
// bf16 kernels' wgmma chunks take them) keeps every thread busy on every
// slab. Shared memory sets the rest: beside the ring (131,072 bytes at
// H = 256) the activation tiles [R, H + 4] and the i- and j-side sums take
// what is left, so the wrapper's plan (ops/egcl_allpairs.py
// f32_wide_plan) takes the most rows a tile first: every row tile streams
// the weights once, so the L2 bytes a launch reads go as its tiles' count.
// K2 p's dW2 and dW3 do not fit in registers either (2H threads hold 2 H^2
// floats: 256 a thread at H = 256, past the 128 registers a thread of 512
// may use), so each thread keeps its outer-product tile in the block's
// slice of the partials in global memory and reads, adds to and writes it
// once a row tile, one 64-column group at a time (outer_slice), in the
// order and with the FMAs the register tile takes: the same bits.
//
// Wide node features (route "f32_wide_nf", every H and N;
// egcl_wide_nf.cuh). The other routes keep W1a and W1b whole in shared
// memory (8 nf H bytes) and, in the input-gradient backward, per-row
// arrays that grow with nf (gpart [R, H/32, 2 nf + 1], rd [R, 2 nf + 3]):
// past nf ~24-32 at H = 256 or ~60-77 at H = 128 no block of 8 atoms and 8
// rows fits. Where the block pairs' plan finds none, the wrapper runs them
// with their PROJ flag at nf 0: z1_row adds the rows of hA = h W1a and hB =
// h W1b, precomputed once per atom by egcl_nf_proj_kernel ([B N, 2H]),
// read from global memory (L2) instead of its nf-long dots; the backward
// (egcl_f32_wide_nf_bwd_kernel, with or without parameter gradients) keeps
// each row's dz1 in the X0 tile and sums it per atom, H wide, on both
// sides, as K2 p's block pairs do, writing si [B, N, H + 4] and pj [B, nI,
// N, H + 4] ([dz1 sums, dcd sums, 0]); egcl_wide_nf.cuh's kernels then
// form dpos, dh = (sum_j dz1) W1a^T + (sum_i dz1) W1b^T and dW1a, dW1b per
// atom. Nothing in shared memory grows with nf.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "egcl_part_layout.cuh"
#include "egcl_wide_nf.cuh"

namespace {

constexpr int kQmaxFwd = 9;   // at most 72 rows a tile (forward)
constexpr int kQmaxBwdIn = 9; // at most 72 rows a tile (input gradients)
constexpr int kQmaxBwd = 5;   // at most 40 rows a tile (parameter gradients)
constexpr size_t kMaxSmem = 232448;
enum Kind { kFwd = 0, kBwd = 1, kBwdParams = 2 };
// weight slabs the ring holds, and the k of a product's sum a slab holds
// (the wide kernels)
constexpr int kRing = 2;
constexpr int kSlab = 64;

// The widths whose W2 and W3 a block holds whole; the block-pair kernels
// stream the others (192, 256) through the ring.
__host__ __device__ constexpr bool resident(int H) {
  return H == 64 || H == 128;
}

struct Args {
  int B, N, nf, H;
  int MT;             // molecules a tile
  int R;              // rows a row tile (a multiple of 8)
  int n_tiles;        // molecule tiles, ceil(B / MT)
  const float* h;     // [B, N, nf]
  const float* pos;   // [B, N, 3]
  const float* box;   // [B, 3]
  const float* mask;  // [B, N] (0/1)
  const float* W1a;   // [nf, H]
  const float* W1b;   // [nf, H]
  const float* w1r;   // [H]
  const float* b1;    // [H]
  const float* W2;    // [H, H]
  const float* b2;    // [H]
  const float* W3;    // [H, H]
  const float* b3;    // [H]
  const float* w4;    // [H]
  const float* dagg;  // [B, N, H]   (backward)
  const float* dfsum; // [B, N, 3]   (backward)
  float* agg;         // [B, N, H]   (forward)
  float* fsum;        // [B, N, 3]   (forward)
  float* dh;          // [B, N, nf]  (backward)
  float* dpos;        // [B, N, 3]   (backward)
  float* part;        // [blocks, P] (backward)
  // the block-pair kernels: atoms a block, blocks a molecule, and the
  // backward's i-side sums [B, N, nf + 3] and j-side partials [B, nI, N,
  // nf + 3]
  int A, nI;
  float* si;
  float* pj;
  // the wide_nf route: the projections [B, N, 2H] (hA | hB), the j-side
  // sums [B, N, H] and dW1's row-split partials [splits, 2, nf, H]
  const float* proj;
  float* sj;
  float* dw1;
  int splits;
};

struct Bump {
  char* base;
  size_t off;
  __host__ __device__ char* take(size_t bytes) {
    off = (off + 15) & ~size_t(15);
    char* p = base ? base + off : nullptr;
    off += bytes;
    return p;
  }
};

struct Smem {
  float *W2, *W3, *W1a, *W1b, *w1r, *b1, *b2, *b3, *w4;
  float* ring;          // the wide kernels' kRing slabs [kSlab H] (W2, W3
                        // unused there)
  float* X[3];          // activation tiles [R, H + 4] (forward and input-
                        // gradient backward: 2)
  // a row's partial sums over the H / 32 column warps [R, H/32]; the
  // input-gradient backward's [R, 2 nf + 1, H/32] (dr2, dz1 W1a^T,
  // dz1 W1b^T)
  float* gpart;
  int *ri, *rj;         // the rows' atoms in the molecule tile (m N + i)
  float *cd, *r2, *valid;
  // forward: tr [R, 3]; parameter-gradient backward: dcd [R, 3];
  // input-gradient backward: [R, 2 nf + 3], dz1 W1a^T, dcd, dz1 W1b^T
  float* rd;
  // forward: agg [MT N, H], fsum [MT N, 3]; parameter-gradient backward:
  // dz1_i then dz1_j [2, MT N, H], dpos_i then dpos_j [2, MT N, 3];
  // input-gradient backward: the i side (dh_i, dpos_i) then the j side
  // (dpos_j, dh_j) [2, MT N, nf + 3] in accH
  float *accH, *acc3;
  // two stages of a molecule tile's h [MT N, nf], pos [MT N, 3], mask
  // [MT N], box [MT, 3] and (backward) dfsum [MT N, 3], at float offsets
  // held as ints so that the struct stays in registers
  float* atoms;
  int at_floats, at_pos, at_mask, at_box, at_dfs;
  // the wide_nf route: the i-block's rows of the projections (hA at
  // column 0) and the j-block's (hB at column 0, the j atom at place jA +
  // its place in the block)
  const float *pA, *pB;
  int jA;
  __device__ float* stage(int ab) const { return atoms + ab * at_floats; }
};

// The weights and a row tile's arrays (both kinds of kernel).
__host__ __device__ inline void carve_rows(Bump& m, Smem& s, int nf, int H,
                                           int R, int kind) {
  const size_t fH = sizeof(float) * H;
  const bool in = kind == kBwd;
  if (resident(H)) {
    s.W2 = (float*)m.take(fH * H);
    s.W3 = (float*)m.take(fH * H);
  } else {
    s.ring = (float*)m.take(fH * kSlab * kRing);
  }
  s.W1a = (float*)m.take(fH * nf);
  s.W1b = (float*)m.take(fH * nf);
  s.w1r = (float*)m.take(fH);
  s.b1 = (float*)m.take(fH);
  s.b2 = (float*)m.take(fH);
  s.b3 = (float*)m.take(fH);
  s.w4 = (float*)m.take(fH);
  for (int k = 0; k < 3; ++k)
    s.X[k] = k < (kind == kBwdParams ? 3 : 2)
                 ? (float*)m.take(sizeof(float) * R * (H + 4)) : nullptr;
  s.gpart = (float*)m.take(sizeof(float) * R * (H / 32) *
                           (in ? 2 * nf + 1 : 1));
  s.ri = (int*)m.take(sizeof(int) * R);
  s.rj = (int*)m.take(sizeof(int) * R);
  s.cd = (float*)m.take(sizeof(float) * R * 3);
  s.r2 = (float*)m.take(sizeof(float) * R);
  s.valid = (float*)m.take(sizeof(float) * R);
  s.rd = (float*)m.take(sizeof(float) * R * (in ? 2 * nf + 3 : 3));
}

__host__ __device__ inline void carve(Bump& m, Smem& s, int N, int nf, int H,
                                      int MT, int R, int kind) {
  const bool bwd = kind != kFwd, in = kind == kBwd;
  carve_rows(m, s, nf, H, R, kind);
  const int na = MT * N, sides = bwd ? 2 : 1;
  s.accH = (float*)m.take(sizeof(float) * na * sides * (in ? nf + 3 : H));
  s.acc3 = in ? nullptr : (float*)m.take(sizeof(float) * na * 3 * sides);
  s.at_pos = na * nf;
  s.at_mask = s.at_pos + na * 3;
  s.at_box = s.at_mask + na;
  s.at_dfs = s.at_box + MT * 3;
  s.at_floats = (s.at_dfs + (bwd ? na * 3 : 0) + 3) & ~3;
  s.atoms = (float*)m.take(sizeof(float) * 2 * s.at_floats);
}

// The block-pair kernels: the row tile's arrays, the sums of an i-block
// (and a j-block) of A atoms (forward agg, fsum; parameter gradients dz1
// and dcd a side; input gradients nf + 3 floats an atom a side), and one
// stage of atoms: the i-block's at places 0 .. A-1, the j-block's at A ..
// 2A-1, the box and the i-block's dfsum rows. With proj (the wide_nf
// route, nf 0) the input-gradient backward keeps K2 p's H-wide dz1 sums.
__host__ __device__ inline void carve_pairs(Bump& m, Smem& s, int A, int nf,
                                            int H, int R, int kind,
                                            bool proj = false) {
  const bool bwd = kind != kFwd, in = kind == kBwd && !proj;
  carve_rows(m, s, nf, H, R, kind);
  const int sides = bwd ? 2 : 1;
  s.accH = (float*)m.take(sizeof(float) * A * sides * (in ? nf + 3 : H));
  s.acc3 = in ? nullptr : (float*)m.take(sizeof(float) * A * 3 * sides);
  s.at_pos = 2 * A * nf;
  s.at_mask = s.at_pos + 2 * A * 3;
  s.at_box = s.at_mask + 2 * A;
  s.at_dfs = s.at_box + 4;
  s.at_floats = s.at_dfs + (bwd ? A * 3 : 0);
  s.atoms = (float*)m.take(sizeof(float) * s.at_floats);
}

// cp.async: 4-byte and 16-byte copies, global -> shared.
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
// Waits until at most n of this thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n >= 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

__device__ __forceinline__ float sig(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float silu(float x) { return x * sig(x); }
__device__ __forceinline__ float dsilu(float x) {
  const float s = sig(x);
  return s * (1.0f + x * (1.0f - s));
}

template <int W> __device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// W2, W3 [H, H] in shared memory, 16-byte chunk kc of row r stored at chunk
// kc ^ ((r / 4) % 8): the row products read W[k][4cx..] (one row, 8
// consecutive chunks a quarter warp) and W[4cx+u][kc..] (8 rows four apart,
// one chunk) without bank conflicts.
template <int H>
__device__ __forceinline__ const float* wchunk(const float* W, int r, int kc) {
  return W + r * H + ((kc ^ ((r >> 2) & 7)) << 2);
}

// W2, W3 (swizzled), W1a, W1b and the bias rows by 16-byte cp.async (the
// caller commits).
template <int H>
__device__ void load_weights(const Args& a, const Smem& s) {
  constexpr int NT = 2 * H, CH = H / 4;
  for (int k = threadIdx.x; k < H * CH; k += NT) {
    const int r = k / CH, kc = k % CH;
    const int dst = r * H + ((kc ^ ((r >> 2) & 7)) << 2);
    cp_async16(s.W2 + dst, a.W2 + 4 * k);
    cp_async16(s.W3 + dst, a.W3 + 4 * k);
  }
}
// The wide kernels' place in their stream of weight slabs. Slab s of the
// stream is product (s / G) % nprod of a row tile, G = H / kSlab: W2 (X W),
// W3 (X W), and for the backward W3 (X W^T), W2 (X W^T); within it the k
// 64 (s % G) ..; it lands in slot slot_of(s) of the ring. Every thread
// keeps the same copy. (The resident widths carry an unused one.)
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

// The ring of a kernel (nprod products a row tile): the first kRing - 1
// slabs issued at the streamed widths.
template <int H>
__device__ Ring start_ring(const Args& a, const Smem& s, int nprod) {
  Ring rg{s.ring, a.W2, a.W3, 0, nprod};
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

template <int H>
__device__ void load_small(const Args& a, const Smem& s) {
  constexpr int NT = 2 * H;
  const auto load = [&](float* dst, const float* src, int n) {
    for (int k = threadIdx.x; k < n / 4; k += NT)
      cp_async16(dst + 4 * k, src + 4 * k);
  };
  load(s.W1a, a.W1a, a.nf * H);
  load(s.W1b, a.W1b, a.nf * H);
  load(s.w1r, a.w1r, H);
  load(s.b1, a.b1, H);
  load(s.b2, a.b2, H);
  load(s.b3, a.b3, H);
  load(s.w4, a.w4, H);
}

// Molecule tile `tile`'s atoms into stage ab, 4-byte cp.async (the caller
// commits).
template <int H, bool BWD>
__device__ void prefetch_atoms(const Args& a, const Smem& s, int ab,
                               int tile) {
  constexpr int NT = 2 * H;
  const int b0 = tile * a.MT, nm = min(a.MT, a.B - b0), na = nm * a.N;
  float* d = s.stage(ab);
  const auto copy = [&](float* dst, const float* src, int n) {
    for (int k = threadIdx.x; k < n; k += NT) cp_async4(dst + k, src + k);
  };
  copy(d, a.h + (size_t)b0 * a.N * a.nf, na * a.nf);
  copy(d + s.at_pos, a.pos + (size_t)b0 * a.N * 3, na * 3);
  copy(d + s.at_mask, a.mask + (size_t)b0 * a.N, na);
  copy(d + s.at_box, a.box + (size_t)b0 * 3, nm * 3);
  if (BWD) copy(d + s.at_dfs, a.dfsum + (size_t)b0 * a.N * 3, na * 3);
}

// A block's work: molecule tiles blockIdx.x, + gridDim.x, ... of MT
// molecules; a tile's nm N(N-1) rows in row tiles of R rows, the last one
// holding the rest (a tile without rows, N = 1, is one empty row tile).
struct Cursor {
  int tile, g0;
};
__device__ __forceinline__ int rows_of(const Args& a, int tile) {
  return min(a.MT, a.B - tile * a.MT) * a.N * (a.N - 1);
}
__device__ __forceinline__ Cursor advance(const Args& a, Cursor c) {
  if (c.g0 + a.R < rows_of(a, c.tile)) return Cursor{c.tile, c.g0 + a.R};
  return Cursor{c.tile + (int)gridDim.x, 0};
}

// Per row r < R of the tile: its atoms (m N + i, m N + j), the min-image cd
// (round half to even, as jnp.round), r2 and valid = mask_i mask_j; rows
// past nr are padding (atoms 0, geometry and valid 0).
__device__ void row_geometry(const Args& a, const Smem& s, const float* at,
                             int g0, int nr) {
  const int r = threadIdx.x;
  if (r >= a.R) return;
  const int N = a.N, E = N * (N - 1);
  if (r < nr) {
    const float* pos = at + s.at_pos;
    const float* mask = at + s.at_mask;
    const int g = g0 + r, m = g / E, q = g - m * E;
    const int i = q / (N - 1), jj = q - i * (N - 1), j = jj + (jj >= i);
    const int ai = m * N + i, aj = m * N + j;
    float r2 = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float c = pos[ai * 3 + d] - pos[aj * 3 + d];
      const float bx = at[s.at_box + m * 3 + d];
      c = c - rintf(c / bx) * bx;
      s.cd[r * 3 + d] = c;
      r2 += c * c;
    }
    s.r2[r] = r2;
    s.valid[r] = mask[ai] * mask[aj];
    s.ri[r] = ai;
    s.rj[r] = aj;
  } else {
#pragma unroll
    for (int d = 0; d < 3; ++d) s.cd[r * 3 + d] = 0.f;
    s.r2[r] = 0.f;
    s.valid[r] = 0.f;
    s.ri[r] = 0;
    s.rj[r] = 0;
  }
}

// z1 = h_i W1a + h_j W1b + b1 + r2 w1r of row r, columns c0 .. c0 + 3;
// with PROJ h_i W1a and h_j W1b are rows of the projections (a padding
// row's j atom, place 0, reads the j-block's first).
template <int H, bool PROJ = false>
__device__ __forceinline__ void z1_row(int nf, const Smem& s,
                                       const float* hs, int r, int c0,
                                       float (&z)[4]) {
  float pa[4] = {0.f, 0.f, 0.f, 0.f}, pb[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (PROJ) {
    const float4 a4 = __ldg(
        reinterpret_cast<const float4*>(s.pA + s.ri[r] * 2 * H + c0));
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(
        s.pB + max(s.rj[r] - s.jA, 0) * 2 * H + c0));
    pa[0] = a4.x; pa[1] = a4.y; pa[2] = a4.z; pa[3] = a4.w;
    pb[0] = b4.x; pb[1] = b4.y; pb[2] = b4.z; pb[3] = b4.w;
  }
  const float* hi = hs + s.ri[r] * nf;
  const float* hj = hs + s.rj[r] * nf;
  for (int k = 0; k < (PROJ ? 0 : nf); ++k) {
    const float xi = hi[k], xj = hj[k];
    const float4 wa = *reinterpret_cast<const float4*>(s.W1a + k * H + c0);
    const float4 wb = *reinterpret_cast<const float4*>(s.W1b + k * H + c0);
    pa[0] = fmaf(xi, wa.x, pa[0]);
    pa[1] = fmaf(xi, wa.y, pa[1]);
    pa[2] = fmaf(xi, wa.z, pa[2]);
    pa[3] = fmaf(xi, wa.w, pa[3]);
    pb[0] = fmaf(xj, wb.x, pb[0]);
    pb[1] = fmaf(xj, wb.y, pb[1]);
    pb[2] = fmaf(xj, wb.z, pb[2]);
    pb[3] = fmaf(xj, wb.w, pb[3]);
  }
  const float4 b = *reinterpret_cast<const float4*>(s.b1 + c0);
  const float4 w = *reinterpret_cast<const float4*>(s.w1r + c0);
  const float r2 = s.r2[r];
  z[0] = ((pa[0] + pb[0]) + b.x) + r2 * w.x;
  z[1] = ((pa[1] + pb[1]) + b.y) + r2 * w.y;
  z[2] = ((pa[2] + pb[2]) + b.z) + r2 * w.z;
  z[3] = ((pa[3] + pb[3]) + b.w) + r2 * w.w;
}

// X = silu(z1) over the thread's rows of the tile (padding included), in
// the row products' layout.
template <int H, int QM, bool PROJ = false>
__device__ __forceinline__ void first_layer(int nf, const Smem& s,
                                            const float* hs, int q, int ry,
                                            int c0, float* X) {
  constexpr int LD = H + 4;
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    float z[4];
    z1_row<H, PROJ>(nf, s, hs, r, c0, z);
    *reinterpret_cast<float4*>(X + r * LD + c0) =
        make_float4(silu(z[0]), silu(z[1]), silu(z[2]), silu(z[3]));
  }
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

// acc[p][b] += sum_{r < nr} L[r, k_p] G[r, n_b]: the thread's 8 k
// (4ky + p%4 + (p/4) H/2) by 4 NG n (4nx + b%4 + (b/4) 64), two float4 of
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

// i-side node sums of the tile's rows [g0, g0 + nr): the rows of atom l
// (m N + i) of the molecule tile are the run [l (N-1), (l+1) (N-1)); one
// (atom, column) a thread, in row order: dst[l][c] += sum src[r][c].
__device__ __forceinline__ void isum_rows(float* dst, int ncols,
                                          const float* src, int ld, int g0,
                                          int nr, int N, int NT) {
  if (nr <= 0) return;
  const int K = N - 1, l0 = g0 / K, l1 = (g0 + nr - 1) / K;
  for (int w = threadIdx.x; w < (l1 - l0 + 1) * ncols; w += NT) {
    const int l = l0 + w / ncols, c = w % ncols;
    const int rs = max(l * K - g0, 0);
    const int re = min((l + 1) * K - g0, nr);
    float acc = 0.f;
#pragma unroll 4
    for (int r = rs; r < re; ++r) acc += src[r * ld + c];
    dst[l * ncols + c] += acc;
  }
}

// j-side node sums of the tile's rows: for atom m N + j of each molecule m
// the tile touches, its rows (i, j) of the tile in row (i) order, one
// (atom, column) a thread: dst[m N + j][c] += sum src[r][c].
__device__ __forceinline__ void jsum_rows(float* dst, int ncols,
                                          const float* src, int ld, int g0,
                                          int nr, int N, int NT) {
  if (nr <= 0) return;
  const int K = N - 1, E = N * K;
  const int m0 = g0 / E, m1 = (g0 + nr - 1) / E;
  for (int w = threadIdx.x; w < (m1 - m0 + 1) * N * ncols; w += NT) {
    const int l = m0 * N + w / ncols, c = w % ncols;
    const int m = l / N, j = l - m * N, e0 = m * E;
    const int lo = max(g0, e0), hi = min(g0 + nr, e0 + E);
    float acc = 0.f;
    for (int i = (lo - e0) / K; i <= (hi - 1 - e0) / K; ++i) {
      if (i == j) continue;
      const int g = e0 + i * K + j - (j > i);
      if (g >= lo && g < hi) acc += src[(g - g0) * ld + c];
    }
    dst[l * ncols + c] += acc;
  }
}

// A thread's place in the row products: a warp is 4 rows x 8 column lanes
// (32 columns), CW = H / 32 warps span a row; wc is the warp's column
// group (its slot in the per-row partial sums).
struct Thr {
  int tid, lane, wc, cx, ry, c0;
};

template <int H>
__device__ __forceinline__ Thr thread_place() {
  constexpr int CW = H / 32;
  Thr p;
  p.tid = threadIdx.x;
  p.lane = p.tid & 31;
  const int wp = p.tid >> 5;
  p.wc = wp % CW;
  p.cx = 8 * p.wc + (p.lane & 7);
  p.ry = 4 * (wp / CW) + (p.lane >> 3);
  p.c0 = 4 * p.cx;
  return p;
}

// ---- one row tile, shared by the one-molecule and block-pair kernels
//
// The row tiles differ only in which atoms their rows pair (the geometry
// pass before: row_geometry or pair_geometry) and where their node sums go
// (the caller's, after or at sum_m2); the rows' arithmetic is this.

// The forward's rows: m1 -> X0 (then after_m1, before the barrier that
// publishes it), m2 -> X1 (then sum_m2: agg's rows are complete), the
// gate, tr -> rd. Ends with a barrier.
template <int H, bool PROJ = false, typename AfterM1, typename SumM2>
__device__ __forceinline__ void fwd_rows(const Smem& s, const float* at,
                                         int nf, int nr, const Thr& p,
                                         Ring& rg, AfterM1&& after_m1,
                                         SumM2&& sum_m2) {
  constexpr int NT = 2 * H, CW = H / 32, LD = H + 4, QM = kQmaxFwd;
  const int q = (nr + 7) >> 3, ry = p.ry, cx = p.cx, c0 = p.c0;
  float acc[QM][4];
  first_layer<H, QM, PROJ>(nf, s, at, q, ry, c0, s.X[0]);        // m1
  after_m1();
  __syncthreads();
  product_q<H, false, QM>(q, rg, s.X[0], s.W2, ry, cx, acc);         // z2
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    const float v = s.valid[r];
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = silu(acc[i][u] + s.b2[c0 + u]) * v;
    *reinterpret_cast<float4*>(s.X[1] + r * LD + c0) =
        make_float4(o[0], o[1], o[2], o[3]);                     // m2
  }
  __syncthreads();
  sum_m2();                                                      // agg
  product_q<H, false, QM>(q, rg, s.X[1], s.W3, ry, cx, acc);         // z3
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    float g = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      g = fmaf(silu(acc[i][u] + s.b3[c0 + u]), s.w4[c0 + u], g);
    g = lane_sum<8>(g);
    if ((p.lane & 7) == 0) s.gpart[(ry + 8 * i) * CW + p.wc] = g;
  }
  __syncthreads();
  for (int r = p.tid; r < nr; r += NT) {
    float gate = 0.f;
    for (int w = 0; w < CW; ++w) gate += s.gpart[r * CW + w];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float t = fminf(fmaxf(s.cd[r * 3 + d] * gate, -100.f), 100.f);
      s.rd[r * 3 + d] = t * s.valid[r];                           // tr
    }
  }
  __syncthreads();
}

// The block's parameter-gradient sums across its row tiles: dW2, dW3 in
// registers (the outer-product tile; at the streamed widths a 1 x 1
// stand-in, the tile kept in the block's slice at gW2, gW3 instead), the
// column sums per thread (its 4 columns, its rows).
template <int H>
constexpr int kDW = resident(H) ? 4 * (H / 64) : 1;

template <int H>
struct ParamAcc {
  float dW2[8][kDW<H>], dW3[8][kDW<H>];
  float pw4[4], pb3[4], pb2[4], pw1r[4];
  float *gW2, *gW3;
};

template <int H>
__device__ __forceinline__ void zero_params(ParamAcc<H>& g) {
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int b = 0; b < kDW<H>; ++b) g.dW2[p][b] = g.dW3[p][b] = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) g.pw4[u] = g.pb3[u] = g.pb2[u] = g.pw1r[u] = 0.f;
}

// The parameter-gradient backward's rows: the forward recomputed, the
// force branch, dz3, dz2, dz1 -> X0 and dcd -> rd, the rows' terms of dW2,
// dW3 and the column sums into g; dagg [., H] and dfs [., 3] are indexed
// by the rows' i atoms (s.ri). Ends with a barrier.
template <int H, bool PROJ = false, typename AfterM1>
__device__ __forceinline__ void bwd_params_rows(
    const Smem& s, const float* at, const float* dagg, const float* dfs,
    int nf, int nr, const Thr& p, Ring& rg, ParamAcc<H>& g,
    AfterM1&& after_m1) {
  constexpr int NT = 2 * H, CW = H / 32, LD = H + 4, QM = kQmaxBwd;
  const int q = (nr + 7) >> 3, ry = p.ry, cx = p.cx, c0 = p.c0;
  const int nx = p.tid % 16, ky = p.tid / 16;
  float acc[QM][4];
  float* X0 = s.X[0];
  float* X1 = s.X[1];
  float* X2 = s.X[2];

  // -- recompute the forward: m1 -> X0; z2 -> X2, m2 -> X1
  first_layer<H, QM, PROJ>(nf, s, at, q, ry, c0, X0);
  after_m1();
  __syncthreads();
  product_q<H, false, QM>(q, rg, X0, s.W2, ry, cx, acc);
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    const float v = s.valid[r];
    float z2[4], m2[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      z2[u] = acc[i][u] + s.b2[c0 + u];
      m2[u] = silu(z2[u]) * v;
    }
    *reinterpret_cast<float4*>(X2 + r * LD + c0) =
        make_float4(z2[0], z2[1], z2[2], z2[3]);
    *reinterpret_cast<float4*>(X1 + r * LD + c0) =
        make_float4(m2[0], m2[1], m2[2], m2[3]);
  }
  __syncthreads();

  // -- z3 (in acc), g1 -> X0 and the gate's partial sums; then per row
  //    the force branch (clip mask -100 <= cd gate <= 100), dgate, the
  //    gate part of dcd, dw4, db3 and dz3 -> X0
  product_q<H, false, QM>(q, rg, X1, s.W3, ry, cx, acc);
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    float g1[4], t = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc[i][u] += s.b3[c0 + u];
      g1[u] = silu(acc[i][u]);
      t = fmaf(g1[u], s.w4[c0 + u], t);
    }
    *reinterpret_cast<float4*>(X0 + r * LD + c0) =
        make_float4(g1[0], g1[1], g1[2], g1[3]);
    t = lane_sum<8>(t);
    if ((p.lane & 7) == 0) s.gpart[r * CW + p.wc] = t;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    const float v = s.valid[r];
    const int ai = s.ri[r];
    float gate = 0.f;
    for (int w = 0; w < CW; ++w) gate += s.gpart[r * CW + w];
    float dgate = 0.f, dcd = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float c = s.cd[r * 3 + d];
      const float raw = c * gate;
      const float inside = (raw >= -100.f && raw <= 100.f) ? 1.f : 0.f;
      const float dtr = dfs[ai * 3 + d] * inside * v;
      dgate = fmaf(c, dtr, dgate);
      if (cx == d) dcd = gate * dtr;
    }
    if (cx < 3) s.rd[r * 3 + cx] = dcd;
    float4* x = reinterpret_cast<float4*>(X0 + r * LD + c0);
    const float4 gv = *x;
    const float g1[4] = {gv.x, gv.y, gv.z, gv.w};
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      g.pw4[u] = fmaf(g1[u], dgate, g.pw4[u]);
      const float d = (dgate * s.w4[c0 + u]) * dsilu(acc[i][u]);
      g.pb3[u] += d;
      o[u] = d;
    }
    *x = make_float4(o[0], o[1], o[2], o[3]);                    // dz3
  }
  __syncthreads();

  // -- dW3 += m2^T dz3; dm2 = (dz3 W3^T + dagg_i) valid; dz2 -> X2, db2
  if constexpr (resident(H))
    outer<H>(X1, X0, nr, ky, nx, g.dW3);
  else
    outer_slice<H>(X1, X0, nr, ky, nx, g.gW3);
  product_q<H, true, QM>(q, rg, X0, s.W3, ry, cx, acc);
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    const float v = s.valid[r];
    const float4 da = __ldg(reinterpret_cast<const float4*>(
        dagg + (size_t)s.ri[r] * H + c0));
    const float dav[4] = {da.x, da.y, da.z, da.w};
    float4* p2 = reinterpret_cast<float4*>(X2 + r * LD + c0);
    const float4 zv = *p2;
    const float z2[4] = {zv.x, zv.y, zv.z, zv.w};
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float d = ((acc[i][u] + dav[u]) * v) * dsilu(z2[u]);
      g.pb2[u] += d;
      o[u] = d;
    }
    *p2 = make_float4(o[0], o[1], o[2], o[3]);                   // dz2
  }
  __syncthreads();
  first_layer<H, QM, PROJ>(nf, s, at, q, ry, c0, X1);            // m1
  __syncthreads();

  // -- dW2 += m1^T dz2; dz1 = (dz2 W2^T) dsilu(z1) -> X0, dw1r and the
  //    row partial sums of dr2 = dz1 . w1r
  if constexpr (resident(H))
    outer<H>(X1, X2, nr, ky, nx, g.dW2);
  else
    outer_slice<H>(X1, X2, nr, ky, nx, g.gW2);
  product_q<H, true, QM>(q, rg, X2, s.W2, ry, cx, acc);
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    const float r2 = s.r2[r];
    float z[4], o[4], t = 0.f;
    z1_row<H, PROJ>(nf, s, at, r, c0, z);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float d = acc[i][u] * dsilu(z[u]);
      g.pw1r[u] = fmaf(r2, d, g.pw1r[u]);
      t = fmaf(d, s.w1r[c0 + u], t);
      o[u] = d;
    }
    *reinterpret_cast<float4*>(X0 + r * LD + c0) =
        make_float4(o[0], o[1], o[2], o[3]);                     // dz1
    t = lane_sum<8>(t);
    if ((p.lane & 7) == 0) s.gpart[r * CW + p.wc] = t;
  }
  __syncthreads();
  for (int r = p.tid; r < nr; r += NT) {
    float dr2 = 0.f;
    for (int w = 0; w < CW; ++w) dr2 += s.gpart[r * CW + w];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      s.rd[r * 3 + d] += 2.f * s.cd[r * 3 + d] * dr2;             // dcd
  }
  __syncthreads();
}

// The input-gradient backward's rows on two activation tiles (X0: m1, then
// m2, then dz3; X1: dsilu(z2), then dz2), each row's vector [dz1 W1a^T
// (nf), dcd (3), dz1 W1b^T (nf)] -> rd (row stride 2 nf + 3). SiLU and its
// derivative at z2 and z3 share one sigmoid. With PROJ (nf 0) the vector
// is dcd alone and dz1 goes to X0 (over dz3, whose reads are done) for the
// caller's H-wide sums. Ends with a barrier.
template <int H, bool PROJ = false, typename AfterM1>
__device__ __forceinline__ void bwd_in_rows(const Smem& s, const float* at,
                                            const float* dagg,
                                            const float* dfs, int nf, int nr,
                                            const Thr& p, Ring& rg,
                                            AfterM1&& after_m1) {
  constexpr int NT = 2 * H, CW = H / 32, LD = H + 4, QM = kQmaxBwdIn;
  const int q = (nr + 7) >> 3, ry = p.ry, cx = p.cx, c0 = p.c0;
  const int wc = p.wc, lane = p.lane;
  const int V = 2 * nf + 3, K1 = 2 * nf + 1;
  float acc[QM][4];
  float* X0 = s.X[0];
  float* X1 = s.X[1];

  // -- recompute the forward: m1 -> X0; z2 (acc), then dsilu(z2) -> X1
  //    and m2 -> X0 from one sigmoid
  first_layer<H, QM, PROJ>(nf, s, at, q, ry, c0, X0);
  after_m1();
  __syncthreads();
  product_q<H, false, QM>(q, rg, X0, s.W2, ry, cx, acc);
  __syncthreads();                                // every read of m1 done
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    const float v = s.valid[r];
    float d2[4], m2[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float z2 = acc[i][u] + s.b2[c0 + u], g = sig(z2);
      m2[u] = (z2 * g) * v;
      d2[u] = g * (1.0f + z2 * (1.0f - g));
    }
    *reinterpret_cast<float4*>(X1 + r * LD + c0) =
        make_float4(d2[0], d2[1], d2[2], d2[3]);
    *reinterpret_cast<float4*>(X0 + r * LD + c0) =
        make_float4(m2[0], m2[1], m2[2], m2[3]);
  }
  __syncthreads();

  // -- z3 and the gate's partial sums, dsilu(z3) (in acc) from the same
  //    sigmoid; then per row the force branch (clip mask -100 <= cd gate
  //    <= 100), dgate, the gate part of dcd and dz3 -> X0 (every read of
  //    m2 is done at the barrier)
  product_q<H, false, QM>(q, rg, X0, s.W3, ry, cx, acc);
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    float t = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float z3 = acc[i][u] + s.b3[c0 + u], g = sig(z3);
      t = fmaf(z3 * g, s.w4[c0 + u], t);
      acc[i][u] = g * (1.0f + z3 * (1.0f - g));
    }
    t = lane_sum<8>(t);
    if ((lane & 7) == 0) s.gpart[r * CW + wc] = t;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    const float v = s.valid[r];
    const int ai = s.ri[r];
    float gate = 0.f;
    for (int w = 0; w < CW; ++w) gate += s.gpart[r * CW + w];
    float dgate = 0.f, dcd = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float c = s.cd[r * 3 + d];
      const float raw = c * gate;
      const float inside = (raw >= -100.f && raw <= 100.f) ? 1.f : 0.f;
      const float dtr = dfs[ai * 3 + d] * inside * v;
      dgate = fmaf(c, dtr, dgate);
      if (cx == d) dcd = gate * dtr;
    }
    if (cx < 3) s.rd[r * V + nf + cx] = dcd;
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      o[u] = (dgate * s.w4[c0 + u]) * acc[i][u];
    *reinterpret_cast<float4*>(X0 + r * LD + c0) =
        make_float4(o[0], o[1], o[2], o[3]);                     // dz3
  }
  __syncthreads();

  // -- dm2 = (dz3 W3^T + dagg_i) valid; dz2 = dm2 dsilu(z2) -> X1
  //    (over the dsilu(z2) it holds)
  product_q<H, true, QM>(q, rg, X0, s.W3, ry, cx, acc);
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    const float v = s.valid[r];
    const float4 da = __ldg(reinterpret_cast<const float4*>(
        dagg + (size_t)s.ri[r] * H + c0));
    const float dav[4] = {da.x, da.y, da.z, da.w};
    float4* p2 = reinterpret_cast<float4*>(X1 + r * LD + c0);
    const float4 gv = *p2;
    const float ds2[4] = {gv.x, gv.y, gv.z, gv.w};
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      o[u] = ((acc[i][u] + dav[u]) * v) * ds2[u];
    *p2 = make_float4(o[0], o[1], o[2], o[3]);                   // dz2
  }
  __syncthreads();

  // -- dz1 = (dz2 W2^T) dsilu(z1), kept in registers: per row its dot
  //    with w1r (dr2) and the transposes dz1 W1a^T, dz1 W1b^T, each the
  //    thread's 4 columns summed over the 8 column lanes, one partial a
  //    column warp
  product_q<H, true, QM>(q, rg, X1, s.W2, ry, cx, acc);
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i >= q) break;
    const int r = ry + 8 * i;
    float z[4], d[4], t = 0.f;
    z1_row<H, PROJ>(nf, s, at, r, c0, z);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      d[u] = acc[i][u] * dsilu(z[u]);
      t = fmaf(d[u], s.w1r[c0 + u], t);
    }
    if constexpr (PROJ)
      *reinterpret_cast<float4*>(X0 + r * LD + c0) =
          make_float4(d[0], d[1], d[2], d[3]);                   // dz1
    float* gp = s.gpart + r * K1 * CW + wc;
    t = lane_sum<8>(t);
    if ((lane & 7) == 0) gp[0] = t;
    for (int k = 0; k < 2 * nf; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(
          (k < nf ? s.W1a + k * H : s.W1b + (k - nf) * H) + c0);
      float x = fmaf(d[3], w.w, fmaf(d[2], w.z, fmaf(d[1], w.y,
                     d[0] * w.x)));
      x = lane_sum<8>(x);
      if ((lane & 7) == 0) gp[(1 + k) * CW] = x;
    }
  }
  __syncthreads();
  for (int w = p.tid; w < nr * K1; w += NT) {
    const int r = w / K1, k = w - r * K1;
    const float* gp = s.gpart + w * CW;
    float t = 0.f;
    for (int c = 0; c < CW; ++c) t += gp[c];
    float* rv = s.rd + r * V;
    if (k == 0) {
#pragma unroll
      for (int d = 0; d < 3; ++d)
        rv[nf + d] += 2.f * s.cd[r * 3 + d] * t;                  // dcd
    } else {
      rv[k <= nf ? k - 1 : k + 2] = t;
    }
  }
  __syncthreads();
}

// The block's slice of the partials: dW2, dW3 (the resident widths) and
// the column sums written once with plain stores (the column sums over the 8 row lanes of each
// column, added in row-lane order in the X0 tile).
template <int H>
__device__ void write_slice(float* part, const PartLayout& L, const Smem& s,
                            const Thr& p, const ParamAcc<H>& g) {
  constexpr int NT = 2 * H, NG = H / 64;
  const int nx = p.tid % 16, ky = p.tid / 16;
  // (the streamed widths wrote dW2 and dW3 in place, outer_slice)
  if constexpr (resident(H)) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = 4 * ky + (q & 3) + (q >> 2) * (H / 2);
#pragma unroll
      for (int b = 0; b < NG; ++b) {
        const int n = 64 * b + 4 * nx;
        *reinterpret_cast<float4*>(part + L.dW2 + k * H + n) = make_float4(
            g.dW2[q][4 * b], g.dW2[q][4 * b + 1], g.dW2[q][4 * b + 2],
            g.dW2[q][4 * b + 3]);
        *reinterpret_cast<float4*>(part + L.dW3 + k * H + n) = make_float4(
            g.dW3[q][4 * b], g.dW3[q][4 * b + 1], g.dW3[q][4 * b + 2],
            g.dW3[q][4 * b + 3]);
      }
    }
  }
  float* red = s.X[0];
  const auto column_sums = [&](const float (&v)[4], int off) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u) red[p.ry * H + p.c0 + u] = v[u];
    __syncthreads();
    for (int c = p.tid; c < H; c += NT) {
      float t = 0.f;
      for (int y = 0; y < 8; ++y) t += red[y * H + c];
      part[off + c] = t;
    }
  };
  column_sums(g.pw4, L.dw4);
  column_sums(g.pb3, L.db3);
  column_sums(g.pb2, L.db2);
  column_sums(g.pw1r, L.dw1r);
}

// ---- the one-molecule kernels: persistent blocks over molecule tiles

template <int H>
__global__ void __launch_bounds__(2 * H, 1) egcl_f32_fwd_kernel(Args a) {
  constexpr int NT = 2 * H, LD = H + 4;
  extern __shared__ __align__(128) char smem_raw[];
  const int tid = threadIdx.x, N = a.N, nf = a.nf;
  Smem s;
  Bump m{smem_raw, 0};
  carve(m, s, N, nf, H, a.MT, a.R, kFwd);
  const Thr p = thread_place<H>();
  Ring rg{};                                  // unused: W2, W3 resident
  // the first tile's atoms and the small weights, then W2 and W3 (waited
  // for after the first layer, which needs neither)
  Cursor cur{(int)blockIdx.x, 0};
  int ab = 0;
  if (cur.tile < a.n_tiles) prefetch_atoms<H, false>(a, s, ab, cur.tile);
  load_small<H>(a, s);
  cp_async_commit();
  load_weights<H>(a, s);
  cp_async_commit();
  bool first = true;
  while (cur.tile < a.n_tiles) {
    const int b0 = cur.tile * a.MT, na = min(a.MT, a.B - b0) * N;
    const int rows = rows_of(a, cur.tile);
    const int g0 = cur.g0, nr = min(a.R, rows - g0);
    const Cursor nxt = advance(a, cur);
    const int more = nxt.tile < a.n_tiles;
    const bool new_atoms = more && nxt.tile != cur.tile;
    if (more) {
      if (new_atoms) prefetch_atoms<H, false>(a, s, ab ^ 1, nxt.tile);
      cp_async_commit();
    }
    cp_async_wait_n(first + more);
    __syncthreads();
    const float* at = s.stage(ab);
    if (g0 == 0) {
      for (int k = tid; k < na * H; k += NT) s.accH[k] = 0.f;
      for (int k = tid; k < na * 3; k += NT) s.acc3[k] = 0.f;
    }
    row_geometry(a, s, at, g0, nr);
    __syncthreads();
    fwd_rows<H>(
        s, at, nf, nr, p, rg,
        [&] {
          if (first) cp_async_wait_n(more);               // W2, W3
          first = false;
        },
        [&] { isum_rows(s.accH, H, s.X[1], LD, g0, nr, N, NT); });
    isum_rows(s.acc3, 3, s.rd, 3, g0, nr, N, NT);                   // fsum
    if (g0 + nr == rows) {
      __syncthreads();
      float* agg = a.agg + (size_t)b0 * N * H;
      float* fs = a.fsum + (size_t)b0 * N * 3;
      for (int k = tid; k < na * H; k += NT) agg[k] = s.accH[k];
      for (int k = tid; k < na * 3; k += NT) fs[k] = s.acc3[k];
    }
    __syncthreads();
    if (new_atoms) ab ^= 1;
    cur = nxt;
  }
}

template <int H>
__global__ void __launch_bounds__(2 * H, 1)
    egcl_f32_bwd_params_kernel(Args a) {
  constexpr int NT = 2 * H, LD = H + 4;
  extern __shared__ __align__(128) char smem_raw[];
  const int tid = threadIdx.x, N = a.N, nf = a.nf, MT = a.MT;
  Smem s;
  Bump m{smem_raw, 0};
  carve(m, s, N, nf, H, MT, a.R, kBwdParams);
  const Thr p = thread_place<H>();
  Ring rg{};                                  // unused: W2, W3 resident
  const PartLayout L(nf, H);
  float* const part = a.part + (size_t)blockIdx.x * L.P;
  // dW1a, dW1b and db1 are added into once a molecule tile, by the thread
  // that zeroes them here (item w: dW1a | dW1b for w < 2 nf H, then db1)
  const int n_w1 = 2 * nf * H;
  for (int w = tid; w < n_w1 + H; w += NT)
    part[w < n_w1 ? L.dW1a + w : L.db1 + w - n_w1] = 0.f;
  Cursor cur{(int)blockIdx.x, 0};
  int ab = 0;
  if (cur.tile < a.n_tiles) prefetch_atoms<H, true>(a, s, ab, cur.tile);
  load_small<H>(a, s);
  cp_async_commit();
  load_weights<H>(a, s);
  cp_async_commit();
  bool first = true;

  ParamAcc<H> g;
  zero_params<H>(g);
  float* const dz1i = s.accH;
  float* const dz1j = s.accH + MT * N * H;
  float* const dpi = s.acc3;
  float* const dpj = s.acc3 + MT * N * 3;

  while (cur.tile < a.n_tiles) {
    const int b0 = cur.tile * MT, na = min(MT, a.B - b0) * N;
    const int rows = rows_of(a, cur.tile);
    const int g0 = cur.g0, nr = min(a.R, rows - g0);
    const Cursor nxt = advance(a, cur);
    const int more = nxt.tile < a.n_tiles;
    const bool new_atoms = more && nxt.tile != cur.tile;
    if (more) {
      if (new_atoms) prefetch_atoms<H, true>(a, s, ab ^ 1, nxt.tile);
      cp_async_commit();
    }
    cp_async_wait_n(first + more);
    __syncthreads();
    const float* at = s.stage(ab);
    if (g0 == 0) {
      for (int k = tid; k < MT * N * H; k += NT) dz1i[k] = dz1j[k] = 0.f;
      for (int k = tid; k < MT * N * 3; k += NT) dpi[k] = dpj[k] = 0.f;
    }
    row_geometry(a, s, at, g0, nr);
    __syncthreads();
    bwd_params_rows<H>(s, at, a.dagg + (size_t)b0 * N * H, at + s.at_dfs,
                       nf, nr, p, rg, g, [&] {
                         if (first) cp_async_wait_n(more);  // W2, W3
                         first = false;
                       });

    // -- node sums, i side and j side, in a fixed order
    isum_rows(dz1i, H, s.X[0], LD, g0, nr, N, NT);
    jsum_rows(dz1j, H, s.X[0], LD, g0, nr, N, NT);
    isum_rows(dpi, 3, s.rd, 3, g0, nr, N, NT);
    jsum_rows(dpj, 3, s.rd, 3, g0, nr, N, NT);

    if (g0 + nr == rows) {
      // -- the molecule tile is done: dh = dz1_i W1a^T + dz1_j W1b^T and
      //    dpos; dW1a += h^T dz1_i, dW1b += h^T dz1_j, db1 += sum dz1_i
      __syncthreads();
      float* dh = a.dh + (size_t)b0 * N * nf;
      for (int it = tid; it < na * nf; it += NT) {
        const int l = it / nf, k = it - l * nf;
        float si = 0.f, sj = 0.f;
        for (int c = 0; c < H; ++c) {
          si = fmaf(dz1i[l * H + c], s.W1a[k * H + c], si);
          sj = fmaf(dz1j[l * H + c], s.W1b[k * H + c], sj);
        }
        dh[it] = si + sj;
      }
      float* dpos = a.dpos + (size_t)b0 * N * 3;
      for (int k = tid; k < na * 3; k += NT) dpos[k] = dpi[k] - dpj[k];
      for (int w = tid; w < n_w1 + H; w += NT) {
        float v = 0.f;
        if (w < n_w1) {
          const int side = w / (nf * H), kc = w - side * nf * H;
          const int k = kc / H, c = kc - k * H;
          const float* src = side ? dz1j : dz1i;
          for (int l = 0; l < na; ++l) v = fmaf(at[l * nf + k], src[l * H + c], v);
          part[L.dW1a + w] += v;
        } else {
          for (int l = 0; l < na; ++l) v += dz1i[l * H + w - n_w1];
          part[L.db1 + w - n_w1] += v;
        }
      }
    }
    __syncthreads();
    if (new_atoms) ab ^= 1;
    cur = nxt;
  }
  write_slice<H>(part, L, s, p, g);
}

// The input-gradient backward: dh and dpos only. The parameter-gradient
// kernel's rows, recompute and clip mask, without the outer products and
// the slice, and with dh's node sums taken per row after the first
// layer's transposes (see the top).
template <int H>
__global__ void __launch_bounds__(2 * H, 1) egcl_f32_bwd_kernel(Args a) {
  constexpr int NT = 2 * H;
  extern __shared__ __align__(128) char smem_raw[];
  const int tid = threadIdx.x, N = a.N, nf = a.nf, MT = a.MT;
  Smem s;
  Bump m{smem_raw, 0};
  carve(m, s, N, nf, H, MT, a.R, kBwd);
  const Thr p = thread_place<H>();
  Ring rg{};                                  // unused: W2, W3 resident
  // a row's vector: [dz1 W1a^T (nf), dcd (3), dz1 W1b^T (nf)]; the i side
  // sums its first nf + 3 columns, the j side its last nf + 3
  const int V = 2 * nf + 3, A = nf + 3;
  float* const si = s.accH;
  float* const sj = s.accH + MT * N * A;
  Cursor cur{(int)blockIdx.x, 0};
  int ab = 0;
  if (cur.tile < a.n_tiles) prefetch_atoms<H, true>(a, s, ab, cur.tile);
  load_small<H>(a, s);
  cp_async_commit();
  load_weights<H>(a, s);
  cp_async_commit();
  bool first = true;

  while (cur.tile < a.n_tiles) {
    const int b0 = cur.tile * MT, na = min(MT, a.B - b0) * N;
    const int rows = rows_of(a, cur.tile);
    const int g0 = cur.g0, nr = min(a.R, rows - g0);
    const Cursor nxt = advance(a, cur);
    const int more = nxt.tile < a.n_tiles;
    const bool new_atoms = more && nxt.tile != cur.tile;
    if (more) {
      if (new_atoms) prefetch_atoms<H, true>(a, s, ab ^ 1, nxt.tile);
      cp_async_commit();
    }
    cp_async_wait_n(first + more);
    __syncthreads();
    const float* at = s.stage(ab);
    if (g0 == 0)
      for (int k = tid; k < 2 * MT * N * A; k += NT) si[k] = 0.f;
    row_geometry(a, s, at, g0, nr);
    __syncthreads();
    bwd_in_rows<H>(s, at, a.dagg + (size_t)b0 * N * H, at + s.at_dfs, nf,
                   nr, p, rg, [&] {
                     if (first) cp_async_wait_n(more);      // W2, W3
                     first = false;
                   });

    // -- node sums, i side and j side, in a fixed order
    isum_rows(si, A, s.rd, V, g0, nr, N, NT);
    jsum_rows(sj, A, s.rd + nf, V, g0, nr, N, NT);

    if (g0 + nr == rows) {
      // -- the molecule tile is done: dh = sum_j dz1_ij W1a^T + sum_i
      //    dz1_ij W1b^T, dpos = dcd_i - dcd_j
      __syncthreads();
      float* dh = a.dh + (size_t)b0 * N * nf;
      for (int it = tid; it < na * nf; it += NT) {
        const int l = it / nf, k = it - l * nf;
        dh[it] = si[l * A + k] + sj[l * A + 3 + k];
      }
      float* dpos = a.dpos + (size_t)b0 * N * 3;
      for (int it = tid; it < na * 3; it += NT) {
        const int l = it / 3, d = it - l * 3;
        dpos[it] = si[l * A + nf + d] - sj[l * A + d];
      }
    }
    __syncthreads();
    if (new_atoms) ab ^= 1;
    cur = nxt;
  }
}

// ---- the block-pair kernels: molecules past one block's shared memory
//
// The unit of work is a (molecule, i-block) item: a block keeps the
// i-block's atoms and i-side sums in shared memory and walks the j-blocks
// in order, loading each one's atoms beside the i-block's and visiting the
// block pair's rows i != j in row tiles of R rows with the row code above
// (Pairs: i-major, j = i skipped on the diagonal block pair). The forward's
// sums are i-side only, so an item writes its atoms' agg and fsum itself.
// The backward's j-side sums of a block pair, as nf + 3 floats an atom
// ([dcd_j, dz1_j W1b^T]), go to their own row of the partials pj [B, nI,
// N, nf + 3]; an item's i-side sums ([dz1_i W1a^T, dcd_i]) to si [B, N,
// nf + 3]; egcl_f32_blocks_finish_kernel sums pj over the i-blocks in
// order and forms dh and dpos. With parameter gradients a block pair keeps
// its j-block's H-wide dz1 sums and adds h_j (x) them into the block's
// dW1b (then projects them to its partials); an item adds h_i (x) its
// i-side dz1 sums into dW1a and their sum into db1; dW2, dW3 and the
// column sums are the one-molecule kernel's. Every sum has one owner and a
// fixed order, no atomics: a second launch gives the same bits.

// A block pair's rows: ni i atoms against nj j atoms (ncol = nj, or nj - 1
// on the diagonal block pair, diag, where the blocks are one); row q < E
// = ni ncol is the pair (i, j), i = q / ncol, j the (q % ncol)-th j atom,
// skipping j = i where diag.
struct Pairs {
  int ncol, nj, E;
  bool diag;
};

__host__ __device__ inline Pairs pairs_of(int ni, int nj, bool diag) {
  const int ncol = nj - (diag ? 1 : 0);
  return Pairs{ncol, nj, ni * ncol, diag};
}

// Per row r < R of a block pair's row tile from row g0: its atoms in the
// staged atoms (the i atom at its place in the i-block, the j atom at A +
// its place in the j-block), the min-image cd (round half to even, as
// jnp.round), r2 and valid = mask_i mask_j; rows past nr are padding.
__device__ void pair_geometry(const Smem& s, const float* at, const Pairs& P,
                              int A, int R, int g0, int nr) {
  const int r = threadIdx.x;
  if (r >= R) return;
  if (r < nr) {
    const float* pos = at + s.at_pos;
    const float* mask = at + s.at_mask;
    const int g = g0 + r, i = g / P.ncol, jj = g - i * P.ncol;
    const int aj = A + jj + (P.diag && jj >= i);
    float r2 = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float c = pos[i * 3 + d] - pos[aj * 3 + d];
      const float bx = at[s.at_box + d];
      c = c - rintf(c / bx) * bx;
      s.cd[r * 3 + d] = c;
      r2 += c * c;
    }
    s.r2[r] = r2;
    s.valid[r] = mask[i] * mask[aj];
    s.ri[r] = i;
    s.rj[r] = aj;
  } else {
#pragma unroll
    for (int d = 0; d < 3; ++d) s.cd[r * 3 + d] = 0.f;
    s.r2[r] = 0.f;
    s.valid[r] = 0.f;
    s.ri[r] = 0;
    s.rj[r] = 0;
  }
}

// j-side sums of a block pair's row tile [g0, g0 + nr): for each of its nj
// j atoms the tile's rows (i, j) in row (i) order, one (atom, column) a
// thread: dst[j][c] += sum src[r][c].
__device__ __forceinline__ void jsum_pair(float* dst, int ncols,
                                          const float* src, int ld, int g0,
                                          int nr, const Pairs& P, int NT) {
  if (nr <= 0) return;
  const int i0 = g0 / P.ncol, i1 = (g0 + nr - 1) / P.ncol;
  for (int w = threadIdx.x; w < P.nj * ncols; w += NT) {
    const int l = w / ncols, c = w % ncols;
    float acc = 0.f;
    for (int i = i0; i <= i1; ++i) {
      if (P.diag && i == l) continue;
      const int g = i * P.ncol + l - (P.diag && l > i);
      if (g >= g0 && g < g0 + nr) acc += src[(g - g0) * ld + c];
    }
    dst[l * ncols + c] += acc;
  }
}

// Atoms a0 .. a0 + n - 1 of molecule b into the staged atoms from place at0
// (the i-block at 0, the j-block at A): h, pos and mask; with `side_i` also
// the molecule's box and (backward) the atoms' dfsum rows.
template <int H>
__device__ void load_block(const Args& a, const Smem& s, float* at, int b,
                           int a0, int n, int at0, bool side_i, bool bwd) {
  constexpr int NT = 2 * H;
  const int nf = a.nf;
  const size_t nb = (size_t)b * a.N + a0;
  for (int k = threadIdx.x; k < n * nf; k += NT)
    at[at0 * nf + k] = a.h[nb * nf + k];
  for (int k = threadIdx.x; k < n * 3; k += NT)
    at[s.at_pos + at0 * 3 + k] = a.pos[nb * 3 + k];
  for (int k = threadIdx.x; k < n; k += NT)
    at[s.at_mask + at0 + k] = a.mask[nb + k];
  if (!side_i) return;
  for (int k = threadIdx.x; k < 3; k += NT)
    at[s.at_box + k] = a.box[(size_t)b * 3 + k];
  if (bwd)
    for (int k = threadIdx.x; k < n * 3; k += NT)
      at[s.at_dfs + k] = a.dfsum[nb * 3 + k];
}

// The weights by cp.async, waited for (the block-pair kernels' prologue;
// at the streamed widths the small ones, W2 and W3 come through the ring).
template <int H>
__device__ void load_all_weights(const Args& a, const Smem& s) {
  load_small<H>(a, s);
  if constexpr (resident(H)) load_weights<H>(a, s);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Atoms a block of atoms k of a molecule holds (the last may be short).
__device__ __forceinline__ int block_len(int N, int A, int k) {
  return min(A, N - k * A);
}

template <int H, bool PROJ = false>
__global__ void __launch_bounds__(2 * H, 1)
    egcl_f32_blocks_fwd_kernel(Args a) {
  constexpr int NT = 2 * H, LD = H + 4;
  extern __shared__ __align__(128) char smem_raw[];
  const int tid = threadIdx.x, N = a.N, nf = a.nf, A = a.A, nI = a.nI;
  Smem s;
  Bump m{smem_raw, 0};
  carve_pairs(m, s, A, nf, H, a.R, kFwd, PROJ);
  s.jA = A;
  const Thr p = thread_place<H>();
  float* const at = s.stage(0);
  load_all_weights<H>(a, s);
  Ring rg = start_ring<H>(a, s, 2);
  const long long items = (long long)a.B * nI;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = (int)(it / nI), ib = (int)(it % nI);
    const int ni = block_len(N, A, ib);
    load_block<H>(a, s, at, b, ib * A, ni, 0, true, false);
    for (int k = tid; k < ni * H; k += NT) s.accH[k] = 0.f;
    for (int k = tid; k < ni * 3; k += NT) s.acc3[k] = 0.f;
    if constexpr (PROJ) s.pA = a.proj + ((size_t)b * N + ib * A) * 2 * H;
    for (int jb = 0; jb < nI; ++jb) {
      const int nj = block_len(N, A, jb);
      load_block<H>(a, s, at, b, jb * A, nj, A, false, false);
      if constexpr (PROJ)
        s.pB = a.proj + ((size_t)b * N + jb * A) * 2 * H + H;
      __syncthreads();
      const Pairs P = pairs_of(ni, nj, ib == jb);
      for (int g0 = 0; g0 < P.E; g0 += a.R) {
        const int nr = min(a.R, P.E - g0);
        pair_geometry(s, at, P, A, a.R, g0, nr);
        __syncthreads();
        fwd_rows<H, PROJ>(s, at, nf, nr, p, rg, [] {}, [&] {
          isum_rows(s.accH, H, s.X[1], LD, g0, nr, P.ncol + 1, NT);
        });
        isum_rows(s.acc3, 3, s.rd, 3, g0, nr, P.ncol + 1, NT);      // fsum
        __syncthreads();
      }
    }
    const size_t nb = (size_t)b * N + ib * A;
    for (int k = tid; k < ni * H; k += NT) a.agg[nb * H + k] = s.accH[k];
    for (int k = tid; k < ni * 3; k += NT) a.fsum[nb * 3 + k] = s.acc3[k];
    __syncthreads();
  }
  if constexpr (!resident(H)) cp_async_wait<0>();    // the slab issued ahead
}

// The input-gradient backward over block pairs: the i-side sums [ni, nf +
// 3] of an item and the j-side sums [nj, nf + 3] of each block pair, in
// the one-molecule kernel's row vectors.
template <int H>
__global__ void __launch_bounds__(2 * H, 1)
    egcl_f32_blocks_bwd_kernel(Args a) {
  constexpr int NT = 2 * H;
  extern __shared__ __align__(128) char smem_raw[];
  const int tid = threadIdx.x, N = a.N, nf = a.nf, A = a.A, nI = a.nI;
  Smem s;
  Bump m{smem_raw, 0};
  carve_pairs(m, s, A, nf, H, a.R, kBwd);
  const Thr p = thread_place<H>();
  const int V = 2 * nf + 3, A3 = nf + 3;
  float* const si = s.accH;
  float* const sj = s.accH + A * A3;
  float* const at = s.stage(0);
  load_all_weights<H>(a, s);
  Ring rg = start_ring<H>(a, s, 4);
  const long long items = (long long)a.B * nI;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = (int)(it / nI), ib = (int)(it % nI);
    const int ni = block_len(N, A, ib);
    const size_t ni0 = (size_t)b * N + ib * A;
    load_block<H>(a, s, at, b, ib * A, ni, 0, true, true);
    for (int k = tid; k < ni * A3; k += NT) si[k] = 0.f;
    for (int jb = 0; jb < nI; ++jb) {
      const int nj = block_len(N, A, jb);
      load_block<H>(a, s, at, b, jb * A, nj, A, false, true);
      for (int k = tid; k < nj * A3; k += NT) sj[k] = 0.f;
      __syncthreads();
      const Pairs P = pairs_of(ni, nj, ib == jb);
      for (int g0 = 0; g0 < P.E; g0 += a.R) {
        const int nr = min(a.R, P.E - g0);
        pair_geometry(s, at, P, A, a.R, g0, nr);
        __syncthreads();
        bwd_in_rows<H>(s, at, a.dagg + ni0 * H, at + s.at_dfs, nf, nr, p,
                       rg, [] {});
        isum_rows(si, A3, s.rd, V, g0, nr, P.ncol + 1, NT);
        jsum_pair(sj, A3, s.rd + nf, V, g0, nr, P, NT);
        __syncthreads();
      }
      // this block pair's j-side sums: row (b, ib) of the partials
      float* pj = a.pj + (((size_t)b * nI + ib) * N + jb * A) * A3;
      for (int k = tid; k < nj * A3; k += NT) pj[k] = sj[k];
      __syncthreads();
    }
    for (int k = tid; k < ni * A3; k += NT) a.si[ni0 * A3 + k] = si[k];
    __syncthreads();
  }
  if constexpr (!resident(H)) cp_async_wait<0>();    // the slab issued ahead
}

// The parameter-gradient backward over block pairs: the H-wide dz1 sums
// (i side an item, j side a block pair) and the dcd sums, projected to
// the input-gradient kernel's partials where their parameter gradients
// are taken.
template <int H>
__global__ void __launch_bounds__(2 * H, 1)
    egcl_f32_blocks_bwd_params_kernel(Args a) {
  constexpr int NT = 2 * H, LD = H + 4;
  extern __shared__ __align__(128) char smem_raw[];
  const int tid = threadIdx.x, N = a.N, nf = a.nf, A = a.A, nI = a.nI;
  Smem s;
  Bump m{smem_raw, 0};
  carve_pairs(m, s, A, nf, H, a.R, kBwdParams);
  const Thr p = thread_place<H>();
  const PartLayout L(nf, H);
  float* const part = a.part + (size_t)blockIdx.x * L.P;
  // dW1a (an item), dW1b (a block pair) and db1 (an item) are added into
  // by the thread that zeroes them here (item w as in the one-molecule
  // kernel: dW1a | dW1b for w < 2 nf H, then db1)
  const int n_w1 = 2 * nf * H, A3 = nf + 3;
  for (int w = tid; w < n_w1 + H; w += NT)
    part[w < n_w1 ? L.dW1a + w : L.db1 + w - n_w1] = 0.f;
  ParamAcc<H> g;
  zero_params<H>(g);
  if constexpr (!resident(H)) {
    // dW2, dW3 in the slice (outer_slice), each thread's elements zeroed
    // by it
    g.gW2 = part + L.dW2;
    g.gW3 = part + L.dW3;
    zero_slice<H>(tid / 16, tid % 16, g.gW2);
    zero_slice<H>(tid / 16, tid % 16, g.gW3);
  }
  float* const dz1i = s.accH;
  float* const dz1j = s.accH + A * H;
  float* const dpi = s.acc3;
  float* const dpj = s.acc3 + A * 3;
  float* const at = s.stage(0);
  load_all_weights<H>(a, s);
  Ring rg = start_ring<H>(a, s, 4);
  const long long items = (long long)a.B * nI;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = (int)(it / nI), ib = (int)(it % nI);
    const int ni = block_len(N, A, ib);
    const size_t ni0 = (size_t)b * N + ib * A;
    load_block<H>(a, s, at, b, ib * A, ni, 0, true, true);
    for (int k = tid; k < ni * H; k += NT) dz1i[k] = 0.f;
    for (int k = tid; k < ni * 3; k += NT) dpi[k] = 0.f;
    for (int jb = 0; jb < nI; ++jb) {
      const int nj = block_len(N, A, jb);
      load_block<H>(a, s, at, b, jb * A, nj, A, false, true);
      for (int k = tid; k < nj * H; k += NT) dz1j[k] = 0.f;
      for (int k = tid; k < nj * 3; k += NT) dpj[k] = 0.f;
      __syncthreads();
      const Pairs P = pairs_of(ni, nj, ib == jb);
      for (int g0 = 0; g0 < P.E; g0 += a.R) {
        const int nr = min(a.R, P.E - g0);
        pair_geometry(s, at, P, A, a.R, g0, nr);
        __syncthreads();
        bwd_params_rows<H>(s, at, a.dagg + ni0 * H, at + s.at_dfs, nf, nr,
                           p, rg, g, [] {});
        isum_rows(dz1i, H, s.X[0], LD, g0, nr, P.ncol + 1, NT);
        jsum_pair(dz1j, H, s.X[0], LD, g0, nr, P, NT);
        isum_rows(dpi, 3, s.rd, 3, g0, nr, P.ncol + 1, NT);
        jsum_pair(dpj, 3, s.rd, 3, g0, nr, P, NT);
        __syncthreads();
      }
      // -- the block pair is done: dW1b += h_j^T dz1_j; its partials
      //    [dcd_j, dz1_j W1b^T]
      const float* hj = at + A * nf;
      for (int w = tid; w < n_w1 + H; w += NT) {
        if (w < nf * H || w >= n_w1) continue;
        const int kc = w - nf * H, k = kc / H, c = kc - k * H;
        float v = 0.f;
        for (int l = 0; l < nj; ++l) v = fmaf(hj[l * nf + k], dz1j[l * H + c], v);
        part[L.dW1a + w] += v;
      }
      float* pj = a.pj + (((size_t)b * nI + ib) * N + jb * A) * A3;
      for (int w = tid; w < nj * A3; w += NT) {
        const int l = w / A3, v = w - l * A3;
        float x = 0.f;
        if (v < 3) {
          x = dpj[l * 3 + v];
        } else {
          for (int c = 0; c < H; ++c)
            x = fmaf(dz1j[l * H + c], s.W1b[(v - 3) * H + c], x);
        }
        pj[w] = x;
      }
      __syncthreads();
    }
    // -- the item is done: dW1a += h_i^T dz1_i, db1 += sum dz1_i; its
    //    i-side sums [dz1_i W1a^T, dcd_i]
    for (int w = tid; w < n_w1 + H; w += NT) {
      if (w >= nf * H && w < n_w1) continue;
      float v = 0.f;
      if (w < n_w1) {
        const int k = w / H, c = w - k * H;
        for (int l = 0; l < ni; ++l) v = fmaf(at[l * nf + k], dz1i[l * H + c], v);
        part[L.dW1a + w] += v;
      } else {
        for (int l = 0; l < ni; ++l) v += dz1i[l * H + w - n_w1];
        part[L.db1 + w - n_w1] += v;
      }
    }
    for (int w = tid; w < ni * A3; w += NT) {
      const int l = w / A3, v = w - l * A3;
      float x = 0.f;
      if (v < nf) {
        for (int c = 0; c < H; ++c)
          x = fmaf(dz1i[l * H + c], s.W1a[v * H + c], x);
      } else {
        x = dpi[l * 3 + v - nf];
      }
      a.si[ni0 * A3 + w] = x;
    }
    __syncthreads();
  }
  if constexpr (!resident(H)) cp_async_wait<0>();    // the slab issued ahead
  write_slice<H>(part, L, s, p, g);
}

// The wide_nf route's backward over block pairs (PROJ, nf 0), with or
// without parameter gradients: the rows of bwd_params_rows or bwd_in_rows
// leave each row's dz1 in X0 and its dcd in rd; the i-side sums of an item
// and the j-side sums of each block pair are H-wide dz1 sums and dcd sums,
// written as rows [dz1 (H), dcd (3), 0] of si and of pj (row (b, ib)).
// With PARAMS dW2, dW3 and the column sums are K2 p's, db1 = sum of the
// i-side dz1 sums an item, and the slice has no dW1a / dW1b (PartLayout at
// nf 0; egcl_nf_dw1_kernel forms them).
template <int H, bool PARAMS>
__global__ void __launch_bounds__(2 * H, 1)
    egcl_f32_wide_nf_bwd_kernel(Args a) {
  constexpr int NT = 2 * H, LD = H + 4, C = H + 4;
  extern __shared__ __align__(128) char smem_raw[];
  const int tid = threadIdx.x, N = a.N, A = a.A, nI = a.nI;
  Smem s;
  Bump m{smem_raw, 0};
  carve_pairs(m, s, A, 0, H, a.R, PARAMS ? kBwdParams : kBwd, true);
  s.jA = A;
  const Thr p = thread_place<H>();
  const PartLayout L(0, H);
  float* const part = PARAMS ? a.part + (size_t)blockIdx.x * L.P : nullptr;
  ParamAcc<H> g;
  zero_params<H>(g);
  if constexpr (PARAMS) {
    // db1 is added into an item at a time by the thread that zeroes it
    for (int c = tid; c < H; c += NT) part[L.db1 + c] = 0.f;
    if constexpr (!resident(H)) {
      g.gW2 = part + L.dW2;
      g.gW3 = part + L.dW3;
      zero_slice<H>(tid / 16, tid % 16, g.gW2);
      zero_slice<H>(tid / 16, tid % 16, g.gW3);
    }
  }
  float* const dz1i = s.accH;
  float* const dz1j = s.accH + A * H;
  float* const dpi = s.acc3;
  float* const dpj = s.acc3 + A * 3;
  float* const at = s.stage(0);
  load_all_weights<H>(a, s);
  Ring rg = start_ring<H>(a, s, 4);
  // a row [dz1 (H), dcd (3), 0] from the sums of atom l
  const auto row_of = [&](const float* dz1, const float* dp, int l, int c) {
    return c < H ? dz1[l * H + c] : c < H + 3 ? dp[l * 3 + c - H] : 0.f;
  };
  const long long items = (long long)a.B * nI;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = (int)(it / nI), ib = (int)(it % nI);
    const int ni = block_len(N, A, ib);
    const size_t ni0 = (size_t)b * N + ib * A;
    load_block<H>(a, s, at, b, ib * A, ni, 0, true, true);
    for (int k = tid; k < ni * H; k += NT) dz1i[k] = 0.f;
    for (int k = tid; k < ni * 3; k += NT) dpi[k] = 0.f;
    s.pA = a.proj + ni0 * 2 * H;
    for (int jb = 0; jb < nI; ++jb) {
      const int nj = block_len(N, A, jb);
      load_block<H>(a, s, at, b, jb * A, nj, A, false, true);
      for (int k = tid; k < nj * H; k += NT) dz1j[k] = 0.f;
      for (int k = tid; k < nj * 3; k += NT) dpj[k] = 0.f;
      s.pB = a.proj + ((size_t)b * N + jb * A) * 2 * H + H;
      __syncthreads();
      const Pairs P = pairs_of(ni, nj, ib == jb);
      for (int g0 = 0; g0 < P.E; g0 += a.R) {
        const int nr = min(a.R, P.E - g0);
        pair_geometry(s, at, P, A, a.R, g0, nr);
        __syncthreads();
        if constexpr (PARAMS)
          bwd_params_rows<H, true>(s, at, a.dagg + ni0 * H, at + s.at_dfs, 0,
                                   nr, p, rg, g, [] {});
        else
          bwd_in_rows<H, true>(s, at, a.dagg + ni0 * H, at + s.at_dfs, 0, nr,
                               p, rg, [] {});
        isum_rows(dz1i, H, s.X[0], LD, g0, nr, P.ncol + 1, NT);
        jsum_pair(dz1j, H, s.X[0], LD, g0, nr, P, NT);
        isum_rows(dpi, 3, s.rd, 3, g0, nr, P.ncol + 1, NT);
        jsum_pair(dpj, 3, s.rd, 3, g0, nr, P, NT);
        __syncthreads();
      }
      // this block pair's j-side sums: row (b, ib) of the partials
      float* pj = a.pj + (((size_t)b * nI + ib) * N + jb * A) * C;
      for (int w = tid; w < nj * C; w += NT)
        pj[w] = row_of(dz1j, dpj, w / C, w % C);
      __syncthreads();
    }
    for (int w = tid; w < ni * C; w += NT)
      a.si[ni0 * C + w] = row_of(dz1i, dpi, w / C, w % C);
    if constexpr (PARAMS)
      for (int c = tid; c < H; c += NT) {
        float v = 0.f;
        for (int l = 0; l < ni; ++l) v += dz1i[l * H + c];
        part[L.db1 + c] += v;
      }
    __syncthreads();
  }
  if constexpr (!resident(H)) cp_async_wait<0>();    // the slab issued ahead
  if constexpr (PARAMS) write_slice<H>(part, L, s, p, g);
}

// The block-pair backward's dh and dpos, one thread an atom: the j-side
// partials summed over the i-blocks in order, dh = si[:nf] + sj[3:], dpos
// = si[nf:] - sj[:3].
constexpr int kFinishThreads = 256;

__global__ void __launch_bounds__(kFinishThreads)
    egcl_f32_blocks_finish_kernel(Args a) {
  const int nf = a.nf, N = a.N, nI = a.nI, A3 = nf + 3;
  const long long rows = (long long)a.B * N;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < rows; row += (long long)gridDim.x * blockDim.x) {
    const long long b = row / N, l = row - b * N;
    const float* si = a.si + row * A3;
    const float* pj = a.pj + (b * nI * N + l) * A3;   // block ib: + ib N A3
    for (int v = 0; v < A3; ++v) {
      float x = 0.f;
      for (int ib = 0; ib < nI; ++ib) x += pj[(size_t)ib * N * A3 + v];
      if (v < 3)
        a.dpos[row * 3 + v] = si[nf + v] - x;
      else
        a.dh[row * nf + v - 3] = si[v - 3] + x;
    }
  }
}

// The row tiles every kernel takes: R rows, a multiple of 8, at most its
// kind's register tile.
bool takes_rows(int nf, int R, int kind) {
  const int qmax = kind == kFwd ? kQmaxFwd
                   : kind == kBwd ? kQmaxBwdIn : kQmaxBwd;
  return kind >= kFwd && kind <= kBwdParams && nf >= 1 && R >= 8 &&
         R % 8 == 0 && R <= 8 * qmax;
}

bool takes(int N, int nf, int H, int MT, int R, int kind) {
  return takes_rows(nf, R, kind) && resident(H) && N >= 1 && MT >= 1;
}

size_t smem_bytes(int N, int nf, int H, int MT, int R, int kind) {
  Smem s;
  Bump m{nullptr, 0};
  carve(m, s, N, nf, H, MT, R, kind);
  return m.off;
}

template <int H>
int launch(const Args& a, int kind, int blocks, cudaStream_t stream) {
  // the attribute once per kernel: every launch stays under kMaxSmem
  static bool ready[3] = {false, false, false};
  void (*kernel)(Args) = kind == kFwd   ? egcl_f32_fwd_kernel<H>
                         : kind == kBwd ? egcl_f32_bwd_kernel<H>
                                        : egcl_f32_bwd_params_kernel<H>;
  if (!ready[kind]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    ready[kind] = true;
  }
  const size_t smem = smem_bytes(a.N, a.nf, H, a.MT, a.R, kind);
  kernel<<<blocks, 2 * H, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The block-pair kernels take A >= 1 atoms a block and the one-molecule
// kernels' row tiles, at the resident widths and the streamed ones.
bool takes_pairs(int A, int nf, int H, int R, int kind) {
  return takes_rows(nf, R, kind) && A >= 1 &&
         (resident(H) || H == 192 || H == 256);
}

size_t pairs_smem_bytes(int A, int nf, int H, int R, int kind) {
  Smem s;
  Bump m{nullptr, 0};
  carve_pairs(m, s, A, nf, H, R, kind);
  return m.off;
}

// A block-pair launch: min(blocks, B nI) blocks over the B nI items; the
// backward's finish kernel after it on the same stream.
template <int H>
int launch_pairs(const Args& a, int kind, int blocks, cudaStream_t stream) {
  static bool ready[3] = {false, false, false};
  void (*kernel)(Args) = kind == kFwd   ? egcl_f32_blocks_fwd_kernel<H>
                         : kind == kBwd ? egcl_f32_blocks_bwd_kernel<H>
                                        : egcl_f32_blocks_bwd_params_kernel<H>;
  if (!ready[kind]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    ready[kind] = true;
  }
  const size_t smem = pairs_smem_bytes(a.A, a.nf, H, a.R, kind);
  kernel<<<blocks, 2 * H, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || kind == kFwd) return (int)err;
  const long long rows = (long long)a.B * a.N;
  const long long grid = std::min<long long>(
      (rows + kFinishThreads - 1) / kFinishThreads, 16LL * blocks);
  egcl_f32_blocks_finish_kernel<<<(int)grid, kFinishThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch_pairs(Args& a, int kind, int blocks, void* stream) {
  if (!takes_pairs(a.A, a.nf, a.H, a.R, kind) || a.B < 1 || a.N < 1 ||
      blocks < 1 ||
      pairs_smem_bytes(a.A, a.nf, a.H, a.R, kind) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  a.nI = (a.N + a.A - 1) / a.A;
  blocks = (int)std::min<long long>(blocks, (long long)a.B * a.nI);
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.H) {
    case 64: return launch_pairs<64>(a, kind, blocks, st);
    case 128: return launch_pairs<128>(a, kind, blocks, st);
    case 192: return launch_pairs<192>(a, kind, blocks, st);
    default: return launch_pairs<256>(a, kind, blocks, st);
  }
}

// The wide_nf route's block pairs: nf 0, the projections read per row.
bool takes_wide_nf(int A, int H, int R, int kind) {
  return takes_rows(1, R, kind) && A >= 1 &&
         (resident(H) || H == 192 || H == 256);
}

size_t wide_nf_smem_bytes(int A, int H, int R, int kind) {
  Smem s;
  Bump m{nullptr, 0};
  carve_pairs(m, s, A, 0, H, R, kind, true);
  return m.off;
}

// A wide_nf launch (a.nf the caller's): the projections, the block pairs
// at nf 0, and for the backward egcl_wide_nf.cuh's sums, dh and (with
// parameter gradients) dW1's partials, all on one stream.
template <int H>
int launch_wide_nf(const Args& a, int kind, int blocks, cudaStream_t stream) {
  static bool ready[3] = {false, false, false};
  void (*kernel)(Args) = kind == kFwd   ? egcl_f32_blocks_fwd_kernel<H, true>
                         : kind == kBwd ? egcl_f32_wide_nf_bwd_kernel<H, false>
                                        : egcl_f32_wide_nf_bwd_kernel<H, true>;
  if (!ready[kind]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    ready[kind] = true;
  }
  cudaError_t err = wide_nf::launch_proj<float>(
      a.B * a.N, a.nf, H, a.h, a.W1a, a.W1b, (float*)a.proj, stream);
  if (err != cudaSuccess) return (int)err;
  Args p = a;
  p.nf = 0;
  kernel<<<blocks, 2 * H, wide_nf_smem_bytes(a.A, H, a.R, kind), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || kind == kFwd) return (int)err;
  return (int)wide_nf::launch_first_layer_bwd<float>(
      a.B, a.N, a.nI, a.nf, H, blocks, a.h, a.W1a, a.W1b, a.si, a.pj, a.sj,
      a.dpos, a.dh, kind == kBwdParams ? a.dw1 : nullptr, a.splits, stream);
}

int dispatch_wide_nf(Args& a, int kind, int blocks, void* stream) {
  if (!takes_wide_nf(a.A, a.H, a.R, kind) || a.B < 1 || a.N < 1 ||
      a.nf < 1 || blocks < 1 || (kind == kBwdParams && a.splits < 1) ||
      wide_nf_smem_bytes(a.A, a.H, a.R, kind) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  a.nI = (a.N + a.A - 1) / a.A;
  blocks = (int)std::min<long long>(blocks, (long long)a.B * a.nI);
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.H) {
    case 64: return launch_wide_nf<64>(a, kind, blocks, st);
    case 128: return launch_wide_nf<128>(a, kind, blocks, st);
    case 192: return launch_wide_nf<192>(a, kind, blocks, st);
    default: return launch_wide_nf<256>(a, kind, blocks, st);
  }
}

int dispatch(Args& a, int kind, int blocks, void* stream) {
  if (!takes(a.N, a.nf, a.H, a.MT, a.R, kind) || a.B < 1 || blocks < 1 ||
      smem_bytes(a.N, a.nf, a.H, a.MT, a.R, kind) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  a.n_tiles = (a.B + a.MT - 1) / a.MT;
  blocks = min(blocks, a.n_tiles);
  cudaStream_t st = (cudaStream_t)stream;
  return a.H == 64 ? launch<64>(a, kind, blocks, st)
                   : launch<128>(a, kind, blocks, st);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at MT molecules a tile and R rows a
// row tile, or -1 for sizes the kernels do not take. kind: 0 the forward,
// 1 the input-gradient backward, 2 the backward with parameter gradients.
// A launch needs at most egcl_f32_smem_limit() bytes.
long long egcl_f32_smem_bytes(int N, int nf, int H, int MT, int R,
                              int kind) {
  if (!takes(N, nf, H, MT, R, kind)) return -1;
  return (long long)smem_bytes(N, nf, H, MT, R, kind);
}

long long egcl_f32_smem_limit() { return (long long)kMaxSmem; }

// Every tensor float32. Molecules are taken in tiles of MT, tiles spread
// over min(blocks, ceil(B / MT)) blocks, each tile's rows in row tiles of
// R. Returns the cudaError_t of the launch (0 on success).
int egcl_f32_fwd(int B, int N, int nf, int H, int MT, int R, int blocks,
                 const void* h, const void* pos, const void* box,
                 const void* mask, const void* W1a, const void* W1b,
                 const void* w1r, const void* b1, const void* W2,
                 const void* b2, const void* W3, const void* b3,
                 const void* w4, void* agg, void* fsum, void* stream) {
  Args a{B, N, nf, H, MT, R, 0, (const float*)h, (const float*)pos,
         (const float*)box, (const float*)mask, (const float*)W1a,
         (const float*)W1b, (const float*)w1r, (const float*)b1,
         (const float*)W2, (const float*)b2, (const float*)W3,
         (const float*)b3, (const float*)w4, nullptr, nullptr,
         (float*)agg, (float*)fsum, nullptr, nullptr, nullptr};
  return dispatch(a, kFwd, blocks, stream);
}

// The input-gradient backward: dh [B, N, nf] and dpos [B, N, 3].
int egcl_f32_bwd(int B, int N, int nf, int H, int MT, int R, int blocks,
                 const void* h, const void* pos, const void* box,
                 const void* mask, const void* W1a, const void* W1b,
                 const void* w1r, const void* b1, const void* W2,
                 const void* b2, const void* W3, const void* b3,
                 const void* w4, const void* dagg, const void* dfsum,
                 void* dh, void* dpos, void* stream) {
  Args a{B, N, nf, H, MT, R, 0, (const float*)h, (const float*)pos,
         (const float*)box, (const float*)mask, (const float*)W1a,
         (const float*)W1b, (const float*)w1r, (const float*)b1,
         (const float*)W2, (const float*)b2, (const float*)W3,
         (const float*)b3, (const float*)w4, (const float*)dagg,
         (const float*)dfsum, nullptr, nullptr, (float*)dh, (float*)dpos,
         nullptr};
  return dispatch(a, kBwd, blocks, stream);
}

// The backward with parameter gradients: part is a [min(blocks,
// ceil(B / MT)), P] float32 buffer (P = egcl_part_size); each block writes
// every element of its row's nine gradients (no zeroing needed), and the
// caller sums the rows.
int egcl_f32_bwd_params(int B, int N, int nf, int H, int MT, int R,
                        int blocks, const void* h, const void* pos,
                        const void* box, const void* mask, const void* W1a,
                        const void* W1b, const void* w1r, const void* b1,
                        const void* W2, const void* b2, const void* W3,
                        const void* b3, const void* w4, const void* dagg,
                        const void* dfsum, void* dh, void* dpos, void* part,
                        void* stream) {
  Args a{B, N, nf, H, MT, R, 0, (const float*)h, (const float*)pos,
         (const float*)box, (const float*)mask, (const float*)W1a,
         (const float*)W1b, (const float*)w1r, (const float*)b1,
         (const float*)W2, (const float*)b2, (const float*)W3,
         (const float*)b3, (const float*)w4, (const float*)dagg,
         (const float*)dfsum, nullptr, nullptr, (float*)dh, (float*)dpos,
         (float*)part};
  return dispatch(a, kBwdParams, blocks, stream);
}

// The block-pair kernels (molecules past the one-molecule kernels' shared
// memory at H = 64 or 128; every molecule at H = 192 or 256, W2 and W3
// streamed): dynamic shared memory of one block at A atoms a block and R
// rows a row tile, or -1 for sizes they do not take (kind as above).
long long egcl_f32_blocks_smem_bytes(int A, int nf, int H, int R, int kind) {
  if (!takes_pairs(A, nf, H, R, kind)) return -1;
  return (long long)pairs_smem_bytes(A, nf, H, R, kind);
}

// Blocks of A atoms (nI = ceil(N / A) a molecule), the B nI (molecule,
// i-block) items over min(blocks, B nI) blocks, row tiles of R rows.
int egcl_f32_blocks_fwd(int B, int N, int nf, int H, int A, int R, int blocks,
                        const void* h, const void* pos, const void* box,
                        const void* mask, const void* W1a, const void* W1b,
                        const void* w1r, const void* b1, const void* W2,
                        const void* b2, const void* W3, const void* b3,
                        const void* w4, void* agg, void* fsum, void* stream) {
  Args a{B, N, nf, H, 1, R, 0, (const float*)h, (const float*)pos,
         (const float*)box, (const float*)mask, (const float*)W1a,
         (const float*)W1b, (const float*)w1r, (const float*)b1,
         (const float*)W2, (const float*)b2, (const float*)W3,
         (const float*)b3, (const float*)w4, nullptr, nullptr,
         (float*)agg, (float*)fsum, nullptr, nullptr, nullptr,
         A, 0, nullptr, nullptr};
  return dispatch_pairs(a, kFwd, blocks, stream);
}

// The input-gradient backward: dh [B, N, nf] and dpos [B, N, 3]; si [B, N,
// nf + 3] and pj [B, nI, N, nf + 3] float32 scratch, every element written
// by the kernels.
int egcl_f32_blocks_bwd(int B, int N, int nf, int H, int A, int R, int blocks,
                        const void* h, const void* pos, const void* box,
                        const void* mask, const void* W1a, const void* W1b,
                        const void* w1r, const void* b1, const void* W2,
                        const void* b2, const void* W3, const void* b3,
                        const void* w4, const void* dagg, const void* dfsum,
                        void* dh, void* dpos, void* si, void* pj,
                        void* stream) {
  Args a{B, N, nf, H, 1, R, 0, (const float*)h, (const float*)pos,
         (const float*)box, (const float*)mask, (const float*)W1a,
         (const float*)W1b, (const float*)w1r, (const float*)b1,
         (const float*)W2, (const float*)b2, (const float*)W3,
         (const float*)b3, (const float*)w4, (const float*)dagg,
         (const float*)dfsum, nullptr, nullptr, (float*)dh, (float*)dpos,
         nullptr, A, 0, (float*)si, (float*)pj};
  return dispatch_pairs(a, kBwd, blocks, stream);
}

// The backward with parameter gradients: as egcl_f32_blocks_bwd, and part
// a [min(blocks, B nI), P] float32 buffer, each row written whole by its
// block; the caller sums the rows.
int egcl_f32_blocks_bwd_params(int B, int N, int nf, int H, int A, int R,
                               int blocks, const void* h, const void* pos,
                               const void* box, const void* mask,
                               const void* W1a, const void* W1b,
                               const void* w1r, const void* b1,
                               const void* W2, const void* b2,
                               const void* W3, const void* b3,
                               const void* w4, const void* dagg,
                               const void* dfsum, void* dh, void* dpos,
                               void* si, void* pj, void* part,
                               void* stream) {
  Args a{B, N, nf, H, 1, R, 0, (const float*)h, (const float*)pos,
         (const float*)box, (const float*)mask, (const float*)W1a,
         (const float*)W1b, (const float*)w1r, (const float*)b1,
         (const float*)W2, (const float*)b2, (const float*)W3,
         (const float*)b3, (const float*)w4, (const float*)dagg,
         (const float*)dfsum, nullptr, nullptr, (float*)dh, (float*)dpos,
         (float*)part, A, 0, (float*)si, (float*)pj};
  return dispatch_pairs(a, kBwdParams, blocks, stream);
}

// ---- the wide_nf route (any nf; egcl_wide_nf.cuh): the block pairs with
// the first layer's projections precomputed

// Dynamic shared memory of one block-pair block at A atoms a block and R
// rows a row tile with PROJ (nothing in it grows with nf), or -1 for sizes
// the kernels do not take.
long long egcl_f32_wide_nf_smem_bytes(int A, int H, int R, int kind) {
  if (!takes_wide_nf(A, H, R, kind)) return -1;
  return (long long)wide_nf_smem_bytes(A, H, R, kind);
}

// dW1's row splits of a launch (rows = B N atoms; blocks as the launch's):
// the first dimension of its dw1 buffer [splits, 2, nf, H].
int egcl_f32_wide_nf_splits(int rows, int nf, int H, int blocks) {
  return wide_nf::dw1_splits(rows, nf, H, blocks);
}

// The contract of egcl_f32_blocks_fwd / _bwd / _bwd_params at any nf, with
// float32 scratch that the kernels fill themselves: proj [B, N, 2H], si
// [B, N, H+4], pj [B, nI, N, H+4], sj [B, N, H]; with parameter gradients
// dw1 [splits, 2, nf, H] (summed by the caller beside part's [min(blocks,
// B nI), egcl_part_size(0, H)] rows: dW1a and dW1b are not in them).
int egcl_f32_wide_nf_fwd(int B, int N, int nf, int H, int A, int R,
                         int blocks, const void* h, const void* pos,
                         const void* box, const void* mask, const void* W1a,
                         const void* W1b, const void* w1r, const void* b1,
                         const void* W2, const void* b2, const void* W3,
                         const void* b3, const void* w4, void* proj,
                         void* agg, void* fsum, void* stream) {
  Args a{B, N, nf, H, 1, R, 0, (const float*)h, (const float*)pos,
         (const float*)box, (const float*)mask, (const float*)W1a,
         (const float*)W1b, (const float*)w1r, (const float*)b1,
         (const float*)W2, (const float*)b2, (const float*)W3,
         (const float*)b3, (const float*)w4, nullptr, nullptr,
         (float*)agg, (float*)fsum, nullptr, nullptr, nullptr,
         A, 0, nullptr, nullptr, (const float*)proj};
  return dispatch_wide_nf(a, kFwd, blocks, stream);
}

int egcl_f32_wide_nf_bwd(int B, int N, int nf, int H, int A, int R,
                         int blocks, const void* h, const void* pos,
                         const void* box, const void* mask, const void* W1a,
                         const void* W1b, const void* w1r, const void* b1,
                         const void* W2, const void* b2, const void* W3,
                         const void* b3, const void* w4, const void* dagg,
                         const void* dfsum, void* proj, void* dh, void* dpos,
                         void* si, void* pj, void* sj, void* stream) {
  Args a{B, N, nf, H, 1, R, 0, (const float*)h, (const float*)pos,
         (const float*)box, (const float*)mask, (const float*)W1a,
         (const float*)W1b, (const float*)w1r, (const float*)b1,
         (const float*)W2, (const float*)b2, (const float*)W3,
         (const float*)b3, (const float*)w4, (const float*)dagg,
         (const float*)dfsum, nullptr, nullptr, (float*)dh, (float*)dpos,
         nullptr, A, 0, (float*)si, (float*)pj, (const float*)proj,
         (float*)sj};
  return dispatch_wide_nf(a, kBwd, blocks, stream);
}

int egcl_f32_wide_nf_bwd_params(int B, int N, int nf, int H, int A, int R,
                                int blocks, int splits, const void* h,
                                const void* pos, const void* box,
                                const void* mask, const void* W1a,
                                const void* W1b, const void* w1r,
                                const void* b1, const void* W2,
                                const void* b2, const void* W3,
                                const void* b3, const void* w4,
                                const void* dagg, const void* dfsum,
                                void* proj, void* dh, void* dpos, void* si,
                                void* pj, void* sj, void* dw1, void* part,
                                void* stream) {
  Args a{B, N, nf, H, 1, R, 0, (const float*)h, (const float*)pos,
         (const float*)box, (const float*)mask, (const float*)W1a,
         (const float*)W1b, (const float*)w1r, (const float*)b1,
         (const float*)W2, (const float*)b2, (const float*)W3,
         (const float*)b3, (const float*)w4, (const float*)dagg,
         (const float*)dfsum, nullptr, nullptr, (float*)dh, (float*)dpos,
         (float*)part, A, 0, (float*)si, (float*)pj, (const float*)proj,
         (float*)sj, (float*)dw1, splits};
  return dispatch_wide_nf(a, kBwdParams, blocks, stream);
}

const char* egcl_f32_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
