// Blockwise Lennard-Jones pair energy and its analytic gradient in one pass,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of enflow_tpu/ops/pairwise_kernel.py
// (_run_kernel / _kernel under the custom VJP _pair_energy) and computes the
// same contract over ordered pairs (i, j) of one molecule, halved:
//   E_b        = 0.5 * sum_{i,j valid} e(d2_ij)
//   dE/dx_i    = sum_{j valid} e'(d2_ij) * 2 * d_ij
// Form r2 (the NLL term):  e = 4((d2+s)^-6 - (d2+s)^-3), raw displacements.
// Form r  (the MD potential): e = 4((s+r)^-12 - (s+r)^-6), min-image
//   displacements (round half to even, as jnp.round), d2 < cutoff^2.
// valid = mask_i * mask_j * (d2 > 0) [* (d2 < cutoff^2)]; an invalid pair is
// evaluated at d2 := 1 and dropped, as the TPU kernel guards it. Form r
// takes a flag, `coincident`: with it and softening > 0, a pair of distinct
// real atoms at d2 = 0 inside the cutoff is counted too, at its finite
// energy 4(s^-12 - s^-6) and with a zero gradient, as the JAX package's
// dense MD potential counts it (enflow_tpu/sim/potentials.py). Without it
// (the TPU kernel's contract) such pairs are left out.
//
// What bounds it on this card: per valid ordered pair ~25 (r2) to ~40 (r)
// f32 operations on 16 bytes of positions and mask that are read once per
// column tile. At the training shapes (B=30 molecules of N=13, or one
// molecule of 13 in the MD) the whole call is a few microseconds of work and
// is bound by the launch itself; at N in the thousands it is bound by f32
// arithmetic (67 TFLOP/s), never by bytes.
//
// Design: a block is one (molecule, row tile of kTile atoms); each thread
// owns one row atom and walks the molecule's column tiles, which the block
// stages in shared memory, accumulating its energy and gradient in
// registers. The block's energy is reduced in a fixed order and written to
// e_part[b, tile]; the wrapper sums the tiles afterwards (deterministic, no
// atomics). The TPU design's padding of N to a multiple of the tile does
// not exist here: the last tile masks its ragged edge.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;   // threads per block = rows = columns per tile

enum { kFormR2 = 0, kFormR = 1 };

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int FORM>
__global__ void __launch_bounds__(kTile)
    pair_energy_kernel(const float* __restrict__ pos,
                       const float* __restrict__ mask,
                       const float* __restrict__ box, int N, int n_tiles,
                       float softening, float cutoff2, bool coincident,
                       float* __restrict__ e_part, float* __restrict__ grad) {
  __shared__ float cpos[kTile * 3];
  __shared__ float cmask[kTile];
  __shared__ float wsum[kTile / 32];
  const int b = blockIdx.x / n_tiles, t = blockIdx.x - b * n_tiles;
  const int tid = threadIdx.x, i = t * kTile + tid;
  const float* P = pos + (size_t)b * N * 3;
  const float* M = mask + (size_t)b * N;
  float xi[3] = {0.f, 0.f, 0.f}, bx[3];
  const float mi = i < N ? M[i] : 0.f;
  for (int k = 0; k < 3; ++k) {
    if (i < N) xi[k] = P[i * 3 + k];
    bx[k] = box[b * 3 + k];
  }
  float acc_e = 0.f, g[3] = {0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < N; c0 += kTile) {
    __syncthreads();
    const int j = c0 + tid;
    for (int k = 0; k < 3; ++k) cpos[tid * 3 + k] = j < N ? P[j * 3 + k] : 0.f;
    cmask[tid] = j < N ? M[j] : 0.f;
    __syncthreads();
    const int nc = min(kTile, N - c0);
    for (int q = 0; q < nc; ++q) {
      float d[3];
      for (int k = 0; k < 3; ++k) {
        float dk = xi[k] - cpos[q * 3 + k];
        if (FORM == kFormR) dk = dk - rintf(dk / bx[k]) * bx[k];
        d[k] = dk;
      }
      const float d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      bool valid = mi * cmask[q] > 0.f && d2 > 0.f;
      if (FORM == kFormR) {
        // a coincident pair of distinct real atoms (the flag, s > 0)
        if (coincident && d2 == 0.f && c0 + q != i && mi * cmask[q] > 0.f)
          valid = true;
        valid = valid && d2 < cutoff2;
      }
      float e, de;
      pair_terms<FORM>(valid ? d2 : 1.0f, softening, e, de);
      if (valid) {
        acc_e += e;
        // at d2 = 0 the force is 0 (de/dd2 is infinite there, d is 0)
        if (d2 > 0.f)
          for (int k = 0; k < 3; ++k) g[k] += de * 2.0f * d[k];
      }
    }
  }
  if (i < N)
    for (int k = 0; k < 3; ++k) grad[((size_t)b * N + i) * 3 + k] = g[k];
  acc_e = warp_sum(acc_e);
  if ((tid & 31) == 0) wsum[tid >> 5] = acc_e;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kTile / 32; ++w) s += wsum[w];
    e_part[blockIdx.x] = 0.5f * s;                 // ordered -> i < j
  }
}

}  // namespace

extern "C" {

// Row tiles per molecule: e_part holds B * pair_energy_row_tiles(N) floats.
int pair_energy_row_tiles(int N) { return (N + kTile - 1) / kTile; }

// form: 0 = r2, 1 = r (the cutoff applies to form r only). pos [B,N,3],
// mask [B,N] (0/1), box [B,3], all float32 on the card; cutoff2 is the
// squared cutoff, rounded to float32 once by the caller; coincident != 0
// counts form r's coincident pairs when softening > 0 (see the top). Writes
// e_part [B, row tiles] and grad [B,N,3]. Returns the cudaError_t of the
// launch (0 on success).
int pair_energy(int form, int B, int N, const void* pos, const void* mask,
                const void* box, float softening, float cutoff2,
                int coincident, void* e_part, void* grad, void* stream) {
  if (B < 1 || N < 1 || (form != kFormR2 && form != kFormR))
    return (int)cudaErrorInvalidValue;
  const int tiles = pair_energy_row_tiles(N);
  const long long blocks = (long long)B * tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto* p = (const float*)pos;
  auto* m = (const float*)mask;
  auto* bx = (const float*)box;
  const bool coinc = coincident != 0 && form == kFormR && softening > 0.f;
  if (form == kFormR2)
    pair_energy_kernel<kFormR2><<<(unsigned)blocks, kTile, 0, st>>>(
        p, m, bx, N, tiles, softening, cutoff2, false, (float*)e_part,
        (float*)grad);
  else
    pair_energy_kernel<kFormR><<<(unsigned)blocks, kTile, 0, st>>>(
        p, m, bx, N, tiles, softening, cutoff2, coinc, (float*)e_part,
        (float*)grad);
  return (int)cudaGetLastError();
}

const char* pair_energy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
