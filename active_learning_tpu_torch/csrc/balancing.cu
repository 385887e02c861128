// Kernel H: the balancing pick of BalancingSampler.
//
// Replaces the JAX package's active_learning_tpu/strategies/balancing.py:61-85
// _balancing_pick (ROADMAP K6).  For every row i of the pool:
//     d_rare_i = sum_k (e_ik - c_rk)^2                 (1 where rare_empty)
//     norm_i   = max over majority classes c of (a2_i + b2_c) - 2 e_i . c_c
//     score_i  = eligible_i ? d_rare_i / norm_i : +inf
// and the pick is the index of the least score, ties to the lower index, a
// NaN winning over any number (jnp.argmin's rule: the first NaN).  a2 and b2
// are the rows' and the centers' squared norms.  The norm is the expanded
// form the JAX function writes, not clamped at 0: a row on a majority
// centroid can get a norm near 0 or below it, and the pick copies that.
//
// Arithmetic.  float32 throughout, no tensor core and no TF32.  Every dot
// product, a2 and d_rare is one fmaf chain in ascending feature order per
// row (and center), so the result does not depend on the tiling; b2 is a
// fixed lane split and xor tree per center.  The distance is formed as
// (a2 + b2) - 2*dot with __fadd_rn/__fsub_rn, as the plain version's
// separate operations, and the max over classes propagates a NaN as
// jnp.max does.  The argmin ranks by one 64-bit key: the float's total
// order in the high word (a NaN below everything, -0 read as +0 so that
// the two tie) and the row index in the low word; a min under that key is
// exact in any tree.
//
// Bound.  One pick reads the pool once (N*D*4 bytes) and does
// 2*N*D*(majority classes + 1) float32 operations.  At the CIFAR sweep's
// widths (N = 20,431..50,000, D = 512, C = 10) the bytes bound it
// (12.5..31 us at 3.35 TB/s); at ImageNet-LT's (N = 130,000, D = 2048,
// C = 1000) the operations do (67 TFLOP/s outside the tensor cores).
// Design, kept simple: three launches per pick.
//   prep   one warp per center computes b2; block 0 also compacts the
//          majority mask into an ascending list of class ids.
//   pick   a block takes TR rows and walks the majority centers in tiles
//          of TC, staging KC features of rows and centers at a time in
//          shared memory (so any C*D fits: the centers are never held
//          whole); each thread keeps RM x CM dot products in registers and
//          a running max per row.  The first tile also forms a2 and d_rare
//          (the rare center staged beside).  Each block writes one key.
//          Two shapes: 128 rows x 8 centers for C <= 16 (one row a
//          thread), 64 x 64 with a 4 x 4 register block above.
//   merge  one block of 1024 threads takes the least key and writes the
//          int64 row index.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// balancing.py.  bal_pick returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KC = 16;  // features per shared-memory tile
constexpr int PREP_WARPS = 8;
constexpr int MERGE_THREADS = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

// jnp.max's rule: a NaN anywhere makes the max NaN.
__device__ __forceinline__ float nan_max(float m, float x) {
  return (x > m || x != x) ? x : m;
}

__device__ __forceinline__ unsigned long long pick_key(float s, int row) {
  uint32_t u = 0u;  // a NaN: below every number
  if (s == s) {
    const uint32_t b = __float_as_uint(s == 0.0f ? 0.0f : s);
    u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return ((unsigned long long)u << 32) | (uint32_t)row;
}

__device__ __forceinline__ unsigned long long key_min(unsigned long long a,
                                                      unsigned long long b) {
  return b < a ? b : a;
}

// The least key of the block, in every thread; `sh` holds 32 entries.
__device__ unsigned long long block_min(unsigned long long k,
                                        unsigned long long* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    k = key_min(k, __shfl_xor_sync(kFull, k, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) sh[warp] = k;
  __syncthreads();
  k = lane < nwarps ? sh[lane] : kNoKey;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    k = key_min(k, __shfl_xor_sync(kFull, k, o));
  return k;
}

// b2 of each center (one warp per center: lane l sums features l, l+32,
// ... in ascending order, then an xor tree), and in block 0 the ascending
// list of majority classes and its length.
__global__ void __launch_bounds__(PREP_WARPS * 32) prep_kernel(
    const float* __restrict__ centers, int c_count, int d,
    const uint8_t* __restrict__ maj, float* __restrict__ b2,
    int* __restrict__ maj_idx, int* __restrict__ n_maj) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * PREP_WARPS + warp;
  if (c < c_count) {
    const float* row = centers + (size_t)c * d;
    float acc = 0.f;
    for (int k = lane; k < d; k += 32) acc = fmaf(row[k], row[k], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, o));
    if (lane == 0) b2[c] = acc;
  }
  if (blockIdx.x != 0) return;
  __shared__ int warp_counts[PREP_WARPS];
  int base = 0;
  for (int c0 = 0; c0 < c_count; c0 += PREP_WARPS * 32) {
    const int ci = c0 + threadIdx.x;
    const bool m = ci < c_count && maj[ci] != 0;
    const unsigned ballot = __ballot_sync(kFull, m);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int off = base;
    for (int w = 0; w < warp; ++w) off += warp_counts[w];
    if (m) maj_idx[off + __popc(ballot & ((1u << lane) - 1u))] = ci;
    for (int w = 0; w < PREP_WARPS; ++w) base += warp_counts[w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *n_maj = base;
}

template <int TR, int TC, int RM, int CM>
__global__ void __launch_bounds__((TR / RM) * (TC / CM)) pick_kernel(
    const float* __restrict__ emb, int n, int d,
    const uint8_t* __restrict__ eligible, const float* __restrict__ centers,
    const float* __restrict__ b2, const int* __restrict__ maj_idx,
    const int* __restrict__ n_maj_p, int rarest, int rare_empty,
    unsigned long long* __restrict__ block_keys) {
  constexpr int CT = TC / CM;  // threads across the centers of a tile
  constexpr int THREADS = (TR / RM) * CT;
  __shared__ float As[KC][TR + 1];
  __shared__ float Bs[KC][TC + 1];
  __shared__ float Rs[KC];
  __shared__ int cls[TC];
  __shared__ float a2s[TR], drs[TR];
  __shared__ float parts[CT][TR];
  __shared__ unsigned long long sh[32];
  const int t = threadIdx.x;
  const int tr = t / CT, tc = t % CT;
  const int row0 = blockIdx.x * TR;
  const int nm = *n_maj_p;
  const int tiles = nm > 0 ? (nm + TC - 1) / TC : 1;

  float mx[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) mx[i] = -INFINITY;

  for (int tile = 0; tile < tiles; ++tile) {
    const int c0 = tile * TC;
    const bool first = tile == 0;
    for (int c = t; c < TC; c += THREADS)
      cls[c] = c0 + c < nm ? maj_idx[c0 + c] : -1;
    __syncthreads();
    float acc[RM][CM], a2[RM], dr[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      a2[i] = dr[i] = 0.f;
#pragma unroll
      for (int j = 0; j < CM; ++j) acc[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < d; k0 += KC) {
      for (int e = t; e < TR * KC; e += THREADS) {
        const int r = e / KC, k = e % KC;
        const int row = row0 + r, col = k0 + k;
        As[k][r] = (row < n && col < d) ? emb[(size_t)row * d + col] : 0.f;
      }
      for (int e = t; e < TC * KC; e += THREADS) {
        const int c = e / KC, k = e % KC;
        const int col = k0 + k;
        Bs[k][c] = (cls[c] >= 0 && col < d)
                       ? centers[(size_t)cls[c] * d + col] : 0.f;
      }
      if (first && t < KC)
        Rs[t] = k0 + t < d ? centers[(size_t)rarest * d + k0 + t] : 0.f;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        float a[RM], b[CM];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = As[k][tr * RM + i];
#pragma unroll
        for (int j = 0; j < CM; ++j) b[j] = Bs[k][tc * CM + j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        // Past the last feature a and Rs are 0: the chains add exact zeros.
        if (first && tc == 0) {
          const float r = Rs[k];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            a2[i] = fmaf(a[i], a[i], a2[i]);
            const float df = __fsub_rn(a[i], r);
            dr[i] = fmaf(df, df, dr[i]);
          }
        }
      }
      __syncthreads();
    }
    if (first) {
      if (tc == 0) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          a2s[tr * RM + i] = a2[i];
          drs[tr * RM + i] = dr[i];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < CM; ++j) {
      const int c = cls[tc * CM + j];
      if (c < 0) continue;
      const float bc = b2[c];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float dd = __fsub_rn(__fadd_rn(a2s[tr * RM + i], bc),
                                   2.0f * acc[i][j]);
        mx[i] = nan_max(mx[i], dd);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) parts[tc][tr * RM + i] = mx[i];
  __syncthreads();
  unsigned long long key = kNoKey;
  if (t < TR && row0 + t < n) {
    float norm = -INFINITY;
#pragma unroll
    for (int p = 0; p < CT; ++p) norm = nan_max(norm, parts[p][t]);
    const int row = row0 + t;
    const float num = rare_empty ? 1.0f : drs[t];
    const float s = eligible[row] ? __fdiv_rn(num, norm) : INFINITY;
    key = pick_key(s, row);
  }
  key = block_min(key, sh);
  if (t == 0) block_keys[blockIdx.x] = key;
}

__global__ void __launch_bounds__(MERGE_THREADS) merge_kernel(
    const unsigned long long* __restrict__ block_keys, int blocks,
    int64_t* __restrict__ out) {
  __shared__ unsigned long long sh[32];
  unsigned long long key = kNoKey;
  for (int b = threadIdx.x; b < blocks; b += MERGE_THREADS)
    key = key_min(key, block_keys[b]);
  key = block_min(key, sh);
  if (threadIdx.x == 0) out[0] = (int64_t)(key & 0xffffffffull);
}

constexpr int NARROW_C = 16;  // the 128 x 8 shape up to this many classes

int row_tile(int c_count) { return c_count <= NARROW_C ? 128 : 64; }

}  // namespace

extern "C" {

// Per-block keys the wrapper allocates for a pool of n rows and C classes.
int bal_blocks(int n, int c_count) {
  const int tr = row_tile(c_count);
  return (n + tr - 1) / tr;
}

int bal_pick(const float* emb, int n, int d, const uint8_t* eligible,
             const float* centers, int c_count, const uint8_t* maj,
             int rarest, int rare_empty, float* b2, int* maj_idx, int* n_maj,
             unsigned long long* block_keys, int64_t* out,
             cudaStream_t stream) {
  prep_kernel<<<(c_count + PREP_WARPS - 1) / PREP_WARPS, PREP_WARPS * 32, 0,
                stream>>>(centers, c_count, d, maj, b2, maj_idx, n_maj);
  const int blocks = bal_blocks(n, c_count);
  if (c_count <= NARROW_C) {
    pick_kernel<128, 8, 1, 8><<<blocks, 128, 0, stream>>>(
        emb, n, d, eligible, centers, b2, maj_idx, n_maj, rarest, rare_empty,
        block_keys);
  } else {
    pick_kernel<64, 64, 4, 4><<<blocks, 256, 0, stream>>>(
        emb, n, d, eligible, centers, b2, maj_idx, n_maj, rarest, rare_empty,
        block_keys);
  }
  merge_kernel<<<1, MERGE_THREADS, 0, stream>>>(block_keys, blocks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
