// Training-mode BatchNorm: the per-channel reductions and the one-pass
// input gradient (kernel C).
//
// Replaces the JAX package's hand-written training BatchNorm,
// active_learning_tpu/ops/backward.py:131-214 fused_bn_train (ROADMAP
// kernel K1, training half), the custom VJP FusedBatchNorm runs on every
// train step (models/resnet.py:153-170).  Three device functions over a
// channels-last activation, read as a [rows, C] matrix (rows = N*H*W):
//
//   channel_sums (forward statistics): s1 = sum x, s2 = sum x*x, then
//     mean = s1 * (1/n) and mean2 = s2 * (1/n), as XLA takes a mean.
//     bf16 (or f32) reads; the square and every sum in f32, because
//     E[x^2] - E[x]^2 cancels (the comment at models/resnet.py:154-163 of
//     the JAX package).
//   channel_sums (backward reduction): s1 = sum gy, s2 = sum gy*x over
//     the cotangent at the BN output (ReLU-masked by the caller) and the
//     saved input, bf16 reads, f32 sums.  Same kernel, two inputs.
//   bn_dx: dx = gy*mul + x*c2 + c1 per element, in f32 with one rounding
//     to the activation dtype.  The per-channel chain that yields mul, c1
//     and c2 (backward.py:174-203) is [C]-sized and stays in the wrapper.
//
// Bound: device-memory bytes.  Per element the statistics read x (2 B in
// bf16), the backward reduction reads gy and x (4 B), bn_dx reads gy and
// x and writes dx (6 B); each does a few flops per element, far below
// the card's ridge point.
//
// Design: the reductions are deterministic and two-stage, with no
// atomics.  The row range is cut into blocks whose size depends on the
// shape alone (rows and C, never the SM count or occupancy); each block
// covers 64 channels and its rows, each thread sums its rows in order,
// the block folds its 8 row lanes in a fixed order and writes one
// partial per channel to [nblk, 2, C]; the second pass folds those
// partials in a fixed order.  So two launches on the same input give
// bit-equal results.  Loads are coalesced along the channels (a warp
// reads 32 consecutive channels of one row).  bn_dx uses the same
// tiling and __fmul_rn/__fadd_rn, so it does the plain version's
// separately rounded float32 operations in the same order.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// bn_train.py.  Each function returns cudaGetLastError() after its
// launches; the wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;      // row lanes per block (blockDim.y)
constexpr int kTile = 64;      // channels per block: 2 per thread of a warp

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Partial sums over one block of rows: partial[blk][0][c] = sum a,
// partial[blk][1][c] = sum a*b (a*a when SAME).
template <typename T, bool SAME>
__global__ void sums_partial(const T* __restrict__ a,
                             const T* __restrict__ b, long long rows, int C,
                             int rows_per_block,
                             float* __restrict__ partial) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.y * kTile + tx;
  const int c1 = c0 + 32;
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  long long r_end = r_begin + rows_per_block;
  if (r_end > rows) r_end = rows;
  float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
  for (long long r = r_begin + ty; r < r_end; r += kLanes) {
    const long long base = r * C;
    if (c0 < C) {
      const float va = load(a, base + c0);
      const float vb = SAME ? va : load(b, base + c0);
      s1a += va;
      s2a += va * vb;
    }
    if (c1 < C) {
      const float va = load(a, base + c1);
      const float vb = SAME ? va : load(b, base + c1);
      s1b += va;
      s2b += va * vb;
    }
  }
  __shared__ float sh[4][kLanes][32];
  sh[0][ty][tx] = s1a;
  sh[1][ty][tx] = s2a;
  sh[2][ty][tx] = s1b;
  sh[3][ty][tx] = s2b;
  __syncthreads();
  if (ty == 0) {
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float acc = sh[k][0][tx];
#pragma unroll
      for (int l = 1; l < kLanes; ++l) acc += sh[k][l][tx];
      t[k] = acc;
    }
    float* out = partial + (long long)blockIdx.x * 2 * C;
    if (c0 < C) {
      out[c0] = t[0];
      out[C + c0] = t[1];
    }
    if (c1 < C) {
      out[c1] = t[2];
      out[C + c1] = t[3];
    }
  }
}

// Second stage: fold the [nblk, 2, C] partials in a fixed order and
// multiply by ``scale`` (1/rows for means, 1 for sums).
__global__ void sums_finalize(const float* __restrict__ partial, int nblk,
                              int C, float scale, float* __restrict__ out1,
                              float* __restrict__ out2) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    for (int j = ty; j < nblk; j += kLanes) {
      s1 += partial[(long long)j * 2 * C + c];
      s2 += partial[(long long)j * 2 * C + C + c];
    }
  }
  __shared__ float sh[2][kLanes][32];
  sh[0][ty][tx] = s1;
  sh[1][ty][tx] = s2;
  __syncthreads();
  if (ty == 0 && c < C) {
    float t1 = sh[0][0][tx], t2 = sh[1][0][tx];
#pragma unroll
    for (int l = 1; l < kLanes; ++l) {
      t1 += sh[0][l][tx];
      t2 += sh[1][l][tx];
    }
    out1[c] = t1 * scale;
    out2[c] = t2 * scale;
  }
}

template <typename T>
__global__ void dx_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                          long long rows, int C, int rows_per_block,
                          const float* __restrict__ mul,
                          const float* __restrict__ c2,
                          const float* __restrict__ c1, T* __restrict__ dx) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch[2] = {(int)(blockIdx.y * kTile + tx),
                     (int)(blockIdx.y * kTile + tx + 32)};
  float m[2], k2[2], k1[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool ok = ch[j] < C;
    m[j] = ok ? mul[ch[j]] : 0.f;
    k2[j] = ok ? c2[ch[j]] : 0.f;
    k1[j] = ok ? c1[ch[j]] : 0.f;
  }
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  long long r_end = r_begin + rows_per_block;
  if (r_end > rows) r_end = rows;
  for (long long r = r_begin + ty; r < r_end; r += kLanes) {
    const long long base = r * C;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (ch[j] < C) {
        const long long i = base + ch[j];
        const float t1 = __fmul_rn(load(gy, i), m[j]);
        const float t2 = __fmul_rn(load(x, i), k2[j]);
        store(dx, i, __fadd_rn(__fadd_rn(t1, t2), k1[j]));
      }
    }
  }
}

}  // namespace

extern "C" {

// Per-channel (sum a * scale, sum a*b * scale) over a [rows, C] buffer
// (a == b: the statistics).  ``partial`` is [nblk, 2, C] f32
// scratch, nblk = ceil(rows / rows_per_block).
int bn_channel_sums(const void* a, const void* b, int is_bf16,
                    long long rows, int C, int rows_per_block, int nblk,
                    float* partial, float scale, float* out1, float* out2,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, kLanes);
  const dim3 grid(nblk, (C + kTile - 1) / kTile);
  const bool same = a == b;
  if (is_bf16) {
    auto pa = static_cast<const __nv_bfloat16*>(a);
    auto pb = static_cast<const __nv_bfloat16*>(b);
    if (same)
      sums_partial<__nv_bfloat16, true><<<grid, block, 0, s>>>(
          pa, pb, rows, C, rows_per_block, partial);
    else
      sums_partial<__nv_bfloat16, false><<<grid, block, 0, s>>>(
          pa, pb, rows, C, rows_per_block, partial);
  } else {
    auto pa = static_cast<const float*>(a);
    auto pb = static_cast<const float*>(b);
    if (same)
      sums_partial<float, true><<<grid, block, 0, s>>>(
          pa, pb, rows, C, rows_per_block, partial);
    else
      sums_partial<float, false><<<grid, block, 0, s>>>(
          pa, pb, rows, C, rows_per_block, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sums_finalize<<<dim3((C + 31) / 32), block, 0, s>>>(partial, nblk, C,
                                                      scale, out1, out2);
  return (int)cudaGetLastError();
}

// dx = gy*mul + x*c2 + c1 (per-channel f32 coefficients), rounded once.
int bn_dx(const void* gy, const void* x, int is_bf16, long long rows, int C,
          int rows_per_block, int nblk, const float* mul, const float* c2,
          const float* c1, void* dx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, kLanes);
  const dim3 grid(nblk, (C + kTile - 1) / kTile);
  if (is_bf16)
    dx_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(gy),
        static_cast<const __nv_bfloat16*>(x), rows, C, rows_per_block, mul,
        c2, c1, static_cast<__nv_bfloat16*>(dx));
  else
    dx_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(gy), static_cast<const float*>(x), rows, C,
        rows_per_block, mul, c2, c1, static_cast<float*>(dx));
  return (int)cudaGetLastError();
}

}  // extern "C"
