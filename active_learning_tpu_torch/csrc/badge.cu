// Kernel G: BADGE's gradient-embedding factors, with the adaptive-average
// pooling of the partitioned variant.
//
// Replaces the JAX package's active_learning_tpu/strategies/scoring.py:154-193
// make_badge_step (ROADMAP K5, BADGE half), which XLA fused after the head.
// Per row of float32 logits z [C]:
//     p = exp(z - max z) / sum exp(z - max z)        (jax.nn.softmax)
//     a = p - onehot(argmax z)                       (first index on ties)
// and with pooling, a is averaged into H = min(16, C) bins and the
// embedding row e [D] into W = 512 / H bins, with torch's adaptive-pool
// edges: bin o covers [floor(o*n/out), ceil((o+1)*n/out)), so neighbouring
// bins may overlap (C = 10 -> 10 bins, D = 512 -> 51 bins of about 10).
// A bin's value is sum_k x_k * float32(1 / (end - start)), the terms of
// the JAX step's `x @ M` that are not zero, summed in index order.
//
// Why CUDA and not Triton: it is the same row-per-block softmax as kernel A
// (csrc/prob_stats.cu), whose fixed-order reductions it reuses, and it
// builds with the other CUDA sources in one nvcc pass at first use.
//
// Bound: memory.  At the main path's shape (B = 256, C = 1000, D = 2048)
// a call reads 1 MB of logits (and 2 MB of embeddings when pooling) and
// writes 1 MB (or 48 KB pooled): under 1.3 us at 3.35 TB/s; launch latency
// dominates.  Design: one block per row; the logits row is read once into
// shared memory and the max, the sum and the factor pass run from there;
// the sum has a fixed order (each thread's strided elements in index order,
// a fixed shuffle tree, then the warps' partials in order).
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// badge.py.  The function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr unsigned kFull = 0xffffffffu;
// The logits row is dynamic shared memory beside the kernel's 256 static
// bytes (sv, si); without an opt-in both fit in 48 KB.
constexpr int MAX_CLASSES = (48 * 1024 - 32 * 4 - 32 * 4) / 4;  // 12224

__device__ __forceinline__ bool max_before(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Block max with its first index; every thread gets the result.
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    const int j = __shfl_xor_sync(kFull, i, o);
    if (max_before(w, j, v, i)) {
      v = w;
      i = j;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < THREADS / 32; ++k)
      if (max_before(sv[k], si[k], v, i)) {
        v = sv[k];
        i = si[k];
      }
    sv[0] = v;
    si[0] = i;
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();
}

// Block sum in a fixed order; every thread gets the result.
__device__ float block_sum(float s, float* sv) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sv[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = sv[0];
    for (int k = 1; k < THREADS / 32; ++k) t += sv[k];
    sv[0] = t;
  }
  __syncthreads();
  const float out = sv[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ float bin_mean(const float* x, int n, int out,
                                          int o) {
  const int start = (int)(((long long)o * n) / out);
  const int end = (int)(((long long)(o + 1) * n + out - 1) / out);
  const float w = (float)(1.0 / (double)(end - start));
  float acc = 0.f;
  for (int k = start; k < end; ++k) acc = fmaf(x[k], w, acc);
  return acc;
}

__global__ void __launch_bounds__(THREADS) badge_kernel(
    const float* __restrict__ logits, const float* __restrict__ emb, int C,
    int D, int pool_h, int pool_w, float* __restrict__ a_out,
    float* __restrict__ e_out) {
  extern __shared__ float x[];  // C floats
  __shared__ float sv[32];
  __shared__ int si[32];
  const float* z = logits + (size_t)blockIdx.x * C;
  float m = -INFINITY;
  int arg = INT_MAX;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float v = z[c];
    x[c] = v;
    if (max_before(v, c, m, arg)) {
      m = v;
      arg = c;
    }
  }
  block_argmax(m, arg, sv, si);
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float u = expf(__fsub_rn(x[c], m));
    x[c] = u;
    s += u;
  }
  s = block_sum(s, sv);
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float a = __fsub_rn(__fdiv_rn(x[c], s), c == arg ? 1.f : 0.f);
    if (pool_h > 0)
      x[c] = a;
    else
      a_out[(size_t)blockIdx.x * C + c] = a;
  }
  if (pool_h == 0) return;
  __syncthreads();
  const float* e = emb + (size_t)blockIdx.x * D;
  for (int o = threadIdx.x; o < pool_h + pool_w; o += THREADS) {
    if (o < pool_h)
      a_out[(size_t)blockIdx.x * pool_h + o] = bin_mean(x, C, pool_h, o);
    else
      e_out[(size_t)blockIdx.x * pool_w + (o - pool_h)] =
          bin_mean(e, D, pool_w, o - pool_h);
  }
}

}  // namespace

extern "C" {

// logits [B, C]; emb [B, D] (read only when pooling).  pool_h = 0: a_out
// [B, C] gets a.  pool_h > 0: a_out [B, pool_h] and e_out [B, pool_w] get
// the pooled factors.
int badge_factors_f32(const float* logits, const float* emb, int B, int C,
                      int D, int pool_h, int pool_w, float* a_out,
                      float* e_out, cudaStream_t stream) {
  if (B < 1 || C < 1 || C > MAX_CLASSES) return cudaErrorInvalidValue;
  badge_kernel<<<B, THREADS, C * sizeof(float), stream>>>(
      logits, emb, C, D, pool_h, pool_w, a_out, e_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
