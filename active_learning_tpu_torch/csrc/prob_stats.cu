// Softmax statistics of a batch of logits: confidence, margin, entropy and
// the predicted class.
//
// Replaces the JAX package's softmax-statistics pass,
// active_learning_tpu/strategies/scoring.py::make_prob_stats_step
// (scoring.py:109-126, ROADMAP kernel K3), which XLA fused after the head.
// Per row, in float32 and in the JAX step's own arithmetic:
//   m = max x;  s = sum exp(x - m);  p = exp(x - m) / s (a division);
//   logp = (x - m) - log s;
//   top-2 over p (not over x), ranked by value and then by the LOWER
//   index, a NaN above every number, as jax.lax.top_k ranks them;
//   confidence = p1, margin = p1 - p2, pred = index of p1;
//   entropy = -sum_{p > 0} p * logp (0 log 0 := 0), each product rounded
//   on its own.
// A row holding a NaN or a +inf has p NaN everywhere, so pred is 0 and
// confidence and margin are NaN, as in the reference: jnp.max makes m NaN
// there, and here fmaxf skips the NaN but exp(NaN - m) makes s NaN, which
// gives the same p.  A finite p lies in [0, 1], so the top-2 ranks a NaN
// first by taking it as 2 (and writes it back as NaN): the merges keep
// the plain compares of value and index.
//
// Bound: launch and latency.  At the served shape (B = 64 rows, C = 1000
// classes) the kernel reads 256 KB and writes 1 KB, under 0.1 us of the
// card's memory time; what costs is the launch, three dependent
// reductions a row and each thread's chain of exps and divides.  Design:
// a block a row, so that many warps share a row's exps and divides (32
// threads for C <= 32, 128 to C = 512, 256 above); the row is read once
// into shared memory, and each reduction is a warp shuffle tree, then one
// slot a warp in shared memory folded by the first warp.  A warp a row
// with the row in registers was tried and was slower on the device at
// every measured shape (PERF.md, kernel A): one warp cannot hide its lanes'
// 32 exps and IEEE divides.  The host's side of a call (one output
// allocation, one ctypes call) is what paces a caller at the served
// shape.  Every reduction has a fixed order (each thread walks its
// elements in a fixed order, then a fixed tree), so a row's result never
// depends on scheduling; the top-2 merge uses a total order, so it is
// exact whatever the tree.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// prob_stats.py.  The function returns cudaGetLastError() after the
// launch; the wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxClasses = 12288;  // the row in shared memory: 48 KB
// Rows past this many classes need the opt-in to more than 48 KB of
// shared memory (the row and the static partials).
constexpr int kOptInClasses = 12000;

struct Top2 {
  float v1;
  int i1;
  float v2;
  int i2;
};

// The rank of a probability in the top-2: p itself, a NaN above every p.
constexpr float kNanRank = 2.f;

// Value descending, ties to the lower index.
__device__ __forceinline__ bool ranks_before(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ float unrank(float r) {
  return r == kNanRank ? NAN : r;
}

__device__ __forceinline__ Top2 merge_top2(const Top2& a, const Top2& b) {
  Top2 r;
  if (ranks_before(a.v1, a.i1, b.v1, b.i1)) {
    r.v1 = a.v1;
    r.i1 = a.i1;
    if (ranks_before(a.v2, a.i2, b.v1, b.i1)) {
      r.v2 = a.v2;
      r.i2 = a.i2;
    } else {
      r.v2 = b.v1;
      r.i2 = b.i1;
    }
  } else {
    r.v1 = b.v1;
    r.i1 = b.i1;
    if (ranks_before(a.v1, a.i1, b.v2, b.i2)) {
      r.v2 = a.v1;
      r.i2 = a.i1;
    } else {
      r.v2 = b.v2;
      r.i2 = b.i2;
    }
  }
  return r;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ Top2 warp_top2(Top2 t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Top2 u;
    u.v1 = __shfl_xor_sync(kFull, t.v1, o);
    u.i1 = __shfl_xor_sync(kFull, t.i1, o);
    u.v2 = __shfl_xor_sync(kFull, t.v2, o);
    u.i2 = __shfl_xor_sync(kFull, t.i2, o);
    t = merge_top2(t, u);
  }
  return t;
}

// Block-wide reductions: every thread returns the block's result.  The
// per-warp partials go through shared memory and the first warp folds
// them in warp order.  `scratch` holds one slot per warp; the leading
// __syncthreads makes it safe to reuse across consecutive reductions.
template <int BLOCK>
__device__ float block_max(float v, float* scratch) {
  constexpr int kWarps = BLOCK / 32;
  v = warp_max(v);
  if (kWarps == 1) return v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < kWarps ? scratch[lane] : -INFINITY;
  return warp_max(v);
}

template <int BLOCK>
__device__ float block_sum(float v, float* scratch) {
  constexpr int kWarps = BLOCK / 32;
  v = warp_sum(v);
  if (kWarps == 1) return v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < kWarps ? scratch[lane] : 0.f;
  return warp_sum(v);
}

template <int BLOCK>
__device__ Top2 block_top2(Top2 t, Top2* scratch) {
  constexpr int kWarps = BLOCK / 32;
  t = warp_top2(t);
  if (kWarps == 1) return t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = t;
  __syncthreads();
  Top2 none = {-INFINITY, INT_MAX, -INFINITY, INT_MAX};
  t = lane < kWarps ? scratch[lane] : none;
  return warp_top2(t);
}

template <int BLOCK>
__global__ void __launch_bounds__(BLOCK)
prob_stats_kernel(const float* __restrict__ logits, int rows, int cols,
                 float* __restrict__ out) {
  extern __shared__ float row[];  // cols floats
  __shared__ float red[BLOCK / 32];
  __shared__ Top2 red_top[BLOCK / 32];

  const int tid = threadIdx.x;
  const float* x = logits + static_cast<size_t>(blockIdx.x) * cols;

  float m = -INFINITY;
  for (int i = tid; i < cols; i += BLOCK) {
    const float v = x[i];
    row[i] = v;
    m = fmaxf(m, v);
  }
  m = block_max<BLOCK>(m, red);

  float s = 0.f;
  for (int i = tid; i < cols; i += BLOCK) s += expf(row[i] - m);
  s = block_sum<BLOCK>(s, red);
  const float log_s = logf(s);

  float h = 0.f;
  Top2 t = {-INFINITY, INT_MAX, -INFINITY, INT_MAX};
  for (int i = tid; i < cols; i += BLOCK) {
    const float shifted = row[i] - m;
    const float p = expf(shifted) / s;
    const float logp = shifted - log_s;
    // __fmul_rn keeps the product rounded on its own, as the JAX step
    // (and the plain version) compute p * logp before the sum.
    if (p > 0.f) h += __fmul_rn(p, logp);
    const float r = p == p ? p : kNanRank;
    if (ranks_before(r, i, t.v1, t.i1)) {
      t.v2 = t.v1;
      t.i2 = t.i1;
      t.v1 = r;
      t.i1 = i;
    } else if (ranks_before(r, i, t.v2, t.i2)) {
      t.v2 = r;
      t.i2 = i;
    }
  }
  h = block_sum<BLOCK>(h, red);
  t = block_top2<BLOCK>(t, red_top);

  // out is [4, rows]: confidence, margin, entropy, pred (int32 bits).
  if (tid == 0) {
    const float p1 = unrank(t.v1);
    out[blockIdx.x] = p1;
    out[rows + blockIdx.x] = p1 - unrank(t.v2);
    out[2 * rows + blockIdx.x] = -h;
    reinterpret_cast<int*>(out)[3 * rows + blockIdx.x] = t.i1;
  }
}

template <int BLOCK>
void launch(const float* logits, int rows, int cols, float* out,
            cudaStream_t s) {
  prob_stats_kernel<BLOCK><<<rows, BLOCK, cols * sizeof(float), s>>>(
      logits, rows, cols, out);
}

}  // namespace

extern "C" {

// logits [rows, cols] float32, row-major; out [4, rows] 32-bit
// (confidence, margin, entropy, pred as int32).  Block size: one warp for
// cols <= 32, else 128 or 256 threads, so that each thread holds a
// handful of the row's elements.
int prob_stats_f32(const float* logits, int rows, int cols, float* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols < 2 || cols > kMaxClasses) return cudaErrorInvalidValue;
  if (cols <= 32) {
    launch<32>(logits, rows, cols, out, s);
  } else if (cols <= 512) {
    launch<128>(logits, rows, cols, out, s);
  } else {
    if (cols > kOptInClasses) {
      // The row and the static partials pass the 48 KB default at the
      // longest rows; the allowance is set once a device.
      constexpr int kDevices = 64;
      static bool allowed[kDevices] = {};
      int dev = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess && !(dev < kDevices && allowed[dev])) {
        e = cudaFuncSetAttribute(prob_stats_kernel<256>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxClasses * (int)sizeof(float));
        if (e == cudaSuccess && dev < kDevices) allowed[dev] = true;
      }
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    launch<256>(logits, rows, cols, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
