// Fused SGD + momentum + weight decay over every parameter leaf in one
// launch (kernel D).
//
// Replaces the JAX package's active_learning_tpu/train/optim.py:97-128
// fused_sgd_update (ROADMAP kernel K2), which the train step applies once
// per step (trainer.py:367-379).  Per element, in float32, with each
// product and sum rounded on its own (__fmul_rn/__fadd_rn: nvcc would
// otherwise contract a*b + c into one FMA, and the result would no
// longer be the JAX update's bit for bit):
//
//   d  = g + wd*p          (d = g when wd == 0)
//   t' = d + mu*t          (t read and stored in the state dtype: f32,
//                           or bf16 rounded once on store)
//   p' = p + (-lr)*t'      (t' before the store's rounding)
//
// and with no momentum p' = p + (-lr)*d with no state.
//
// Bound: device-memory bytes.  It reads p, g and t and writes p and t:
// 20 bytes per parameter at f32 state (16 at bf16), three flops.
//
// Design: one launch per step over a device-side table of leaves, so
// ResNet-50's 161 leaves cost one launch, not 161.  The wrapper
// (active_learning_tpu_torch/ops/fused_sgd.py, leaf_split) cuts each
// leaf into a scalar head (the elements before p, g and t reach a
// 16-byte boundary together), a body of 4-element vectors and a scalar
// tail; a leaf whose buffers can never align together (a view at an odd
// storage offset against an aligned one) is all head.  A leaf's work
// units are its vectors, then its head and tail elements, and the table
// row carries the prefix sum of the units.
//   * The grid is kWaves waves of as many blocks as fit on the card at
//     once (the occupancy calculator's count per SM times the SMs,
//     asked once per kernel, device and table size); block k takes
//     the contiguous range [k*U/G, (k+1)*U/G) of the U units.  One
//     wave left the card waiting on its slowest blocks; more waves
//     of smaller ranges measured faster on the card, up to 32.  An
//     elementwise update: the result does not depend on G.  It reads the
//     whole table into shared memory in one pass (no load waits on
//     another), finds its first leaf by bisection there, and walks its
//     leaves in order.
//   * The body: float4 loads of p and g and of an f32 trace, 8 bytes for
//     four bf16 trace values; each thread has four vectors of each array
//     in flight (unrolled), neighbouring threads on neighbouring vectors.
//     (Streaming cache hints, 2 or 8 vectors a thread and 512 threads a
//     block measured no better on the card.)
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kWaves = 32;
// Table row (int64): param, grad and trace pointers, first unit, vector
// count, head length, element count, unused.
constexpr int kRow = 8;
enum { kP = 0, kG, kT, kU0, kN4, kHead, kNumel };

__device__ __forceinline__ float sgd1(float p, float g, float* t, float neg_lr,
                                      float mu, float wd, bool momentum,
                                      bool decay) {
  float d = g;
  if (decay) d = __fadd_rn(d, __fmul_rn(wd, p));
  if (momentum) {
    d = __fadd_rn(d, __fmul_rn(mu, *t));
    *t = d;
  }
  return __fadd_rn(p, __fmul_rn(neg_lr, d));
}

__device__ __forceinline__ float4 load_t4(const float* t) {
  return *reinterpret_cast<const float4*>(t);
}
__device__ __forceinline__ float4 load_t4(const __nv_bfloat16* t) {
  const uint2 u = *reinterpret_cast<const uint2*>(t);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store_t4(float* t, float4 v) {
  *reinterpret_cast<float4*>(t) = v;
}
__device__ __forceinline__ void store_t4(__nv_bfloat16* t, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(t) = u;
}
__device__ __forceinline__ float load_t1(const float* t) { return *t; }
__device__ __forceinline__ float load_t1(const __nv_bfloat16* t) {
  return __bfloat162float(*t);
}
__device__ __forceinline__ void store_t1(float* t, float v) { *t = v; }
__device__ __forceinline__ void store_t1(__nv_bfloat16* t, float v) {
  *t = __float2bfloat16_rn(v);
}

template <typename TT, bool MOMENTUM, bool DECAY>
__global__ void __launch_bounds__(kThreads)
    sgd_kernel(const long long* __restrict__ table, int nleaves,
               long long units, float neg_lr, float mu, float wd) {
  extern __shared__ long long rows[];
  for (int i = threadIdx.x; i < nleaves * kRow; i += kThreads)
    rows[i] = table[i];
  __syncthreads();
  const long long ub = units * blockIdx.x / gridDim.x;
  const long long ue = units * (blockIdx.x + 1) / gridDim.x;
  if (ub >= ue) return;
  // The last leaf whose first unit is <= ub.
  int lo = 0, hi = nleaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (rows[mid * kRow + kU0] <= ub)
      lo = mid;
    else
      hi = mid - 1;
  }
  for (int l = lo; l < nleaves; ++l) {
    const long long* row = rows + l * kRow;
    const long long u0 = row[kU0];
    if (u0 >= ue) break;
    float* p = reinterpret_cast<float*>(row[kP]);
    const float* g = reinterpret_cast<const float*>(row[kG]);
    TT* t = reinterpret_cast<TT*>(row[kT]);
    const long long n4 = row[kN4], head = row[kHead], numel = row[kNumel];
    const long long nunits = n4 + numel - 4 * n4;
    const long long a = (ub > u0 ? ub : u0) - u0;
    long long z = ue - u0;
    if (z > nunits) z = nunits;
    // The body: vector v covers elements head + 4v .. head + 4v + 3.
    const long long vend = z < n4 ? z : n4;
    float* pv = p + head;
    const float* gv = g + head;
    TT* tv = t + head;
    for (long long v = a + threadIdx.x; v < vend;
         v += (long long)kUnroll * kThreads) {
      float4 pr[kUnroll], gr[kUnroll], tr[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long vk = v + (long long)k * kThreads;
        if (vk < vend) {
          pr[k] = *reinterpret_cast<const float4*>(pv + 4 * vk);
          gr[k] = __ldg(reinterpret_cast<const float4*>(gv + 4 * vk));
          if (MOMENTUM) tr[k] = load_t4(tv + 4 * vk);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long vk = v + (long long)k * kThreads;
        if (vk < vend) {
          float4 o;
          o.x = sgd1(pr[k].x, gr[k].x, &tr[k].x, neg_lr, mu, wd, MOMENTUM,
                     DECAY);
          o.y = sgd1(pr[k].y, gr[k].y, &tr[k].y, neg_lr, mu, wd, MOMENTUM,
                     DECAY);
          o.z = sgd1(pr[k].z, gr[k].z, &tr[k].z, neg_lr, mu, wd, MOMENTUM,
                     DECAY);
          o.w = sgd1(pr[k].w, gr[k].w, &tr[k].w, neg_lr, mu, wd, MOMENTUM,
                     DECAY);
          *reinterpret_cast<float4*>(pv + 4 * vk) = o;
          if (MOMENTUM) store_t4(tv + 4 * vk, tr[k]);
        }
      }
    }
    // The head and tail elements, one unit each.
    for (long long u = (a > n4 ? a : n4) + threadIdx.x; u < z;
         u += kThreads) {
      const long long s = u - n4;
      const long long e = s < head ? s : s + 4 * n4;
      float tv1 = MOMENTUM ? load_t1(t + e) : 0.f;
      p[e] = sgd1(p[e], g[e], &tv1, neg_lr, mu, wd, MOMENTUM, DECAY);
      if (MOMENTUM) store_t1(t + e, tv1);
    }
  }
}

// Blocks of ``kern`` the current device holds at once with ``smem``
// bytes of dynamic shared memory (the occupancy calculator's count per
// SM times the SMs), after opting in to more than 48 KB: worked out once
// per (kernel, device, smem) and kept, so a step's launch asks the
// runtime nothing else.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kern, size_t smem, long long* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, long long> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple((const void*)kern, dev, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = seen.find(key);
  if (hit != seen.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  seen[key] = *blocks;
  return cudaSuccess;
}

template <typename TT>
int launch(const long long* table, int nleaves, long long units,
           int momentum, int decay, float neg_lr, float mu, float wd,
           cudaStream_t s) {
  const size_t smem = sizeof(long long) * kRow * nleaves;
  auto kern = momentum ? (decay ? sgd_kernel<TT, true, true>
                                : sgd_kernel<TT, true, false>)
                       : (decay ? sgd_kernel<TT, false, true>
                                : sgd_kernel<TT, false, false>);
  // kWaves waves of as many blocks as fit on the card at once.
  long long resident = 0;
  const cudaError_t err = resident_blocks(kern, smem, &resident);
  if (err != cudaSuccess) return (int)err;
  const long long work = (units + kThreads * kUnroll - 1) /
                         (kThreads * kUnroll);
  long long grid = resident * kWaves;
  if (grid > work) grid = work;
  if (grid < 1) grid = 1;
  kern<<<(int)grid, kThreads, smem, s>>>(table, nleaves, units, neg_lr, mu,
                                         wd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ``table``: device int64 [nleaves, 8] = (param ptr, grad ptr, trace
// ptr, first unit, vectors, head, numel, 0), the units of leaf l being
// its vectors then its head and tail elements; ``units`` their total.
int fused_sgd(const long long* table, int nleaves, long long units,
              int trace_bf16, int momentum, int decay, float neg_lr,
              float mu, float wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (units > 0) {
    const int err =
        trace_bf16 ? launch<__nv_bfloat16>(table, nleaves, units, momentum,
                                           decay, neg_lr, mu, wd, s)
                   : launch<float>(table, nleaves, units, momentum, decay,
                                   neg_lr, mu, wd, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
