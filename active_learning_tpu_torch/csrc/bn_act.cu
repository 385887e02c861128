// Kernel B: eval-mode BatchNorm, optional residual add and ReLU, in one
// pass over a channels-last (NHWC) activation.
//
// Replaces the BatchNorm affine of the JAX package's models/resnet.py
// (FusedBatchNorm's x*mul - sub at resnet.py:151-152,190-192, or flax
// nn.BatchNorm) together with the residual add and ReLU that follow it
// (resnet.py:257, :289, the stems' bn_stem + ReLU at :324-325, :346-347),
// which XLA fused into the convolutions' epilogues on the TPU (ROADMAP
// K1, eval half).  Per element, with per-channel float32 coefficients:
//     y = relu?((x - shift) * mul + add [+ residual])
// rounded once to the activation type (bf16 or float32) at the store.
//
// Arithmetic.  __fsub_rn / __fmul_rn / __fadd_rn: separately rounded
// float32 operations in the plain version's order, never contracted into
// an FMA, so the kernel equals ops/bn_act.py's bn_act_reference bit for
// bit.  ReLU is torch.relu's on the card (clamp_min: a NaN passes through,
// otherwise fmaxf(v, 0)); the bf16 store is __float2bfloat16_rn, what
// PyTorch's float-to-bf16 cast calls on sm_80 and later.
//
// Bound: device-memory bytes.  Per element it reads x (and the residual)
// and writes y (4 or 6 bytes in bf16, 8 or 12 in float32) for four
// float32 operations, far below the card's ridge point.  Design:
//   - 16-byte vectors along the channels (8 bf16 or 4 float32 a load),
//     four in flight a thread, every load issued before any store, in a
//     grid-stride loop whose stride is a multiple of the vectors in a
//     pixel's row of channels: each thread keeps one channel vector for
//     the whole pass, so it reads that vector's coefficients once (float4
//     loads) and divides no index per element;
//   - a scalar path, the same arithmetic one element at a time, when the
//     channel count is not a multiple of the vector or a pointer is not
//     16-byte aligned;
//   - enough blocks for four units a thread (a grid capped at what the
//     card holds at once, with a longer stride loop, was slower over a
//     forward's shapes in a probe not kept in the repository).
// The host side is the other half of the design: ops/bn_act.py caches a
// launch plan per shape, so one call is a dictionary lookup, an empty
// output and one ctypes call.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// bn_act.py.  bn_act returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // units a thread has in flight

__device__ __forceinline__ float bn_affine(float x, float s, float m,
                                           float a) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, s), m), a);
}

// torch.relu on the card: clamp_min(v, 0), a NaN kept as it is.
__device__ __forceinline__ float relu_like_torch(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

// V elements of a row at p, as float32.
template <int V>
__device__ __forceinline__ void load_elems(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
}

template <int V>
__device__ __forceinline__ void load_elems(const __nv_bfloat16* p,
                                           float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __bfloat162float(__ushort_as_bfloat16(
        __ldg(reinterpret_cast<const unsigned short*>(p))));
  } else {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = w[i];
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_elems(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int V>
__device__ __forceinline__ void store_elems(__nv_bfloat16* p,
                                            const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = __float2bfloat16_rn(v[0]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
      const uint32_t hi =
          __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// V coefficients of one channel vector (float4 reads for V > 1).
template <int V>
__device__ __forceinline__ void load_coeffs(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  }
}

template <typename T, int V, bool RES, bool RELU>
__device__ __forceinline__ void one_unit(const T* __restrict__ x,
                                         const T* __restrict__ r,
                                         T* __restrict__ y, long long u,
                                         const float (&s)[V],
                                         const float (&m)[V],
                                         const float (&a)[V]) {
  float v[V];
  load_elems<V>(x + u * V, v);
  float w[V];
  if (RES) load_elems<V>(r + u * V, w);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float o = bn_affine(v[i], s[i], m[i], a[i]);
    if (RES) o = __fadd_rn(o, w[i]);
    if (RELU) o = relu_like_torch(o);
    v[i] = o;
  }
  store_elems<V>(y + u * V, v);
}

// units: vectors (or elements) in the tensor; upr: units in one pixel's
// row of channels; stride: a multiple of upr, at most the grid's threads.
template <typename T, int V, bool RES, bool RELU>
__global__ void __launch_bounds__(THREADS) bn_act_kernel(
    const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ y,
    const float* __restrict__ shift, const float* __restrict__ mul,
    const float* __restrict__ add, long long units, int upr,
    long long stride) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= stride) return;
  const int cu = (int)(g % upr);  // this thread's channel unit, fixed
  float s[V], m[V], a[V];
  load_coeffs<V>(shift + (size_t)cu * V, s);
  load_coeffs<V>(mul + (size_t)cu * V, m);
  load_coeffs<V>(add + (size_t)cu * V, a);
  long long u = g;
  // UNROLL units in flight: every load issued before any store.
  for (; u + (UNROLL - 1) * stride < units; u += UNROLL * stride) {
    float v[UNROLL][V], w[UNROLL][V];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      load_elems<V>(x + (u + q * stride) * V, v[q]);
      if (RES) load_elems<V>(r + (u + q * stride) * V, w[q]);
    }
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float o = bn_affine(v[q][i], s[i], m[i], a[i]);
        if (RES) o = __fadd_rn(o, w[q][i]);
        if (RELU) o = relu_like_torch(o);
        v[q][i] = o;
      }
    }
#pragma unroll
    for (int q = 0; q < UNROLL; ++q)
      store_elems<V>(y + (u + q * stride) * V, v[q]);
  }
  for (; u < units; u += stride) one_unit<T, V, RES, RELU>(x, r, y, u, s, m, a);
}

template <typename T, int V, bool RES, bool RELU>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&bn_act_kernel<T, V, RES, RELU>);
}

// The kernel of a variant: bits 1 bf16, 2 residual, 4 ReLU, 8 vectors.
const void* variant_kernel(int variant) {
  switch (variant & 15) {
#define BN_CASE(bits, T, V, R, L) \
  case bits:                      \
    return kernel_of<T, V, R, L>();
    BN_CASE(0, float, 1, false, false)
    BN_CASE(1, __nv_bfloat16, 1, false, false)
    BN_CASE(2, float, 1, true, false)
    BN_CASE(3, __nv_bfloat16, 1, true, false)
    BN_CASE(4, float, 1, false, true)
    BN_CASE(5, __nv_bfloat16, 1, false, true)
    BN_CASE(6, float, 1, true, true)
    BN_CASE(7, __nv_bfloat16, 1, true, true)
    BN_CASE(8, float, 4, false, false)
    BN_CASE(9, __nv_bfloat16, 8, false, false)
    BN_CASE(10, float, 4, true, false)
    BN_CASE(11, __nv_bfloat16, 8, true, false)
    BN_CASE(12, float, 4, false, true)
    BN_CASE(13, __nv_bfloat16, 8, false, true)
    BN_CASE(14, float, 4, true, true)
    BN_CASE(15, __nv_bfloat16, 8, true, true)
#undef BN_CASE
  }
  return nullptr;
}

}  // namespace

extern "C" {

// y = relu?((x - shift) * mul + add [+ r]) over `units` units of the
// variant's width, `upr` units to a pixel; r may be null without a
// residual.  blocks * THREADS must be at least upr.
int bn_act(const void* x, const void* r, void* y, const float* shift,
           const float* mul, const float* add, long long units, int upr,
           int variant, int blocks, cudaStream_t stream) {
  if (units < 1 || upr < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)blocks * THREADS;
  const long long stride = threads / upr * upr;
  if (stride < 1) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x,     (void*)&r,   (void*)&y,
                  (void*)&shift, (void*)&mul, (void*)&add,
                  (void*)&units, (void*)&upr, (void*)&stride};
  return (int)cudaLaunchKernel(variant_kernel(variant), dim3(blocks),
                               dim3(THREADS), args, 0, stream);
}

}  // extern "C"

