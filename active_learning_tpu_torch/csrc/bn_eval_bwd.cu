// Kernel B': the backward of kernel B (eval-mode BatchNorm with its
// optional residual add and ReLU), over a channels-last (NHWC) activation
// read as a [rows, C] matrix (rows = N*H*W).
//
// Replaces XLA's derivative of the JAX package's eval-mode BatchNorm
// (FusedBatchNorm or flax nn.BatchNorm with use_running_average) with the
// residual add and nn.relu that follow it (active_learning_tpu/models/
// resnet.py:150-152, 190-192, 250-257, 278-289): what pretrained
// fine-tuning runs on every step, since the reference keeps BatchNorm in
// eval mode when a checkpoint is configured (train/trainer.py:155-160).
// The forward is y = relu?((x - shift) * mul + add [+ r]); given the
// cotangent g of y and the stored output y, per element:
//     dz  = relu ? (y > 0 ? g : 0) : g    (jax.nn.relu's zero gradient at
//                                          0; NaN > 0 is false)
//     dx  = dz * mul, rounded once to the activation type
//     dr  = dz                             (the residual's gradient)
// and per channel, float32 sums in a fixed order:
//     s1 = sum dz                          (the gradient of add)
//     s2 = sum dz * (x - shift)            (the gradient of mul)
// from which autograd's chain through ops/bn_act.py's bn_coefficients
// gives the gradients of scale and bias.
//
// Arithmetic.  __fsub_rn / __fmul_rn / __fadd_rn, never contracted into
// an FMA: dx and dr equal ops/bn_act.py's bn_act_backward_reference bit
// for bit; the sums are the plain version's terms added in another order.
//
// Bound: device-memory bytes.  Per element it reads g, x and (with a ReLU)
// y, and writes dx and (with a residual and a ReLU) dr: 8 or 10 bytes in
// bf16 for six float32 operations, far below the card's ridge point.
// Design, kernel C's reduction (csrc/bn_train.cu) with the elementwise
// pass fused into it: one read of g, x and y serves both dx and the sums.
//   - 16-byte accesses, a thread owning 8 bf16 or 4 float32 channels of a
//     row (one channel when C is not a multiple of that or a pointer is
//     not 16-byte aligned), so a warp reads whole runs of a row;
//   - deterministic two-stage sums, no atomics: the row range is cut into
//     blocks whose size depends on the shape alone; a block's row lanes
//     sum their rows in order and fold their lanes in a fixed order into
//     one [2, C] partial; the last stage folds the partials in a fixed
//     order.  Two launches on the same input give bit-equal results.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// bn_act.py (bn_act_backward).  bn_act_bwd returns cudaGetLastError()
// after its two launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the elementwise pass and its partial sums
constexpr int kFin = 32;       // last stage: 32 channels x 32 lanes

template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&o)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    o[0] = lo_bf16(v.x);
    o[1] = hi_bf16(v.x);
    o[2] = lo_bf16(v.y);
    o[3] = hi_bf16(v.y);
    o[4] = lo_bf16(v.z);
    o[5] = hi_bf16(v.z);
    o[6] = lo_bf16(v.w);
    o[7] = hi_bf16(v.w);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&o)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                   pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[1]) {
    o[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&o)[1]) {
    p[0] = o[0];
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[1]) {
    o[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&o)[1]) {
    p[0] = __float2bfloat16_rn(o[0]);
  }
};

// The per-channel coefficients of V channels from c0 (float32, no vector
// load: c0 * 4 bytes need not lie on 16 bytes for every V).
template <int V>
__device__ __forceinline__ void load_coeff(const float* __restrict__ p,
                                           int c0, float (&o)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = __ldg(p + c0 + i);
}

// Channel groups of V channels a block row: G threads cover G*V channels,
// kThreads / G row lanes (as csrc/bn_train.cu's reductions).
__host__ __device__ __forceinline__ int group_width(int C, int V) {
  const int groups = C / V;
  int g = 1;
  while (g < groups && g < 32) g <<= 1;
  return g;
}

// dx (and dr) per element; partial[blk][0][c] = sum dz, partial[blk][1][c]
// = sum dz * (x - shift) over the block's rows.
template <typename T, int V, bool RELU, bool GRES>
__global__ void __launch_bounds__(kThreads) bwd_partial(
    const T* __restrict__ g, const T* __restrict__ x,
    const T* __restrict__ y, const float* __restrict__ shift,
    const float* __restrict__ mul, long long rows, int C, int G,
    int rows_per_block, T* __restrict__ dx, T* __restrict__ dr,
    float* __restrict__ partial) {
  __shared__ float sh[2 * kThreads * V];
  const int L = kThreads / G, GV = G * V;
  const int gi = threadIdx.x % G, l = threadIdx.x / G;
  const int c0 = blockIdx.y * GV + gi * V;
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (c0 < C) {
    float sf[V], mf[V];
    load_coeff<V>(shift, c0, sf);
    load_coeff<V>(mul, c0, mf);
    const long long r_begin = (long long)blockIdx.x * rows_per_block;
    const long long r_end = min(r_begin + rows_per_block, rows);
    for (long long r = r_begin + l; r < r_end; r += L) {
      const long long off = r * C + c0;
      float vg[V], vx[V], out[V];
      Vec<T, V>::load(g + off, vg);
      Vec<T, V>::load(x + off, vx);
      if (RELU) {
        float vy[V];
        Vec<T, V>::load(y + off, vy);
#pragma unroll
        for (int i = 0; i < V; ++i) vg[i] = vy[i] > 0.f ? vg[i] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        out[i] = __fmul_rn(vg[i], mf[i]);
        s1[i] = __fadd_rn(s1[i], vg[i]);
        s2[i] = __fadd_rn(s2[i], __fmul_rn(vg[i], __fsub_rn(vx[i], sf[i])));
      }
      Vec<T, V>::store(dx + off, out);
      // dz is g or 0: exact in T, so this store only copies.
      if (GRES) Vec<T, V>::store(dr + off, vg);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sh[l * GV + gi * V + i] = s1[i];
    sh[(L + l) * GV + gi * V + i] = s2[i];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * GV; o += kThreads) {
    const int s = o / GV, c = o - s * GV;
    float acc = sh[(s * L) * GV + c];
    for (int k = 1; k < L; ++k) acc = __fadd_rn(acc, sh[(s * L + k) * GV + c]);
    const int ch = blockIdx.y * GV + c;
    if (ch < C) partial[((long long)blockIdx.x * 2 + s) * C + ch] = acc;
  }
}

// Fold the [nblk, 2, C] partials in a fixed order into out[2, C].
__global__ void __launch_bounds__(kFin * kFin) bwd_finalize(
    const float* __restrict__ partial, int nblk, int C,
    float* __restrict__ out) {
  __shared__ float sh[2][kFin][kFin + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kFin + tx;
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    for (int j = ty; j < nblk; j += kFin) {
      s1 = __fadd_rn(s1, partial[(long long)j * 2 * C + c]);
      s2 = __fadd_rn(s2, partial[(long long)j * 2 * C + C + c]);
    }
  }
  sh[0][ty][tx] = s1;
  sh[1][ty][tx] = s2;
  __syncthreads();
  if (ty == 0 && c < C) {
    float t1 = sh[0][0][tx], t2 = sh[1][0][tx];
    for (int k = 1; k < kFin; ++k) {
      t1 = __fadd_rn(t1, sh[0][k][tx]);
      t2 = __fadd_rn(t2, sh[1][k][tx]);
    }
    out[c] = t1;
    out[C + c] = t2;
  }
}

template <typename T, int V, bool RELU, bool GRES>
void launch_partial(const void* g, const void* x, const void* y,
                    const float* shift, const float* mul, long long rows,
                    int C, int rows_per_block, int nblk, void* dx, void* dr,
                    float* partial, cudaStream_t stream) {
  const int G = group_width(C, V);
  const dim3 grid(nblk, (C + G * V - 1) / (G * V));
  bwd_partial<T, V, RELU, GRES><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(y), shift, mul, rows, C, G, rows_per_block,
      static_cast<T*>(dx), static_cast<T*>(dr), partial);
}

template <typename T, int V>
void dispatch_mask(int relu, int gres, const void* g, const void* x,
                   const void* y, const float* shift, const float* mul,
                   long long rows, int C, int per, int nblk, void* dx,
                   void* dr, float* partial, cudaStream_t stream) {
  if (relu && gres)
    launch_partial<T, V, true, true>(g, x, y, shift, mul, rows, C, per, nblk,
                                     dx, dr, partial, stream);
  else if (relu)
    launch_partial<T, V, true, false>(g, x, y, shift, mul, rows, C, per,
                                      nblk, dx, dr, partial, stream);
  else
    launch_partial<T, V, false, false>(g, x, y, shift, mul, rows, C, per,
                                       nblk, dx, dr, partial, stream);
}

}  // namespace

extern "C" {

// g, x, y (y may be null without a ReLU), dx, dr (null unless gres, which
// needs a ReLU): [rows, C] in bf16 (bf16 != 0) or float32; shift, mul:
// [C] float32; partial: [nblk, 2, C] float32 scratch; out: [2, C] float32
// (row 0 sum dz, row 1 sum dz * (x - shift)).  vec: 16-byte accesses (C a
// multiple of 8 in bf16 or 4 in float32, every pointer on 16 bytes).
int bn_act_bwd(const void* g, const void* x, const void* y,
               const float* shift, const float* mul, long long rows, int C,
               int rows_per_block, int nblk, int bf16, int vec, int relu,
               int gres, void* dx, void* dr, float* partial, float* out,
               cudaStream_t stream) {
  if (rows < 1 || C < 1 || rows_per_block < 1 || nblk < 1 ||
      (relu && y == nullptr) || (gres && (!relu || dr == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (vec)
      dispatch_mask<__nv_bfloat16, 8>(relu, gres, g, x, y, shift, mul, rows,
                                      C, rows_per_block, nblk, dx, dr,
                                      partial, stream);
    else
      dispatch_mask<__nv_bfloat16, 1>(relu, gres, g, x, y, shift, mul, rows,
                                      C, rows_per_block, nblk, dx, dr,
                                      partial, stream);
  } else {
    if (vec)
      dispatch_mask<float, 4>(relu, gres, g, x, y, shift, mul, rows, C,
                              rows_per_block, nblk, dx, dr, partial, stream);
    else
      dispatch_mask<float, 1>(relu, gres, g, x, y, shift, mul, rows, C,
                              rows_per_block, nblk, dx, dr, partial, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_finalize<<<dim3((C + kFin - 1) / kFin), dim3(kFin, kFin), 0, stream>>>(
      partial, nblk, C, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
