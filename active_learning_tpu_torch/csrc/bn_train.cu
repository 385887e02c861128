// Training-mode BatchNorm: the per-channel reductions with the per-channel
// [C] chain folded into their last stage, and the one-pass input gradient
// (kernel C).
//
// Replaces the JAX package's hand-written training BatchNorm,
// active_learning_tpu/ops/backward.py:131-214 fused_bn_train (ROADMAP
// kernel K1, training half), the custom VJP FusedBatchNorm runs on every
// train step (models/resnet.py:153-170), and the autodiff of flax
// nn.BatchNorm in training mode.  A channels-last activation is read as a
// [rows, C] matrix (rows = N*H*W).  Device functions:
//
//   bn_sums, forward: s1 = sum x, s2 = sum x*x (f32 square and sums over
//     bf16 or f32 reads: E[x^2] - E[x]^2 cancels, the comment at
//     models/resnet.py:154-163 of the JAX package), then in the last
//     stage, per channel: mean = s1 * (1/n), mean2 = s2 * (1/n) (as XLA
//     takes a mean), var = max(mean2 - mean^2, 0), kernel B's (shift,
//     mul, add) in either formula (FusedBatchNorm: mul and sub rounded to
//     the activation dtype; flax: float32) and the running statistics
//     ra = 0.9 ra + 0.1 batch, updated in place.
//   bn_sums, backward: s1 = sum gy, s2 = sum gy*x, where gy is masked to 0
//     where the forward's output y is not positive (the ReLU's gradient;
//     y is read only when the BatchNorm had one), then per channel
//     backward.py:174-203's chain: dscale, dbias, mul (the forward's, as
//     the forward rounded it), c2, c1 with the balanced clamp gradient.
//   bn_chain: the same per-channel chains from all-reduced sums, for N
//     ranks (forward: the sums divided by the rank count; backward: mul,
//     c2, c1 over every rank's rows, while dscale and dbias stay this
//     rank's share, written by its own bn_sums).
//   bn_dx: dx = gy*mul + x*c2 + c1 per element (gy masked as above), in
//     f32 with one rounding to the activation dtype; with a residual it
//     also writes the masked gy, the residual's gradient.
//
// Rounding.  Every step of the chains is a separately rounded
// __fmul_rn / __fadd_rn / __fsub_rn, in the order the port's plain
// version (PyTorch ops on [C] tensors) takes them: nvcc contracts a*b+c
// to an FMA unless told not to.  The reciprocal square root is rsqrtf,
// the function PyTorch's CUDA rsqrt calls; a division by a Python number
// is a multiply by its float32 reciprocal, as PyTorch's CUDA division by
// a scalar computes it.  So on the card the chains equal the plain
// version's bit for bit.
//
// Bound: device-memory bytes.  Per element the statistics read x, the
// backward reduction reads gy, x and (with a ReLU) y, bn_dx reads gy, x
// and y and writes dx (and the residual's gradient): a few flops per
// element, far below the card's ridge point.
//
// Design: 16-byte accesses, each thread owning 8 bf16 or 4 f32 channels
// of a row (1 channel when C is not a multiple of that), so a warp reads
// whole 512-byte runs of a row.  The reductions are deterministic and
// two-stage, with no atomics: the row range is cut into blocks whose size
// depends on the shape alone (never the SM count or occupancy); a block's
// row lanes sum their rows in order, the block folds its lanes in a fixed
// order into one partial per channel of [nblk, 2, C]; the last stage
// folds those partials in a fixed order and runs the chain.  Two launches
// on the same input give bit-equal results.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// bn_train.py.  Each function returns cudaGetLastError() after its
// launches; the wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The last stage's work (the C entry points take it by pointer, so it
// lives outside the anonymous namespace).
enum Kind {
  kMeans = 0,        // out: mean, mean2
  kForward = 1,      // out: mean, mean2, var, shift, mul, add; running update
  kBackward = 2,     // out: s1, s2, dscale, dbias, mul, c2, c1
  kBackwardLocal = 3,  // out: s1, s2, dscale, dbias
  kBackwardMul = 4,  // out[4..6]: mul, c2, c1 (bn_chain from global sums)
};

struct Chain {
  int kind, fused, round_bf16, pad;
  float inv;    // the sums' multiplier: 1/n for the statistics, 1 backward
  float pre;    // bn_chain forward: 1/world applied to the all-reduced means
  float eps, mom, mom1;
  float inv_n;  // backward: float32(1) / float32(rows over every rank)
  const float* scale;
  const float* bias;
  const float* mean;   // backward: the forward's statistics
  const float* mean2;
  float* run_mean;     // forward: updated in place when not null
  float* run_var;
  float* out[8];
};

namespace {

constexpr int kThreads = 256;  // reduction and dx blocks
constexpr int kFin = 32;       // last stage: 32 channels x 32 lanes

// ---- 16-byte (or scalar) access --------------------------------------------

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

// ---- the per-channel chains ------------------------------------------------

__device__ __forceinline__ float to_dtype(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// mean, mean2 -> var, kernel B's coefficients, the running statistics.
__device__ void forward_chain(const Chain& ch, int c, float mean, float mean2) {
  const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  const float r = rsqrtf(__fadd_rn(var, ch.eps));
  const float sc = ch.scale[c], bi = ch.bias[c];
  float shift, mul, add;
  if (ch.fused) {
    // (scale * rsqrt(var + eps)).to(dtype); mean.to(dtype) * mul -
    // bias.to(dtype) in the dtype; shift 0, add -sub.
    const int b = ch.round_bf16;
    mul = to_dtype(__fmul_rn(sc, r), b);
    const float t = to_dtype(__fmul_rn(to_dtype(mean, b), mul), b);
    const float sub = to_dtype(__fsub_rn(t, to_dtype(bi, b)), b);
    shift = 0.f;
    add = -sub;
  } else {
    shift = mean;
    mul = __fmul_rn(r, sc);
    add = bi;
  }
  ch.out[0][c] = mean;
  ch.out[1][c] = mean2;
  ch.out[2][c] = var;
  ch.out[3][c] = shift;
  ch.out[4][c] = mul;
  ch.out[5][c] = add;
  if (ch.run_mean != nullptr) {
    ch.run_mean[c] = __fadd_rn(__fmul_rn(ch.mom, ch.run_mean[c]),
                               __fmul_rn(ch.mom1, mean));
    ch.run_var[c] = __fadd_rn(__fmul_rn(ch.mom, ch.run_var[c]),
                              __fmul_rn(ch.mom1, var));
  }
}

// s1 = sum gy, s2 = sum gy*x -> backward.py:174-203's coefficients.
__device__ void backward_chain(const Chain& ch, int c, float s1, float s2,
                               int kind) {
  const float mean = ch.mean[c], mean2 = ch.mean2[c], sc = ch.scale[c];
  const float a_pre = __fsub_rn(mean2, __fmul_rn(mean, mean));
  const float var = fmaxf(a_pre, 0.f);
  const float r = rsqrtf(__fadd_rn(var, ch.eps));
  const float mulf = __fmul_rn(sc, r);
  const float mul = ch.fused ? to_dtype(mulf, ch.round_bf16) : mulf;
  const float dmul = __fsub_rn(s2, __fmul_rn(s1, mean));
  if (kind != kBackwardMul) {
    ch.out[0][c] = s1;
    ch.out[1][c] = s2;
    ch.out[2][c] = __fmul_rn(dmul, r);  // dscale
    ch.out[3][c] = s1;                  // dbias
  }
  if (kind == kBackwardLocal) return;
  const float dvar = __fmul_rn(
      __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(dmul, sc), -0.5f), r), r), r);
  // jax's balanced gradient of max(a, 0): half at a == 0.
  const float f = a_pre > 0.f ? 1.f : (a_pre == 0.f ? 0.5f : 0.f);
  const float da = __fmul_rn(dvar, f);
  const float dmean = __fsub_rn(__fmul_rn(-s1, mul),
                                __fmul_rn(__fmul_rn(2.f, mean), da));
  ch.out[4][c] = mul;
  ch.out[5][c] = __fmul_rn(__fmul_rn(2.f, da), ch.inv_n);  // c2
  ch.out[6][c] = __fmul_rn(dmean, ch.inv_n);               // c1
}

__device__ __forceinline__ void run_chain(const Chain& ch, int c, float s1,
                                          float s2) {
  switch (ch.kind) {
    case kMeans:
      ch.out[0][c] = __fmul_rn(s1, ch.inv);
      ch.out[1][c] = __fmul_rn(s2, ch.inv);
      break;
    case kForward:
      forward_chain(ch, c, __fmul_rn(s1, ch.inv), __fmul_rn(s2, ch.inv));
      break;
    default:
      backward_chain(ch, c, s1, s2, ch.kind);
  }
}

// ---- the reductions --------------------------------------------------------

// Channel groups of V channels a block row: G threads cover G*V channels,
// kThreads / G row lanes.
__host__ __device__ __forceinline__ int group_width(int C, int V) {
  const int groups = C / V;
  int g = 1;
  while (g < groups && g < 32) g <<= 1;
  return g;
}

// partial[blk][0][c] = sum a, partial[blk][1][c] = sum a*b over the block's
// rows; MODE 0: b = a (statistics), 1: a*b, 2: a masked where y <= 0.
template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kThreads) sums_partial(
    const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ y,
    long long rows, int C, int G, int rows_per_block,
    float* __restrict__ partial) {
  __shared__ float sh[2 * kThreads * V];
  const int L = kThreads / G, GV = G * V;
  const int g = threadIdx.x % G, l = threadIdx.x / G;
  const int c0 = blockIdx.y * GV + g * V;
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (c0 < C) {
    const long long r_begin = (long long)blockIdx.x * rows_per_block;
    const long long r_end = min(r_begin + rows_per_block, rows);
    for (long long r = r_begin + l; r < r_end; r += L) {
      const long long off = r * C + c0;
      float va[V], vb[V];
      Vec<T, V>::load(a + off, va);
      if (MODE == 0) {
#pragma unroll
        for (int i = 0; i < V; ++i) vb[i] = va[i];
      } else {
        Vec<T, V>::load(b + off, vb);
      }
      if (MODE == 2) {
        float vy[V];
        Vec<T, V>::load(y + off, vy);
#pragma unroll
        for (int i = 0; i < V; ++i) va[i] = vy[i] > 0.f ? va[i] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1[i] = __fadd_rn(s1[i], va[i]);
        s2[i] = __fadd_rn(s2[i], __fmul_rn(va[i], vb[i]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sh[l * GV + g * V + i] = s1[i];
    sh[(L + l) * GV + g * V + i] = s2[i];
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

// Fold the [nblk, 2, C] partials in a fixed order, then the chain.
__global__ void __launch_bounds__(kFin * kFin) sums_finalize(
    const float* __restrict__ partial, int nblk, int C, Chain ch) {
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
    run_chain(ch, c, t1, t2);
  }
}

// The chains from all-reduced [2, C] sums (N ranks).
__global__ void chain_kernel(const float* __restrict__ in, int C, Chain ch) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  if (ch.kind == kForward)
    forward_chain(ch, c, __fmul_rn(in[c], ch.pre), __fmul_rn(in[C + c], ch.pre));
  else
    backward_chain(ch, c, in[c], in[C + c], kBackwardMul);
}

template <typename T, int V, bool MASK, bool GRES>
__global__ void __launch_bounds__(kThreads) dx_kernel(
    const T* __restrict__ gy, const T* __restrict__ x,
    const T* __restrict__ y, long long rows, int C, int G,
    int rows_per_block, const float* __restrict__ mul,
    const float* __restrict__ c2, const float* __restrict__ c1,
    T* __restrict__ dx, T* __restrict__ gres) {
  const int L = kThreads / G, GV = G * V;
  const int g = threadIdx.x % G, l = threadIdx.x / G;
  const int c0 = blockIdx.y * GV + g * V;
  if (c0 >= C) return;
  float m[V], k2[V], k1[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = mul[c0 + i];
    k2[i] = c2[c0 + i];
    k1[i] = c1[c0 + i];
  }
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end = min(r_begin + rows_per_block, rows);
  for (long long r = r_begin + l; r < r_end; r += L) {
    const long long off = r * C + c0;
    float vg[V], vx[V], out[V];
    Vec<T, V>::load(gy + off, vg);
    Vec<T, V>::load(x + off, vx);
    if (MASK) {
      float vy[V];
      Vec<T, V>::load(y + off, vy);
#pragma unroll
      for (int i = 0; i < V; ++i) vg[i] = vy[i] > 0.f ? vg[i] : 0.f;
      if (GRES) Vec<T, V>::store(gres + off, vg);
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
      out[i] = __fadd_rn(__fadd_rn(__fmul_rn(vg[i], m[i]),
                                   __fmul_rn(vx[i], k2[i])),
                         k1[i]);
    Vec<T, V>::store(dx + off, out);
  }
}

template <typename T, int V>
cudaError_t launch_sums(const void* a, const void* b, const void* y, int mode,
                        long long rows, int C, int rows_per_block, int nblk,
                        float* partial, cudaStream_t s) {
  const int G = group_width(C, V);
  const dim3 grid(nblk, (C / V + G - 1) / G);
  auto pa = static_cast<const T*>(a);
  auto pb = static_cast<const T*>(b);
  auto py = static_cast<const T*>(y);
  if (mode == 0)
    sums_partial<T, V, 0><<<grid, kThreads, 0, s>>>(pa, pb, py, rows, C, G,
                                                    rows_per_block, partial);
  else if (mode == 1)
    sums_partial<T, V, 1><<<grid, kThreads, 0, s>>>(pa, pb, py, rows, C, G,
                                                    rows_per_block, partial);
  else
    sums_partial<T, V, 2><<<grid, kThreads, 0, s>>>(pa, pb, py, rows, C, G,
                                                    rows_per_block, partial);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_dx(const void* gy, const void* x, const void* y,
                      long long rows, int C, int rows_per_block, int nblk,
                      const float* mul, const float* c2, const float* c1,
                      void* dx, void* gres, cudaStream_t s) {
  const int G = group_width(C, V);
  const dim3 grid(nblk, (C / V + G - 1) / G);
  auto pg = static_cast<const T*>(gy);
  auto px = static_cast<const T*>(x);
  auto py = static_cast<const T*>(y);
  auto pd = static_cast<T*>(dx);
  auto pr = static_cast<T*>(gres);
  if (y == nullptr)
    dx_kernel<T, V, false, false><<<grid, kThreads, 0, s>>>(
        pg, px, py, rows, C, G, rows_per_block, mul, c2, c1, pd, pr);
  else if (gres == nullptr)
    dx_kernel<T, V, true, false><<<grid, kThreads, 0, s>>>(
        pg, px, py, rows, C, G, rows_per_block, mul, c2, c1, pd, pr);
  else
    dx_kernel<T, V, true, true><<<grid, kThreads, 0, s>>>(
        pg, px, py, rows, C, G, rows_per_block, mul, c2, c1, pd, pr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-channel sums of a [rows, C] buffer and the chain `ch` on them.
// mode 0: (sum a, sum a*a); 1: (sum a, sum a*b); 2: as 1 with a masked
// where y <= 0.  vec: 16-byte access (C a multiple of 8 in bf16, 4 in
// f32, 16-byte aligned buffers), else one channel a thread.  partial:
// [nblk, 2, C] f32 scratch.
int bn_sums(const void* a, const void* b, const void* y, int mode,
            int is_bf16, int vec, long long rows, int C, int rows_per_block,
            int nblk, float* partial, const Chain* ch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = vec ? launch_sums<__nv_bfloat16, 8>(a, b, y, mode, rows, C,
                                              rows_per_block, nblk, partial, s)
              : launch_sums<__nv_bfloat16, 1>(a, b, y, mode, rows, C,
                                              rows_per_block, nblk, partial, s);
  else
    err = vec ? launch_sums<float, 4>(a, b, y, mode, rows, C, rows_per_block,
                                      nblk, partial, s)
              : launch_sums<float, 1>(a, b, y, mode, rows, C, rows_per_block,
                                      nblk, partial, s);
  if (err != cudaSuccess) return (int)err;
  sums_finalize<<<(C + kFin - 1) / kFin, dim3(kFin, kFin), 0, s>>>(
      partial, nblk, C, *ch);
  return (int)cudaGetLastError();
}

// The chain `ch` (kForward or kBackwardMul) from all-reduced [2, C] sums.
int bn_chain(const float* in, int C, const Chain* ch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chain_kernel<<<(C + 255) / 256, 256, 0, s>>>(in, C, *ch);
  return (int)cudaGetLastError();
}

// dx = gy*mul + x*c2 + c1 (per-channel f32 coefficients), rounded once;
// gy masked where y <= 0 when y is given, and then written to gres when
// gres is given.
int bn_dx(const void* gy, const void* x, const void* y, int is_bf16, int vec,
          long long rows, int C, int rows_per_block, int nblk,
          const float* mul, const float* c2, const float* c1, void* dx,
          void* gres, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = vec ? launch_dx<__nv_bfloat16, 8>(gy, x, y, rows, C, rows_per_block,
                                            nblk, mul, c2, c1, dx, gres, s)
              : launch_dx<__nv_bfloat16, 1>(gy, x, y, rows, C, rows_per_block,
                                            nblk, mul, c2, c1, dx, gres, s);
  else
    err = vec ? launch_dx<float, 4>(gy, x, y, rows, C, rows_per_block, nblk,
                                    mul, c2, c1, dx, gres, s)
              : launch_dx<float, 1>(gy, x, y, rows, C, rows_per_block, nblk,
                                    mul, c2, c1, dx, gres, s);
  return (int)err;
}

}  // extern "C"
