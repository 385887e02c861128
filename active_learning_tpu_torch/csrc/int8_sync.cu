// The device steps of the int8 block-scaled gradient sync (kernel J).
//
// Replaces the per-device arithmetic of the JAX package's
// active_learning_tpu/parallel/mesh.py:472 int8_allreduce and :534
// int8_reduce_scatter (ROADMAP kernel K8).  The collectives (NCCL, or
// gloo staged through host memory) sit between the steps, so there are
// four entry points, each one launch over every gradient leaf at once
// (the wrapper packs the leaves into one flat float32 buffer in which
// every leaf starts on a block boundary):
//
//   int8_block_absmax    absmax[b] = max |x| over block b; +inf for a
//                        block holding a NaN or an inf (a cross-rank max
//                        carries +inf, not always NaN);
//   int8_quantize        scale = max(absmax, floor) * float32(1/127),
//                        q = clamp(rint(x / scale), -127, 127), an IEEE
//                        division (__fdiv_rn) and round-half-to-even:
//                        jnp.round of a true division; a non-finite
//                        block writes zeros.  Block b is written at slot
//                        slot_of_block[b] (identity when null), which
//                        orders the reduce-scatter form's all_to_all
//                        send buffer [dest][leaf][blocks];
//   int8_dequant_sum     out = (sum over T payloads of q) * scale[slot],
//                        NaN where absmax[b] is not finite.  The sum of
//                        T integers of magnitude <= 127 is exact in an
//                        int and in float32, so this is JAX's
//                        total * scale bit for bit;
//   int8_sum_requantize  the reduce-scatter owner: reduced = (sum over T
//                        of q) * my_scale, its block absmax, scale2 and
//                        int8 re-quantization in one pass.
//
// Bound: device-memory bytes.  Per element: absmax reads 4 bytes,
// quantize reads 4 and writes 1, dequant_sum reads T and writes 4,
// sum_requantize reads T and writes 1 (plus 4 bytes of scale per 256).
// A few flops an element, no reuse: nothing to tile.
//
// Design: one warp per 256-element block, 8 consecutive elements per
// lane (two 16-byte float loads, one 8-byte int8 load), the block's
// max by warp shuffles; 8 warps a CTA, grid-stride over the blocks.
// No float operation is contracted or reassociated: the products are
// __fmul_rn, the divisions __fdiv_rn, so the plain PyTorch version in
// ops/int8_sync.py gives the same bits.  The scale is a product with
// the float32 reciprocal of 127, not a division by 127: the JAX
// trainer runs its sync inside a jitted step, where XLA's algebraic
// simplifier rewrites `max(absmax, 1e-30) / 127.0` into that multiply
// (both scales, in the reduce-scatter form), and the port computes
// what the reference computes as users run it.
//
// C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kPerLane = 8;
constexpr int kWarps = 8;
constexpr int kMaxGrid = 132 * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInv127 = 1.0f / 127.0f;  // float32(1/127), as XLA folds it

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);  // torch's and numpy's NaN bits
}

__device__ __forceinline__ void load8(const float* p, float v[kPerLane]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float v[kPerLane]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Adds 8 signed bytes at p to acc.
__device__ __forceinline__ void add8q(const int8_t* p, int acc[kPerLane]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i] += (int)(int8_t)((u.x >> (8 * i)) & 0xffu);
    acc[4 + i] += (int)(int8_t)((u.y >> (8 * i)) & 0xffu);
  }
}

__device__ __forceinline__ void store8q(int8_t* p, const int v[kPerLane]) {
  unsigned lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo |= ((unsigned)v[i] & 0xffu) << (8 * i);
    hi |= ((unsigned)v[4 + i] & 0xffu) << (8 * i);
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

// The block's max |v| over the warp, +inf when any value is not finite.
__device__ __forceinline__ float warp_absmax(const float v[kPerLane]) {
  float m = 0.0f;
  bool bad = false;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    bad |= !isfinite(v[i]);
    m = fmaxf(m, fabsf(v[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  return __any_sync(kFull, bad) ? __int_as_float(0x7f800000) : m;
}

__device__ __forceinline__ float block_scale(float absmax, float floor) {
  return __fmul_rn(fmaxf(absmax, floor), kInv127);
}

// q = clamp(rint(v / scale), -127, 127); zeros when the block is not
// finite.
__device__ __forceinline__ void quantize8(const float v[kPerLane],
                                          float scale, bool finite,
                                          int q[kPerLane]) {
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], scale)), -127.0f),
                          127.0f);
    q[i] = finite ? (int)r : 0;
  }
}

__global__ void absmax_kernel(const float* __restrict__ x, long long nb,
                              float* __restrict__ absmax) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       b < nb; b += step) {
    float v[kPerLane];
    load8(x + b * kBlock + lane * kPerLane, v);
    const float m = warp_absmax(v);
    if (lane == 0) absmax[b] = m;
  }
}

__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ absmax,
                                const int* __restrict__ slot_of_block,
                                long long nb, float floor,
                                int8_t* __restrict__ q,
                                float* __restrict__ scale_by_slot) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       b < nb; b += step) {
    const long long slot = slot_of_block ? slot_of_block[b] : b;
    const float a = absmax[b];
    const float scale = block_scale(a, floor);
    float v[kPerLane];
    int qv[kPerLane];
    load8(x + b * kBlock + lane * kPerLane, v);
    quantize8(v, scale, isfinite(a), qv);
    store8q(q + slot * kBlock + lane * kPerLane, qv);
    if (lane == 0) scale_by_slot[slot] = scale;
  }
}

__global__ void dequant_sum_kernel(const int8_t* __restrict__ q, int T,
                                   long long stride,
                                   const int* __restrict__ slot_of_block,
                                   const float* __restrict__ scale_by_slot,
                                   const float* __restrict__ absmax,
                                   long long nb, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       b < nb; b += step) {
    const long long slot = slot_of_block ? slot_of_block[b] : b;
    int acc[kPerLane] = {0, 0, 0, 0, 0, 0, 0, 0};
    const int8_t* p = q + slot * kBlock + lane * kPerLane;
    for (int t = 0; t < T; ++t) add8q(p + t * stride, acc);
    const float s = scale_by_slot[slot];
    const bool finite = isfinite(absmax[b]);
    float v[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      v[i] = finite ? __fmul_rn((float)acc[i], s) : quiet_nan();
    store8(out + b * kBlock + lane * kPerLane, v);
  }
}

__global__ void sum_requantize_kernel(const int8_t* __restrict__ recv, int T,
                                      long long stride,
                                      const float* __restrict__ my_scale,
                                      long long ns, float floor,
                                      int8_t* __restrict__ q2,
                                      float* __restrict__ scale2) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long s = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       s < ns; s += step) {
    int acc[kPerLane] = {0, 0, 0, 0, 0, 0, 0, 0};
    const int8_t* p = recv + s * kBlock + lane * kPerLane;
    for (int t = 0; t < T; ++t) add8q(p + t * stride, acc);
    const float ms = my_scale[s];
    float v[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = __fmul_rn((float)acc[i], ms);
    const float a2 = warp_absmax(v);
    const float sc = block_scale(a2, floor);
    int qv[kPerLane];
    quantize8(v, sc, isfinite(a2), qv);
    store8q(q2 + s * kBlock + lane * kPerLane, qv);
    if (lane == 0) scale2[s] = sc;
  }
}

unsigned grid_for(long long blocks) {
  long long g = (blocks + kWarps - 1) / kWarps;
  return (unsigned)(g < kMaxGrid ? g : kMaxGrid);
}

}  // namespace

extern "C" {

// x: float32 [nb * 256], 16-byte aligned; absmax: float32 [nb].
int int8_block_absmax(const float* x, long long nb, float* absmax,
                      void* stream) {
  if (nb > 0)
    absmax_kernel<<<grid_for(nb), kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, nb, absmax);
  return (int)cudaGetLastError();
}

// slot_of_block: int32 [nb] or null (identity); q: int8 [nb * 256];
// scale_by_slot: float32 [nb].
int int8_quantize(const float* x, const float* absmax,
                  const int* slot_of_block, long long nb, float floor,
                  int8_t* q, float* scale_by_slot, void* stream) {
  if (nb > 0)
    quantize_kernel<<<grid_for(nb), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        x, absmax, slot_of_block, nb, floor, q, scale_by_slot);
  return (int)cudaGetLastError();
}

// q: int8 [T, stride], stride a multiple of 256 (payload t's slot s at
// q + t * stride + s * 256); out: float32 [nb * 256].
int int8_dequant_sum(const int8_t* q, int T, long long stride,
                     const int* slot_of_block, const float* scale_by_slot,
                     const float* absmax, long long nb, float* out,
                     void* stream) {
  if (nb > 0)
    dequant_sum_kernel<<<grid_for(nb), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        q, T, stride, slot_of_block, scale_by_slot, absmax, nb, out);
  return (int)cudaGetLastError();
}

// recv: int8 [T, stride] with ns slots of 256 per payload; my_scale:
// float32 [ns]; q2: int8 [ns * 256]; scale2: float32 [ns].
int int8_sum_requantize(const int8_t* recv, int T, long long stride,
                        const float* my_scale, long long ns, float floor,
                        int8_t* q2, float* scale2, void* stream) {
  if (ns > 0)
    sum_requantize_kernel<<<grid_for(ns), kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        recv, T, stride, my_scale, ns, floor, q2, scale2);
  return (int)cudaGetLastError();
}

}  // extern "C"
