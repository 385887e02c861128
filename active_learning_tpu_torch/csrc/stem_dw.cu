// The s2d stem's weight gradient (kernel I).
//
// Replaces the JAX package's hand-written stem-conv backward,
// active_learning_tpu/ops/backward.py:65-117 _stem_conv_fn (its dW at
// :104-112; ROADMAP kernel K7), which S2DStemConv trains through
// (models/resnet.py:210-229).  Under --stem s2d the 7x7/s2 ImageNet stem
// is an exact 4x4/s1 conv over 12-channel space-to-depth input, and its
// weight gradient is the contraction over batch and space
//
//   dW[f, h, w, c] = sum_{b,i,j} x[b, i+h-ph0, j+w-pw0, c] * g[b, i, j, f]
//
// with x zero outside [0, H) x [0, W).  x is [B, H, W, C] and g is
// [B, Ho, Wo, F], both channels-last (NHWC memory), bf16 (the training
// path) or f32; dW is float32, written as [F, kh, kw, C] (the memory
// order of the channels-last float32 parameter [F, C, kh, kw]).  The JAX
// function reads bf16 and accumulates in float32 (XLA's own derivation
// would accumulate in bf16); so does this kernel: a bf16 x bf16 product
// is exact in float32, and every sum is a float32 fmaf.
//
// Bound, at the training shape (B=128, 112x112, C=12, F=64, 4x4): it
// reads 38.5 MB of x and 205.5 MB of g, 0.073 ms at 3.35 TB/s, which is
// the bound a tensor-core kernel could reach; it does 39.5 GFLOP, 0.589
// ms on the CUDA cores at 67 TFLOP/s, which bounds this kernel.
//
// Design (simple and right first; wgmma and TMA are a later step):
//   * deterministic and two-stage, as kernel C (csrc/bn_train.cu): the
//     output positions are cut into tiles of kTI x kTJ positions of one
//     image; the tiles are split into nblk contiguous runs whose length
//     depends on the shape alone (never on the SM count).  A block
//     stages each tile's g and its x window (with the kh-1, kw-1 halo,
//     zero outside the image) in shared memory as float32, accumulates
//     its outputs in registers over its run of tiles in a fixed order,
//     and writes one partial [F*kh*kw*C].  A second launch folds the
//     partials in block order.  No atomics: two launches on the same
//     input are bit-equal.
//   * each of a block's 256 threads owns 4 filters x C channels at one
//     tap (h, w): per position one float4 of g and C/4 float4 of x from
//     shared memory feed 4*C fmaf.  At 4x4 taps and F=64 the 256 threads
//     hold all 12,288 outputs; more taps or filters add blocks along
//     grid.y, each staging the same tiles.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// stem_conv.py.  Each function returns cudaGetLastError() after its
// launches; the wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 12;         // input channels: 2x2 blocks of RGB
constexpr int kTI = 4;         // output rows per tile
constexpr int kTJ = 28;        // output columns per tile
constexpr int kThreads = 256;  // threads per block: (tap, 4 filters) each

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stem_dw_partial(const T* __restrict__ x, const T* __restrict__ g, int B,
                    int H, int W, int Ho, int Wo, int F, int kh, int kw,
                    int ph0, int pw0, int tiles_per_block,
                    float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* gs = reinterpret_cast<float*>(smem4);   // [kTI][kTJ][F]
  float* xs = gs + kTI * kTJ * F;                // [kTI+kh-1][XJ][kC]
  const int XJ = kTJ + kw - 1;
  const int tid = threadIdx.x;
  const int fq = F / 4;
  const int items = kh * kw * fq;
  const int item = blockIdx.y * kThreads + tid;
  const bool active = item < items;
  const int tap = active ? item / fq : 0;
  const int fg = active ? item % fq : 0;
  const int h = tap / kw, w = tap % kw;

  const int nti = (Ho + kTI - 1) / kTI, ntj = (Wo + kTJ - 1) / kTJ;
  const long long ntiles = (long long)B * nti * ntj;
  const long long t_begin = (long long)blockIdx.x * tiles_per_block;
  long long t_end = t_begin + tiles_per_block;
  if (t_end > ntiles) t_end = ntiles;

  float acc[kC][4];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[c][q] = 0.f;

  for (long long t = t_begin; t < t_end; ++t) {
    const int b = (int)(t / (nti * ntj));
    const int rem = (int)(t % (nti * ntj));
    const int i0 = (rem / ntj) * kTI, j0 = (rem % ntj) * kTJ;
    const int ni = min(kTI, Ho - i0), nj = min(kTJ, Wo - j0);
    const int xi = ni + kh - 1, xj = nj + kw - 1;
    __syncthreads();  // the previous tile's reads are done
    // g tile: each output row's nj*F values are contiguous in memory.
    for (int idx = tid; idx < ni * nj * F; idx += kThreads) {
      const int ii = idx / (nj * F), r = idx % (nj * F);
      const long long src =
          ((long long)(b * Ho + i0 + ii) * Wo + j0) * F + r;
      gs[ii * kTJ * F + r] = load(g, src);
    }
    // x window with its halo, zero outside the image.
    for (int idx = tid; idx < xi * xj * kC; idx += kThreads) {
      const int r = idx / (xj * kC), s = (idx / kC) % xj, c = idx % kC;
      const int u = i0 + r - ph0, v = j0 + s - pw0;
      float val = 0.f;
      if (u >= 0 && u < H && v >= 0 && v < W)
        val = load(x, ((long long)(b * H + u) * W + v) * kC + c);
      xs[(r * XJ + s) * kC + c] = val;
    }
    __syncthreads();
    if (!active) continue;
    for (int ii = 0; ii < ni; ++ii) {
      for (int jj = 0; jj < nj; ++jj) {
        const float4 gv =
            *reinterpret_cast<const float4*>(gs + (ii * kTJ + jj) * F +
                                             fg * 4);
        const float4* xp = reinterpret_cast<const float4*>(
            xs + ((ii + h) * XJ + jj + w) * kC);
        float xv[kC];
#pragma unroll
        for (int k = 0; k < kC / 4; ++k) {
          const float4 v = xp[k];
          xv[4 * k] = v.x;
          xv[4 * k + 1] = v.y;
          xv[4 * k + 2] = v.z;
          xv[4 * k + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          acc[c][0] = fmaf(xv[c], gv.x, acc[c][0]);
          acc[c][1] = fmaf(xv[c], gv.y, acc[c][1]);
          acc[c][2] = fmaf(xv[c], gv.z, acc[c][2]);
          acc[c][3] = fmaf(xv[c], gv.w, acc[c][3]);
        }
      }
    }
  }
  if (!active) return;
  float* out = partial + (long long)blockIdx.x * F * kh * kw * kC;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int f = fg * 4 + q;
    float* o = out + ((f * kh + h) * kw + w) * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) o[c] = acc[c][q];
  }
}

// Second stage: dW[k] = sum over blocks, in block order.
__global__ void stem_dw_fold(const float* __restrict__ partial, int nblk,
                             int K, float* __restrict__ dw) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float s = 0.f;
  for (int j = 0; j < nblk; ++j) s += partial[(long long)j * K + k];
  dw[k] = s;
}

}  // namespace

extern "C" {

// dW [F, kh, kw, 12] f32 of the stride-1 conv of x [B, H, W, 12] with
// leading pads (ph0, pw0), given its output cotangent g [B, Ho, Wo, F];
// ``partial`` is [nblk, F*kh*kw*12] f32 scratch, nblk = ceil(tiles /
// tiles_per_block) with tiles = B * ceil(Ho/4) * ceil(Wo/28).
int stem_dw(const void* x, const void* g, int is_bf16, int B, int H, int W,
            int Ho, int Wo, int F, int kh, int kw, int ph0, int pw0,
            int tiles_per_block, int nblk, float* partial, float* dw,
            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int items = kh * kw * (F / 4);
  const dim3 grid(nblk, (items + kThreads - 1) / kThreads);
  const size_t smem =
      sizeof(float) * (kTI * kTJ * F + (kTI + kh - 1) * (kTJ + kw - 1) * kC);
  if (is_bf16)
    stem_dw_partial<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), B, H, W, Ho, Wo, F, kh, kw,
        ph0, pw0, tiles_per_block, partial);
  else
    stem_dw_partial<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), B, H, W,
        Ho, Wo, F, kh, kw, ph0, pw0, tiles_per_block, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int K = F * kh * kw * kC;
  stem_dw_fold<<<(K + 255) / 256, 256, 0, s>>>(partial, nblk, K, dw);
  return (int)cudaGetLastError();
}

}  // extern "C"
