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
// Design: one launch per step over a device-side table of leaves
// (param, grad, trace, numel), so ResNet-50's 161 leaves cost one launch,
// not 161.  A second table maps each block to (leaf, chunk of 4096
// elements); a block walks its chunk with its 256 threads, neighbouring
// threads on neighbouring elements.  The tables are built by the wrapper
// (active_learning_tpu_torch/ops/fused_sgd.py) and reused while the
// buffers stay where they are.
//
// C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_t(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_t(const __nv_bfloat16* p,
                                        long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_t(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_t(__nv_bfloat16* p, long long i,
                                        float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename TT, bool MOMENTUM, bool DECAY>
__global__ void sgd_kernel(const long long* __restrict__ leaves,
                           const int* __restrict__ chunks, int chunk,
                           float neg_lr, float mu, float wd) {
  const int leaf = chunks[2 * blockIdx.x];
  const long long start = (long long)chunks[2 * blockIdx.x + 1] * chunk;
  const long long* row = leaves + 4 * leaf;
  float* p = reinterpret_cast<float*>(row[0]);
  const float* g = reinterpret_cast<const float*>(row[1]);
  TT* t = reinterpret_cast<TT*>(row[2]);
  long long end = start + chunk;
  if (end > row[3]) end = row[3];
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    const float pv = p[i];
    float d = g[i];
    if (DECAY) d = __fadd_rn(d, __fmul_rn(wd, pv));
    if (MOMENTUM) {
      d = __fadd_rn(d, __fmul_rn(mu, load_t(t, i)));
      store_t(t, i, d);
    }
    p[i] = __fadd_rn(pv, __fmul_rn(neg_lr, d));
  }
}

template <typename TT>
void launch(const long long* leaves, const int* chunks, int nchunks,
            int chunk, int momentum, int decay, float neg_lr, float mu,
            float wd, cudaStream_t s) {
  const dim3 grid(nchunks), block(256);
  if (momentum && decay)
    sgd_kernel<TT, true, true><<<grid, block, 0, s>>>(leaves, chunks, chunk,
                                                      neg_lr, mu, wd);
  else if (momentum)
    sgd_kernel<TT, true, false><<<grid, block, 0, s>>>(leaves, chunks, chunk,
                                                       neg_lr, mu, wd);
  else if (decay)
    sgd_kernel<TT, false, true><<<grid, block, 0, s>>>(leaves, chunks, chunk,
                                                       neg_lr, mu, wd);
  else
    sgd_kernel<TT, false, false><<<grid, block, 0, s>>>(
        leaves, chunks, chunk, neg_lr, mu, wd);
}

}  // namespace

extern "C" {

// ``leaves``: device int64 [L, 4] = (param ptr, grad ptr, trace ptr,
// numel); ``chunks``: device int32 [nchunks, 2] = (leaf, chunk index).
int fused_sgd(const long long* leaves, const int* chunks, int nchunks,
              int chunk, int trace_bf16, int momentum, int decay,
              float neg_lr, float mu, float wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nchunks > 0) {
    if (trace_bf16)
      launch<__nv_bfloat16>(leaves, chunks, nchunks, chunk, momentum, decay,
                            neg_lr, mu, wd, s);
    else
      launch<float>(leaves, chunks, nchunks, chunk, momentum, decay, neg_lr,
                    mu, wd, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
