// Kernel F: MASE's distances to the linear head's one-vs-one decision
// boundaries, and the head's pairwise row distances.
//
// Replaces the JAX package's active_learning_tpu/strategies/scoring.py:196-206
// head_pair_norms and :209-267 boundary_radii (ROADMAP K5), which make_mase_step
// (:270-311) runs once per scored batch.  With the head W [C, D] (the flax
// kernel transposed) and bias b [C], per row e [D] of a batch:
//     pred   = argmax_c (e . w_c + b_c)             (first index on ties)
//     numer  = e . (w_pred - w_j) + b_pred - b_j    for every class j
//     radius = numer / max(norm, 1e-30) where norm = ||w_pred - w_j|| > 0,
//              +inf where the norm is 0 (j == pred, or duplicate rows)
//     min_margin = min_j radius
// The weight DIFFERENCE is formed before the dot product, element by
// element: the algebraically equal logit difference subtracts two large
// rounded dot products and loses the small margins between near-duplicate
// head rows (scoring.py:217-226).  The pair norms are computed by explicit
// row differences too, never through the Gram identity, whose cancellation
// would report near-duplicate rows as coincident (norm 0, radius +inf).
//
// Entry points:
//   br_radii       logits tile pass, per-row argmax, the radius tile pass
//                  (w_pred rows gathered per row), per-row min.
//   br_pair_norms  [C, C] = ||w_c - w_j||, once per head (make_mase_step's
//                  one-slot cache).
// Every dot product is one float32 fmaf chain in ascending feature order;
// sums with the biases are __fadd_rn/__fsub_rn, as the plain version's
// separate ops round them.
//
// Bound.  At the main path's shape (B = 256, C = 1000, D = 2048) a call
// reads 10 MB (W, the batch, a row of the norm table per row) and does
// 2*B*C*D flops for the logits and 3*B*C*D for the radii: 2.6 GFLOP, so
// operations (39 us at 67 TFLOP/s float32 outside the tensor cores; 3 us of
// memory).  The pair norms: 3*C*C*D flops, 6.1 GFLOP.  Design: 64 x 64
// output tiles over shared-memory tiles of 16 features, a 4 x 4 register
// block per thread.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// boundary_radii.py.  Each function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int KC = 16;
constexpr int TR = 64, TC = 64, RM = 4, CM = 4;
constexpr int THREADS = (TR / RM) * (TC / CM);  // 256
constexpr unsigned kFull = 0xffffffffu;

// Load a TRxKC tile of rows `rows[r]` (or row0 + r when rows is null) of a
// row-major [*, d] matrix into S[k][r], zero outside.
template <int T>
__device__ __forceinline__ void load_tile(float (*S)[T + 1],
                                          const float* __restrict__ m, int d,
                                          int nrows, int row0,
                                          const int* __restrict__ rows,
                                          int k0) {
  for (int e = threadIdx.x; e < T * KC; e += THREADS) {
    const int r = e / KC, k = e % KC;
    const int rr = row0 + r, col = k0 + k;
    float v = 0.f;
    if (rr < nrows && col < d) {
      const int src = rows != nullptr ? rows[rr] : rr;
      v = m[(size_t)src * d + col];
    }
    S[k][r] = v;
  }
}

// logits[b, c] = (e_b . w_c) + bias_c
__global__ void __launch_bounds__(THREADS) logits_kernel(
    const float* __restrict__ e, const float* __restrict__ w,
    const float* __restrict__ bias, int B, int C, int D,
    float* __restrict__ logits) {
  __shared__ float As[KC][TR + 1];
  __shared__ float Bs[KC][TC + 1];
  const int row0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int tr = threadIdx.x / (TC / CM), tc = threadIdx.x % (TC / CM);
  float acc[RM][CM] = {};
  for (int k0 = 0; k0 < D; k0 += KC) {
    load_tile<TR>(As, e, D, B, row0, nullptr, k0);
    load_tile<TC>(Bs, w, D, C, c0, nullptr, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j)
          acc[i][j] = fmaf(As[k][tr * RM + i], Bs[k][tc * CM + j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int b = row0 + tr * RM + i;
#pragma unroll
    for (int j = 0; j < CM; ++j) {
      const int c = c0 + tc * CM + j;
      if (b < B && c < C) logits[(size_t)b * C + c] = __fadd_rn(acc[i][j], bias[c]);
    }
  }
}

// Per row: argmax (first index on ties) into arg, or the min into out.
__global__ void row_reduce_kernel(const float* __restrict__ x, int C,
                                  int* __restrict__ arg,
                                  float* __restrict__ out) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const float* row = x + (size_t)blockIdx.x * C;
  const bool want_max = arg != nullptr;
  float v = want_max ? -INFINITY : INFINITY;
  int idx = INT_MAX;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float y = row[c];
    if (want_max ? (y > v || (y == v && c < idx)) : y < v) {
      v = y;
      idx = c;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    const int j = __shfl_xor_sync(kFull, idx, o);
    if (want_max ? (w > v || (w == v && j < idx)) : w < v) {
      v = w;
      idx = j;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) {
      if (want_max ? (sv[k] > v || (sv[k] == v && si[k] < idx)) : sv[k] < v) {
        v = sv[k];
        idx = si[k];
      }
    }
    if (want_max)
      arg[blockIdx.x] = idx == INT_MAX ? 0 : idx;
    else
      out[blockIdx.x] = v;
  }
}

// radii[b, j] from numer = sum_d e_bd * (w_pred(b),d - w_jd), in tiles.
__global__ void __launch_bounds__(THREADS) radii_kernel(
    const float* __restrict__ e, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ norms,
    const int* __restrict__ preds, int B, int C, int D,
    float* __restrict__ radii) {
  __shared__ float As[KC][TR + 1];
  __shared__ float Ps[KC][TR + 1];
  __shared__ float Bs[KC][TC + 1];
  const int row0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int tr = threadIdx.x / (TC / CM), tc = threadIdx.x % (TC / CM);
  float acc[RM][CM] = {};
  for (int k0 = 0; k0 < D; k0 += KC) {
    load_tile<TR>(As, e, D, B, row0, nullptr, k0);
    load_tile<TR>(Ps, w, D, B, row0, preds, k0);
    load_tile<TC>(Bs, w, D, C, c0, nullptr, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = As[k][tr * RM + i], p = Ps[k][tr * RM + i];
#pragma unroll
        for (int j = 0; j < CM; ++j)
          acc[i][j] = fmaf(a, __fsub_rn(p, Bs[k][tc * CM + j]), acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int b = row0 + tr * RM + i;
    if (b >= B) continue;
    const int pred = preds[b];
#pragma unroll
    for (int j = 0; j < CM; ++j) {
      const int c = c0 + tc * CM + j;
      if (c >= C) continue;
      const float numer = __fsub_rn(__fadd_rn(acc[i][j], bias[pred]), bias[c]);
      const float denom = norms[(size_t)pred * C + c];
      radii[(size_t)b * C + c] =
          denom > 0.f ? __fdiv_rn(numer, fmaxf(denom, 1e-30f)) : INFINITY;
    }
  }
}

// norms[c, j] = sqrt(sum_d (w_cd - w_jd)^2)
__global__ void __launch_bounds__(THREADS) pair_norms_kernel(
    const float* __restrict__ w, int C, int D, float* __restrict__ norms) {
  __shared__ float As[KC][TR + 1];
  __shared__ float Bs[KC][TC + 1];
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int tr = threadIdx.x / (TC / CM), tc = threadIdx.x % (TC / CM);
  float acc[RM][CM] = {};
  for (int k0 = 0; k0 < D; k0 += KC) {
    load_tile<TR>(As, w, D, C, r0, nullptr, k0);
    load_tile<TC>(Bs, w, D, C, c0, nullptr, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          const float dlt = __fsub_rn(As[k][tr * RM + i], Bs[k][tc * CM + j]);
          acc[i][j] = fmaf(dlt, dlt, acc[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + tr * RM + i;
#pragma unroll
    for (int j = 0; j < CM; ++j) {
      const int c = c0 + tc * CM + j;
      if (r < C && c < C) norms[(size_t)r * C + c] = sqrtf(acc[i][j]);
    }
  }
}

inline dim3 tiles(int rows, int cols) {
  return dim3((cols + TC - 1) / TC, (rows + TR - 1) / TR);
}

}  // namespace

extern "C" {

// e [B, D], w [C, D], bias [C], norms [C, C] (br_pair_norms of w); logits
// [B, C] is scratch.  Writes preds [B] (int32), radii [B, C], min_margin [B].
int br_radii(const float* e, const float* w, const float* bias,
             const float* norms, int B, int C, int D, float* logits,
             int* preds, float* radii, float* min_margin,
             cudaStream_t stream) {
  if (B < 1 || C < 1 || D < 1) return cudaErrorInvalidValue;
  logits_kernel<<<tiles(B, C), THREADS, 0, stream>>>(e, w, bias, B, C, D,
                                                     logits);
  row_reduce_kernel<<<B, 256, 0, stream>>>(logits, C, preds, nullptr);
  radii_kernel<<<tiles(B, C), THREADS, 0, stream>>>(e, w, bias, norms, preds,
                                                    B, C, D, radii);
  row_reduce_kernel<<<B, 256, 0, stream>>>(radii, C, nullptr, min_margin);
  return (int)cudaGetLastError();
}

int br_pair_norms(const float* w, int C, int D, float* norms,
                  cudaStream_t stream) {
  if (C < 1 || D < 1) return cudaErrorInvalidValue;
  pair_norms_kernel<<<tiles(C, C), THREADS, 0, stream>>>(w, C, D, norms);
  return (int)cudaGetLastError();
}

}  // extern "C"
