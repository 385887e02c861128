// Kernel E: the k-center distance fold, the masked top-q and the D^2 draw.
//
// Replaces the JAX package's k-center device functions (ROADMAP K4): the
// Pallas kernel ops/kcenter_pallas.py::fused_update_argmax (added 7ffa47a,
// deleted eaf35d5) and what took its place at HEAD,
// active_learning_tpu/strategies/scoring.py:45-61 batched_min_dist_update,
// strategies/kcenter.py:165-170 _min_dist_chunk, :189-227 _kcenter_scan
// (the D^2 draw is its randomized arm) and :294-331 _kcenter_scan_batched.
//
// The pool is held as factor matrices: one (Coreset, F [N, D]) or two
// (BADGE, A [N, C] and E [N, D]); a dot product is the product over the
// factors of the factors' dot products.  For each row i and center c:
//     d_ic = (sqn_i + sqn_c) - 2 * prod_F (F_i . F_c)
// and the fold is min_dist_i <- min(min_dist_i, min_c d_ic).
//
// Three entry points share one tile loop:
//   kc_fold_select  fold <= 8 centers, clear their `selectable`, then the
//                   masked top-q of where(selectable > 0, min_dist, -inf)
//                   as block-local candidates, and a one-block merge.
//                   q = 1 is the sequential scan's argmax.
//   kc_fold_draw    fold <= 1 center, then the D^2 Gumbel-max draw over
//                   weights clip(min_dist, 0) * selectable (or selectable
//                   when those sum to 0), block-local and merged.
//   kc_min_fold     fold up to any number of centers (the labeled set's
//                   initial min), no reduce.
// Centers are read from device memory, so a scan step's pick feeds the
// next step's fold without the host.
//
// Arithmetic.  Every dot product is a float32 fmaf chain in ascending
// feature order, one chain per (row, center): the result does not depend
// on the tiling or the scheduling.  No tensor core and no TF32: the JAX
// package selects in float32.  The distance is formed as (sqn_i + sqn_c)
// minus 2*dot with __fadd_rn/__fsub_rn, as the plain version's separate
// ops do.  Top-q ranks by value, then by the LOWER row index, the order
// jax.lax.top_k and argmax use; every reduction is a max/min under that
// total order, so it is exact whatever the tree.
//
// The D^2 draw generates its own random bits: Threefry-2x32 (20 rounds)
// of the 64-bit row counter under the step's key, the two output words
// xored (JAX's partitionable random_bits), then uniform(tiny, 1) and
// -log(-log u) exactly as utils/threefry.py computes them.  The integer
// bits equal JAX's; logf may differ from the host's log by an ulp.
//
// Bound.  A fold over q <= 8 centers reads each factor row once and does
// 2*q flops per element: 1 GB per pass at N = 131,072 x 2048, so memory
// (0.32 ms at 3.35 TB/s).  The initial min over L labeled centers does
// 2*L flops per element: operations (67 TFLOP/s float32 outside the
// tensor cores).  Design: shared-memory tiles of TR rows x TC centers x 16
// features; the fold tile is 128 rows x 8 centers with one row per thread
// (center values broadcast from shared memory), the initial-min tile
// 64 x 64 with a 4 x 4 register block per thread.  Candidates: one block
// keeps its q best, one block of 1024 threads merges them.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// kcenter.py.  Each function returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int KC = 16;       // features per shared-memory tile
constexpr int MAXQ = 8;      // centers per fold, candidates per block
constexpr int MERGE_THREADS = 1024;
constexpr unsigned kFull = 0xffffffffu;

// ---- ranking ---------------------------------------------------------------

struct Cand {
  float v;
  int i;
  float p;  // the draw's weight at the row (kc_fold_draw only)
};

__device__ __forceinline__ bool ranks_before(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ Cand better(const Cand& a, const Cand& b) {
  return ranks_before(b.v, b.i, a.v, a.i) ? b : a;
}

__device__ __forceinline__ Cand shfl_cand(const Cand& c, int o) {
  Cand r;
  r.v = __shfl_xor_sync(kFull, c.v, o);
  r.i = __shfl_xor_sync(kFull, c.i, o);
  r.p = __shfl_xor_sync(kFull, c.p, o);
  return r;
}

// The best candidate of the block; `sh` holds one entry per warp.  Every
// thread returns the winner.
__device__ Cand block_best(Cand c, Cand* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c = better(c, shfl_cand(c, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) sh[warp] = c;
  __syncthreads();
  if (warp == 0) {
    Cand w = lane < nwarps ? sh[lane] : Cand{-INFINITY, INT_MAX, 0.f};
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w = better(w, shfl_cand(w, o));
    if (lane == 0) sh[32] = w;
  }
  __syncthreads();
  Cand out = sh[32];
  __syncthreads();
  return out;
}

__device__ __forceinline__ Cand none() { return Cand{-INFINITY, INT_MAX, 0.f}; }

// ---- Threefry-2x32 ---------------------------------------------------------

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void tf_rounds(uint32_t& x0, uint32_t& x1, int a,
                                          int b, int c, int d) {
  x0 += x1; x1 = rotl(x1, a); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, b); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, c); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, d); x1 ^= x0;
}

// 32 random bits at counter `idx` under key (k0, k1): JAX's partitionable
// threefry random_bits, bits1 ^ bits2 of the hash of (idx >> 32, idx).
__device__ __forceinline__ uint32_t tf_bits(uint32_t k0, uint32_t k1,
                                            uint64_t idx) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)(idx >> 32) + k0;
  uint32_t x1 = (uint32_t)idx + k1;
  tf_rounds(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  tf_rounds(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  tf_rounds(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  tf_rounds(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  tf_rounds(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

// -log(-log u), u = max(tiny, f * (1 - tiny) + tiny) with f in [0, 1) from
// the top 23 bits; 1 - tiny rounds to 1 in float32, so f * 1 is exact.
__device__ __forceinline__ float tf_gumbel(uint32_t bits) {
  const float tiny = 1.17549435e-38f;
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(tiny, __fadd_rn(f, tiny));
  return -logf(-logf(u));
}

// ---- the tile loop ---------------------------------------------------------

// acc[i][j] = F_row . F_center over one factor, for this thread's RM rows
// and CM centers of the TR x TC tile at (row0, c0).  Each dot product is
// one fmaf chain in ascending feature order.
template <int TR, int TC, int RM, int CM>
__device__ __forceinline__ void tile_dots(
    const float* __restrict__ f, int d, int n, int row0,
    const int64_t* __restrict__ centers, int c0, int nc,
    float (*As)[TR + 1], float (*Bs)[TC + 1], float (&acc)[RM][CM]) {
  constexpr int THREADS = (TR / RM) * (TC / CM);
  const int t = threadIdx.x;
  const int tr = t / (TC / CM), tc = t % (TC / CM);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CM; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += KC) {
    for (int e = t; e < TR * KC; e += THREADS) {
      const int r = e / KC, k = e % KC;
      const int row = row0 + r, col = k0 + k;
      As[k][r] = (row < n && col < d) ? f[(size_t)row * d + col] : 0.f;
    }
    for (int e = t; e < TC * KC; e += THREADS) {
      const int c = e / KC, k = e % KC;
      const int ci = c0 + c, col = k0 + k;
      Bs[k][c] = (ci < nc && col < d) ? f[(size_t)centers[ci] * d + col]
                                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float a[RM], b[CM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[k][tr * RM + i];
#pragma unroll
      for (int j = 0; j < CM; ++j) b[j] = Bs[k][tc * CM + j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int TR, int TC, int RM, int CM>
__device__ __forceinline__ void tile_products(
    const float* f1, int d1, const float* f2, int d2, int n, int row0,
    const int64_t* centers, int c0, int nc, float (*As)[TR + 1],
    float (*Bs)[TC + 1], float (&prod)[RM][CM]) {
  tile_dots<TR, TC, RM, CM>(f1, d1, n, row0, centers, c0, nc, As, Bs, prod);
  if (f2 != nullptr) {
    float acc[RM][CM];
    tile_dots<TR, TC, RM, CM>(f2, d2, n, row0, centers, c0, nc, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) prod[i][j] = __fmul_rn(prod[i][j], acc[i][j]);
  }
}

__device__ __forceinline__ float sq_dist(float sqn_i, float sqn_c, float dot) {
  return __fsub_rn(__fadd_rn(sqn_i, sqn_c), 2.0f * dot);
}

// ---- fold + select / draw --------------------------------------------------

constexpr int FOLD_TR = 128;  // rows per block, one per thread

enum Mode { kSelect = 1, kDraw = 2 };

__global__ void __launch_bounds__(FOLD_TR) fold_kernel(
    const float* __restrict__ f1, int d1, const float* __restrict__ f2,
    int d2, int n, const float* __restrict__ sqn, float* __restrict__ min_dist,
    float* __restrict__ sel, const int64_t* __restrict__ centers, int nc,
    int mode, int q, uint32_t k0, uint32_t k1, float* __restrict__ cand_v,
    int* __restrict__ cand_i, float* __restrict__ cand_p) {
  __shared__ float As[KC][FOLD_TR + 1];
  __shared__ float Bs[KC][MAXQ + 1];
  __shared__ float csq[MAXQ];
  __shared__ int cidx[MAXQ];
  __shared__ Cand sh[33];
  const int row0 = blockIdx.x * FOLD_TR;
  const int row = row0 + threadIdx.x;
  if (threadIdx.x < nc) {
    cidx[threadIdx.x] = (int)centers[threadIdx.x];
    csq[threadIdx.x] = sqn[centers[threadIdx.x]];
  }
  float prod[1][MAXQ];
  if (nc > 0)
    tile_products<FOLD_TR, MAXQ, 1, MAXQ>(f1, d1, f2, d2, n, row0, centers, 0,
                                          nc, As, Bs, prod);
  __syncthreads();
  float md = -INFINITY, s = 0.f;
  if (row < n) {
    md = min_dist[row];
    s = sel[row];
    if (nc > 0) {
      const float si = sqn[row];
      float m = INFINITY;
      bool center = false;
#pragma unroll
      for (int j = 0; j < MAXQ; ++j) {
        if (j < nc) {
          m = fminf(m, sq_dist(si, csq[j], prod[0][j]));
          center |= cidx[j] == row;
        }
      }
      md = fminf(md, m);
      min_dist[row] = md;
      if (center && s != 0.f) {
        s = 0.f;
        sel[row] = 0.f;
      }
    }
  }
  if (mode == kSelect) {
    // Masked top-q of the block, best first.
    const Cand mine = row < n ? Cand{s > 0.f ? md : -INFINITY, row, 0.f}
                              : none();
    Cand prev = none();
    for (int r = 0; r < q; ++r) {
      const bool ok = r == 0 || ranks_before(prev.v, prev.i, mine.v, mine.i);
      prev = block_best(ok ? mine : none(), sh);
      if (threadIdx.x == 0) {
        cand_v[blockIdx.x * q + r] = prev.v;
        cand_i[blockIdx.x * q + r] = prev.i;
      }
    }
  } else if (mode == kDraw) {
    // Two Gumbel-max candidates: over log(p) (used when any p > 0) and over
    // log(selectable) (the uniform fallback when every p is 0).
    Cand a = none(), b = none();
    if (row < n) {
      const float p = __fmul_rn(fmaxf(md, 0.f), s);
      const float g = tf_gumbel(tf_bits(k0, k1, (uint64_t)row));
      a = Cand{__fadd_rn(g, logf(p)), row, p};
      b = Cand{__fadd_rn(g, logf(s)), row, p};
    }
    a = block_best(a, sh);
    b = block_best(b, sh);
    if (threadIdx.x == 0) {
      cand_v[blockIdx.x * 2] = a.v;
      cand_i[blockIdx.x * 2] = a.i;
      cand_p[blockIdx.x * 2] = a.p;
      cand_v[blockIdx.x * 2 + 1] = b.v;
      cand_i[blockIdx.x * 2 + 1] = b.i;
      cand_p[blockIdx.x * 2 + 1] = b.p;
    }
  }
}

// Merge of the block candidates.  kSelect: the top q of m = blocks * q
// candidates, best first, into out_v[q], out_i[q].  kDraw: the winner of
// the log(p) candidates if it is finite, else of the log(selectable) ones;
// out_i[0] = its row, out_v[0] = its weight p.
__global__ void __launch_bounds__(MERGE_THREADS) merge_kernel(
    const float* __restrict__ cand_v, const int* __restrict__ cand_i,
    const float* __restrict__ cand_p, int blocks, int q, int mode,
    float* __restrict__ out_v, int64_t* __restrict__ out_i) {
  __shared__ Cand sh[33];
  if (mode == kSelect) {
    const int m = blocks * q;
    Cand prev = none();
    for (int r = 0; r < q; ++r) {
      Cand best = none();
      for (int e = threadIdx.x; e < m; e += blockDim.x) {
        const float v = cand_v[e];
        const int i = cand_i[e];
        if (r == 0 || ranks_before(prev.v, prev.i, v, i))
          best = better(best, Cand{v, i, 0.f});
      }
      prev = block_best(best, sh);
      if (threadIdx.x == 0) {
        out_v[r] = prev.v;
        out_i[r] = prev.i;
      }
    }
  } else {
    Cand a = none(), b = none();
    for (int e = threadIdx.x; e < blocks; e += blockDim.x) {
      a = better(a, Cand{cand_v[2 * e], cand_i[2 * e], cand_p[2 * e]});
      b = better(b, Cand{cand_v[2 * e + 1], cand_i[2 * e + 1],
                         cand_p[2 * e + 1]});
    }
    a = block_best(a, sh);
    b = block_best(b, sh);
    if (threadIdx.x == 0) {
      const Cand w = a.v > -INFINITY ? a : b;
      out_v[0] = w.p;
      out_i[0] = w.i;
    }
  }
}

// ---- the initial min over many centers -------------------------------------

constexpr int MIN_TR = 64, MIN_TC = 64, MIN_RM = 4, MIN_CM = 4;
constexpr int MIN_THREADS = (MIN_TR / MIN_RM) * (MIN_TC / MIN_CM);  // 256

__global__ void __launch_bounds__(MIN_THREADS) min_fold_kernel(
    const float* __restrict__ f1, int d1, const float* __restrict__ f2,
    int d2, int n, const float* __restrict__ sqn, float* __restrict__ min_dist,
    const int64_t* __restrict__ centers, int nc) {
  __shared__ float As[KC][MIN_TR + 1];
  __shared__ float Bs[KC][MIN_TC + 1];
  __shared__ float csq[MIN_TC];
  const int row0 = blockIdx.x * MIN_TR;
  const int tr = threadIdx.x / (MIN_TC / MIN_CM);
  const int tc = threadIdx.x % (MIN_TC / MIN_CM);
  float sqr[MIN_RM], run[MIN_RM];
#pragma unroll
  for (int i = 0; i < MIN_RM; ++i) {
    const int row = row0 + tr * MIN_RM + i;
    sqr[i] = row < n ? sqn[row] : 0.f;
    run[i] = INFINITY;
  }
  for (int c0 = 0; c0 < nc; c0 += MIN_TC) {
    if (threadIdx.x < MIN_TC)
      csq[threadIdx.x] =
          c0 + threadIdx.x < nc ? sqn[centers[c0 + threadIdx.x]] : 0.f;
    float prod[MIN_RM][MIN_CM];
    tile_products<MIN_TR, MIN_TC, MIN_RM, MIN_CM>(f1, d1, f2, d2, n, row0,
                                                  centers, c0, nc, As, Bs,
                                                  prod);
#pragma unroll
    for (int j = 0; j < MIN_CM; ++j) {
      const int c = tc * MIN_CM + j;
      if (c0 + c < nc) {
#pragma unroll
        for (int i = 0; i < MIN_RM; ++i)
          run[i] = fminf(run[i], sq_dist(sqr[i], csq[c], prod[i][j]));
      }
    }
    __syncthreads();  // csq is rewritten by the next tile
  }
  // The 16 threads of a row group are 16 neighbouring lanes of one warp.
#pragma unroll
  for (int i = 0; i < MIN_RM; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      run[i] = fminf(run[i], __shfl_xor_sync(kFull, run[i], o));
    const int row = row0 + tr * MIN_RM + i;
    if (tc == 0 && row < n) min_dist[row] = fminf(min_dist[row], run[i]);
  }
}

// ---- the random bits alone, for tests --------------------------------------

__global__ void bits_kernel(uint32_t k0, uint32_t k1, int n,
                            uint32_t* __restrict__ bits,
                            float* __restrict__ gumbel) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t b = tf_bits(k0, k1, (uint64_t)i);
  bits[i] = b;
  gumbel[i] = tf_gumbel(b);
}

inline int fold_blocks(int n) { return (n + FOLD_TR - 1) / FOLD_TR; }

}  // namespace

extern "C" {

// Scratch: cand_v, cand_i of fold_blocks(n) * q entries.  centers: nc <= 8
// int64 row indices on the device (nc may be 0: no fold).
int kc_fold_select(const float* f1, int d1, const float* f2, int d2, int n,
                   const float* sqn, float* min_dist, float* sel,
                   const int64_t* centers, int nc, int q, float* cand_v,
                   int* cand_i, float* out_v, int64_t* out_i,
                   cudaStream_t stream) {
  if (nc < 0 || nc > MAXQ || q < 1 || q > MAXQ || n < 1) return cudaErrorInvalidValue;
  const int blocks = fold_blocks(n);
  fold_kernel<<<blocks, FOLD_TR, 0, stream>>>(f1, d1, f2, d2, n, sqn, min_dist,
                                              sel, centers, nc, kSelect, q, 0u,
                                              0u, cand_v, cand_i, nullptr);
  merge_kernel<<<1, MERGE_THREADS, 0, stream>>>(cand_v, cand_i, nullptr,
                                                blocks, q, kSelect, out_v,
                                                out_i);
  return (int)cudaGetLastError();
}

// Scratch: cand_v, cand_i, cand_p of 2 * fold_blocks(n) entries.  centers:
// nc <= 1.  Writes the pick's row to out_i[0] and its weight to out_v[0].
int kc_fold_draw(const float* f1, int d1, const float* f2, int d2, int n,
                 const float* sqn, float* min_dist, float* sel,
                 const int64_t* centers, int nc, uint32_t k0, uint32_t k1,
                 float* cand_v, int* cand_i, float* cand_p, float* out_v,
                 int64_t* out_i, cudaStream_t stream) {
  if (nc < 0 || nc > 1 || n < 1) return cudaErrorInvalidValue;
  const int blocks = fold_blocks(n);
  fold_kernel<<<blocks, FOLD_TR, 0, stream>>>(f1, d1, f2, d2, n, sqn, min_dist,
                                              sel, centers, nc, kDraw, 1, k0,
                                              k1, cand_v, cand_i, cand_p);
  merge_kernel<<<1, MERGE_THREADS, 0, stream>>>(cand_v, cand_i, cand_p,
                                                blocks, 1, kDraw, out_v, out_i);
  return (int)cudaGetLastError();
}

int kc_min_fold(const float* f1, int d1, const float* f2, int d2, int n,
                const float* sqn, float* min_dist, const int64_t* centers,
                int nc, cudaStream_t stream) {
  if (n < 1 || nc < 1) return cudaErrorInvalidValue;
  min_fold_kernel<<<(n + MIN_TR - 1) / MIN_TR, MIN_THREADS, 0, stream>>>(
      f1, d1, f2, d2, n, sqn, min_dist, centers, nc);
  return (int)cudaGetLastError();
}

int kc_fold_blocks(int n) { return fold_blocks(n); }

int kc_random_bits(uint32_t k0, uint32_t k1, int n, uint32_t* bits,
                   float* gumbel, cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  bits_kernel<<<(n + 255) / 256, 256, 0, stream>>>(k0, k1, n, bits, gumbel);
  return (int)cudaGetLastError();
}

}  // extern "C"
