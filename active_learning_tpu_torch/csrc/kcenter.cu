// Kernel E: the k-center distance fold, the masked top-q, the batched
// greedy's re-check and the D^2 draw.
//
// Replaces the JAX package's k-center device functions (ROADMAP K4): the
// Pallas kernel ops/kcenter_pallas.py::fused_update_argmax (added 7ffa47a,
// deleted eaf35d5) and what took its place at HEAD,
// active_learning_tpu/strategies/scoring.py:45-61 batched_min_dist_update,
// strategies/kcenter.py:165-170 _min_dist_chunk, :189-227 _kcenter_scan
// (the D^2 draw is its randomized arm) and :294-331 _kcenter_scan_batched
// with its re-check (:230-291), which the JAX package runs on the device
// inside one lax.while_loop.
//
// The pool is held as factor matrices: one (Coreset, F [N, D]) or two
// (BADGE, A [N, C] and E [N, D]); a dot product is the product over the
// factors of the factors' dot products.  For each row i and center c:
//     d_ic = (sqn_i + sqn_c) - 2 * prod_F (F_i . F_c)
// and the fold is min_dist_i <- min(min_dist_i, min_c d_ic).
//
// Entry points:
//   kc_fold_select  fold <= 8 centers, clear their `selectable`, then the
//                   masked top-q of where(selectable > 0, min_dist, -inf);
//                   q = 1 is the sequential scan's argmax.
//   kc_batch_pass   one pass of the batched greedy, with no host in it:
//                   fold the previous pass's accepted sequence (read from
//                   device memory), take the masked top-q, form the
//                   candidates' [q, q] distances, run the exact in-batch
//                   re-check (strict > against the q-th value, at most
//                   min(q, budget - count) accepted, the lowest pool index
//                   among equal maxima), write the padded sequence and its
//                   distances at picks[count:], dists[count:] and advance
//                   `count` in device memory.  A pass that finds count >=
//                   budget does nothing, so the host can queue
//                   ceil((budget - count) / q) passes before it reads
//                   count once.
//   kc_fold_draw    fold <= 1 center, then the D^2 Gumbel-max draw over
//                   weights clip(min_dist, 0) * selectable (or selectable
//                   when those sum to 0).
//   kc_min_fold     fold any number of centers (the labeled set's initial
//                   min), no reduce.
//
// Arithmetic.  Float32 FMA on the CUDA cores, no TF32 and no tensor core:
// the JAX package selects in float32.  In the fold a dot product is a
// fixed tree that depends on the feature count alone: lane l of a warp
// owns features 128m + 4l .. 128m + 4l + 3 of every 128-feature chunk m
// and chains its fmaf over them in that order; the 32 lane sums are then
// added in the butterfly order (xor 16, 8, 4, 2, 1).  The re-check forms
// its [q, q] distances with the same lane partition and the same tree, so
// it compares exactly the numbers the next fold writes, and the batched
// picks equal the q = 1 scan's pick for pick.  The distance is
// (sqn_i + sqn_c) - 2*dot with __fadd_rn/__fsub_rn, as the plain
// version's separate ops.  kc_min_fold chains each (row, center) dot in
// ascending feature order.  Nothing depends on the grid, the SM count or
// the scheduling: two launches give equal bits.  Ranking is by value,
// then by the LOWER row index (jax.lax.top_k's and argmax's order), a NaN
// above every number (jnp.argmax's first NaN; -0 and +0 rank equal, as
// argmax has them); every reduction is a max/min under that total order,
// exact in any tree.  A candidate carries its value as an integer key
// that orders that way, made once where the candidate is made, so every
// compare in the trees is the plain (key, row) compare.
//
// Non-finite rows follow the reference.  Every min that folds a distance
// (the lanes' mins over the centers, the row update, the re-check's
// running minimum, min_fold's epilogue) and the re-check's max propagate
// NaN, as jnp.minimum / jnp.min / jnp.max do: PTX min.NaN / max.NaN, one
// instruction each at the rate of min.f32.  The draw's weight is
// max.NaN(min_dist, 0) * selectable, and a NaN weight anywhere sends the
// draw to its uniform candidate, as the reference's sum of the weights
// does (see kDraw).
//
// The D^2 draw generates its own random bits: Threefry-2x32 (20 rounds)
// of the 64-bit row counter under the step's key, the two output words
// xored (JAX's partitionable random_bits), then uniform(tiny, 1) and
// -log(-log u) exactly as utils/threefry.py computes them.  The integer
// bits equal JAX's; logf may differ from the host's log by an ulp.
//
// Bound.  A fold over q <= 8 centers reads each factor row once and does
// 2*q flops per element: 1 GB a pass at N = 131,072 x 2048, so memory
// (0.32 ms at 3.35 TB/s); the merge reads q candidate rows more.  Design:
// a warp folds 4 rows at once, each lane loading 16 bytes of each row a
// chunk straight into registers (read-only path, the next chunk's loads
// issued before this chunk's FMAs: 4 KB in flight a warp), the centers'
// features held in shared memory and read as 16-byte vectors, one per 16
// FMAs.  Rows are read once and never shared, so they do not pass through
// shared memory: its port carries the centers.  The 32 (row, center)
// lane sums are reduced by a recursive-halving transpose (31 shuffles
// for 32 sums), after which lane l holds row l/8, center l%8.  Each row's
// owner lane keeps a sorted list of its best q rows; lists merge by
// warp-level pop rounds on (value, index), blocks walk contiguous row
// ranges (at most 264 blocks), and one block of 1024 threads merges the
// blocks' candidates and runs the re-check.
//
// The initial min over L labeled centers does 2*L flops per element:
// operations (67 TFLOP/s float32 outside the tensor cores).  Design: a
// 128-row x 128-center block tile, 8 x 8 outputs per thread, K-major
// tiles of 32 features copied by a double-buffered cp.async ring (16-byte
// copies where the rows are 16-byte aligned, 4-byte otherwise; 72 KB of
// dynamic shared memory), 16-byte shared-memory reads (one per 4 FMAs of
// a thread's 8 x 8 block, spread over the banks by a padded row stride),
// the min taken in the epilogue: no [N, L] matrix is written.  One block
// an SM: its ~250 registers a thread (two blocks would spill).
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// kcenter.py.  Each function returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int MAXQ = 8;          // centers per fold, candidates per block
constexpr int CHUNK = 128;       // features a warp covers per step
constexpr int FOLD_WARPS = 8;
constexpr int FOLD_THREADS = FOLD_WARPS * 32;
constexpr int RPW = 4;           // rows a warp folds at once
constexpr int ROW_GROUP = FOLD_WARPS * RPW;
constexpr int FOLD_MAX_BLOCKS = 264;
constexpr int MERGE_THREADS = 1024;
constexpr int SMEM_LIMIT = 200 * 1024;  // dynamic, beside ~4 KB static
constexpr unsigned kFull = 0xffffffffu;

// ---- ranking ---------------------------------------------------------------

struct Cand {
  int k;    // rank_key of the value
  int i;    // the row
  float p;  // the draw's weight at the row (kc_fold_draw only)
};

// An integer that orders values as the ranking does: a NaN above +inf,
// -0 equal to +0, otherwise float order.
__device__ __forceinline__ int rank_key(float v) {
  if (v != v) return INT_MAX;
  const int b = __float_as_int(__fadd_rn(v, 0.f));  // -0 + 0 = +0
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// The value of a key (a NaN for a NaN's; +0 for -0's).
__device__ __forceinline__ float key_value(int k) {
  return k == INT_MAX ? NAN : __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ Cand cand(float v, int i, float p) {
  return Cand{rank_key(v), i, p};
}

// Key k at row i before key l at row j: the larger key, then the lower row.
__device__ __forceinline__ bool ranks_before(int k, int i, int l, int j) {
  return k > l || (k == l && i < j);
}

// jnp.minimum and jnp.maximum: NaN when either operand is NaN (fminf and
// fmaxf return the other operand).
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ Cand better(const Cand& a, const Cand& b) {
  return ranks_before(b.k, b.i, a.k, a.i) ? b : a;
}

// No candidate: -inf at no row, after every real candidate (a -inf one
// ranks before it by its row).
constexpr int kNegInfKey = -2139095041;  // rank_key(-inf): 0x807fffff
__device__ __forceinline__ Cand none() { return Cand{kNegInfKey, INT_MAX, 0.f}; }

__device__ __forceinline__ Cand shfl_cand(const Cand& c, int o) {
  Cand r;
  r.k = __shfl_xor_sync(kFull, c.k, o);
  r.i = __shfl_xor_sync(kFull, c.i, o);
  r.p = __shfl_xor_sync(kFull, c.p, o);
  return r;
}

__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c = better(c, shfl_cand(c, o));
  return c;
}

// Insert c into a best-first list of q entries (the worst falls out).
__device__ __forceinline__ void insert(Cand (&list)[MAXQ], Cand c, int q) {
#pragma unroll
  for (int s = 0; s < MAXQ; ++s) {
    if (s < q && ranks_before(c.k, c.i, list[s].k, list[s].i)) {
      const Cand t = list[s];
      list[s] = c;
      c = t;
    }
  }
}

// The warp's best q of its lanes' sorted lists, best first, into out[q]
// (written by lane 0).  Each round takes the best head and pops it.
__device__ __forceinline__ void warp_top(Cand (&list)[MAXQ], int q,
                                         Cand* out) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < q; ++r) {
    const Cand w = warp_best(list[0]);
    if (lane == 0) out[r] = w;
    if (list[0].i == w.i) {
#pragma unroll
      for (int s = 0; s < MAXQ - 1; ++s) list[s] = list[s + 1];
      list[MAXQ - 1] = none();
    }
  }
}

// The block's best q of its threads' lists, into top[q] (shared memory,
// visible to every thread on return).  wl: [32][MAXQ] shared scratch.
__device__ void block_top(Cand (&list)[MAXQ], int q, Cand (*wl)[MAXQ],
                          Cand* top) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  warp_top(list, q, wl[warp]);
  __syncthreads();
  if (warp == 0) {
    Cand l2[MAXQ];
#pragma unroll
    for (int s = 0; s < MAXQ; ++s)
      l2[s] = (lane < nwarps && s < q) ? wl[lane][s] : none();
    warp_top(l2, q, top);
  }
  __syncthreads();
}

// The block's best candidate; every thread returns it.  sh: [33].
__device__ Cand block_best(Cand c, Cand* sh) {
  c = warp_best(c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) sh[warp] = c;
  __syncthreads();
  if (warp == 0) {
    Cand w = lane < nwarps ? sh[lane] : none();
    w = warp_best(w);
    if (lane == 0) sh[32] = w;
  }
  __syncthreads();
  const Cand out = sh[32];
  __syncthreads();
  return out;
}

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

// ---- the fold's dot products -----------------------------------------------

struct Factor {
  const float* f;
  int d;       // features
  int chunks;  // ceil(d / CHUNK)
  int vec;     // 1: rows start on 16 bytes (d % 4 == 0, aligned base)
};

// Features k..k+3 of a row; zeros past the row's end or the matrix's.
__device__ __forceinline__ float4 load4(const Factor& F, int row, int n,
                                        int k) {
  float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= n || k >= F.d) return z;
  const float* p = F.f + (size_t)row * F.d + k;
  if (F.vec) return __ldg(reinterpret_cast<const float4*>(p));
  z.x = __ldg(p);
  if (k + 1 < F.d) z.y = __ldg(p + 1);
  if (k + 2 < F.d) z.z = __ldg(p + 2);
  if (k + 3 < F.d) z.w = __ldg(p + 3);
  return z;
}

// One lane's chain over four features: the order every dot product of
// the fold and the re-check takes.
__device__ __forceinline__ float fma4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[r * MAXQ + j] = this lane's partial of (row row0 + r) . (center j)
// over one factor; cs: the centers' features in shared memory, center j
// at cs + j * chunks * CHUNK, zero past d.
__device__ __forceinline__ void lane_dots(const Factor& F, const float* cs,
                                          int nc, int row0, int n,
                                          float (&acc)[RPW * MAXQ]) {
  const int lane = threadIdx.x & 31;
  const int stride = F.chunks * CHUNK;
#pragma unroll
  for (int e = 0; e < RPW * MAXQ; ++e) acc[e] = 0.f;
  float4 cur[RPW], nxt[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) cur[r] = load4(F, row0 + r, n, lane * 4);
  for (int m = 0; m < F.chunks; ++m) {
    const int k = m * CHUNK + lane * 4;
#pragma unroll
    for (int r = 0; r < RPW; ++r)
      nxt[r] = m + 1 < F.chunks ? load4(F, row0 + r, n, k + CHUNK) : cur[r];
#pragma unroll
    for (int j = 0; j < MAXQ; ++j) {
      if (j < nc) {
        const float4 c = *reinterpret_cast<const float4*>(cs + j * stride + k);
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          acc[r * MAXQ + j] = fma4(cur[r], c, acc[r * MAXQ + j]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) cur[r] = nxt[r];
  }
}

// One halving step of the transpose: keep half of the values, add the
// partner's copy of the same items.
template <int H>
__device__ __forceinline__ void halve(float (&v)[RPW * MAXQ], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// The warp sum of item `lane` of v[32] (item r * MAXQ + j): the same
// tree as warp_sum, so the same bits.
__device__ __forceinline__ float reduce_scatter(float (&v)[RPW * MAXQ]) {
  const int lane = threadIdx.x & 31;
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = x + __shfl_xor_sync(kFull, x, o);
  return x;
}

// Row a . row b over one factor in the fold's order (every lane returns
// it).
__device__ __forceinline__ float warp_dot(const Factor& F, int a, int b,
                                          int n) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int m = 0; m < F.chunks; ++m) {
    const int k = m * CHUNK + lane * 4;
    acc = fma4(load4(F, a, n, k), load4(F, b, n, k), acc);
  }
  return warp_sum(acc);
}

__device__ __forceinline__ float sq_dist(float sqn_i, float sqn_c, float dot) {
  return __fsub_rn(__fadd_rn(sqn_i, sqn_c), 2.0f * dot);
}

// ---- fold + select / draw --------------------------------------------------

enum Mode { kSelect = 1, kDraw = 2, kBatch = 3 };

struct FoldArgs {
  Factor f1, f2;
  int two, n;
  const float* sqn;
  float* min_dist;
  float* sel;
  const int64_t* centers;
  int nc, mode, q, rows_per_block;
  uint32_t k0, k1;
  const int* count;  // kBatch: skip the pass when *count >= budget
  int budget;
  float* cand_v;
  int* cand_i;
  float* cand_p;
};

__global__ void __launch_bounds__(FOLD_THREADS) fold_kernel(FoldArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ float csq[MAXQ];
  __shared__ int cidx[MAXQ];
  __shared__ Cand wl[32][MAXQ];
  __shared__ Cand top[MAXQ];
  __shared__ Cand sh[33];
  if (a.mode == kBatch && *a.count >= a.budget) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = a.nc;
  float* cs1 = reinterpret_cast<float*>(smem4);
  float* cs2 = cs1 + nc * a.f1.chunks * CHUNK;
  if (tid < nc) {
    cidx[tid] = (int)a.centers[tid];
    csq[tid] = a.sqn[a.centers[tid]];
  }
  __syncthreads();
  for (int t = 0; t < 1 + a.two; ++t) {
    const Factor& F = t ? a.f2 : a.f1;
    float* cs = t ? cs2 : cs1;
    const int stride = F.chunks * CHUNK;
    for (int e = tid; e < nc * stride; e += FOLD_THREADS) {
      const int j = e / stride, k = e - j * stride;
      cs[e] = k < F.d ? F.f[(size_t)cidx[j] * F.d + k] : 0.f;
    }
  }
  __syncthreads();

  const int rb = blockIdx.x * a.rows_per_block;
  const int re = min(a.n, rb + a.rows_per_block);
  const int j = lane & (MAXQ - 1);
  const bool owner = j == 0;
  Cand list[MAXQ];
#pragma unroll
  for (int s = 0; s < MAXQ; ++s) list[s] = none();
  Cand da = none(), db = none();
  for (int row0 = rb + warp * RPW; row0 < re; row0 += ROW_GROUP) {
    const int row = row0 + lane / MAXQ;
    const bool live = row < re;
    float dist = INFINITY;
    bool is_center = false;
    if (nc > 0) {
      float acc[RPW * MAXQ];
      lane_dots(a.f1, cs1, nc, row0, a.n, acc);
      float dot = reduce_scatter(acc);
      if (a.two) {
        lane_dots(a.f2, cs2, nc, row0, a.n, acc);
        dot = __fmul_rn(dot, reduce_scatter(acc));
      }
      if (live && j < nc) {
        dist = sq_dist(a.sqn[row], csq[j], dot);
        is_center = cidx[j] == row;
      }
#pragma unroll
      for (int o = MAXQ / 2; o > 0; o >>= 1)
        dist = nan_min(dist, __shfl_xor_sync(kFull, dist, o));
      const unsigned ball = __ballot_sync(kFull, is_center);
      is_center = (ball >> (lane & ~(MAXQ - 1))) & 0xffu;
    }
    if (!(owner && live)) continue;
    float md = a.min_dist[row];
    float s = a.sel[row];
    if (nc > 0) {
      md = nan_min(md, dist);
      a.min_dist[row] = md;
      if (is_center && s != 0.f) {
        s = 0.f;
        a.sel[row] = 0.f;
      }
    }
    if (a.mode == kDraw) {
      // Two Gumbel-max candidates: over log(p), used when the p sum
      // above 0 (no p is NaN and one is above 0), and over
      // log(selectable), the uniform fallback otherwise.  A NaN p ranks
      // first, so the block's log(p) candidate is NaN exactly when one of
      // its rows has a NaN p (a non-selectable row's too: NaN * 0).
      const float p = __fmul_rn(nan_max(md, 0.f), s);
      const float g = tf_gumbel(tf_bits(a.k0, a.k1, (uint64_t)row));
      da = better(da, cand(__fadd_rn(g, logf(p)), row, p));
      db = better(db, cand(__fadd_rn(g, logf(s)), row, p));
    } else {
      insert(list, cand(s > 0.f ? md : -INFINITY, row, 0.f), a.q);
    }
  }
  if (a.mode == kDraw) {
    da = block_best(da, sh);
    db = block_best(db, sh);
    if (tid == 0) {
      a.cand_v[blockIdx.x * 2] = key_value(da.k);
      a.cand_i[blockIdx.x * 2] = da.i;
      a.cand_p[blockIdx.x * 2] = da.p;
      a.cand_v[blockIdx.x * 2 + 1] = key_value(db.k);
      a.cand_i[blockIdx.x * 2 + 1] = db.i;
      a.cand_p[blockIdx.x * 2 + 1] = db.p;
    }
  } else {
    block_top(list, a.q, wl, top);
    if (tid < a.q) {
      a.cand_v[blockIdx.x * a.q + tid] = key_value(top[tid].k);
      a.cand_i[blockIdx.x * a.q + tid] = top[tid].i;
    }
  }
}

// ---- merge, re-check -------------------------------------------------------

struct MergeArgs {
  Factor f1, f2;
  int two, n;
  const float* sqn;
  const float* cand_v;
  const int* cand_i;
  const float* cand_p;
  int blocks, q, mode;
  float* out_v;       // kSelect, kDraw
  int64_t* out_i;
  int* count;         // kBatch
  int budget;
  int64_t* seq;       // kBatch: the accepted sequence, padded [q]
  int64_t* picks;     // kBatch: [budget + q]
  float* dists;
};

// kSelect: the top q of the blocks' candidates, best first, into out_v,
// out_i.  kDraw: the winner of the log(p) candidates if it is above
// -inf (some p > 0) and not NaN (no p is NaN), else of the
// log(selectable) ones: the reference's `where(sum(p) > 0, p,
// selectable)`; out_i[0] = its row, out_v[0] = its weight p (NaN where
// the reference's p[idx] is).  kBatch: the top q, their [q, q]
// distances, the re-check (strategies/kcenter.py's _recheck_candidates,
// step for step), and the sequence, its distances and the new count
// written to device memory; out_v / out_i get the top q as in kSelect.
__global__ void __launch_bounds__(MERGE_THREADS) merge_kernel(MergeArgs a) {
  __shared__ Cand wl[32][MAXQ];
  __shared__ Cand top[MAXQ];
  __shared__ Cand sh[33];
  __shared__ float dcc[MAXQ][MAXQ];
  const int tid = threadIdx.x;
  if (a.mode == kDraw) {
    Cand x = none(), y = none();
    for (int e = tid; e < a.blocks; e += blockDim.x) {
      x = better(x, cand(a.cand_v[2 * e], a.cand_i[2 * e], a.cand_p[2 * e]));
      y = better(y, cand(a.cand_v[2 * e + 1], a.cand_i[2 * e + 1],
                         a.cand_p[2 * e + 1]));
    }
    x = block_best(x, sh);
    y = block_best(y, sh);
    if (tid == 0) {
      const Cand w = key_value(x.k) > -INFINITY ? x : y;
      a.out_v[0] = w.p;
      a.out_i[0] = w.i;
    }
    return;
  }
  int count = 0;
  if (a.mode == kBatch) {
    count = *a.count;
    if (count >= a.budget) return;
  }
  const int q = a.q;
  Cand list[MAXQ];
#pragma unroll
  for (int s = 0; s < MAXQ; ++s) list[s] = none();
  for (int e = tid; e < a.blocks * q; e += blockDim.x)
    insert(list, cand(a.cand_v[e], a.cand_i[e], 0.f), q);
  block_top(list, q, wl, top);
  if (tid < q) {
    a.out_v[tid] = key_value(top[tid].k);
    a.out_i[tid] = top[tid].i;
  }
  if (a.mode != kBatch) return;

  // The candidates' pairwise distances, in the fold's arithmetic.
  const int warp = tid >> 5, lane = tid & 31;
  for (int p = warp; p < q * q; p += blockDim.x >> 5) {
    const int r = p / q, c = p - r * q;
    if (r > c) continue;
    const int ra = top[r].i, rc = top[c].i;
    float dot = warp_dot(a.f1, ra, rc, a.n);
    if (a.two) dot = __fmul_rn(dot, warp_dot(a.f2, ra, rc, a.n));
    if (lane == 0) {
      const float d = sq_dist(a.sqn[ra], a.sqn[rc], dot);
      dcc[r][c] = d;
      dcc[c][r] = d;
    }
  }
  __syncthreads();
  if (tid != 0) return;

  // The exact in-batch re-check.
  const float thresh = key_value(top[q - 1].k);
  float cur[MAXQ], dv[MAXQ];
  bool accepted[MAXQ];
  int order[MAXQ];
#pragma unroll
  for (int i = 0; i < MAXQ; ++i) {
    cur[i] = i < q ? key_value(top[i].k) : -INFINITY;
    accepted[i] = i == 0;
    order[i] = 0;
    dv[i] = 0.f;
  }
  dv[0] = key_value(top[0].k);
  const int limit = min(q, a.budget - count);
  int n_acc = 1, last = 0;
  bool stop = false;
  for (int it = 0; it < q - 1; ++it) {
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < MAXQ; ++i) {
      if (i < q) {
        cur[i] = nan_min(cur[i], dcc[i][last]);
        m = nan_max(m, accepted[i] ? -INFINITY : cur[i]);
      }
    }
    // Lowest pool index among the maxima (the sentinel n elsewhere).
    int p = 0;
    long long key = LLONG_MAX;
#pragma unroll
    for (int i = 0; i < MAXQ; ++i) {
      if (i < q) {
        const float avail = accepted[i] ? -INFINITY : cur[i];
        const long long k = avail >= m ? (long long)top[i].i : (long long)a.n;
        if (k < key) {
          key = k;
          p = i;
        }
      }
    }
    const bool ok = m > thresh && !stop && n_acc < limit;
    if (ok) {
#pragma unroll
      for (int i = 0; i < MAXQ; ++i) {
        if (i == p) accepted[i] = true;
        if (i == n_acc) {
          order[i] = p;
          dv[i] = m;
        }
      }
      last = p;
      ++n_acc;
    }
    stop = stop || !ok;
  }
  int first = 0;
#pragma unroll
  for (int i = 0; i < MAXQ; ++i)
    if (i == order[0]) first = top[i].i;
  for (int s = 0; s < q; ++s) {
    int o = 0;
#pragma unroll
    for (int i = 0; i < MAXQ; ++i)
      if (i == s) o = order[i];
    int row = first;
#pragma unroll
    for (int i = 0; i < MAXQ; ++i)
      if (i == o && s < n_acc) row = top[i].i;
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < MAXQ; ++i)
      if (i == s) d = dv[i];
    a.seq[s] = row;
    a.picks[count + s] = row;
    a.dists[count + s] = d;
  }
  *a.count = count + n_acc;
}

// ---- the initial min over many centers -------------------------------------

// 32 features a tile: half the barriers of 16 per feature.
constexpr int MT = 128, NT = 128, BK = 32, PADK = BK + 4;
constexpr int STAGES = 2;
constexpr int MIN_THREADS = 256;
constexpr size_t MIN_SMEM = (size_t)STAGES * (MT + NT) * PADK * sizeof(float);

struct MinArgs {
  Factor f1, f2;
  int two, n;
  const float* sqn;
  float* min_dist;
  const int64_t* centers;
  int nc;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int sz = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(sz));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int sz = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(sz));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most STAGES - 1 groups are in flight: the oldest stage
// has landed.
__device__ __forceinline__ void cp_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));
}

// Copy features k0..k0+BK-1 of rows row0.. (A) and of the centers crow[]
// (B) into one stage; zeros past the matrix, the row count or nc.
__device__ __forceinline__ void load_stage(const Factor& F, int n, int row0,
                                           const int64_t* crow, int cvalid,
                                           int k0, float (*As)[PADK],
                                           float (*Bs)[PADK]) {
  const int t = threadIdx.x;
  if (F.vec) {
    constexpr int V4 = BK / 4;
#pragma unroll
    for (int u = 0; u < MT * V4 / MIN_THREADS; ++u) {
      const int e = t + u * MIN_THREADS;
      const int r = e / V4, c4 = (e % V4) * 4, k = k0 + c4;
      const bool pa = row0 + r < n && k < F.d;
      cp_async16(&As[r][c4],
                 pa ? F.f + (size_t)(row0 + r) * F.d + k : F.f, pa);
      const bool pb = r < cvalid && k < F.d;
      cp_async16(&Bs[r][c4], pb ? F.f + (size_t)crow[r] * F.d + k : F.f, pb);
    }
  } else {
#pragma unroll
    for (int u = 0; u < MT * BK / MIN_THREADS; ++u) {
      const int e = t + u * MIN_THREADS;
      const int r = e / BK, c = e % BK, k = k0 + c;
      const bool pa = row0 + r < n && k < F.d;
      cp_async4(&As[r][c], pa ? F.f + (size_t)(row0 + r) * F.d + k : F.f, pa);
      const bool pb = r < cvalid && k < F.d;
      cp_async4(&Bs[r][c], pb ? F.f + (size_t)crow[r] * F.d + k : F.f, pb);
    }
  }
}

// acc[i][j] = (row tr + 16 i) . (center tc + 16 j) of the tile, each an
// fmaf chain in ascending feature order.
__device__ __forceinline__ void tile_dots(const Factor& F, int n, int row0,
                                          const int64_t* crow, int cvalid,
                                          float (*As)[MT][PADK],
                                          float (*Bs)[NT][PADK], int tr,
                                          int tc, float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int kt_n = (F.d + BK - 1) / BK;
  // A ring of STAGES tiles: STAGES - 1 in flight while one is read.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < kt_n)
      load_stage(F, n, row0, crow, cvalid, st * BK, As[st], Bs[st]);
    cp_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt % STAGES;
    const int ahead = kt + STAGES - 1;
    if (ahead < kt_n)
      load_stage(F, n, row0, crow, cvalid, ahead * BK, As[ahead % STAGES],
                 Bs[ahead % STAGES]);
    cp_commit();
    cp_wait_stage();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(&As[st][tr + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = *reinterpret_cast<const float4*>(&Bs[st][tc + 16 * j][kk]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fma4(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <bool TWO>
__global__ void __launch_bounds__(MIN_THREADS, 1) min_fold_kernel(MinArgs a) {
  extern __shared__ float4 min_smem[];
  auto As = reinterpret_cast<float (*)[MT][PADK]>(min_smem);
  auto Bs = reinterpret_cast<float (*)[NT][PADK]>(
      reinterpret_cast<float*>(min_smem) + STAGES * MT * PADK);
  __shared__ int64_t crow[NT];
  __shared__ float csq[NT];
  __shared__ float rsq[MT];
  __shared__ float red[8][4][8];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int tr = (warp >> 1) * 4 + (lane >> 3);
  const int tc = (warp & 1) * 8 + (lane & 7);
  const int row0 = blockIdx.x * MT;
  if (t < MT) rsq[t] = row0 + t < a.n ? a.sqn[row0 + t] : 0.f;
  float run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) run[i] = INFINITY;
  for (int c0 = 0; c0 < a.nc; c0 += NT) {
    const int cvalid = min(NT, a.nc - c0);
    if (t < NT) {
      const int64_t c = t < cvalid ? a.centers[c0 + t] : 0;
      crow[t] = c;
      csq[t] = t < cvalid ? a.sqn[c] : 0.f;
    }
    __syncthreads();
    float prod[8][8];
    tile_dots(a.f1, a.n, row0, crow, cvalid, As, Bs, tr, tc, prod);
    if (TWO) {
      float acc[8][8];
      tile_dots(a.f2, a.n, row0, crow, cvalid, As, Bs, tr, tc, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) prod[i][j] = __fmul_rn(prod[i][j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tc + 16 * j;
      if (c < cvalid) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          run[i] = nan_min(run[i], sq_dist(rsq[tr + 16 * i], csq[c],
                                           prod[i][j]));
      }
    }
    __syncthreads();  // crow and csq are rewritten by the next tile
  }
  // The 16 threads of a row: lanes with equal lane >> 3 of warps 2w, 2w+1.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      run[i] = nan_min(run[i], __shfl_xor_sync(kFull, run[i], o));
  }
  if ((lane & 7) == 0 && (warp & 1))
#pragma unroll
    for (int i = 0; i < 8; ++i) red[warp >> 1][lane >> 3][i] = run[i];
  __syncthreads();
  if ((lane & 7) == 0 && !(warp & 1)) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + tr + 16 * i;
      if (row < a.n) {
        const float m = nan_min(run[i], red[warp >> 1][lane >> 3][i]);
        a.min_dist[row] = nan_min(a.min_dist[row], m);
      }
    }
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

// ---- host side -------------------------------------------------------------

// Rows per fold block: a multiple of the warps' row group, at most
// FOLD_MAX_BLOCKS blocks; a function of n alone.
inline int fold_rows_per_block(int n) {
  int per = (n + FOLD_MAX_BLOCKS - 1) / FOLD_MAX_BLOCKS;
  return (per + ROW_GROUP - 1) / ROW_GROUP * ROW_GROUP;
}

inline int fold_blocks(int n) {
  const int per = fold_rows_per_block(n);
  return (n + per - 1) / per;
}

inline Factor make_factor(const float* f, int d) {
  Factor F;
  F.f = f;
  F.d = d;
  F.chunks = f != nullptr ? (d + CHUNK - 1) / CHUNK : 0;
  F.vec = f != nullptr && d % 4 == 0 && (reinterpret_cast<uintptr_t>(f) & 15) == 0;
  return F;
}

inline size_t fold_smem(int nc, int d1, int d2) {
  const size_t per = (size_t)((d1 + CHUNK - 1) / CHUNK +
                              (d2 > 0 ? (d2 + CHUNK - 1) / CHUNK : 0)) * CHUNK;
  return (size_t)nc * per * sizeof(float);
}

int launch_fold(FoldArgs& a, cudaStream_t stream) {
  const size_t smem = fold_smem(a.nc, a.f1.d, a.two ? a.f2.d : 0);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    opted = SMEM_LIMIT;
  }
  a.rows_per_block = fold_rows_per_block(a.n);
  fold_kernel<<<fold_blocks(a.n), FOLD_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

FoldArgs fold_args(const float* f1, int d1, const float* f2, int d2, int n,
                   const float* sqn, float* min_dist, float* sel,
                   const int64_t* centers, int nc) {
  FoldArgs a = {};
  a.f1 = make_factor(f1, d1);
  a.f2 = make_factor(f2, d2);
  a.two = f2 != nullptr;
  a.n = n;
  a.sqn = sqn;
  a.min_dist = min_dist;
  a.sel = sel;
  a.centers = centers;
  a.nc = nc;
  return a;
}

MergeArgs merge_args(const FoldArgs& f, int mode) {
  MergeArgs m = {};
  m.f1 = f.f1;
  m.f2 = f.f2;
  m.two = f.two;
  m.n = f.n;
  m.sqn = f.sqn;
  m.cand_v = f.cand_v;
  m.cand_i = f.cand_i;
  m.cand_p = f.cand_p;
  m.blocks = fold_blocks(f.n);
  m.q = f.q;
  m.mode = mode;
  return m;
}

}  // namespace

extern "C" {

int kc_fold_blocks(int n) { return n < 1 ? 0 : fold_blocks(n); }

// Bytes of shared memory a fold of nc centers needs; the wrappers refuse
// more than kc_smem_limit().
int kc_fold_smem(int nc, int d1, int d2) { return (int)fold_smem(nc, d1, d2); }
int kc_smem_limit() { return SMEM_LIMIT; }

// Scratch: cand_v, cand_i of kc_fold_blocks(n) * q entries.  centers: nc
// <= 8 int64 row indices on the device (nc may be 0: no fold).
int kc_fold_select(const float* f1, int d1, const float* f2, int d2, int n,
                   const float* sqn, float* min_dist, float* sel,
                   const int64_t* centers, int nc, int q, float* cand_v,
                   int* cand_i, float* out_v, int64_t* out_i,
                   cudaStream_t stream) {
  if (nc < 0 || nc > MAXQ || q < 1 || q > MAXQ || n < 1)
    return (int)cudaErrorInvalidValue;
  FoldArgs a = fold_args(f1, d1, f2, d2, n, sqn, min_dist, sel, centers, nc);
  a.mode = kSelect;
  a.q = q;
  a.cand_v = cand_v;
  a.cand_i = cand_i;
  const int err = launch_fold(a, stream);
  if (err != 0) return err;
  MergeArgs m = merge_args(a, kSelect);
  m.out_v = out_v;
  m.out_i = out_i;
  merge_kernel<<<1, MERGE_THREADS, 0, stream>>>(m);
  return (int)cudaGetLastError();
}

// One pass of the batched greedy.  seq: the previous pass's sequence [q]
// (nc = 0 on the first pass, q after); count: int32 in device memory;
// picks, dists: [budget + q]; top_v, top_i: the pass's top q (for checks);
// scratch as kc_fold_select's.
int kc_batch_pass(const float* f1, int d1, const float* f2, int d2, int n,
                  const float* sqn, float* min_dist, float* sel,
                  int64_t* seq, int nc, int q, int budget, int* count,
                  float* cand_v, int* cand_i, int64_t* picks, float* dists,
                  float* top_v, int64_t* top_i, cudaStream_t stream) {
  if (nc < 0 || nc > q || q < 1 || q > MAXQ || n < 1 || budget < 1)
    return (int)cudaErrorInvalidValue;
  FoldArgs a = fold_args(f1, d1, f2, d2, n, sqn, min_dist, sel, seq, nc);
  a.mode = kBatch;
  a.q = q;
  a.count = count;
  a.budget = budget;
  a.cand_v = cand_v;
  a.cand_i = cand_i;
  const int err = launch_fold(a, stream);
  if (err != 0) return err;
  MergeArgs m = merge_args(a, kBatch);
  m.out_v = top_v;
  m.out_i = top_i;
  m.count = count;
  m.budget = budget;
  m.seq = seq;
  m.picks = picks;
  m.dists = dists;
  merge_kernel<<<1, MERGE_THREADS, 0, stream>>>(m);
  return (int)cudaGetLastError();
}

// Scratch: cand_v, cand_i, cand_p of 2 * kc_fold_blocks(n) entries.
// centers: nc <= 1.  Writes the pick's row to out_i[0] and its weight to
// out_v[0].
int kc_fold_draw(const float* f1, int d1, const float* f2, int d2, int n,
                 const float* sqn, float* min_dist, float* sel,
                 const int64_t* centers, int nc, uint32_t k0, uint32_t k1,
                 float* cand_v, int* cand_i, float* cand_p, float* out_v,
                 int64_t* out_i, cudaStream_t stream) {
  if (nc < 0 || nc > 1 || n < 1) return (int)cudaErrorInvalidValue;
  FoldArgs a = fold_args(f1, d1, f2, d2, n, sqn, min_dist, sel, centers, nc);
  a.mode = kDraw;
  a.q = 1;
  a.k0 = k0;
  a.k1 = k1;
  a.cand_v = cand_v;
  a.cand_i = cand_i;
  a.cand_p = cand_p;
  const int err = launch_fold(a, stream);
  if (err != 0) return err;
  MergeArgs m = merge_args(a, kDraw);
  m.out_v = out_v;
  m.out_i = out_i;
  merge_kernel<<<1, MERGE_THREADS, 0, stream>>>(m);
  return (int)cudaGetLastError();
}

int kc_min_fold(const float* f1, int d1, const float* f2, int d2, int n,
                const float* sqn, float* min_dist, const int64_t* centers,
                int nc, cudaStream_t stream) {
  if (n < 1 || nc < 1) return (int)cudaErrorInvalidValue;
  MinArgs a;
  a.f1 = make_factor(f1, d1);
  a.f2 = make_factor(f2, d2);
  a.two = f2 != nullptr;
  a.n = n;
  a.sqn = sqn;
  a.min_dist = min_dist;
  a.centers = centers;
  a.nc = nc;
  static bool opted = false;
  if (!opted) {
    cudaError_t e = cudaFuncSetAttribute(
        min_fold_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)MIN_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(min_fold_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MIN_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const int grid = (n + MT - 1) / MT;
  if (a.two)
    min_fold_kernel<true><<<grid, MIN_THREADS, MIN_SMEM, stream>>>(a);
  else
    min_fold_kernel<false><<<grid, MIN_THREADS, MIN_SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

int kc_random_bits(uint32_t k0, uint32_t k1, int n, uint32_t* bits,
                   float* gumbel, cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  bits_kernel<<<(n + 255) / 256, 256, 0, stream>>>(k0, k1, n, bits, gumbel);
  return (int)cudaGetLastError();
}

}  // extern "C"
