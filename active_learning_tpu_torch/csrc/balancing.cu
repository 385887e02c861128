// Kernel H: the balancing pick of BalancingSampler.
//
// Replaces the JAX package's active_learning_tpu/strategies/balancing.py:61-85
// _balancing_pick (ROADMAP K6).  For every row i of the pool:
//     d_rare_i = sum_k (e_ik - c_rk)^2                 (1 where rare_empty)
//     norm_i   = max over majority classes c of (a2_i + b2_c) - 2 e_i . c_c
//     score_i  = eligible_i ? d_rare_i / norm_i : +inf
// and the pick is the index of the least score, ties to the lower index, a
// NaN winning over any number (jnp.argmin's rule: the first NaN).  a2 and b2
// are the rows' and the centers' squared norms.  The norm is the expanded
// form the JAX function writes, not clamped at 0: a row on a majority
// centroid can get a norm near 0 or below it, and the pick copies that.
//
// Arithmetic.  float32 throughout, on the CUDA cores: no tensor core and no
// TF32 (the JAX function pins Precision.HIGHEST).  Each sum is a fixed tree
// that depends on the shapes alone, never on the grid or the scheduling,
// so two launches give equal bits; the plain version sums in another order,
// and the picks are held to it within ops/balancing.py's score_tolerance.
// The distance is (a2 + b2) - 2*dot with __fadd_rn/__fsub_rn, as the
// plain version's separate operations, and the max over classes
// propagates a NaN as jnp.max does.  The argmin ranks by one 64-bit key:
// the float's total order in the high word (a NaN below everything, -0
// read as +0 so that the two tie) and the row index in the low word; a
// min under that key is exact in any tree.
//
// Bound.  One pick reads the pool once (N*D*4 bytes) and does
// 2*N*D*(majority classes + 1) float32 operations.  At the CIFAR sweep's
// widths (N = 20,431..50,000, D = 512, C = 10) the bytes bound it
// (12.5..31 us at 3.35 TB/s); at ImageNet-LT's (N = 130,000, D = 2048,
// C = 1000, ~408 majority classes) the operations do (3.25 ms at 67
// TFLOP/s outside the tensor cores).
//
// Design: at most two launches a pick, and in BalancingSampler's loop no
// host work between them but one copy of a pinned block.
//   update  one block applies the loop's queued changes, copied to the
//           device in one block with the majority mask: the taken rows'
//           eligibility off, the changed centers written, each changed
//           center's b2 (small C; large C forms b2 in the fold), and the
//           ascending list of majority classes.
//   fold    the score of every row and the least key of each block; the
//           last block to finish (an atomic ticket after a __threadfence)
//           merges the blocks' keys, writes the row index (into pinned
//           host memory for the loop) and resets the ticket.
//   Small C (at most SMALL_C classes, their rows in shared memory): a warp
//   folds 32/S rows at once, S slots a row (a2, d_rare and up to S - 2
//   majority dots).  Lane l owns features 128m + 4l .. 128m + 4l + 3 of
//   every 128-feature chunk, loads 16 bytes of each row a chunk straight
//   into registers, four chunks at once (a 512-feature row whole), and
//   chains fmaf over them in chunk order; the 32
//   (row, slot) lane sums are reduced by a recursive-halving transpose (31
//   shuffles), after which lane l holds row l / S, slot l % S; the max
//   over classes is a butterfly inside the row's S lanes.  One read of
//   each row gives a2, d_rare and every dot.
//   Large C: a 128-row x 128-center float32 tile GEMM over the compacted
//   majority centers, 8 x 8 outputs a thread, K-major tiles of 32
//   features copied by a double-buffered cp.async ring (16-byte copies
//   where rows lie on 16 bytes, 4-byte otherwise), the max over classes
//   in the epilogue; one block walks every majority tile for its row tile
//   so the max stays in registers.  The first tile's pass also forms each
//   row's a2 and d_rare (the rare center staged beside), every tile's pass
//   its centers' b2; the last tile computes only its 16-column groups that
//   hold centers.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// balancing.py.  The entry points return cudaGetLastError() after their
// launches (bal_state_pick: the row, or minus the error).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

// The device state of ops/balancing.py's BalancingState (a ctypes
// Structure there).  Outside the anonymous namespace: an extern "C" entry
// that takes it by pointer needs external linkage.
struct BalState {
  const float* emb;           // [n, d]
  unsigned char* eligible;    // [n]
  float* centers;             // [c, d]
  float* b2;                  // [c]
  int* maj_idx;               // [c]
  int* n_maj;                 // [1]
  unsigned long long* keys;   // the fold's block keys
  unsigned int* ticket;       // [1], 0 between picks
  unsigned char* blk;         // the per-pick block on the device
  const unsigned char* host_blk;  // the pinned block
  long long* out;             // device pointer of the pinned result slot
  const long long* host_out;  // its host pointer
  void* event;                // cudaEvent_t the pick waits on
  int n, d, c;
  int launched;               // kernels launched, counted at each launch
};

namespace {

constexpr int CHUNK = 128;  // features a warp covers per step
constexpr int CHUNK_GROUP = 4;  // chunks of a row the warp fold loads at once
constexpr int FOLD_WARPS = 8;
constexpr int FOLD_THREADS = FOLD_WARPS * 32;
constexpr int UPD_THREADS = 512;
constexpr int SMALL_C = 30;              // classes the small path takes
constexpr int SMEM_LIMIT = 200 * 1024;   // dynamic, beside the static
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

// ---- keys ------------------------------------------------------------------

// jnp.max's rule: a NaN anywhere makes the max NaN.
__device__ __forceinline__ float nan_max(float m, float x) {
  return (x > m || x != x) ? x : m;
}

__device__ __forceinline__ unsigned long long pick_key(float s, int row) {
  uint32_t u = 0u;  // a NaN: below every number
  if (s == s) {
    const uint32_t b = __float_as_uint(s == 0.0f ? 0.0f : s);
    u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return ((unsigned long long)u << 32) | (uint32_t)row;
}

__device__ __forceinline__ unsigned long long key_min(unsigned long long a,
                                                      unsigned long long b) {
  return b < a ? b : a;
}

// The least key of the block, in every thread; `sh` holds 32 entries.
__device__ unsigned long long block_min(unsigned long long k,
                                        unsigned long long* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    k = key_min(k, __shfl_xor_sync(kFull, k, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) sh[warp] = k;
  __syncthreads();
  k = lane < nwarps ? sh[lane] : kNoKey;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    k = key_min(k, __shfl_xor_sync(kFull, k, o));
  return k;
}

struct FoldArgs {
  const float* emb;
  const unsigned char* eligible;
  const float* centers;
  const float* b2;  // small path
  const int* maj_idx;
  const int* n_maj;
  int n, d, chunks, vec, rarest, rare_empty;
  unsigned long long* keys;
  unsigned int* ticket;
  long long* out;
};

// The block's least key into keys[block]; the last block to arrive merges
// every block's key, writes the row to *out and resets the ticket for the
// next pick.  Every thread of the block calls it.
__device__ void finish(const FoldArgs& a, unsigned long long key,
                       unsigned long long* sh) {
  __shared__ bool last;
  key = block_min(key, sh);
  if (threadIdx.x == 0) {
    a.keys[blockIdx.x] = key;
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const volatile unsigned long long* keys = a.keys;
  unsigned long long k = kNoKey;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x)
    k = key_min(k, keys[b]);
  k = block_min(k, sh);
  if (threadIdx.x == 0) {
    *a.out = (long long)(k & 0xffffffffull);
    *a.ticket = 0u;
  }
}

// ---- loads and lane sums -----------------------------------------------------

// Features k..k+3 of a row; zeros past the row's end or the matrix's.
__device__ __forceinline__ float4 load4(const float* base, int row, int n,
                                        int d, int k, int vec) {
  float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= n || k >= d) return z;
  const float* p = base + (size_t)row * d + k;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  z.x = __ldg(p);
  if (k + 1 < d) z.y = __ldg(p + 1);
  if (k + 2 < d) z.z = __ldg(p + 2);
  if (k + 3 < d) z.w = __ldg(p + 3);
  return z;
}

__device__ __forceinline__ float fma4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 sub4(const float4& a, const float4& b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

__device__ __forceinline__ float sq_dist(float a2, float b2, float dot) {
  return __fsub_rn(__fadd_rn(a2, b2), 2.0f * dot);
}

// A center's squared norm, by one warp: lane l chains features 128m + 4l
// .. + 3, then the butterfly (every lane returns it).
__device__ __forceinline__ float warp_sq(const float* centers, int c, int d,
                                         int vec) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int k = lane * 4; k < d; k += CHUNK) {
    const float4 v = load4(centers, c, c + 1, d, k, vec);
    acc = fma4(v, v, acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, o));
  return acc;
}

// One halving step of the transpose: keep half of the values, add the
// partner's copy of the same items.
template <int H>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, H));
  }
}

// The warp sum of item `lane` of v[32].
__device__ __forceinline__ float reduce_scatter(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// ---- the update ------------------------------------------------------------

struct UpdArgs {
  const unsigned char* maj;  // [c] mask
  const int* cls;            // [n_cls] changed centers
  const int* rows;           // [n_rows] rows taken
  const float* cvals;        // [n_cls, d] their new values
  int n_cls, n_rows, full, keep_b2, vec;
  unsigned char* eligible;
  float* centers;
  float* b2;
  int* maj_idx;
  int* n_maj;
  int c, d;
};

__global__ void __launch_bounds__(UPD_THREADS) update_kernel(UpdArgs a) {
  constexpr int WARPS = UPD_THREADS / 32;
  __shared__ int warp_counts[WARPS];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  for (int i = t; i < a.n_rows; i += UPD_THREADS) a.eligible[a.rows[i]] = 0;
  const long long nv = (long long)a.n_cls * a.d;
  for (long long e = t; e < nv; e += UPD_THREADS) {
    const int j = (int)(e / a.d), k = (int)(e - (long long)j * a.d);
    a.centers[(size_t)a.cls[j] * a.d + k] = a.cvals[e];
  }
  __syncthreads();  // the block's global writes are visible to it now
  if (a.keep_b2) {
    const int todo = a.full ? a.c : a.n_cls;
    for (int j = warp; j < todo; j += WARPS) {
      const int c = a.full ? j : a.cls[j];
      const float s = warp_sq(a.centers, c, a.d, a.vec);
      if (lane == 0) a.b2[c] = s;
    }
  }
  // The ascending list of majority classes.
  int base = 0;
  for (int c0 = 0; c0 < a.c; c0 += UPD_THREADS) {
    const int ci = c0 + t;
    const bool m = ci < a.c && a.maj[ci] != 0;
    const unsigned ballot = __ballot_sync(kFull, m);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int off = base;
    for (int w = 0; w < warp; ++w) off += warp_counts[w];
    if (m) a.maj_idx[off + __popc(ballot & ((1u << lane) - 1u))] = ci;
    for (int w = 0; w < WARPS; ++w) base += warp_counts[w];
    __syncthreads();
  }
  if (t == 0) *a.n_maj = base;
}

// ---- small C: the warp fold --------------------------------------------------

// acc[r * S + s]: this lane's partial of row row0 + r's slot s (0: a2,
// 1: d_rare, 2 + j: the dot with majority center j).  cs: the rare
// center, then the majority centers, `stride` floats each, zero past d.
// The rows' chunks are loaded CHUNK_GROUP at a time, all issued before
// any is used.
template <int S>
__device__ __forceinline__ void lane_sums(const FoldArgs& a, const float* cs,
                                          int stride, int nm, int row0,
                                          float (&acc)[32]) {
  constexpr int RPW = 32 / S;
  constexpr int G = CHUNK_GROUP;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int m0 = 0; m0 < a.chunks; m0 += G) {
    float4 e[G][RPW];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        e[g][r] = load4(a.emb, row0 + r, a.n, a.d,
                        (m0 + g) * CHUNK + lane * 4, a.vec);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (m0 + g < a.chunks) {
        const int k = (m0 + g) * CHUNK + lane * 4;
        const float4 rc = *reinterpret_cast<const float4*>(cs + k);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          acc[r * S] = fma4(e[g][r], e[g][r], acc[r * S]);
          const float4 df = sub4(e[g][r], rc);
          acc[r * S + 1] = fma4(df, df, acc[r * S + 1]);
        }
#pragma unroll
        for (int j = 0; j < S - 2; ++j) {
          if (j < nm) {
            const float4 c =
                *reinterpret_cast<const float4*>(cs + (j + 1) * stride + k);
#pragma unroll
            for (int r = 0; r < RPW; ++r)
              acc[r * S + 2 + j] = fma4(e[g][r], c, acc[r * S + 2 + j]);
          }
        }
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(FOLD_THREADS) small_fold_kernel(FoldArgs a) {
  constexpr int RPW = 32 / S;
  extern __shared__ float4 small_smem[];
  float* cs = reinterpret_cast<float*>(small_smem);
  __shared__ float cb2[S];
  __shared__ unsigned long long sh[32];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int nm = *a.n_maj;  // at most S - 2: the host chose S for it
  const int stride = a.chunks * CHUNK;
  for (int e = t; e < (nm + 1) * stride; e += FOLD_THREADS) {
    const int j = e / stride, k = e - j * stride;
    const int src = j == 0 ? a.rarest : a.maj_idx[j - 1];
    cs[e] = k < a.d ? a.centers[(size_t)src * a.d + k] : 0.f;
  }
  if (t < nm) cb2[t] = a.b2[a.maj_idx[t]];
  __syncthreads();

  const int s = lane & (S - 1), head = lane & ~(S - 1);
  unsigned long long best = kNoKey;
  const int groups = (a.n + RPW - 1) / RPW;
  for (int g = blockIdx.x * FOLD_WARPS + warp; g < groups;
       g += gridDim.x * FOLD_WARPS) {
    const int row0 = g * RPW;
    float acc[32];
    lane_sums<S>(a, cs, stride, nm, row0, acc);
    const float v = reduce_scatter(acc);
    const float a2 = __shfl_sync(kFull, v, head);
    const float dr = __shfl_sync(kFull, v, head + 1);
    float dd = -INFINITY;
    if (s >= 2 && s - 2 < nm) dd = sq_dist(a2, cb2[s - 2], v);
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1)
      dd = nan_max(dd, __shfl_xor_sync(kFull, dd, o));
    const int row = row0 + lane / S;
    if (s == 0 && row < a.n) {
      const float num = a.rare_empty ? 1.0f : dr;
      const float score = a.eligible[row] ? __fdiv_rn(num, dd) : INFINITY;
      best = key_min(best, pick_key(score, row));
    }
  }
  finish(a, best, sh);
}

// ---- large C: the tile GEMM --------------------------------------------------

constexpr int MT = 128, NT = 128, BK = 32, PADK = BK + 4;
constexpr int STAGES = 2;
constexpr int GEMM_THREADS = 256;
constexpr size_t GEMM_SMEM =
    (size_t)STAGES * ((MT + NT) * PADK + BK) * sizeof(float);

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

struct GemmSmem {
  float (*As)[MT][PADK];
  float (*Bs)[NT][PADK];
  float (*Rs)[BK];
};

// Copy features k0..k0+BK-1 of rows row0.. (A), of the centers crow[]
// (B) and, on the first tile, of the rare center (R) into one stage;
// zeros past the matrix, the row count or cvalid.
__device__ __forceinline__ void load_stage(const FoldArgs& a, int row0,
                                           const int* crow, int cvalid,
                                           bool first, int k0, int st,
                                           const GemmSmem& sm) {
  const int t = threadIdx.x;
  const float* E = a.emb;
  const float* C = a.centers;
  if (a.vec) {
    constexpr int V4 = BK / 4;
#pragma unroll
    for (int u = 0; u < MT * V4 / GEMM_THREADS; ++u) {
      const int e = t + u * GEMM_THREADS;
      const int r = e / V4, c4 = (e % V4) * 4, k = k0 + c4;
      const bool pa = row0 + r < a.n && k < a.d;
      cp_async16(&sm.As[st][r][c4], pa ? E + (size_t)(row0 + r) * a.d + k : E,
                 pa);
      const bool pb = r < cvalid && k < a.d;
      cp_async16(&sm.Bs[st][r][c4], pb ? C + (size_t)crow[r] * a.d + k : C,
                 pb);
    }
    if (first && t < V4) {
      const int k = k0 + t * 4;
      const bool p = k < a.d;
      cp_async16(&sm.Rs[st][t * 4], p ? C + (size_t)a.rarest * a.d + k : C,
                 p);
    }
  } else {
#pragma unroll
    for (int u = 0; u < MT * BK / GEMM_THREADS; ++u) {
      const int e = t + u * GEMM_THREADS;
      const int r = e / BK, c = e % BK, k = k0 + c;
      const bool pa = row0 + r < a.n && k < a.d;
      cp_async4(&sm.As[st][r][c], pa ? E + (size_t)(row0 + r) * a.d + k : E,
                pa);
      const bool pb = r < cvalid && k < a.d;
      cp_async4(&sm.Bs[st][r][c], pb ? C + (size_t)crow[r] * a.d + k : C, pb);
    }
    if (first && t < BK) {
      const int k = k0 + t;
      const bool p = k < a.d;
      cp_async4(&sm.Rs[st][t], p ? C + (size_t)a.rarest * a.d + k : C, p);
    }
  }
}

// One majority tile: acc[i][j] = (row tr + 16 i) . (center tc + 16 j) for
// the JN column groups that hold centers, each an fmaf chain in ascending
// feature order; every thread also chains half a row's (t >> 1) features
// of the stage for the first tile's a2 and d_rare (ap, dp) and half a
// center's for b2 (bp).
template <int JN>
__device__ __forceinline__ void tile_pass(const FoldArgs& a, int row0,
                                          const int* crow, int cvalid,
                                          bool first, int tr, int tc,
                                          const GemmSmem& sm,
                                          float (&acc)[8][8], float& ap,
                                          float& dp, float& bp) {
  const int t = threadIdx.x;
  const int q = t >> 1, h = (t & 1) * (BK / 2);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
  const int kt_n = (a.d + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < kt_n) load_stage(a, row0, crow, cvalid, first, st * BK, st, sm);
    cp_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt % STAGES;
    const int ahead = kt + STAGES - 1;
    if (ahead < kt_n)
      load_stage(a, row0, crow, cvalid, first, ahead * BK, ahead % STAGES,
                 sm);
    cp_commit();
    cp_wait_stage();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 2; kk += 4) {
      const float4 bv = *reinterpret_cast<const float4*>(&sm.Bs[st][q][h + kk]);
      bp = fma4(bv, bv, bp);
      if (first) {
        const float4 av =
            *reinterpret_cast<const float4*>(&sm.As[st][q][h + kk]);
        const float4 rv = *reinterpret_cast<const float4*>(&sm.Rs[st][h + kk]);
        ap = fma4(av, av, ap);
        const float4 df = sub4(av, rv);
        dp = fma4(df, df, dp);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[8], bv[JN];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(&sm.As[st][tr + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < JN; ++j)
        bv[j] = *reinterpret_cast<const float4*>(&sm.Bs[st][tc + 16 * j][kk]);
#pragma unroll
      for (int j = 0; j < JN; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fma4(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int JN>
__device__ __forceinline__ void tile_max(const float (&acc)[8][8],
                                         const float* a2s, const float* cb2,
                                         int cvalid, int tr, int tc,
                                         float (&run)[8]) {
#pragma unroll
  for (int j = 0; j < JN; ++j) {
    const int c = tc + 16 * j;
    if (c < cvalid) {
      const float bc = cb2[c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        run[i] = nan_max(run[i], sq_dist(a2s[tr + 16 * i], bc, acc[i][j]));
    }
  }
}

__global__ void __launch_bounds__(GEMM_THREADS, 1) gemm_fold_kernel(
    FoldArgs a) {
  extern __shared__ float4 gemm_smem[];
  GemmSmem sm;
  sm.As = reinterpret_cast<float (*)[MT][PADK]>(gemm_smem);
  sm.Bs = reinterpret_cast<float (*)[NT][PADK]>(
      reinterpret_cast<float*>(gemm_smem) + STAGES * MT * PADK);
  sm.Rs = reinterpret_cast<float (*)[BK]>(
      reinterpret_cast<float*>(gemm_smem) + STAGES * (MT + NT) * PADK);
  __shared__ int crow[NT];
  __shared__ float cb2[NT];
  __shared__ float a2s[MT], drs[MT];
  __shared__ float red[8][4][8];
  __shared__ unsigned long long sh[32];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int tr = (warp >> 1) * 4 + (lane >> 3);
  const int tc = (warp & 1) * 8 + (lane & 7);
  const int row0 = blockIdx.x * MT;
  const int nm = *a.n_maj;
  const int tiles = nm > 0 ? (nm + NT - 1) / NT : 1;
  float run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) run[i] = -INFINITY;
  float ap = 0.f, dp = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int c0 = tile * NT;
    const int cvalid = min(NT, nm - c0);
    const bool first = tile == 0;
    if (t < NT) crow[t] = t < cvalid ? a.maj_idx[c0 + t] : 0;
    __syncthreads();
    float acc[8][8], bp = 0.f;
    const int jn = (cvalid + 15) / 16;
    if (jn > 4) {
      tile_pass<8>(a, row0, crow, cvalid, first, tr, tc, sm, acc, ap, dp, bp);
    } else if (jn > 2) {
      tile_pass<4>(a, row0, crow, cvalid, first, tr, tc, sm, acc, ap, dp, bp);
    } else {
      tile_pass<2>(a, row0, crow, cvalid, first, tr, tc, sm, acc, ap, dp, bp);
    }
    // Each half-sum pair is two neighbouring lanes.
    bp = __fadd_rn(bp, __shfl_xor_sync(kFull, bp, 1));
    if (first) {
      ap = __fadd_rn(ap, __shfl_xor_sync(kFull, ap, 1));
      dp = __fadd_rn(dp, __shfl_xor_sync(kFull, dp, 1));
    }
    if (!(t & 1)) {
      cb2[t >> 1] = bp;
      if (first) {
        a2s[t >> 1] = ap;
        drs[t >> 1] = dp;
      }
    }
    __syncthreads();
    if (jn > 4) {
      tile_max<8>(acc, a2s, cb2, cvalid, tr, tc, run);
    } else if (jn > 2) {
      tile_max<4>(acc, a2s, cb2, cvalid, tr, tc, run);
    } else {
      tile_max<2>(acc, a2s, cb2, cvalid, tr, tc, run);
    }
    __syncthreads();  // crow and cb2 are rewritten by the next tile
  }
  // The 16 threads of a row: lanes with equal lane >> 3 of warps 2w, 2w+1.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      run[i] = nan_max(run[i], __shfl_xor_sync(kFull, run[i], o));
  }
  if ((lane & 7) == 0 && (warp & 1))
#pragma unroll
    for (int i = 0; i < 8; ++i) red[warp >> 1][lane >> 3][i] = run[i];
  __syncthreads();
  unsigned long long best = kNoKey;
  if ((lane & 7) == 0 && !(warp & 1)) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tr + 16 * i, row = row0 + r;
      if (row < a.n) {
        const float norm = nan_max(run[i], red[warp >> 1][lane >> 3][i]);
        const float num = a.rare_empty ? 1.0f : drs[r];
        const float score =
            a.eligible[row] ? __fdiv_rn(num, norm) : INFINITY;
        best = key_min(best, pick_key(score, row));
      }
    }
  }
  finish(a, best, sh);
}

// ---- host side -------------------------------------------------------------

inline int padded(int d) { return (d + CHUNK - 1) / CHUNK * CHUNK; }

inline bool small_path(int c, int d) {
  return c <= SMALL_C &&
         (size_t)(c + 1) * padded(d) * sizeof(float) <= (size_t)SMEM_LIMIT;
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

inline bool vec_ok(const float* p, int d) {
  return d % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int S>
int launch_small(const FoldArgs& a, int m_hi, int* launched,
                 cudaStream_t stream) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        small_fold_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const size_t smem = (size_t)(m_hi + 1) * padded(a.d) * sizeof(float);
  static size_t last_smem = ~(size_t)0;
  static int per_sm = 0;
  if (smem != last_smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, small_fold_kernel<S>, FOLD_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    last_smem = smem;
  }
  const int groups = (a.n + 32 / S - 1) / (32 / S);
  int blocks = (groups + FOLD_WARPS - 1) / FOLD_WARPS;
  blocks = std::min(blocks, sm_count() * std::max(per_sm, 1));
  small_fold_kernel<S><<<blocks, FOLD_THREADS, smem, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return (int)e;
}

int launch_gemm(const FoldArgs& a, int* launched, cudaStream_t stream) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)GEMM_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  gemm_fold_kernel<<<(a.n + MT - 1) / MT, GEMM_THREADS, GEMM_SMEM, stream>>>(
      a);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return (int)e;
}

// The update launch, then the fold.  m_hi: at most this many majority
// classes (the small path sizes its shared memory and slots by it).  Each
// launch that the runtime accepts adds one to *launched.
int launch_pick(UpdArgs u, FoldArgs f, int m_hi, int* launched,
                cudaStream_t stream) {
  const bool small = small_path(u.c, u.d);
  u.keep_b2 = small;
  u.vec = vec_ok(u.centers, u.d);
  update_kernel<<<1, UPD_THREADS, 0, stream>>>(u);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++*launched;
  f.chunks = (f.d + CHUNK - 1) / CHUNK;
  f.vec = vec_ok(f.emb, f.d) && vec_ok(f.centers, f.d);
  if (!small) return launch_gemm(f, launched, stream);
  if (m_hi <= 6) return launch_small<8>(f, m_hi, launched, stream);
  if (m_hi <= 14) return launch_small<16>(f, m_hi, launched, stream);
  return launch_small<32>(f, m_hi, launched, stream);
}

}  // namespace

extern "C" {

// Block keys a fold over n rows can write (either path).
int bal_key_slots(int n) {
  const int gemm = (n + MT - 1) / MT;
  const int small = sm_count() * (2048 / FOLD_THREADS);
  return gemm > small ? gemm : small;
}

// Pinned host memory the device reads and writes (mapped), and its
// device pointer; null on failure.
void* bal_host_alloc(long long bytes) {
  void* p = nullptr;
  if (cudaHostAlloc(&p, (size_t)bytes,
                    cudaHostAllocMapped | cudaHostAllocPortable) !=
      cudaSuccess)
    return nullptr;
  return p;
}

void* bal_host_device_ptr(void* host) {
  void* d = nullptr;
  if (cudaHostGetDevicePointer(&d, host, 0) != cudaSuccess) return nullptr;
  return d;
}

int bal_host_free(void* host) { return (int)cudaFreeHost(host); }

void* bal_event_create() {
  cudaEvent_t e = nullptr;
  if (cudaEventCreateWithFlags(&e, cudaEventDisableTiming) != cudaSuccess)
    return nullptr;
  return e;
}

int bal_event_destroy(void* e) {
  return (int)cudaEventDestroy((cudaEvent_t)e);
}

// One pick of the loop: the pinned block's first blk_bytes bytes copied
// to the device (the majority mask at 0; n_cls class ids at off_cls, their
// new rows at off_cvals; n_rows taken rows at off_rows), the update and
// the fold launched, then the host waits for the row.  full: compute
// every center's b2 (the first pick, or after a plain pick changed the
// centers).  m_hi: the majority classes in the mask.  s->launched grows
// by the kernels launched.  Returns the row, or minus a CUDA error code.
long long bal_state_pick(BalState* s, long long blk_bytes, int off_cls,
                         int n_cls, int off_rows, int n_rows, int off_cvals,
                         int full, int m_hi, int rarest, int rare_empty,
                         cudaStream_t stream) {
  if (rarest < 0 || rarest >= s->c || m_hi < 0 || m_hi > s->c)
    return -(long long)cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyAsync(s->blk, s->host_blk, (size_t)blk_bytes,
                                  cudaMemcpyHostToDevice, stream);
  if (e != cudaSuccess) return -(long long)e;
  UpdArgs u = {};
  u.maj = s->blk;
  u.cls = reinterpret_cast<const int*>(s->blk + off_cls);
  u.rows = reinterpret_cast<const int*>(s->blk + off_rows);
  u.cvals = reinterpret_cast<const float*>(s->blk + off_cvals);
  u.n_cls = n_cls;
  u.n_rows = n_rows;
  u.full = full;
  u.eligible = s->eligible;
  u.centers = s->centers;
  u.b2 = s->b2;
  u.maj_idx = s->maj_idx;
  u.n_maj = s->n_maj;
  u.c = s->c;
  u.d = s->d;
  FoldArgs f = {};
  f.emb = s->emb;
  f.eligible = s->eligible;
  f.centers = s->centers;
  f.b2 = s->b2;
  f.maj_idx = s->maj_idx;
  f.n_maj = s->n_maj;
  f.n = s->n;
  f.d = s->d;
  f.rarest = rarest;
  f.rare_empty = rare_empty;
  f.keys = s->keys;
  f.ticket = s->ticket;
  f.out = s->out;
  const int err = launch_pick(u, f, m_hi, &s->launched, stream);
  if (err != 0) return -(long long)err;
  cudaEvent_t ev = (cudaEvent_t)s->event;
  e = cudaEventRecord(ev, stream);
  if (e == cudaSuccess) e = cudaEventSynchronize(ev);
  if (e != cudaSuccess) return -(long long)e;
  return *(const volatile long long*)s->host_out;
}

}  // extern "C"
