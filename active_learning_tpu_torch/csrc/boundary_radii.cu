// Kernel F: MASE's distances to the linear head's one-vs-one decision
// boundaries, and the head's pairwise row distances.
//
// Replaces the JAX package's active_learning_tpu/strategies/scoring.py:196-206
// head_pair_norms and :209-267 boundary_radii (ROADMAP K5), which make_mase_step
// (:270-311) runs once per scored batch, with its min_margin (:290).  With
// the head W [C, D] (the flax kernel transposed) and bias b [C], per row e
// [D] of a batch:
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
// Non-finite rows follow the reference: in the argmax a NaN ranks above
// every number (jnp.argmax and torch.argmax return the first NaN), and the
// min propagates a NaN (jnp.min).
//
// Entry points:
//   br_radii       two launches: the logits tile pass, whose epilogue
//                  writes each tile's per-row argmax key (no [B, C] logits
//                  leave the kernel), then the radius tile pass, which
//                  decodes pred from those keys, gathers the w_pred rows,
//                  writes the radii and folds the min into a per-row key;
//                  the last block of each row tile decodes min_margin.
//   br_pair_norms  [C, C] = ||w_c - w_j||, once per head (make_mase_step's
//                  one-slot cache): the same tile pass over the tiles that
//                  touch the upper triangle, each written with its mirror.
// Every output of a tile pass is four float32 fmaf chains, one per
// feature group g (features 16s + 4g .. 16s + 4g + 3 of every 16,
// ascending), added in the order g = 0, 1, 2, 3; sums with the biases are
// __fadd_rn/__fsub_rn, as the plain version's separate ops round them.
// ||w_c - w_j|| and ||w_j - w_c|| are the same sums of the same squares
// (a - b = -(b - a) exactly), so the table is symmetric bit for bit.
//
// Bound.  At the main path's shape (B = 256, C = 1000, D = 2048) a radii
// call reads 10 MB and issues 3*B*C*D float32 lane instructions (B*C*D
// FFMA for the logits; an FSUB, which cannot fuse, and an FFMA a term for
// the radii): 1.57e9 over 132 SMs x 128 lanes at 1,980 MHz, 47 us
// (operations; memory 3 us).  The pair norms, upper triangle: C*C*D lane
// instructions, 61 us.  What held the first design at 13x its bound, and
// what this one does about it:
//   * 64 blocks on 132 SMs.  Tiles of 32 rows x 64 classes: 128 blocks
//     at B = 256, C = 1000, eight warps each.
//   * Shared-memory issue.  A thread holds 4 rows x 8 classes and reads
//     4 features of each operand as one 16-byte load: 16 loads feed 256
//     lane instructions (radii), 12 feed 256 (pair norms) or 128.  A
//     warp's 16-byte loads of one operand touch 4 or 8 rows (the rest
//     broadcast): rows are padded to 68 floats and a warp's 8 classes
//     are consecutive rows, so each is one conflict-free wavefront.  (On
//     an H100 an 8 x 8 block spilled and was no faster; so were 8 groups
//     of 64 threads, and rings of 3 to 8 stages.)
//   * No overlap.  Slabs of 64 features come through a 4-stage cp.async
//     ring in 16-byte pieces (4-byte pieces when D or an address is not
//     a multiple of 4 floats), so the next slabs' copies run under this
//     slab's arithmetic; the four feature groups of a block split each
//     slab, and their partial sums meet once, in shared memory.
//   * Four launches and a [B, C] logits round trip.  Two launches; the
//     argmax and the min ride the epilogues.
//   * The full C x C table.  Tiles wholly below the diagonal exit at once.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// boundary_radii.py.  Each function returns cudaGetLastError() and adds
// to *launched one for each kernel the runtime accepted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int TR = 32, TC = 64;        // an output tile: rows x classes
constexpr int BK = 64, PADK = BK + 4;  // features a slab; padded row pitch
constexpr int STAGES = 4;              // the cp.async ring
constexpr int KS = 4;                  // feature groups a block
constexpr int GT = 64;                 // threads a group
constexpr int THREADS = GT * KS;       // 256
constexpr int NWARPS = THREADS / 32;
constexpr int RPW = TR / NWARPS;       // rows a warp in the epilogues
constexpr int RM = 4, CM = 8;          // a thread's rows x classes
constexpr int RED_PITCH = TC + 8;      // the merge buffer's row pitch
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kLogits = 0, kRadii = 1, kNorms = 2 };

template <int MODE>
__host__ __device__ constexpr int stage_floats() {
  return ((MODE == kRadii ? 2 : 1) * TR + TC) * PADK;
}

// The ring, whose memory the merge buffer and the mirror tile reuse.
template <int MODE>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (STAGES * stage_floats<MODE>() > KS * TR * RED_PITCH
                              ? STAGES * stage_floats<MODE>()
                              : KS * TR * RED_PITCH);
}

static_assert(TR * (TC + 1) <= KS * TR * RED_PITCH,
              "the mirror tile reuses the merge buffer");
static_assert(TR * BK / 4 % THREADS == 0 && TC * BK / 4 % THREADS == 0,
              "every thread copies the same number of pieces a slab");

struct Args {
  const float* a;     // the tile's rows: e [rows, D], or w (pair norms)
  const float* w;     // [C, D]
  const float* bias;  // [C]
  const float* norms; // [C, C] (radii)
  int rows, C, D, vec, n_ct;
  unsigned long long* part;  // [rows, n_ct]: each class tile's argmax key
  unsigned int* min_keys;    // [rows]
  unsigned int* tickets;     // [ceil(rows / TR)]
  int* preds;                // [rows]
  float* out;                // radii [rows, C] or norms [C, C]
  float* min_margin;         // [rows]
};

// ---- keys ------------------------------------------------------------------

// The float's order as an unsigned integer (-0 taken as +0, as the
// comparisons of argmax and min take it); NaN is left to the callers.
__device__ __forceinline__ uint32_t ord(float v) {
  const uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// jnp.argmax's order: a NaN above every number, ties to the lower index.
__device__ __forceinline__ unsigned long long max_key(float v, int c) {
  const uint32_t u = v != v ? 0xffffffffu : ord(v);
  return ((unsigned long long)u << 32) | (uint32_t)~c;
}

// jnp.min's order: a NaN below every number.  No number maps to 0 or to
// 0xffffffff (both are NaN bit patterns).
__device__ __forceinline__ uint32_t min_key(float v) {
  return v != v ? 0u : ord(v);
}

__device__ __forceinline__ float from_min_key(uint32_t k) {
  if (k == 0u) return __uint_as_float(0x7fc00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// ---- the copy ring -----------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row r of the slab's operand: `rows` real rows, source row src(r); zeros
// past the rows or the features.
template <int NR>
__device__ __forceinline__ void copy_rows(float* S, const float* m,
                                          const int* src, int row0, int nrows,
                                          int D, int k0, bool vec) {
  const int t = threadIdx.x;
  if (vec) {
    constexpr int V4 = BK / 4;
#pragma unroll
    for (int u = 0; u < NR * V4 / THREADS; ++u) {
      const int e = t + u * THREADS;
      const int r = e / V4, c = (e % V4) * 4, k = k0 + c;
      const int s = src != nullptr ? src[r] : (row0 + r < nrows ? row0 + r
                                                                : -1);
      const bool p = s >= 0 && k < D;
      cp_async16(S + r * PADK + c, p ? m + (size_t)s * D + k : m, p);
    }
  } else {
#pragma unroll
    for (int u = 0; u < NR * BK / THREADS; ++u) {
      const int e = t + u * THREADS;
      const int r = e / BK, c = e % BK, k = k0 + c;
      const int s = src != nullptr ? src[r] : (row0 + r < nrows ? row0 + r
                                                                : -1);
      const bool p = s >= 0 && k < D;
      cp_async4(S + r * PADK + c, p ? m + (size_t)s * D + k : m, p);
    }
  }
}

template <int MODE>
__device__ __forceinline__ void load_stage(const Args& a, int row0, int c0,
                                           const int* prow, int k0,
                                           float* st) {
  constexpr int kP = MODE == kRadii ? 1 : 0;
  copy_rows<TR>(st, a.a, nullptr, row0, a.rows, a.D, k0, a.vec);
  if (kP) copy_rows<TR>(st + TR * PADK, a.w, prow, 0, 0, a.D, k0, a.vec);
  copy_rows<TC>(st + (1 + kP) * TR * PADK, a.w, nullptr, c0, a.C, a.D, k0,
                a.vec);
}

// One output's chain over 4 features.
template <int MODE>
__device__ __forceinline__ float step4(const float4& x, const float4& p,
                                       const float4& y, float acc) {
  if (MODE == kLogits) {
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    return fmaf(x.w, y.w, acc);
  } else if (MODE == kRadii) {
    acc = fmaf(x.x, __fsub_rn(p.x, y.x), acc);
    acc = fmaf(x.y, __fsub_rn(p.y, y.y), acc);
    acc = fmaf(x.z, __fsub_rn(p.z, y.z), acc);
    return fmaf(x.w, __fsub_rn(p.w, y.w), acc);
  } else {
    float d = __fsub_rn(x.x, y.x);
    acc = fmaf(d, d, acc);
    d = __fsub_rn(x.y, y.y);
    acc = fmaf(d, d, acc);
    d = __fsub_rn(x.z, y.z);
    acc = fmaf(d, d, acc);
    d = __fsub_rn(x.w, y.w);
    return fmaf(d, d, acc);
  }
}

// ---- the tile pass -------------------------------------------------------------

// Every thread's 4 x 8 partial sums over its feature group, through the
// ring; rows tr + 8 i, classes tc + 8 j of the tile.
template <int MODE>
__device__ __forceinline__ void tile_sums(const Args& a, int row0, int c0,
                                          const int* prow, float* smem,
                                          float (&acc)[RM][CM]) {
  const int t = threadIdx.x, g = t / GT, u = t % GT;
  const int tr = u / 8, tc = u % 8;
  constexpr int kP = MODE == kRadii ? 1 : 0;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CM; ++j) acc[i][j] = 0.f;
  const int nk = (a.D + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<MODE>(a, row0, c0, prow, s * BK,
                       smem + s * stage_floats<MODE>());
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int ahead = kt + STAGES - 1;
    if (ahead < nk)
      load_stage<MODE>(a, row0, c0, prow, ahead * BK,
                       smem + (ahead % STAGES) * stage_floats<MODE>());
    cp_commit();
    cp_wait<STAGES - 1>();
    __syncthreads();
    const float* As = smem + (kt % STAGES) * stage_floats<MODE>();
    const float* Ps = As + TR * PADK;
    const float* Bs = As + (1 + kP) * TR * PADK;
#pragma unroll
    for (int h = 0; h < BK / (4 * KS); ++h) {
      const int kk = 4 * (g + KS * h);
      float4 bv[CM];
#pragma unroll
      for (int j = 0; j < CM; ++j)
        bv[j] = *reinterpret_cast<const float4*>(Bs + (tc + 8 * j) * PADK +
                                                 kk);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 av =
            *reinterpret_cast<const float4*>(As + (tr + 8 * i) * PADK + kk);
        const float4 pv =
            kP ? *reinterpret_cast<const float4*>(Ps + (tr + 8 * i) * PADK +
                                                  kk)
               : av;
#pragma unroll
        for (int j = 0; j < CM; ++j)
          acc[i][j] = step4<MODE>(av, pv, bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();
}

// The groups' partial sums added in group order: s[i][jj] is row
// warp * RPW + i, class lane + 32 jj of the tile.  Leaves the block synced.
__device__ __forceinline__ void merge_groups(const float (&acc)[RM][CM],
                                             float* red, float (&s)[RPW][2]) {
  const int t = threadIdx.x, g = t / GT, u = t % GT;
  const int tr = u / 8, tc = u % 8;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CM; ++j)
      red[(g * TR + tr + 8 * i) * RED_PITCH + tc + 8 * j] = acc[i][j];
  __syncthreads();
  const int warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int o = (warp * RPW + i) * RED_PITCH + lane + 32 * jj;
      float v = red[o];
#pragma unroll
      for (int q = 1; q < KS; ++q) v = __fadd_rn(v, red[q * TR * RED_PITCH + o]);
      s[i][jj] = v;
    }
  __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) tile_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int prow[TR];
  __shared__ bool last;
  const int row0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (MODE == kNorms && c0 + TC - 1 < row0) return;  // below the diagonal

  if (MODE == kRadii) {
    // pred of each row of the tile from the logits pass's keys.
    if (t < TR) {
      const int b = row0 + t;
      int pred = -1;
      if (b < a.rows) {
        unsigned long long k = 0ull;
        for (int x = 0; x < a.n_ct; ++x) {
          const unsigned long long y = a.part[(size_t)b * a.n_ct + x];
          k = y > k ? y : k;
        }
        pred = (int)~(uint32_t)k;
        if (blockIdx.x == 0) a.preds[b] = pred;
      }
      prow[t] = pred;
    }
    __syncthreads();
  }
  if (MODE == kLogits && blockIdx.x == 0) {
    // The radius pass's min keys and ticket, for the launch after this.
    if (t < TR && row0 + t < a.rows) a.min_keys[row0 + t] = 0xffffffffu;
    if (t == 0) a.tickets[blockIdx.y] = 0u;
  }

  float acc[RM][CM];
  tile_sums<MODE>(a, row0, c0, prow, smem, acc);
  float s[RPW][2];
  merge_groups(acc, smem, s);

  if (MODE == kLogits) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int b = row0 + warp * RPW + i;
      unsigned long long k = 0ull;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = c0 + lane + 32 * jj;
        if (c < a.C) {
          const unsigned long long y =
              max_key(__fadd_rn(s[i][jj], a.bias[c]), c);
          k = y > k ? y : k;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long y = __shfl_xor_sync(kFull, k, o);
        k = y > k ? y : k;
      }
      if (lane == 0 && b < a.rows)
        a.part[(size_t)b * a.n_ct + blockIdx.x] = k;
    }
  } else if (MODE == kRadii) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i, b = row0 + r;
      uint32_t k = 0xffffffffu;
      if (b < a.rows) {
        const int pred = prow[r];
        const float bp = a.bias[pred];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = c0 + lane + 32 * jj;
          if (c >= a.C) continue;
          const float numer = __fsub_rn(__fadd_rn(s[i][jj], bp), a.bias[c]);
          const float denom = a.norms[(size_t)pred * a.C + c];
          const float radius =
              denom > 0.f ? __fdiv_rn(numer, fmaxf(denom, 1e-30f)) : INFINITY;
          a.out[(size_t)b * a.C + c] = radius;
          const uint32_t y = min_key(radius);
          k = y < k ? y : k;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const uint32_t y = __shfl_xor_sync(kFull, k, o);
        k = y < k ? y : k;
      }
      if (lane == 0 && b < a.rows) atomicMin(&a.min_keys[b], k);
    }
    // The last block of the row tile decodes its rows' min keys.
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(&a.tickets[blockIdx.y], 1u) == gridDim.x - 1;
    __syncthreads();
    if (last && t < TR && row0 + t < a.rows) {
      __threadfence();
      const uint32_t k =
          *reinterpret_cast<volatile unsigned int*>(&a.min_keys[row0 + t]);
      a.min_margin[row0 + t] = from_min_key(k);
    }
  } else {
    // The tile and its mirror: the mirror through shared memory, so that
    // a warp writes 32 consecutive floats of a row.
    float* T = smem;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cl = lane + 32 * jj, c = c0 + cl;
        const float v = sqrtf(s[i][jj]);
        T[r * (TC + 1) + cl] = v;
        if (row0 + r < a.C && c < a.C) a.out[(size_t)(row0 + r) * a.C + c] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < TC / NWARPS; ++q) {
      const int cl = warp * (TC / NWARPS) + q, c = c0 + cl, r = row0 + lane;
      if (r < a.C && c < a.C)
        a.out[(size_t)c * a.C + r] = T[lane * (TC + 1) + cl];
    }
  }
}

inline int cdiv(int x, int y) { return (x + y - 1) / y; }

// The kernel's shared-memory allowance, set once a device: the runtime
// call costs host time a launch would otherwise not pay.
template <int MODE>
cudaError_t allow_smem() {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kDevices && done[dev])) return e;
  e = cudaFuncSetAttribute(tile_kernel<MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes<MODE>());
  if (e == cudaSuccess && dev < kDevices) done[dev] = true;
  return e;
}

template <int MODE>
cudaError_t launch(const Args& a, int rows, cudaStream_t stream,
                   int* launched) {
  constexpr size_t bytes = smem_bytes<MODE>();
  const cudaError_t set = allow_smem<MODE>();
  if (set != cudaSuccess) return set;
  tile_kernel<MODE><<<dim3(cdiv(a.C, TC), cdiv(rows, TR)), THREADS, bytes,
                      stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

size_t part_bytes(int B, int C) {
  return (size_t)B * cdiv(C, TC) * sizeof(unsigned long long);
}

}  // namespace

extern "C" {

// Bytes of the scratch br_radii takes: the class tiles' argmax keys, the
// min keys and the row tiles' tickets; -1 past INT_MAX.
int br_scratch_bytes(int B, int C) {
  if (B < 1 || C < 1) return -1;
  const size_t n = part_bytes(B, C) + (size_t)B * 4 + (size_t)cdiv(B, TR) * 4;
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

// e [B, D], w [C, D], bias [C], norms [C, C] (br_pair_norms of w), scratch
// (br_scratch_bytes, 8-byte aligned); vec: D and every address a multiple
// of 4 floats.  Writes preds [B] (int32), radii [B, C], min_margin [B].
int br_radii(const float* e, const float* w, const float* bias,
             const float* norms, int B, int C, int D, int vec, void* scratch,
             int* preds, float* radii, float* min_margin, int* launched,
             cudaStream_t stream) {
  if (B < 1 || C < 1 || D < 1) return cudaErrorInvalidValue;
  char* sc = static_cast<char*>(scratch);
  Args a{e, w, bias, norms, B, C, D, vec, cdiv(C, TC),
         reinterpret_cast<unsigned long long*>(sc),
         reinterpret_cast<unsigned int*>(sc + part_bytes(B, C)),
         reinterpret_cast<unsigned int*>(sc + part_bytes(B, C) +
                                         (size_t)B * 4),
         preds, radii, min_margin};
  cudaError_t err = launch<kLogits>(a, B, stream, launched);
  if (err == cudaSuccess) err = launch<kRadii>(a, B, stream, launched);
  return (int)err;
}

// w [C, D]; writes norms [C, C].
int br_pair_norms(const float* w, int C, int D, int vec, float* norms,
                  int* launched, cudaStream_t stream) {
  if (C < 1 || D < 1) return cudaErrorInvalidValue;
  Args a{w, w, nullptr, nullptr, C, C, D, vec, cdiv(C, TC), nullptr,
         nullptr, nullptr, nullptr, norms, nullptr};
  return (int)launch<kNorms>(a, C, stream, launched);
}

}  // extern "C"
