// Kernel G: BADGE's gradient-embedding factors, with the adaptive-average
// pooling of the partitioned variant.
//
// Replaces the JAX package's active_learning_tpu/strategies/scoring.py:154-193
// make_badge_step (ROADMAP K5, BADGE half), which XLA fused after the head.
// Per row of float32 logits z [C]:
//     p = exp(z - max z) / sum exp(z - max z)        (jax.nn.softmax)
//     a = p - onehot(argmax z)                       (first index on ties)
// and with pooling, a is averaged into H = min(16, C) bins and the
// embedding row e [D] into W = 512 / H bins, with torch's adaptive-pool
// edges: bin o covers [floor(o*n/out), ceil((o+1)*n/out)), so neighbouring
// bins may overlap (C = 10 -> 10 bins, D = 512 -> 51 bins of about 10).
// A bin's value is sum_k x_k * float32(1 / (end - start)) over its own
// terms, the terms of the JAX step's `x @ M` that are not zero.
//
// Non-finite rows follow the reference.  A row holding a NaN or a +inf
// logit has every p NaN (exp(NaN) or inf - inf in the sum), so a is NaN,
// as in the JAX step.  In the pooling, `x @ M` also adds x_k * 0 for every
// k outside the bin, which is NaN when x_k is NaN or ±inf.  So a bin is
// NaN when its row holds more non-finite elements than the bin itself
// (the counts follow the same, possibly overlapping, edges); otherwise it
// is its own sum, which is +inf for a bin holding the row's only +inf.
//
// Why CUDA and not Triton: it is the same row-per-block softmax as kernel A
// (csrc/prob_stats.cu), whose fixed-order reductions it reuses, and it
// builds with the other CUDA sources in one nvcc pass at first use.
//
// Bound: memory.  At the main path's shape (B = 256, C = 1000, D = 2048)
// a call reads 1 MB of logits (and 2 MB of embeddings when pooling) and
// writes 1 MB (or 48 KB pooled): under 1 us at 3.35 TB/s; launch and the
// latency of a row's dependent steps dominate.  Design: a block of 256
// threads a row for the softmax (kernel A's form: a warp a row doubled
// A's device time), with 16-byte loads of the row where C % 4 == 0 and,
// unpooled, 16-byte stores of a; each block reduction takes two barriers.
// Pooled, a bin of a comes straight from the exponentials and their sum,
// w * (sum_{k in bin} u_k / s - [arg in bin]), with no pass that forms a
// (the plain version's `a @ M` sums the same terms in another order), and
// the embedding rows get blocks of their own (B more), which copy their
// row into shared memory and reduce its bins beside the softmax's
// dependent chain instead of after it.  Every thread reduces bins: a
// group of 8 lanes a bin, each lane summing every 8th element of the bin
// in index order, then a fixed xor tree over the group (the parent pooled
// with 48 threads, each walking 64 floats of global memory).  Every sum
// has a fixed order, so two launches give equal bits.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// badge.py.  The function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 8;                 // lanes that reduce one bin
constexpr int GROUPS = THREADS / GROUP;  // bins reduced at once
constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory: a logits row, rounded up to 4 floats, or when
// pooling an embedding row, whichever is longer; 256 bytes are left for
// the static slots (112 used).  Past the 48 KB default the kernel opts
// in, up to Hopper's 227 KB a block.
constexpr int SMEM_DEFAULT = 48 * 1024 - 256;
constexpr int SMEM_MAX = 232448 - 256;
constexpr int MAX_CLASSES = SMEM_DEFAULT / 4;  // 12224

// Launch flags from the wrapper.
constexpr int kRowVec = 1;  // C % 4 == 0, logits on 16 bytes: float4 rows
constexpr int kEmbVec = 2;  // D % 4 == 0, embedding on 16 bytes

__device__ __forceinline__ bool max_before(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void take_max(float v, int i, float& m, int& arg) {
  if (max_before(v, i, m, arg)) {
    m = v;
    arg = i;
  }
}

__device__ __forceinline__ int nonfinite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

__device__ __forceinline__ int nonfinite4(const float4& v) {
  return nonfinite(v.x) + nonfinite(v.y) + nonfinite(v.z) + nonfinite(v.w);
}

// Block max with its first index; every thread gets the result.  sv, si:
// WARPS + 1 slots each, not reused after.
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    const int j = __shfl_xor_sync(kFull, i, o);
    if (max_before(w, j, v, i)) {
      v = w;
      i = j;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < WARPS; ++k)
      if (max_before(sv[k], si[k], v, i)) {
        v = sv[k];
        i = si[k];
      }
    sv[WARPS] = v;
    si[WARPS] = i;
  }
  __syncthreads();
  v = sv[WARPS];
  i = si[WARPS];
}

// Block sum in a fixed order (each warp's shuffle tree, then the warps'
// partials in order); every thread gets the result.  ss: WARPS + 1 slots,
// not reused after.
__device__ float block_sum(float s, float* ss) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) ss[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = ss[0];
    for (int k = 1; k < WARPS; ++k) t += ss[k];
    ss[WARPS] = t;
  }
  __syncthreads();
  return ss[WARPS];
}

// a = p - onehot at class c, p = u / s.
__device__ __forceinline__ float factor(float u, float s, int c, int arg) {
  return __fsub_rn(__fdiv_rn(u, s), c == arg ? 1.f : 0.f);
}

// Bin o of n elements pooled to out: [start, end), torch's adaptive-pool
// edges (o * n stays below 2^31: n <= 58,048 floats, out <= 512).
__device__ __forceinline__ void bin_edges(int o, int n, int out, int& start,
                                          int& end) {
  start = o * n / out;
  end = ((o + 1) * n + out - 1) / out;
}

// float32(1 / m), the plain version's matrix entry for a bin of m (its
// float64 quotient rounds to the same float: 1/m has no run of 28 zero
// bits for m below 2^28).
__device__ __forceinline__ float bin_weight(int m) {
  return __frcp_rn((float)m);
}

// The group of 8 lanes (of this warp) that reduces one bin, and its sum
// over the group by a fixed xor tree.
__device__ __forceinline__ unsigned group_mask() {
  return 0xffu << (threadIdx.x & 31 & ~(GROUP - 1));
}

template <class T>
__device__ __forceinline__ T group_sum(T v, unsigned mask) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

// Blocks B..2B-1 (pooling only): embedding row `row` [D] into pool_w
// bins, beside the softmax blocks.  The row goes through registers (16
// bytes a load where it allows) into shared memory, counting its
// non-finite elements on the way; then every thread reduces bins: a group
// of 8 lanes a bin, each lane summing every 8th element of the bin in
// index order, then group_sum; 32 bins at a time.
__device__ void embedding_bins(const float* __restrict__ emb, int row, int D,
                               int pool_w, int flags, float* x,
                               float* __restrict__ e_out, int* count) {
  const int tid = threadIdx.x;
  const float* e = emb + (size_t)row * D;
  if (tid == 0) *count = 0;
  int bad = 0;
  if (flags & kEmbVec) {
    const float4* e4 = reinterpret_cast<const float4*>(e);
    for (int k = tid; k < D / 4; k += THREADS) {
      const float4 v = __ldg(e4 + k);
      reinterpret_cast<float4*>(x)[k] = v;
      bad += nonfinite4(v);
    }
  } else {
    for (int k = tid; k < D; k += THREADS) {
      const float v = __ldg(e + k);
      x[k] = v;
      bad += nonfinite(v);
    }
  }
  // The barrier publishes the row (and the count's 0).
  int row_bad = 0;
  if (__syncthreads_or(bad)) {
    if (bad) atomicAdd(count, bad);
    __syncthreads();
    row_bad = *count;
  }
  const int l = tid % GROUP;
  const unsigned mask = group_mask();
  for (int o = tid / GROUP; o < pool_w; o += GROUPS) {
    int start, end;
    bin_edges(o, D, pool_w, start, end);
    const float w = bin_weight(end - start);
    float acc = 0.f;
    int own = 0;
#pragma unroll 4
    for (int k = start + l; k < end; k += GROUP) {
      const float t = x[k];
      acc = fmaf(t, w, acc);
      own += nonfinite(t);
    }
    acc = group_sum(acc, mask);
    own = group_sum(own, mask);
    // `e @ M` adds e_k * 0 for every k outside the bin: NaN when one of
    // those is NaN or ±inf.
    if (l == 0) e_out[(size_t)row * pool_w + o] = row_bad > own ? NAN : acc;
  }
}

// Blocks 0..B-1: a row's softmax factor a, pooled into pool_h bins when
// pooling; blocks B..2B-1 (pooling only): embedding_bins.
__global__ void __launch_bounds__(THREADS) badge_kernel(
    const float* __restrict__ logits, const float* __restrict__ emb, int B,
    int C, int D, int pool_h, int pool_w, int flags,
    float* __restrict__ a_out, float* __restrict__ e_out) {
  extern __shared__ float4 smem4[];
  float* x = reinterpret_cast<float*>(smem4);  // the row, padded to 4
  float4* x4 = smem4;
  __shared__ float sv[WARPS + 1], ss[WARPS + 1];
  __shared__ int si[WARPS + 1];
  __shared__ int count;
  const int tid = threadIdx.x;
  if (blockIdx.x >= B) {
    embedding_bins(emb, blockIdx.x - B, D, pool_w, flags, x, e_out, &count);
    return;
  }
  const size_t row = blockIdx.x;
  const bool vec = flags & kRowVec;
  const int c4 = C / 4;

  // 1. The logits row into shared memory, its max and first argmax.
  const float* z = logits + row * C;
  float m = -INFINITY;
  int arg = INT_MAX;
  if (vec) {
    const float4* z4 = reinterpret_cast<const float4*>(z);
    for (int k = tid; k < c4; k += THREADS) {
      const float4 v = __ldg(z4 + k);
      x4[k] = v;
      take_max(v.x, 4 * k, m, arg);
      take_max(v.y, 4 * k + 1, m, arg);
      take_max(v.z, 4 * k + 2, m, arg);
      take_max(v.w, 4 * k + 3, m, arg);
    }
  } else {
    for (int c = tid; c < C; c += THREADS) {
      const float v = __ldg(z + c);
      x[c] = v;
      take_max(v, c, m, arg);
    }
  }
  block_argmax(m, arg, sv, si);

  // 2. u = exp(z - m) in place and its sum, each thread's elements in
  // index order.
  float s = 0.f;
  if (vec) {
    for (int k = tid; k < c4; k += THREADS) {
      float4 u = x4[k];
      u.x = expf(__fsub_rn(u.x, m));
      u.y = expf(__fsub_rn(u.y, m));
      u.z = expf(__fsub_rn(u.z, m));
      u.w = expf(__fsub_rn(u.w, m));
      x4[k] = u;
      s += u.x;
      s += u.y;
      s += u.z;
      s += u.w;
    }
  } else {
    for (int c = tid; c < C; c += THREADS) {
      const float u = expf(__fsub_rn(x[c], m));
      x[c] = u;
      s += u;
    }
  }
  s = block_sum(s, ss);

  if (pool_h > 0) {
    // 3. A bin of a is w * (sum_{k in bin} u_k / s - [arg in bin]), from
    // the u that block_sum's barriers publish.  A row's a is non-finite
    // exactly when s is NaN (a NaN or +inf logit, or -inf throughout),
    // and then every bin is NaN, as `a @ M` has it.
    const int l = tid % GROUP;
    const unsigned mask = group_mask();
    for (int o = tid / GROUP; o < pool_h; o += GROUPS) {
      int start, end;
      bin_edges(o, C, pool_h, start, end);
      float acc = 0.f;
#pragma unroll 4
      for (int k = start + l; k < end; k += GROUP) acc += x[k];
      acc = group_sum(acc, mask);
      if (l == 0) {
        const float hit = arg >= start && arg < end ? 1.f : 0.f;
        a_out[row * pool_h + o] = __fmul_rn(
            bin_weight(end - start), __fsub_rn(__fdiv_rn(acc, s), hit));
      }
    }
    return;
  }

  // 3. Unpooled: a = p - onehot.
  float* a_row = a_out + row * C;
  if (vec) {
    for (int k = tid; k < c4; k += THREADS) {
      const float4 u = x4[k];
      float4 a;
      a.x = factor(u.x, s, 4 * k, arg);
      a.y = factor(u.y, s, 4 * k + 1, arg);
      a.z = factor(u.z, s, 4 * k + 2, arg);
      a.w = factor(u.w, s, 4 * k + 3, arg);
      reinterpret_cast<float4*>(a_row)[k] = a;
    }
  } else {
    for (int c = tid; c < C; c += THREADS) a_row[c] = factor(x[c], s, c, arg);
  }
}

}  // namespace

extern "C" {

// The most bytes of dynamic shared memory a call may take: a block holds
// a logits row (rounded up to 4 floats) or, pooling, an embedding row,
// whichever is longer.  The wrapper refuses more.
int badge_smem_limit() { return SMEM_MAX; }

// logits [B, C]; emb [B, D] (read only when pooling).  pool_h = 0: a_out
// [B, C] gets a.  pool_h > 0: a_out [B, pool_h] and e_out [B, pool_w] get
// the pooled factors.  flags: kRowVec | kEmbVec (the wrapper checks C, D
// and the pointers' 16-byte alignment).
int badge_factors_f32(const float* logits, const float* emb, int B, int C,
                      int D, int pool_h, int pool_w, int flags,
                      float* a_out, float* e_out, cudaStream_t stream) {
  if (B < 1 || B > INT_MAX / 2 || C < 1 || C > MAX_CLASSES ||
      (pool_h > 0 && D < 1))
    return cudaErrorInvalidValue;
  const int row = (C + 3) & ~3;
  const int smem = (pool_h > 0 && D > row ? D : row) * (int)sizeof(float);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > SMEM_DEFAULT) {
    // The allowance is set once a device.
    constexpr int kDevices = 64;
    static bool allowed[kDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && !(dev < kDevices && allowed[dev])) {
      e = cudaFuncSetAttribute(badge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
      if (e == cudaSuccess && dev < kDevices) allowed[dev] = true;
    }
    if (e != cudaSuccess) return (int)e;
  }
  badge_kernel<<<pool_h > 0 ? 2 * B : B, THREADS, smem, stream>>>(
      logits, emb, B, C, D, pool_h, pool_w, flags, a_out, e_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
