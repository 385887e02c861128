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
// is exact in float32.
//
// Bound, at the training shape (B=128, 112x112, C=12, F=64, 4x4): it
// reads 38.5 MB of x and 205.5 MB of g, 0.073 ms at 3.35 TB/s; its 39.5
// GFLOP take 0.040 ms at the bf16 tensor cores' 989 TFLOP/s, so device
// memory bounds it.  On the CUDA cores (67 TFLOP/s in float32) the same
// work takes 0.589 ms: the bf16 path has to run on the tensor cores.
//
// The bf16 path (stem_dw_bf16): dW is one [R x F] matrix product,
// im2col(x)^T . g, contracted over the M = B*Ho*Wo positions, with R =
// kh*kw*12 rows ordered (h, w, c).  `wgmma` (sm_90a) m64n64k16, f32
// accumulators in registers; each of a block's three warpgroups owns one
// 64-row tile of R (more rows: more blocks along grid.y).  A tile is 2
// output rows x tj columns (tj = 8 * NSTEPS, at most 112).
//   * B operand, g: one TMA box [64 filters, tj columns, 2 rows] with the
//     128-byte swizzle, 128 bytes a position (zero past F).  Step s of a
//     tile is 16 K positions: columns 8s..8s+7 of row i0 (8 g rows, one
//     swizzle atom) and the same columns of row i0+1 (the atom tj*128
//     bytes on, the descriptor's stride offset), read as an MN-major
//     (transposed) operand by a shared-memory descriptor.
//   * A operand, im2col(x), from registers.  An A register holds two
//     bf16 of one row (h, w, c) at two consecutive K, here two
//     neighbouring output columns, whose x values are 24 bytes apart: no
//     descriptor fits the raw window.  So each tile's x window is
//     re-laid in shared memory as words (x[u][v][c], x[u][v+1][c]), one
//     32-bit load per A register.  The rows of one h are contiguous
//     words and the four lanes of a quad 24 words apart: a warp's 32
//     loads hit 32 banks.
//   * TMA copies into a ring of 4 stages (kStages), one mbarrier each,
//     and a fourth warpgroup that runs no wgmma: its first thread
//     starts tile t+3's g box and raw x window (boxes of kh+1 rows x
//     256 elements of the [B, H, W*12] view; the halo and the pads are
//     TMA's zero fill), and its 128 threads re-lay tile t+1's window into
//     the other of two paired buffers, while the three wgmma warpgroups
//     load tile t's A registers and multiply; one barrier a tile.  The
//     re-lay's offsets are the same every tile and are worked out once.
//     cp.async (16-byte g rows, 8-byte x pieces) kept too few bytes in
//     flight to reach the bytes' bound on the card; TMA moves a tile in
//     1 + ceil((tj+kw)*12/256) requests.
//     Its tensor maps need rows of a multiple of 16 bytes and g's box
//     to be one 64-filter row: the wrapper pads x to an even width and
//     g to 64 filters (zeros).
//   * Deterministic: the tiles are split into nblk contiguous runs whose
//     length depends on the shape alone (ops/stem_conv.py partition:
//     132 runs, a constant, never the card's SM count).  A block walks
//     its run in order, writes one partial [F*R], and a second launch
//     folds the partials in block order.  No atomics: two launches on
//     the same input are bit-equal.
//   * Numerics.  A tensor core does not add with one IEEE round to
//     nearest per addition: it aligns the addends of a group to the
//     largest exponent, may truncate the others, and normalizes the sum.
//     Per output and 16-position step, the 16 exact products and the
//     accumulator enter in one group or two; in a group of n addends
//     n-1 lose less than one unit in the last place of the largest
//     (<= 2^-23 of it) and the normalized sum one more: at most 18 units
//     of 2^-23 per step, each bounded by the sum of |x||g| so far.  With
//     the fold's nblk float32 additions, the kernel's output is within
//     L_k * 2^-23 * sum|x||g| of the exact sum, L_k = 18 * (steps per
//     run) + nblk (ops/stem_conv.py chain_length, error_unit).
//
// The f32 path (stem_dw_f32) stays on the CUDA cores, in fp32 fmaf with
// one round to nearest per addition (chain: the run's positions + nblk,
// 2^-24 a unit): it serves the card-against-CPU float32 checks, which
// TF32 would break.  Tiles of 4 x 28 positions of one image, cut into at
// most 512 runs of the same shape-only kind; each of a block's 256
// threads owns 4 filters x 12 channels at one tap (h, w), staging each
// tile's g and x window (halo zero outside the image) in shared memory.
//
// C interface for ctypes; the wrapper is active_learning_tpu_torch/ops/
// stem_conv.py.  Each function returns cudaGetLastError() after its
// launches; the wrapper raises if it is not 0.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <dlfcn.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 12;         // input channels: 2x2 blocks of RGB

// Second stage: dW[k] = sum over blocks, in block order.
__global__ void stem_dw_fold(const float* __restrict__ partial, int nblk,
                             int K, float* __restrict__ dw) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float s = 0.f;
  for (int j = 0; j < nblk; ++j) s += partial[(long long)j * K + k];
  dw[k] = s;
}

// -- the f32 path: CUDA cores ---------------------------------------------

constexpr int kTI = 4;         // output rows per tile
constexpr int kTJ = 28;        // output columns per tile
constexpr int kThreads = 256;  // threads per block: (tap, 4 filters) each

__global__ void __launch_bounds__(kThreads)
    stem_dw_partial_f32(const float* __restrict__ x,
                        const float* __restrict__ g, int B, int H, int W,
                        int Ho, int Wo, int F, int kh, int kw, int ph0,
                        int pw0, int tiles_per_block,
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
      gs[ii * kTJ * F + r] = g[src];
    }
    // x window with its halo, zero outside the image.
    for (int idx = tid; idx < xi * xj * kC; idx += kThreads) {
      const int r = idx / (xj * kC), s = (idx / kC) % xj, c = idx % kC;
      const int u = i0 + r - ph0, v = j0 + s - pw0;
      float val = 0.f;
      if (u >= 0 && u < H && v >= 0 && v < W)
        val = x[((long long)(b * H + u) * W + v) * kC + c];
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

// -- the bf16 path: tensor cores ------------------------------------------

constexpr int kTcThreads = 512;  // three wgmma warpgroups + one more
constexpr int kMma = 384;        // threads of the wgmma warpgroups
constexpr int kGRow = 128;       // bytes of one position's g row in smem
constexpr int kXBox = 256;       // x elements along a row per TMA box
constexpr int kStages = 4;       // stages of the copy ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D (g) or 3-D (x) tensor map into shared memory,
// completing on ``bar``.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's shared-memory accesses through the generic proxy
// before later ones through the async proxy (TMA writes, wgmma reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory descriptor of a 128-byte-swizzled MN-major operand: one
// 64-element swizzle atom wide along N (the leading offset is not used),
// its two 8-row K groups ``sbo`` bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t sbo) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;               // leading byte offset (unused)
  d |= (uint64_t)(sbo >> 4) << 32;      // stride byte offset
  d |= (uint64_t)1 << 62;               // 128-byte swizzle
  return d;
}

// D[64 x 64] += A[64 x 16] (registers) . B[16 x 64] (smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

// Ties registers to this point of the program: their values are made
// before a wgmma.fence that follows, and read after a wait that comes
// before (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) : : "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i]) : : "memory");
}

__host__ __device__ __forceinline__ int round16(int v) {
  return (v + 15) & ~15;
}

// Shared-memory plan of the bf16 path (ops/stem_conv.py _tc_smem):
// kStages stages of a g tile (2 x tj positions of 128 bytes, 1024-aligned for
// the swizzle) and a raw x window (nbox TMA boxes of (kh+1) rows x 256
// elements, xj + 1 pixels: a box starts on an even pixel, 16 bytes), two
// paired windows, kStages mbarriers, 1 KB to align.
struct TcSmem {
  int xj, nbox, g_stage, x_stage, p_buf, total;
  __host__ __device__ TcSmem(int tj, int kh, int kw) {
    xj = tj + kw - 1;
    nbox = ((xj + 1) * kC + kXBox - 1) / kXBox;
    g_stage = 2 * tj * kGRow;
    x_stage = nbox * (kh + 1) * kXBox * 2;
    p_buf = round16((kh + 1) * xj * kC * 4);
    total = 1024 + kStages * (g_stage + x_stage) + 2 * p_buf +
            8 * kStages;
  }
};

// NSTEPS 16-position steps a tile (tile columns tj = 8 * NSTEPS): a
// compile-time count, so every wgmma of a tile is issued on one path
// with no branch around it (a branch serializes them).
template <int NSTEPS>
__global__ void __launch_bounds__(kTcThreads, 1)
    stem_dw_partial_tc(const __grid_constant__ CUtensorMap gmap,
                       const __grid_constant__ CUtensorMap xmap, int Ho,
                       int Wo, int F, int kh, int kw, int ph0, int pw0,
                       int tiles, int tiles_per_block,
                       float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int tj = 8 * NSTEPS;
  const TcSmem plan(tj, kh, kw);
  const int XJ = plan.xj;
  const uint32_t raw_u32 = smem_u32(smem_raw);
  unsigned char* const sb =
      smem_raw + (((raw_u32 + 1023u) & ~1023u) - raw_u32);
  unsigned char* const g_st = sb;                        // g tiles
  unsigned char* const x_st = sb + kStages * plan.g_stage;    // raw windows
  unsigned char* const p_st = x_st + kStages * plan.x_stage;  // 2 paired
  uint64_t* const full = reinterpret_cast<uint64_t*>(p_st + 2 * plan.p_buf);

  const int n_jt = (Wo + tj - 1) / tj, n_ip = (Ho + 1) / 2;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int ntile = min(tiles_per_block, tiles - t_begin);
  const uint32_t tile_bytes = plan.g_stage + plan.x_stage;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool mma = tid < kMma;  // else the copy warpgroup
  const int rows = kh * kw * kC;
  const int mtile = blockIdx.y * 3 + (tid >> 7);
  const int r0 = mtile * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  // A warpgroup past the last row tile multiplies zeros (no branch
  // around its wgmmas) and writes nothing.
  const uint32_t m0 = r0 < rows ? ~0u : 0u, m1 = r1 < rows ? ~0u : 0u;
  // Word offset of row (h, w, c) in a paired window.
  auto row_off = [&](int r) {
    if (r >= rows) return 0;
    const int tap = r / kC;
    return ((tap / kw) * XJ + tap % kw) * kC + r % kC;
  };
  const int off0 = row_off(r0), off1 = row_off(r1);
  const int q = lane & 3;
  // A TMA box starts on a multiple of 16 bytes: an even pixel.  With an
  // odd left pad the raw window starts one pixel early.
  const int shift = pw0 & 1;

  // The copy warpgroup's first thread starts the TMA loads of local tile
  // lt into stage lt % kStages.
  auto produce = [&](int lt) {
    if (tid != kMma || lt >= ntile) return;
    const int t = t_begin + lt, st = lt % kStages;
    const int b = t / (n_ip * n_jt), rem = t % (n_ip * n_jt);
    const int i0 = (rem / n_jt) * 2, j0 = (rem % n_jt) * tj;
    fence_proxy_async();
    mbar_expect_tx(&full[st], tile_bytes);
    tma_load4(smem_u32(g_st + st * plan.g_stage), &gmap, 0, j0, i0, b,
              &full[st]);
    const uint32_t xdst = smem_u32(x_st + st * plan.x_stage);
    for (int k = 0; k < plan.nbox; ++k)
      tma_load3(xdst + k * (kh + 1) * kXBox * 2, &xmap,
                (j0 - pw0 - shift) * kC + k * kXBox, i0 - ph0, b,
                &full[st]);
  };

  // Re-lays tile lt's raw x window (row r, column v of the window) as
  // words (x[r][v][c], x[r][v+1][c]): one A register each.  A row of
  // the window is (XJ-1)*3 items of 4 channels, at most 3 for each of the
  // copy warpgroup's 128 threads; their offsets are the same every tile,
  // so they are worked out once, and each row takes one unrolled pass.
  constexpr int kCopy = kTcThreads - kMma;
  constexpr int kItems = 3;
  int lo_off[kItems], hi_off[kItems], p_off[kItems];
  bool item_ok[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = (tid - kMma) + k * kCopy;
    item_ok[k] = !mma && idx < (XJ - 1) * 3;
    const int v = item_ok[k] ? idx / 3 : 0, c4 = item_ok[k] ? idx % 3 : 0;
    const int e = (v + shift) * kC + 4 * c4, e2 = e + kC;
    lo_off[k] = ((e / kXBox) * (kh + 1) * kXBox + e % kXBox) * 2;
    hi_off[k] = ((e2 / kXBox) * (kh + 1) * kXBox + e2 % kXBox) * 2;
    p_off[k] = (v * kC + 4 * c4) * 4;
  }
  auto pair_cols = [&](int lt) {
    const unsigned char* raw = x_st + (lt % kStages) * plan.x_stage;
    unsigned char* dst = p_st + (lt & 1) * plan.p_buf;
    for (int r = 0; r <= kh; ++r) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (!item_ok[k]) continue;
        const uint2 lo = *reinterpret_cast<const uint2*>(
            raw + lo_off[k] + r * kXBox * 2);
        const uint2 hi = *reinterpret_cast<const uint2*>(
            raw + hi_off[k] + r * kXBox * 2);
        *reinterpret_cast<uint4*>(dst + p_off[k] + r * XJ * kC * 4) =
            make_uint4(__byte_perm(lo.x, hi.x, 0x5410),
                       __byte_perm(lo.x, hi.x, 0x7632),
                       __byte_perm(lo.y, hi.y, 0x5410),
                       __byte_perm(lo.y, hi.y, 0x7632));
      }
    }
  };

  if (tid == kMma) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  if (!mma) {
    for (int lt = 0; lt < kStages - 1; ++lt) produce(lt);
    mbar_wait(&full[0], 0);
    pair_cols(0);
  }
  __syncthreads();

  // Step s of a tile: K positions 0-7 are output row i0, columns 8s..8s+7
  // (g rows 8s..8s+7 of the tile), 8-15 the same columns of row i0+1
  // (g rows tj + 8s ...).  A register pairs: columns (2q, 2q+1) of row
  // i0 (registers 0, 1) and of row i0+1 (2, 3).  A warp cannot get on
  // with other work while its wgmmas read their A registers, so the copy
  // warpgroup, which runs none, starts the loads and re-lays the next
  // window meanwhile; one barrier a tile.
  for (int lt = 0; lt < ntile; ++lt) {
    if (mma) {
      const uint32_t* pw =
          reinterpret_cast<const uint32_t*>(p_st + (lt & 1) * plan.p_buf);
      uint32_t a[NSTEPS][4];
#pragma unroll
      for (int s = 0; s < NSTEPS; ++s) {
        const int c0 = (8 * s + 2 * q) * kC, c1 = c0 + XJ * kC;
        a[s][0] = pw[off0 + c0] & m0;
        a[s][1] = pw[off1 + c0] & m1;
        a[s][2] = pw[off0 + c1] & m0;
        a[s][3] = pw[off1 + c1] & m1;
        fence_regs(a[s]);
      }
      const uint32_t gb = smem_u32(g_st + (lt % kStages) * plan.g_stage);
      // done: the copy WG saw it
      mbar_wait(&full[lt % kStages], (lt / kStages) & 1);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < NSTEPS; ++s)
        wgmma_rs(acc, a[s], desc_sw128(gb + s * 1024, tj * kGRow));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
    } else {
      // into stage (lt - 1) % kStages, freed last tile
      produce(lt + kStages - 1);
      if (lt + 1 < ntile) {
        mbar_wait(&full[(lt + 1) % kStages], ((lt + 1) / kStages) & 1);
        pair_cols(lt + 1);
      }
    }
    __syncthreads();  // stage lt % kStages and paired buffer lt & 1 are free
  }

  if (!mma || mtile * 64 >= rows) return;
  float* out = partial + (long long)blockIdx.x * F * rows;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i & 2) ? r1 : r0;
    const int n = 2 * q + (i & 1) + 8 * (i >> 2);
    if (r < rows && n < F) out[(long long)n * rows + r] = acc[i];
  }
}

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// loaded already (no link against libcuda).
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

template <int NSTEPS>
int launch_tc(const CUtensorMap& gmap, const CUtensorMap& xmap, int Ho,
              int Wo, int F, int kh, int kw, int ph0, int pw0, int tiles,
              int tiles_per_block, int nblk, int mgroups, float* partial,
              cudaStream_t s) {
  const int smem = TcSmem(8 * NSTEPS, kh, kw).total;
  cudaError_t err = cudaFuncSetAttribute(
      stem_dw_partial_tc<NSTEPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  stem_dw_partial_tc<NSTEPS>
      <<<dim3(nblk, mgroups), kTcThreads, smem, s>>>(
          gmap, xmap, Ho, Wo, F, kh, kw, ph0, pw0, tiles, tiles_per_block,
          partial);
  return (int)cudaGetLastError();
}

int launch_tc_steps(int nsteps, const CUtensorMap& gmap,
                    const CUtensorMap& xmap, int Ho, int Wo, int F, int kh,
                    int kw, int ph0, int pw0, int tiles,
                    int tiles_per_block, int nblk, int mgroups,
                    float* partial, cudaStream_t s) {
#define STEM_DW_STEPS(N)                                                 \
  case N:                                                                \
    return launch_tc<N>(gmap, xmap, Ho, Wo, F, kh, kw, ph0, pw0,      \
                           tiles, tiles_per_block, nblk, mgroups,        \
                           partial, s);
  switch (nsteps) {
    STEM_DW_STEPS(1)
    STEM_DW_STEPS(2)
    STEM_DW_STEPS(4)
    STEM_DW_STEPS(7)
    STEM_DW_STEPS(12)
    STEM_DW_STEPS(14)
  }
#undef STEM_DW_STEPS
  return (int)cudaErrorInvalidValue;
}

int fold(const float* partial, int nblk, int K, float* dw, cudaStream_t s) {
  stem_dw_fold<<<(K + 255) / 256, 256, 0, s>>>(partial, nblk, K, dw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dW [F, kh, kw, 12] f32 of the stride-1 conv of f32 x [B, H, W, 12]
// with leading pads (ph0, pw0), given its output cotangent g [B, Ho, Wo,
// F]; ``partial`` is [nblk, F*kh*kw*12] f32 scratch, nblk = ceil(tiles /
// tiles_per_block) with tiles = B * ceil(Ho/4) * ceil(Wo/28).
int stem_dw_f32(const float* x, const float* g, int B, int H, int W, int Ho,
                int Wo, int F, int kh, int kw, int ph0, int pw0,
                int tiles_per_block, int nblk, float* partial, float* dw,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int items = kh * kw * (F / 4);
  const dim3 grid(nblk, (items + kThreads - 1) / kThreads);
  const size_t smem =
      sizeof(float) * (kTI * kTJ * F + (kTI + kh - 1) * (kTJ + kw - 1) * kC);
  stem_dw_partial_f32<<<grid, kThreads, smem, s>>>(
      x, g, B, H, W, Ho, Wo, F, kh, kw, ph0, pw0, tiles_per_block, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return fold(partial, nblk, F * kh * kw * kC, dw, s);
}

// The same for bf16 x and g, on the tensor cores: tiles of 2 output rows
// x tj columns (tj = 8 * steps, steps one of 1, 2, 4, 7, 12, 14), tiles
// = B * ceil(Ho/2) * ceil(Wo/tj), ``mgroups`` blocks
// along grid.y (three 64-row tiles of the kh*kw*12 rows each).  x is
// [B, H, Wx, 12] with Wx even and W <= Wx (columns past W zero), g is
// [B, Ho, Wo, 64] with F <= 64 (filters past F zero), both 16-byte
// aligned: what the TMA tensor maps take.
int stem_dw_bf16(const void* x, const void* g, int B, int H, int Wx, int Ho,
                 int Wo, int Fg, int F, int kh, int kw, int ph0, int pw0,
                 int tj, int tiles, int tiles_per_block, int nblk,
                 int mgroups, float* partial, float* dw,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr || tj % 8 || Fg != 64 || Wx % 2 || kh + 1 > 256)
    return (int)cudaErrorInvalidValue;
  // The encoder needs a current context on this thread (a backward
  // pass runs on autograd's own thread): bind the device's.
  int device = 0;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess) cerr = cudaSetDevice(device);
  if (cerr != cudaSuccess) return (int)cerr;
  CUtensorMap gmap, xmap;
  const cuuint64_t gdims[4] = {(cuuint64_t)Fg, (cuuint64_t)Wo,
                               (cuuint64_t)Ho, (cuuint64_t)B};
  const cuuint64_t gstrides[3] = {(cuuint64_t)Fg * 2,
                                  (cuuint64_t)Wo * Fg * 2,
                                  (cuuint64_t)Ho * Wo * Fg * 2};
  const cuuint32_t gbox[4] = {64, (cuuint32_t)tj, 2, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = encode(&gmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(g), gdims, gstrides, gbox, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const cuuint64_t xdims[3] = {(cuuint64_t)Wx * kC, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint64_t xstrides[2] = {(cuuint64_t)Wx * kC * 2,
                                  (cuuint64_t)H * Wx * kC * 2};
  const cuuint32_t xbox[3] = {kXBox, (cuuint32_t)(kh + 1), 1};
  r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(x), xdims, xstrides, xbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const int err =
      launch_tc_steps(tj / 8, gmap, xmap, Ho, Wo, F, kh, kw, ph0, pw0,
                      tiles, tiles_per_block, nblk, mgroups, partial, s);
  if (err != 0) return err;
  return fold(partial, nblk, F * kh * kw * kC, dw, s);
}

}  // extern "C"
