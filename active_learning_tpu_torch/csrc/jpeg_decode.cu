// JPEG decode on the card with nvJPEG, and the crop + bilinear resize
// kernel that samples every decoded image into one uint8 [N, S, S, 3]
// batch with the arithmetic of csrc/decode.cpp (the copy of the JAX
// package's native/decode.cpp).
//
// Replaces no TPU kernel.  The JAX package decodes on the host with
// libjpeg (native/decode.cpp: al_jpeg_dims, al_decode_crop_resize); the
// card's machine has no libjpeg, but its CUDA toolkit has nvJPEG.  So on
// the card nvJPEG (a library: decode is not a TPU kernel) decodes each
// file into one device buffer, and crop_resize_kernel below, written by
// hand, does what decode.cpp's crop_resize_bilinear does on the host:
//
//   taps:  scale = float(extent) / out;  f = (o + 0.5f) * scale - 0.5f
//          + offset (each operation rounded on its own, no fused
//          multiply-add, as g++ compiles decode.cpp);  i0 = floor(f);
//          frac = f - i0;  w1 = (int)(frac * 256 + 0.5f);  i0 and i0 + 1
//          clamped to the WHOLE image (not the crop box);
//   pass:  h = (a * (256 - w1x) + b * w1x) >> 8 along a source row, then
//          (h0 * (256 - w1y) + h1 * w1y + 128) >> 8 between two rows.
//
// Given the same decoded RGB the kernel's rows equal decode.cpp's bit for
// bit (ops/crop_resize.py holds its plain version to the JAX package's
// native rows on the CPU).  nvJPEG's inverse DCT and chroma upsampling are
// not libjpeg's, so the decoded pixels, and the rows, differ from the CPU
// route's by a bounded amount (PERF.md, the fixture tests).
//
// A grayscale JPEG (1 component) decodes to Y and is replicated into R, G
// and B, as libjpeg's JCS_RGB output replicates it.  Files libjpeg cannot
// emit as RGB either (4 components: CMYK, YCCK), files nvJPEG refuses as
// malformed or unsupported, and files that cannot be read are marked
// failed: the caller decodes just those through PIL, as the JAX package
// does for libjpeg's failures.  Any other nvJPEG or CUDA error is returned
// and the wrapper raises: nothing turns a whole dataset over to PIL.
//
// Bound of the kernel: bytes.  Per image it reads the source pixels its
// taps touch (at most 2S rows x 2S columns x 3) and writes S x S x 3 bytes;
// at S = 224 that is at most 0.75 MB a row in, 150 KB out.  Design: one
// block an output row of one image (grid S x N), so that the row's two
// source rows are shared by the block's threads through L1, and each
// thread computes whole output pixels (three channels) with integer
// arithmetic only.  The decode itself (nvJPEG's hybrid backend: Huffman on
// the host, the inverse DCT on the card) dominates the time of a batch.
//
// C interface for ctypes; the wrappers are active_learning_tpu_torch/
// data/native.py (decode) and ops/crop_resize.py (the kernel).

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Tap {
  int i0, i1;
  int w1;  // weight of i1 in [0, 256]; i0 gets 256 - w1
};

__device__ __forceinline__ Tap make_tap(int o, int offset, int extent,
                                        int out, int clamp_max) {
  const float scale = __fdiv_rn(static_cast<float>(extent),
                                static_cast<float>(out));
  const float f = __fadd_rn(
      __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f), scale),
                -0.5f),
      static_cast<float>(offset));
  const int i0 = static_cast<int>(floorf(f));
  const float frac = __fsub_rn(f, static_cast<float>(i0));
  Tap t;
  t.i1 = min(max(i0 + 1, 0), clamp_max);
  t.i0 = min(max(i0, 0), clamp_max);
  t.w1 = __float2int_rz(__fadd_rn(__fmul_rn(frac, 256.0f), 0.5f));
  return t;
}

// meta[8 * i]: byte offset of image i in src, h, w, channels (3, 1, or
// anything else for a failed image, whose row is written as zeros), top,
// left, crop height, crop width.
__global__ void crop_resize_kernel(const uint8_t* __restrict__ src,
                                   const int64_t* __restrict__ meta, int out,
                                   uint8_t* __restrict__ dst) {
  const int img = blockIdx.y;
  const int oy = blockIdx.x;
  const int64_t* m = meta + 8 * static_cast<int64_t>(img);
  const int64_t off = m[0];
  const int h = static_cast<int>(m[1]);
  const int w = static_cast<int>(m[2]);
  const int c = static_cast<int>(m[3]);
  uint8_t* o = dst + (static_cast<int64_t>(img) * out + oy) * out * 3;
  if (c != 1 && c != 3) {
    for (int i = threadIdx.x; i < out * 3; i += blockDim.x) o[i] = 0;
    return;
  }
  const Tap ty = make_tap(oy, static_cast<int>(m[4]),
                          static_cast<int>(m[6]), out, h - 1);
  const uint8_t* r0 = src + off + static_cast<int64_t>(ty.i0) * w * c;
  const uint8_t* r1 = src + off + static_cast<int64_t>(ty.i1) * w * c;
  const int wy1 = ty.w1, wy0 = 256 - ty.w1;
  for (int ox = threadIdx.x; ox < out; ox += blockDim.x) {
    const Tap tx = make_tap(ox, static_cast<int>(m[5]),
                            static_cast<int>(m[7]), out, w - 1);
    const int wx1 = tx.w1, wx0 = 256 - tx.w1;
    const int a = tx.i0 * c, b = tx.i1 * c;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int ch = (c == 3) ? k : 0;
      const int h0 = (r0[a + ch] * wx0 + r0[b + ch] * wx1) >> 8;
      const int h1 = (r1[a + ch] * wx0 + r1[b + ch] * wx1) >> 8;
      o[ox * 3 + k] = static_cast<uint8_t>((h0 * wy0 + h1 * wy1 + 128) >> 8);
    }
  }
}

// One nvJPEG handle a device, and a pool of decode states.  A state serves
// one decode at a time: nvjpegDecode can return while the decode's copies
// and inverse DCT are still queued on the stream, and they use the state's
// pinned and device buffers, so the state is used again (by any thread,
// the same one included) only after the stream has run them.
struct DevicePool {
  std::mutex mu;
  nvjpegHandle_t handle = nullptr;
  std::vector<nvjpegJpegState_t> free_states;
};

std::mutex g_pools_mu;
std::map<int, DevicePool*> g_pools;

// Returns 0, or an error code: 1000 + nvjpegStatus_t.
int get_pool(int device, DevicePool** out) {
  std::lock_guard<std::mutex> lock(g_pools_mu);
  DevicePool*& p = g_pools[device];
  if (p == nullptr) {
    nvjpegHandle_t handle;
    const nvjpegStatus_t st = nvjpegCreateSimple(&handle);
    if (st != NVJPEG_STATUS_SUCCESS) return 1000 + static_cast<int>(st);
    p = new DevicePool();
    p->handle = handle;
  }
  *out = p;
  return 0;
}

int acquire_state(DevicePool* p, nvjpegJpegState_t* out) {
  {
    std::lock_guard<std::mutex> lock(p->mu);
    if (!p->free_states.empty()) {
      *out = p->free_states.back();
      p->free_states.pop_back();
      return 0;
    }
  }
  const nvjpegStatus_t st = nvjpegJpegStateCreate(p->handle, out);
  return st == NVJPEG_STATUS_SUCCESS ? 0 : 1000 + static_cast<int>(st);
}

void release_state(DevicePool* p, nvjpegJpegState_t s) {
  std::lock_guard<std::mutex> lock(p->mu);
  p->free_states.push_back(s);
}

bool read_file(const char* path, std::vector<unsigned char>& buf) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return false;
  bool ok = std::fseek(fh, 0, SEEK_END) == 0;
  const long size = ok ? std::ftell(fh) : -1;
  ok = ok && size > 0 && std::fseek(fh, 0, SEEK_SET) == 0;
  if (ok) {
    buf.resize(static_cast<size_t>(size));
    ok = std::fread(buf.data(), 1, buf.size(), fh) == buf.size();
  }
  std::fclose(fh);
  return ok;
}

// A file nvJPEG refuses for what it holds: the caller's per-file fallback.
// (10 is NVJPEG_STATUS_INCOMPLETE_BITSTREAM, a truncated file.)
bool per_file_failure(nvjpegStatus_t st) {
  return st == NVJPEG_STATUS_BAD_JPEG ||
         st == NVJPEG_STATUS_JPEG_NOT_SUPPORTED ||
         static_cast<int>(st) == 10;
}

// Runs fn(i) for i in [0, n) on n_threads host threads (each with the
// device current); the first nonzero return of any call is returned.
template <typename Fn>
int parallel_for(int device, int n, int n_threads, Fn fn) {
  n_threads = std::max(1, std::min(n_threads, n));
  std::atomic<int> next(0);
  std::atomic<int> error(0);
  auto work = [&] {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) {
      int zero = 0;
      error.compare_exchange_strong(zero, static_cast<int>(set));
      return;
    }
    int i;
    while (error.load() == 0 && (i = next.fetch_add(1)) < n) {
      const int err = fn(i);
      if (err != 0) {
        int zero = 0;
        error.compare_exchange_strong(zero, err);
      }
    }
  };
  if (n_threads == 1) {
    work();
  } else {
    std::vector<std::thread> workers;
    workers.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) workers.emplace_back(work);
    for (auto& th : workers) th.join();
  }
  return error.load();
}

}  // namespace

extern "C" {

// Header of each file: out_hwc[3*i .. 3*i+2] = height, width, components;
// all three -1 for a file that cannot be read or parsed.  Returns 0, or
// an error code (a CUDA error, or 1000 + an nvJPEG status).
int al_nvjpeg_dims(int device, const char** paths, int n, int32_t* out_hwc,
                   int n_threads) {
  if (n <= 0) return 0;
  DevicePool* pool = nullptr;
  int err = static_cast<int>(cudaSetDevice(device));
  if (err == 0) err = get_pool(device, &pool);
  if (err != 0) return err;
  return parallel_for(device, n, n_threads, [&](int i) {
    int32_t* o = out_hwc + 3 * i;
    o[0] = o[1] = o[2] = -1;
    std::vector<unsigned char> buf;
    if (!read_file(paths[i], buf)) return 0;
    int comps = 0;
    nvjpegChromaSubsampling_t css;
    int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
    const nvjpegStatus_t st = nvjpegGetImageInfo(
        pool->handle, buf.data(), buf.size(), &comps, &css, widths, heights);
    if (st != NVJPEG_STATUS_SUCCESS) {
      return per_file_failure(st) ? 0 : 1000 + static_cast<int>(st);
    }
    o[0] = heights[0];
    o[1] = widths[0];
    o[2] = comps;
    return 0;
  });
}

// Decode file i into dst + offsets[i] (device memory the caller
// allocated: h * w * 3 bytes an image), interleaved RGB (channels[i] = 3)
// or, for a grayscale file, Y (channels[i] = 1), on `stream`.  A file
// the fallback must take gets failed[i] = 1 and channels[i] = 0.  The
// stream is synchronized before returning, so the host buffers of the
// files may go.  Returns 0, or an error code (a CUDA error, or 1000 + an
// nvJPEG status).
int al_nvjpeg_decode(int device, const char** paths, int n,
                     const int64_t* offsets, void* dst, void* stream,
                     int32_t* channels, uint8_t* failed, int n_threads) {
  if (n <= 0) return 0;
  DevicePool* pool = nullptr;
  int err = static_cast<int>(cudaSetDevice(device));
  if (err == 0) err = get_pool(device, &pool);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  std::vector<std::vector<unsigned char>> files(n);
  err = parallel_for(device, n, n_threads, [&](int i) {
    channels[i] = 0;
    failed[i] = 1;
    if (!read_file(paths[i], files[i])) return 0;
    int comps = 0;
    nvjpegChromaSubsampling_t css;
    int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
    nvjpegStatus_t st = nvjpegGetImageInfo(pool->handle, files[i].data(),
                                           files[i].size(), &comps, &css,
                                           widths, heights);
    if (st != NVJPEG_STATUS_SUCCESS) {
      return per_file_failure(st) ? 0 : 1000 + static_cast<int>(st);
    }
    if (comps != 1 && comps != 3) return 0;
    nvjpegImage_t image;
    for (int k = 0; k < NVJPEG_MAX_COMPONENT; ++k) {
      image.channel[k] = nullptr;
      image.pitch[k] = 0;
    }
    image.channel[0] = static_cast<unsigned char*>(dst) + offsets[i];
    image.pitch[0] = static_cast<size_t>(widths[0]) * comps;
    nvjpegJpegState_t state;
    const int got = acquire_state(pool, &state);
    if (got != 0) return got;
    st = nvjpegDecode(pool->handle, state, files[i].data(), files[i].size(),
                      comps == 3 ? NVJPEG_OUTPUT_RGBI : NVJPEG_OUTPUT_Y,
                      &image, s);
    // The state goes back to the pool only once its queued work has run
    // (see DevicePool).  Reused earlier, even by this thread on this
    // stream, it corrupted decoded rows when the card was busy.
    const cudaError_t done = cudaStreamSynchronize(s);
    release_state(pool, state);
    if (done != cudaSuccess) return static_cast<int>(done);
    if (st != NVJPEG_STATUS_SUCCESS) {
      return per_file_failure(st) ? 0 : 1000 + static_cast<int>(st);
    }
    channels[i] = comps;
    failed[i] = 0;
    return 0;
  });
  const int sync = static_cast<int>(cudaStreamSynchronize(s));
  return err != 0 ? err : sync;
}

// The crop + bilinear resize of n decoded images (meta: device int64
// [n, 8], see crop_resize_kernel) into dst (device uint8 [n, out, out,
// 3]), on `stream`.  Returns cudaGetLastError() after the launch.
int al_crop_resize(const void* src, const void* meta, int n, int out,
                   void* dst, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid(out, n);
  crop_resize_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int64_t*>(meta),
      out, static_cast<uint8_t*>(dst));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
