// Native batch JPEG decode + crop + bilinear resize for the data loader.
//
// The reference delegates all native dataloading to torch's C++ DataLoader
// workers + PIL (src/query_strategies/strategy.py:325-328); this is the
// TPU-side equivalent: the 1.28M-image acquisition-scoring passes
// (SURVEY.md hard part (e)) are bottlenecked by host JPEG decode, so the
// decode -> crop -> resize pipeline runs here in C++ with a std::thread
// pool, writing straight into a caller-owned uint8 [N, S, S, 3] buffer
// (zero Python-object overhead per image).
//
// Split of responsibilities: Python computes crop rectangles (the seeded
// RandomResizedCrop / Resize+CenterCrop parameter logic stays in
// data/imagenet.py where it is reproducible per (seed, epoch, index));
// C++ does header parsing, Huffman decode, and the bandwidth-heavy pixel
// work.  C ABI only — loaded via ctypes, no pybind11 dependency.
//
// Build: see native/Makefile (links against the system libjpeg).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>  // requires <cstdio>/<cstddef> first

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file into an RGB buffer.  Returns true on success and
// fills (h, w); the buffer is resized to h*w*3.
bool decode_rgb(const char* path, std::vector<uint8_t>& rgb, int* h,
                int* w) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fh);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fh);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  rgb.resize(static_cast<size_t>(*h) * *w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) *
                                    *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fh);
  return true;
}

// Bilinear tap: source index pair + 8.8 fixed-point weight for one output
// coordinate (align-corners=false pixel-center convention, matching
// PIL/torchvision resize geometry).
struct Tap {
  int i0, i1;
  int w1;  // weight of i1 in [0, 256]; i0 gets 256 - w1
};

void make_taps(int in_size, int offset, int in_extent, int out,
               int clamp_max, std::vector<Tap>& taps) {
  taps.resize(out);
  const float scale = static_cast<float>(in_extent) / out;
  for (int o = 0; o < out; ++o) {
    float f = (o + 0.5f) * scale - 0.5f + offset;
    int i0 = static_cast<int>(std::floor(f));
    float frac = f - i0;
    Tap& t = taps[o];
    t.i1 = std::min(std::max(i0 + 1, 0), clamp_max);
    t.i0 = std::min(std::max(i0, 0), clamp_max);
    t.w1 = static_cast<int>(frac * 256.0f + 0.5f);
  }
  (void)in_size;
}

// Crop box [top, left, ch, cw] of src (h x w x 3) -> dst (out x out x 3),
// separable two-pass bilinear with precomputed fixed-point taps: the
// horizontal pass shrinks each needed source row once, the vertical pass
// blends two resampled rows — O(rows_used * out) weight computations
// instead of recomputing 4-tap weights per output pixel.
void crop_resize_bilinear(const uint8_t* src, int h, int w, int top,
                          int left, int ch, int cw, uint8_t* dst, int out) {
  std::vector<Tap> xt, yt;
  make_taps(w, left, cw, out, w - 1, xt);
  make_taps(h, top, ch, out, h - 1, yt);

  // Horizontal pass cache, sized to the row range the vertical taps can
  // touch (the crop box +- 1, not the whole image).
  int row_lo = h - 1, row_hi = 0;
  for (const Tap& t : yt) {
    row_lo = std::min(row_lo, t.i0);
    row_hi = std::max(row_hi, t.i1);
  }
  const int n_rows = row_hi - row_lo + 1;
  std::vector<int16_t> rows(static_cast<size_t>(n_rows) * out * 3);
  std::vector<uint8_t> row_done(n_rows, 0);
  auto hrow = [&](int y_abs) -> const int16_t* {
    const int y = y_abs - row_lo;
    int16_t* r = rows.data() + static_cast<size_t>(y) * out * 3;
    if (!row_done[y]) {
      const uint8_t* s = src + static_cast<size_t>(y_abs) * w * 3;
      for (int o = 0; o < out; ++o) {
        const Tap& t = xt[o];
        const uint8_t* a = s + t.i0 * 3;
        const uint8_t* b = s + t.i1 * 3;
        const int w1 = t.w1, w0 = 256 - t.w1;
        r[o * 3 + 0] = static_cast<int16_t>((a[0] * w0 + b[0] * w1) >> 8);
        r[o * 3 + 1] = static_cast<int16_t>((a[1] * w0 + b[1] * w1) >> 8);
        r[o * 3 + 2] = static_cast<int16_t>((a[2] * w0 + b[2] * w1) >> 8);
      }
      row_done[y] = 1;
    }
    return r;
  };

  for (int oy = 0; oy < out; ++oy) {
    const Tap& t = yt[oy];
    const int16_t* r0 = hrow(t.i0);
    const int16_t* r1 = hrow(t.i1);
    const int w1 = t.w1, w0 = 256 - t.w1;
    uint8_t* o = dst + static_cast<size_t>(oy) * out * 3;
    for (int i = 0; i < out * 3; ++i) {
      o[i] = static_cast<uint8_t>((r0[i] * w0 + r1[i] * w1 + 128) >> 8);
    }
  }
}

template <typename Fn>
void parallel_for(int n, int n_threads, Fn fn) {
  n_threads = std::max(1, std::min(n_threads, n));
  if (n_threads == 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([&] {
      int i;
      while ((i = next.fetch_add(1)) < n) fn(i);
    });
  }
  for (auto& th : workers) th.join();
}

}  // namespace

extern "C" {

// Parse JPEG headers only: out_hw[2*i] = height, out_hw[2*i+1] = width.
// Returns the number of files that FAILED (0 == all ok); failures get -1.
int al_jpeg_dims(const char** paths, int n, int32_t* out_hw,
                 int n_threads) {
  std::atomic<int> failures(0);
  parallel_for(n, n_threads, [&](int i) {
    FILE* fh = std::fopen(paths[i], "rb");
    if (!fh) {
      out_hw[2 * i] = out_hw[2 * i + 1] = -1;
      failures.fetch_add(1);
      return;
    }
    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
      jpeg_destroy_decompress(&cinfo);
      std::fclose(fh);
      out_hw[2 * i] = out_hw[2 * i + 1] = -1;
      failures.fetch_add(1);
      return;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, fh);
    jpeg_read_header(&cinfo, TRUE);
    out_hw[2 * i] = static_cast<int32_t>(cinfo.image_height);
    out_hw[2 * i + 1] = static_cast<int32_t>(cinfo.image_width);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fh);
  });
  return failures.load();
}

// Decode each JPEG, crop rects[i] = {top, left, ch, cw}, bilinear-resize to
// out_size, write into out[i] (uint8, n * out_size * out_size * 3).
// Per-file failures (e.g. CMYK JPEGs libjpeg can't emit as RGB) set
// failed[i] = 1 and zero the slot so the caller can re-decode just those
// files through its fallback path.  Returns the failure count.
int al_decode_crop_resize(const char** paths, int n, const int32_t* rects,
                          int out_size, uint8_t* out, uint8_t* failed,
                          int n_threads) {
  std::atomic<int> failures(0);
  const size_t stride =
      static_cast<size_t>(out_size) * out_size * 3;
  parallel_for(n, n_threads, [&](int i) {
    std::vector<uint8_t> rgb;
    int h = 0, w = 0;
    if (!decode_rgb(paths[i], rgb, &h, &w)) {
      std::memset(out + i * stride, 0, stride);
      failed[i] = 1;
      failures.fetch_add(1);
      return;
    }
    failed[i] = 0;
    const int32_t* r = rects + 4 * i;
    crop_resize_bilinear(rgb.data(), h, w, r[0], r[1], r[2], r[3],
                         out + i * stride, out_size);
  });
  return failures.load();
}

}  // extern "C"
