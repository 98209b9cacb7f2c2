// Host normalisation of the loaders' focal stacks: uint8 (or float32) ->
// float32 ``x / 127.5 - 1``, padded bottom and right to the x32 shape, in one
// multithreaded pass; and the (H, W, C, N) -> (N, H, W, C) layout change of
// the DefocusNet stacks.  A copy of the JAX package's host library
// (csrc/dffxio.cc), split into three translation units: this one needs only
// the C++ standard library and threads; codec.cc (JPEG, PNG) and tiff.cc
// (TIFF) need the codecs' headers.  dffx_torch/data/_host_build.py builds the
// units it can into one shared library; dffx_torch/data/native.py binds it
// with ctypes, which releases the GIL for each call.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// x / 127.5 - 1 over n elements.
void dffxio_normalize_u8(const uint8_t* src, float* dst, int64_t n) {
  static float lut[256];
  static std::atomic<bool> lut_ready{false};
  if (!lut_ready.load(std::memory_order_acquire)) {
    for (int i = 0; i < 256; ++i) lut[i] = static_cast<float>(i) / 127.5f - 1.0f;
    lut_ready.store(true, std::memory_order_release);
  }
  for (int64_t i = 0; i < n; ++i) dst[i] = lut[src[i]];
}

// Focal-stack loader hot path, fused:
//   src: (N, H, W, C) uint8 slices
//   dst: (N, Hp, Wp, C) float32, normalized x/127.5-1, padded bottom/right
//        with `pad_value` (Hp/Wp are the x32-padded sizes).
// Parallelized over slices (the decoders upstream release the GIL too).
void dffxio_normalize_pad_stack(const uint8_t* src, float* dst, int64_t n,
                                int64_t h, int64_t w, int64_t c, int64_t hp,
                                int64_t wp, float pad_value, int threads) {
  float lut[256];
  for (int i = 0; i < 256; ++i) lut[i] = static_cast<float>(i) / 127.5f - 1.0f;

  auto do_slice = [&](int64_t s) {
    const uint8_t* sp = src + s * h * w * c;
    float* dp = dst + s * hp * wp * c;
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* row = sp + y * w * c;
      float* out = dp + y * wp * c;
      for (int64_t i = 0; i < w * c; ++i) out[i] = lut[row[i]];
      std::fill(out + w * c, out + wp * c, pad_value);
    }
    for (int64_t y = h; y < hp; ++y)
      std::fill(dp + y * wp * c, dp + (y + 1) * wp * c, pad_value);
  };

  if (threads <= 1 || n == 1) {
    for (int64_t s = 0; s < n; ++s) do_slice(s);
    return;
  }
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  int nthreads = std::min<int64_t>(threads, n);
  for (int t = 0; t < nthreads; ++t) {
    pool.emplace_back([&]() {
      for (int64_t s = next.fetch_add(1); s < n; s = next.fetch_add(1))
        do_slice(s);
    });
  }
  for (auto& th : pool) th.join();
}

// float32 variant (e.g. EXR-decoded slices that are already float).
void dffxio_normalize_pad_stack_f32(const float* src, float* dst, int64_t n,
                                    int64_t h, int64_t w, int64_t c, int64_t hp,
                                    int64_t wp, float pad_value, int threads) {
  auto do_slice = [&](int64_t s) {
    const float* sp = src + s * h * w * c;
    float* dp = dst + s * hp * wp * c;
    for (int64_t y = 0; y < h; ++y) {
      const float* row = sp + y * w * c;
      float* out = dp + y * wp * c;
      for (int64_t i = 0; i < w * c; ++i) out[i] = row[i] / 127.5f - 1.0f;
      std::fill(out + w * c, out + wp * c, pad_value);
    }
    for (int64_t y = h; y < hp; ++y)
      std::fill(dp + y * wp * c, dp + (y + 1) * wp * c, pad_value);
  };
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  int nthreads = std::max<int64_t>(1, std::min<int64_t>(threads, n));
  for (int t = 0; t < nthreads; ++t)
    pool.emplace_back([&]() {
      for (int64_t s = next.fetch_add(1); s < n; s = next.fetch_add(1))
        do_slice(s);
    });
  for (auto& th : pool) th.join();
}

// (H, W, C, N) float64/uint8 cv2-style stacks -> (N, H, W, C) float32 with
// normalize, the DefocusNet/Middlebury layout conversion in one pass.
void dffxio_hwcn_to_nhwc_normalize(const double* src, float* dst, int64_t h,
                                   int64_t w, int64_t c, int64_t n,
                                   int threads) {
  auto do_slice = [&](int64_t s) {
    float* dp = dst + s * h * w * c;
    for (int64_t y = 0; y < h; ++y)
      for (int64_t x = 0; x < w; ++x)
        for (int64_t ch = 0; ch < c; ++ch)
          dp[(y * w + x) * c + ch] = static_cast<float>(
              src[((y * w + x) * c + ch) * n + s] / 127.5 - 1.0);
  };
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  int nthreads = std::max<int64_t>(1, std::min<int64_t>(threads, n));
  for (int t = 0; t < nthreads; ++t)
    pool.emplace_back([&]() {
      for (int64_t s = next.fetch_add(1); s < n; s = next.fetch_add(1))
        do_slice(s);
    });
  for (auto& th : pool) th.join();
}

// The library's interface version: that of the JAX package's library, whose
// entry points and guards these units keep.
int dffxio_version() { return 4; }

}  // extern "C"
