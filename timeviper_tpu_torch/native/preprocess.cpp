// Native frame preprocessing: batched antialiased bicubic resize + normalize.
//
// The reference's input pipeline leans on native code end-to-end (decord's
// C++ demux/decode + torchvision transforms, SURVEY.md §2.2 N8). This
// library is the TPU build's equivalent for the CPU-side hot loop AFTER
// decode: (N, H, W, 3) uint8 frames -> (N, S, S, 3) float32 normalized.
//
// The resampler follows PIL's convolution resample: cubic kernel (a=-0.5),
// support scaled by the downscale ratio (antialiasing), per-axis
// precomputed coefficient tables, separable two-pass — so outputs match
// PIL.Image.resize(..., BICUBIC) to u8 rounding.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libpreprocess.so preprocess.cpp -lpthread

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline float cubic_filter(float x) {
  const float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

struct Coeffs {
  // for each output index: first source index + weight span
  std::vector<int> xmin;
  std::vector<int> xsize;
  std::vector<float> weights;  // row-major, ksize per output index
  int ksize = 0;
};

// PIL-style coefficient precomputation (antialiased when downscaling).
Coeffs make_coeffs(int src, int dst) {
  Coeffs c;
  const float scale = static_cast<float>(src) / dst;
  const float filterscale = std::max(scale, 1.0f);
  const float support = 2.0f * filterscale;  // cubic support = 2
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.ksize = ksize;
  c.xmin.resize(dst);
  c.xsize.resize(dst);
  c.weights.assign(static_cast<size_t>(dst) * ksize, 0.0f);
  const float inv_fs = 1.0f / filterscale;
  for (int xx = 0; xx < dst; ++xx) {
    const float center = (xx + 0.5f) * scale;
    int x0 = static_cast<int>(center - support + 0.5f);
    if (x0 < 0) x0 = 0;
    int x1 = static_cast<int>(center + support + 0.5f);
    if (x1 > src) x1 = src;
    float* w = c.weights.data() + static_cast<size_t>(xx) * ksize;
    float wsum = 0.0f;
    for (int x = x0; x < x1; ++x) {
      const float ww = cubic_filter((x - center + 0.5f) * inv_fs);
      w[x - x0] = ww;
      wsum += ww;
    }
    if (wsum != 0.0f) {
      const float inv = 1.0f / wsum;
      for (int x = 0; x < x1 - x0; ++x) w[x] *= inv;
    }
    c.xmin[xx] = x0;
    c.xsize[xx] = x1 - x0;
  }
  return c;
}

// (sh, sw, 3) u8 -> (dh, dw, 3) f32, using precomputed per-axis coeffs.
void resize_one(const uint8_t* src, int sh, int sw, float* dst, int dh,
                int dw, const Coeffs& ch, const Coeffs& cv,
                std::vector<float>& tmp) {
  // horizontal pass: (sh, dw, 3)
  tmp.resize(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    float* orow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const float* w = ch.weights.data() + static_cast<size_t>(x) * ch.ksize;
      const int x0 = ch.xmin[x];
      const int n = ch.xsize[x];
      float a0 = 0, a1 = 0, a2 = 0;
      for (int k = 0; k < n; ++k) {
        const uint8_t* p = row + (x0 + k) * 3;
        const float ww = w[k];
        a0 += ww * p[0];
        a1 += ww * p[1];
        a2 += ww * p[2];
      }
      orow[x * 3 + 0] = a0;
      orow[x * 3 + 1] = a1;
      orow[x * 3 + 2] = a2;
    }
  }
  // vertical pass: (dh, dw, 3)
  for (int y = 0; y < dh; ++y) {
    const float* w = cv.weights.data() + static_cast<size_t>(y) * cv.ksize;
    const int y0 = cv.xmin[y];
    const int n = cv.xsize[y];
    float* orow = dst + static_cast<size_t>(y) * dw * 3;
    std::memset(orow, 0, sizeof(float) * dw * 3);
    for (int k = 0; k < n; ++k) {
      const float ww = w[k];
      const float* irow = tmp.data() + static_cast<size_t>(y0 + k) * dw * 3;
      for (int x = 0; x < dw * 3; ++x) orow[x] += ww * irow[x];
    }
  }
}

}  // namespace

extern "C" {

// frames: (n, sh, sw, 3) uint8 -> out: (n, S, S, 3) float32 normalized:
// out[c] = (clamp(resized[c], 0, 255)/255 - mean[c]) / std[c]
void preprocess_frames(const uint8_t* frames, int n, int sh, int sw,
                       float* out, int S, const float* mean,
                       const float* stdv, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min(n_threads, n > 0 ? n : 1);
  const Coeffs ch = make_coeffs(sw, S);
  const Coeffs cv = make_coeffs(sh, S);
  const float inv255 = 1.0f / 255.0f;
  const float inv_std[3] = {1.0f / stdv[0], 1.0f / stdv[1], 1.0f / stdv[2]};

  auto work = [&](int t) {
    std::vector<float> tmp;
    std::vector<float> resized(static_cast<size_t>(S) * S * 3);
    for (int i = t; i < n; i += n_threads) {
      const uint8_t* src = frames + static_cast<size_t>(i) * sh * sw * 3;
      float* dst = out + static_cast<size_t>(i) * S * S * 3;
      resize_one(src, sh, sw, resized.data(), S, S, ch, cv, tmp);
      for (size_t px = 0; px < static_cast<size_t>(S) * S; ++px) {
        for (int c = 0; c < 3; ++c) {
          // PIL rounds to u8 after resampling; mirror the clamp+round so
          // outputs byte-match the PIL fallback path
          float v = resized[px * 3 + c];
          v = std::clamp(std::round(v), 0.0f, 255.0f);
          dst[px * 3 + c] = (v * inv255 - mean[c]) * inv_std[c];
        }
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
}

// standalone resize for tests: one image u8 -> f32 (no normalize/round)
void resize_bicubic(const uint8_t* src, int sh, int sw, float* dst, int dh,
                    int dw) {
  const Coeffs ch = make_coeffs(sw, dw);
  const Coeffs cv = make_coeffs(sh, dh);
  std::vector<float> tmp;
  resize_one(src, sh, sw, dst, dh, dw, ch, cv, tmp);
}

}  // extern "C"
