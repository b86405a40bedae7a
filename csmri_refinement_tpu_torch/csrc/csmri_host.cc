// csmri_host — native host-side data pipeline.
//
// The reference delegates its hot host path to native libraries inside
// torch DataLoader workers (scipy/cv2 interpolation, numpy FFT; see
// SURVEY.md §2.7). Here the equivalent batch-preparation hot path is a
// small multithreaded C++ library driven from Python via ctypes
// (csmri_refinement_tpu/data/native.py): slice gathering, per-slice
// max-abs normalization, and geometric augmentation (translate + rotate +
// zoom with bilinear sampling), producing ready float32 GT batches for the
// on-device forward model.
//
// Build: make -C native   (g++ -O3 -march=native -shared -fPIC -pthread)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// xorshift128+ per-item RNG — deterministic per (seed, item index)
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    // splitmix64 init
    auto next = [&seed]() {
      uint64_t z = (seed += 0x9e3779b97f4a7c15ULL);
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      return z ^ (z >> 31);
    };
    s0 = next();
    s1 = next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // uniform in [lo, hi)
  double uniform(double lo, double hi) {
    return lo + (hi - lo) * ((next() >> 11) * (1.0 / 9007199254740992.0));
  }
  // integer in [lo, hi)
  int64_t randint(int64_t lo, int64_t hi) {
    return lo + static_cast<int64_t>(next() % static_cast<uint64_t>(hi - lo));
  }
};

inline float bilinear(const float* img, int h, int w, float y, float x) {
  // reflect-at-border sampling
  if (y < 0) y = -y;
  if (x < 0) x = -x;
  if (y > h - 1) y = 2 * (h - 1) - y;
  if (x > w - 1) x = 2 * (w - 1) - x;
  y = std::max(0.0f, std::min(y, static_cast<float>(h - 1)));
  x = std::max(0.0f, std::min(x, static_cast<float>(w - 1)));
  int y0 = static_cast<int>(y), x0 = static_cast<int>(x);
  int y1 = std::min(y0 + 1, h - 1), x1 = std::min(x0 + 1, w - 1);
  float fy = y - y0, fx = x - x0;
  float v00 = img[y0 * w + x0], v01 = img[y0 * w + x1];
  float v10 = img[y1 * w + x0], v11 = img[y1 * w + x1];
  return v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
         v10 * fy * (1 - fx) + v11 * fy * fx;
}

void prepare_one(const float* slice, float* out, int h, int w,
                 int shift, float max_rotate, float zoom_lo, float zoom_hi,
                 uint64_t seed) {
  Rng rng(seed);
  float ty = 0.f, tx = 0.f, angle = 0.f, zoom = 1.f;
  if (shift > 0) {
    ty = static_cast<float>(rng.randint(-shift, shift));
    tx = static_cast<float>(rng.randint(-shift, shift));
  }
  if (max_rotate > 0) {
    angle = static_cast<float>(rng.uniform(-max_rotate, max_rotate)) *
            static_cast<float>(M_PI) / 180.0f;
  }
  if (zoom_lo != 1.0f || zoom_hi != 1.0f) {
    zoom = static_cast<float>(rng.uniform(zoom_lo, zoom_hi));
  }

  const float cy = (h - 1) * 0.5f, cx = (w - 1) * 0.5f;
  const float ca = std::cos(angle), sa = std::sin(angle);
  const float inv_zoom = 1.0f / zoom;

  float peak = 1e-12f;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      // inverse map: output pixel -> source coordinates
      float dy = (y - cy) * inv_zoom, dx = (x - cx) * inv_zoom;
      float sy = ca * dy - sa * dx + cy + ty;
      float sx = sa * dy + ca * dx + cx + tx;
      float v = bilinear(slice, h, w, sy, sx);
      out[y * w + x] = v;
      peak = std::max(peak, std::fabs(v));
    }
  }
  const float inv_peak = 1.0f / peak;
  for (int i = 0; i < h * w; ++i) out[i] *= inv_peak;
}

}  // namespace

extern "C" {

// Gather + augment + normalize a batch of slices.
//   slices:  (num_slices, h, w) float32 source pool
//   indices: (batch,) int32 slice indices
//   out:     (batch, h, w) float32 output
//   shift/max_rotate/zoom_*: augmentation ranges (0/0/1/1 disables)
//   seed: base seed; per-item seed = seed ^ hash(index, counter)
//   num_threads: worker threads (<=0 → hardware concurrency)
void csmri_prepare_batch(const float* slices, const int32_t* indices,
                         float* out, int32_t batch, int32_t h, int32_t w,
                         int32_t shift, float max_rotate, float zoom_lo,
                         float zoom_hi, uint64_t seed,
                         int32_t num_threads) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  int threads = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  threads = std::max(1, std::min<int>(threads, batch));

  std::atomic<int32_t> cursor{0};
  auto worker = [&]() {
    for (;;) {
      int32_t i = cursor.fetch_add(1);
      if (i >= batch) break;
      uint64_t item_seed =
          seed ^ (0x9e3779b97f4a7c15ULL * (static_cast<uint64_t>(indices[i]) + 1));
      prepare_one(slices + static_cast<int64_t>(indices[i]) * hw,
                  out + static_cast<int64_t>(i) * hw, h, w, shift,
                  max_rotate, zoom_lo, zoom_hi, item_seed);
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

// Per-slice max-abs normalization in place: (n, hw) float32
void csmri_normalize(float* data, int64_t n, int64_t hw,
                     int32_t num_threads) {
  int threads = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  threads = std::max<int>(1, std::min<int64_t>(threads, n));
  std::atomic<int64_t> cursor{0};
  auto worker = [&]() {
    for (;;) {
      int64_t i = cursor.fetch_add(1);
      if (i >= n) break;
      float* p = data + i * hw;
      float peak = 1e-12f;
      for (int64_t j = 0; j < hw; ++j) peak = std::max(peak, std::fabs(p[j]));
      const float inv = 1.0f / peak;
      for (int64_t j = 0; j < hw; ++j) p[j] *= inv;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

// Extract 2D float32 slices from a Fortran-ordered int16 Analyze volume
// (dim1 x dim2 x nz), transposing to (nz, dim1, dim2) C order with
// optional scale factor.
void csmri_extract_slices_i16(const int16_t* vol, float* out, int32_t dim1,
                              int32_t dim2, int32_t nz, float scale) {
  if (scale == 0.0f) scale = 1.0f;
  for (int32_t z = 0; z < nz; ++z) {
    float* dst = out + static_cast<int64_t>(z) * dim1 * dim2;
    for (int32_t y = 0; y < dim1; ++y) {
      for (int32_t x = 0; x < dim2; ++x) {
        // Fortran order: vol[y + x*dim1 + z*dim1*dim2]
        dst[y * dim2 + x] = scale *
            static_cast<float>(vol[y + static_cast<int64_t>(x) * dim1 +
                                    static_cast<int64_t>(z) * dim1 * dim2]);
      }
    }
  }
}

}  // extern "C"
