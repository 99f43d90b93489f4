// Native host image preprocessing (the port's own copy of
// defer_tpu/native/imageproc.cpp): fused bilinear resize + center-crop
// + per-channel affine (the ImageNet input transforms), uint8 NHWC in,
// float32 or bfloat16 NHWC out.
//
// The reference's host input path is PIL resize + numpy arithmetic on
// the driver (reference src/test.py:13-16); here the whole transform is
// one C++ pass so the feed thread keeps up with a card consuming >10k
// images/sec. Semantics match defer_tpu_torch/runtime/data.py's numpy path
// exactly: short-side resize with half-pixel-centered bilinear
// sampling, center crop, then out = sample * scale + offset[channel],
// with an optional RGB->BGR swap (the caffe convention).
//
// C ABI only — consumed via ctypes.
//
// Build: g++ -O3 -shared -fPIC imageproc.cpp -o libimageproc.so -pthread

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Round-to-nearest-even truncation of an IEEE754 float to bfloat16
// (the top 16 bits), matching numpy/ml_dtypes casting.
inline uint16_t float_to_bf16(float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, sizeof(bits));
  const uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
  return static_cast<uint16_t>((bits + rounding) >> 16);
}

struct PlanRow {
  int64_t lo;
  int64_t hi;
  float w;  // weight of hi sample
};

// Half-pixel-centered source coordinate plan for one output axis,
// matching _bilinear_resize_np: clip((i + 0.5) * src/dst - 0.5, 0,
// src-1), with the crop offset folded in.
std::vector<PlanRow> make_plan(int64_t src, int64_t dst, int64_t crop0,
                               int64_t out) {
  std::vector<PlanRow> plan(static_cast<size_t>(out));
  const double r = static_cast<double>(src) / static_cast<double>(dst);
  for (int64_t i = 0; i < out; ++i) {
    double pos = (static_cast<double>(i + crop0) + 0.5) * r - 0.5;
    pos = std::min(std::max(pos, 0.0), static_cast<double>(src - 1));
    const int64_t lo = static_cast<int64_t>(std::floor(pos));
    plan[static_cast<size_t>(i)] = {
        lo, std::min(lo + 1, src - 1),
        static_cast<float>(pos - static_cast<double>(lo))};
  }
  return plan;
}

struct Job {
  const uint8_t* src;
  int64_t h, w, c;
  const PlanRow* ys;
  const PlanRow* xs;
  int64_t size;
  const float* scale;   // per channel (post-swap order)
  const float* offset;  // per channel (post-swap order)
  int swap_rb;
  int out_bf16;
  void* dst;
};

void process_rows(const Job& job, int64_t row0, int64_t row1) {
  const int64_t c = job.c, w = job.w, size = job.size;
  float* out_f = static_cast<float*>(job.dst);
  uint16_t* out_h = static_cast<uint16_t*>(job.dst);
  for (int64_t i = row0; i < row1; ++i) {
    const PlanRow& py = job.ys[i];
    const uint8_t* top = job.src + py.lo * w * c;
    const uint8_t* bot = job.src + py.hi * w * c;
    const float wy = py.w;
    for (int64_t j = 0; j < size; ++j) {
      const PlanRow& px = job.xs[j];
      const uint8_t* tl = top + px.lo * c;
      const uint8_t* tr = top + px.hi * c;
      const uint8_t* bl = bot + px.lo * c;
      const uint8_t* br = bot + px.hi * c;
      const float wx = px.w;
      for (int64_t k = 0; k < c; ++k) {
        const float t = static_cast<float>(tl[k]) +
                        (static_cast<float>(tr[k]) - static_cast<float>(tl[k])) * wx;
        const float b = static_cast<float>(bl[k]) +
                        (static_cast<float>(br[k]) - static_cast<float>(bl[k])) * wx;
        const float v = t + (b - t) * wy;
        const int64_t ko = job.swap_rb && c == 3 ? c - 1 - k : k;
        const float r = v * job.scale[ko] + job.offset[ko];
        const int64_t idx = (i * size + j) * c + ko;
        if (job.out_bf16) {
          out_h[idx] = float_to_bf16(r);
        } else {
          out_f[idx] = r;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Preprocess n HWC uint8 images (contiguous NHWC) into n size*size*c
// outputs. scale/offset are length-c, indexed by OUTPUT channel (after
// the optional R<->B swap). Returns 0 on success, nonzero on bad args.
int defer_preprocess(const uint8_t* src, int64_t n, int64_t h, int64_t w,
                     int64_t c, int64_t size, const float* scale,
                     const float* offset, int swap_rb, int out_bf16,
                     int64_t num_threads, void* dst) {
  if (!src || !dst || n < 0 || h <= 0 || w <= 0 || c <= 0 || size <= 0) {
    return 1;
  }
  if (n == 0) return 0;  // nothing to do (and no zero-size pool math)
  // Short-side resize dims, then centered crop offsets (matching
  // _resize_center_crop; std::nearbyint under the default FP
  // environment rounds half-to-even, like Python's round()).
  const double s =
      static_cast<double>(size) / static_cast<double>(std::min(h, w));
  const int64_t nh =
      std::max(size, static_cast<int64_t>(std::nearbyint(h * s)));
  const int64_t nw =
      std::max(size, static_cast<int64_t>(std::nearbyint(w * s)));
  const int64_t top = (nh - size) / 2;
  const int64_t left = (nw - size) / 2;
  const auto ys = make_plan(h, nh, top, size);
  const auto xs = make_plan(w, nw, left, size);

  const int64_t out_elem = out_bf16 ? 2 : 4;
  const int64_t total_rows = n * size;
  auto run_range = [&](int64_t g0, int64_t g1) {
    // Global row index g = img * size + row; regroup into contiguous
    // per-image spans so each Job is set up once per span.
    int64_t g = g0;
    while (g < g1) {
      const int64_t img = g / size;
      const int64_t row0 = g % size;
      const int64_t row1 = std::min<int64_t>(size, row0 + (g1 - g));
      Job job{src + img * h * w * c,
              h,
              w,
              c,
              ys.data(),
              xs.data(),
              size,
              scale,
              offset,
              swap_rb,
              out_bf16,
              static_cast<uint8_t*>(dst) + img * size * size * c * out_elem};
      process_rows(job, row0, row1);
      g += row1 - row0;
    }
  };
  // One pool over ALL n*size output rows (not per image): thread
  // create/join overhead is paid once per call, and a batch keeps
  // every worker busy across image boundaries.
  int64_t threads = std::max<int64_t>(1, num_threads);
  threads = std::min(threads, total_rows);
  if (threads == 1) {
    run_range(0, total_rows);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(static_cast<size_t>(threads));
    const int64_t chunk = (total_rows + threads - 1) / threads;
    for (int64_t t = 0; t < threads; ++t) {
      const int64_t r0 = t * chunk;
      const int64_t r1 = std::min(r0 + chunk, total_rows);
      if (r0 >= r1) break;
      pool.emplace_back([&run_range, r0, r1] { run_range(r0, r1); });
    }
    for (auto& th : pool) th.join();
  }
  return 0;
}

}  // extern "C"
