// Native host-side image resampler — bit-exact with Pillow.
//
// The reference's input pipeline spends its host CPU in PIL's C resize
// (dataloaders/JSRT.py:62-65: Image.convert('L').resize((128, 128)) inside
// torch DataLoader workers). This is our native equivalent: the same
// separable fixed-point convolution resampling Pillow implements
// (Resample.c), for single-band 8-bit images, with a std::thread batch
// fan-out so a whole training batch is resized in one call.
//
// Bit-exactness contract (pinned by tests/test_native_resample.py): for
// BICUBIC (PIL's resize default for mode 'L'), BILINEAR and NEAREST, the
// output bytes equal PIL.Image.resize() exactly, so enabling the native
// path cannot change any model number.
//
// Exposed C ABI (ctypes-friendly):
//   tedm_resize_u8       — one image
//   tedm_resize_batch_u8 — (B, H, W) -> (B, OH, OW), threaded

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Pillow's 8-bit fixed-point precision (Resample.c: PRECISION_BITS).
constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

struct Filter {
  double (*fn)(double);
  double support;
};

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

double bicubic_filter(double x) {
  // Keys cubic, a = -0.5 (Pillow's BICUBIC).
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

const Filter kFilters[] = {
    {nullptr, 0.0},          // 0: NEAREST (separate path)
    {bilinear_filter, 1.0},  // 1: BILINEAR
    {bicubic_filter, 2.0},   // 2: BICUBIC
};

// Pillow precompute_coeffs + normalize_coeffs_8bpc, fused.
// Returns ksize; fills bounds (2 per out pixel) and int coeffs.
int precompute_coeffs(int in_size, int out_size, const Filter& f,
                      std::vector<int>* bounds, std::vector<int>* kk_int) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = f.support * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  bounds->assign(static_cast<size_t>(out_size) * 2, 0);
  kk_int->assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> k(ksize);

  for (int xx = 0; xx < out_size; xx++) {
    const double center = (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    // Round the field of contributions (Pillow truncates center-support+0.5
    // toward zero, then clamps — identical for all reachable values).
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; x++) {
      const double w = f.fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (int x = xmax; x < ksize; x++) k[x] = 0.0;
    (*bounds)[xx * 2 + 0] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
    for (int x = 0; x < ksize; x++) {
      const double v = k[x] * (1 << kPrecisionBits);
      (*kk_int)[static_cast<size_t>(xx) * ksize + x] =
          v < 0.0 ? static_cast<int>(v - 0.5) : static_cast<int>(v + 0.5);
    }
  }
  return ksize;
}

// Precomputed plan shared by every image in a batch.
struct Plan {
  int h, w, oh, ow;
  bool horiz, vert;
  int ksize_h = 0, ksize_v = 0;
  std::vector<int> bounds_h, kk_h, bounds_v, kk_v;
};

Plan make_plan(int h, int w, int oh, int ow, const Filter& f) {
  Plan p;
  p.h = h; p.w = w; p.oh = oh; p.ow = ow;
  p.horiz = (ow != w);
  p.vert = (oh != h);
  if (p.horiz) p.ksize_h = precompute_coeffs(w, ow, f, &p.bounds_h, &p.kk_h);
  if (p.vert) p.ksize_v = precompute_coeffs(h, oh, f, &p.bounds_v, &p.kk_v);
  return p;
}

void resample_one(const uint8_t* in, uint8_t* out, const Plan& p,
                  std::vector<uint8_t>* scratch) {
  const uint8_t* src = in;
  int src_w = p.w;
  // Horizontal pass: (h, w) -> (h, ow).
  if (p.horiz) {
    uint8_t* dst;
    if (p.vert) {
      scratch->resize(static_cast<size_t>(p.h) * p.ow);
      dst = scratch->data();
    } else {
      dst = out;
    }
    for (int yy = 0; yy < p.h; yy++) {
      const uint8_t* row = src + static_cast<size_t>(yy) * src_w;
      uint8_t* orow = dst + static_cast<size_t>(yy) * p.ow;
      for (int xx = 0; xx < p.ow; xx++) {
        const int xmin = p.bounds_h[xx * 2 + 0];
        const int xmax = p.bounds_h[xx * 2 + 1];
        const int* k = &p.kk_h[static_cast<size_t>(xx) * p.ksize_h];
        int ss0 = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; x++) ss0 += row[x + xmin] * k[x];
        orow[xx] = clip8(ss0);
      }
    }
    src = dst;
    src_w = p.ow;
  }
  // Vertical pass: (h, src_w) -> (oh, src_w).
  if (p.vert) {
    for (int yy = 0; yy < p.oh; yy++) {
      const int ymin = p.bounds_v[yy * 2 + 0];
      const int ymax = p.bounds_v[yy * 2 + 1];
      const int* k = &p.kk_v[static_cast<size_t>(yy) * p.ksize_v];
      uint8_t* orow = out + static_cast<size_t>(yy) * src_w;
      for (int xx = 0; xx < src_w; xx++) {
        int ss0 = 1 << (kPrecisionBits - 1);
        for (int y = 0; y < ymax; y++) {
          ss0 += src[static_cast<size_t>(y + ymin) * src_w + xx] * k[y];
        }
        orow[xx] = clip8(ss0);
      }
    }
  } else if (!p.horiz) {
    std::memcpy(out, in, static_cast<size_t>(p.h) * p.w);
  }
}

// PIL NEAREST resize = affine sampling at pixel centers, truncated.
void nearest_one(const uint8_t* in, int h, int w, uint8_t* out, int oh,
                 int ow) {
  const double sx = static_cast<double>(w) / ow;
  const double sy = static_cast<double>(h) / oh;
  std::vector<int> xmap(ow);
  for (int xx = 0; xx < ow; xx++) {
    int v = static_cast<int>((xx + 0.5) * sx);
    xmap[xx] = std::min(v, w - 1);
  }
  for (int yy = 0; yy < oh; yy++) {
    int sy_i = std::min(static_cast<int>((yy + 0.5) * sy), h - 1);
    const uint8_t* row = in + static_cast<size_t>(sy_i) * w;
    uint8_t* orow = out + static_cast<size_t>(yy) * ow;
    for (int xx = 0; xx < ow; xx++) orow[xx] = row[xmap[xx]];
  }
}

}  // namespace

extern "C" {

int tedm_resize_u8(const uint8_t* in, int h, int w, uint8_t* out, int oh,
                   int ow, int filter_id) {
  if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0) return -1;
  if (filter_id == 0) {
    nearest_one(in, h, w, out, oh, ow);
    return 0;
  }
  if (filter_id < 0 || filter_id > 2) return -2;
  Plan p = make_plan(h, w, oh, ow, kFilters[filter_id]);
  std::vector<uint8_t> scratch;
  resample_one(in, out, p, &scratch);
  return 0;
}

int tedm_resize_batch_u8(const uint8_t* in, int b, int h, int w, uint8_t* out,
                         int oh, int ow, int filter_id, int nthreads) {
  if (b <= 0 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0) return -1;
  if (filter_id < 0 || filter_id > 2) return -2;
  Plan plan;
  if (filter_id != 0) plan = make_plan(h, w, oh, ow, kFilters[filter_id]);
  const size_t in_stride = static_cast<size_t>(h) * w;
  const size_t out_stride = static_cast<size_t>(oh) * ow;
  int nt = std::max(1, std::min(nthreads, b));

  auto worker = [&](int t) {
    std::vector<uint8_t> scratch;
    for (int i = t; i < b; i += nt) {
      const uint8_t* src = in + i * in_stride;
      uint8_t* dst = out + i * out_stride;
      if (filter_id == 0) {
        nearest_one(src, h, w, dst, oh, ow);
      } else {
        resample_one(src, dst, plan, &scratch);
      }
    }
  };
  if (nt == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; t++) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  return 0;
}

}  // extern "C"
