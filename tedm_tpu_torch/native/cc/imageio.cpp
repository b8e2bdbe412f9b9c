// Native PNG decode + grayscale + resize, PIL-compatible.
//
// The reference feeds its DDPM backbone from ~90k 1024^2 CXR14 PNGs through
// PIL inside DataLoader workers (dataloaders/CXR14.py:49-74:
// Image.open().convert('L').resize()). This file is the native equivalent
// of that whole per-image pipeline: libpng decode -> PIL's fixed-point
// ITU-R 601-2 luma conversion -> the bit-exact resampler in resample.cpp,
// with a std::thread batch fan-out (no GIL) for whole-batch loads.
//
// PIL-compatibility contract (pinned by tests/test_native_resample.py):
//   gray8            -> passthrough
//   RGB / RGBA       -> L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16
//                       (Pillow convert.c L24 macro; alpha ignored, as PIL)
//   palette          -> palette->RGB -> same luma
//   gray16 (no alpha)-> saturating clamp to 255 (Pillow opens 16-bit gray
//                       PNG as I;16 and convert('L') clamps, verified
//                       against Pillow 12.1; NOT the high byte)
//   gray16 + alpha   -> high byte (Pillow reads LA;16B as 8-bit channels)
//   1/2/4-bit gray   -> expanded to 8 bit
// Interlaced PNGs are handled by png_read_image. Anything that fails to
// decode returns nonzero and the Python caller falls back to PIL.

#include <png.h>

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" int tedm_resize_u8(const uint8_t* in, int h, int w, uint8_t* out,
                              int oh, int ow, int filter_id);

namespace {

// Decode a PNG file into an 8-bit grayscale buffer (PIL convert('L')
// semantics). Returns 0 on success.
int decode_png_gray(const char* path, std::vector<uint8_t>* gray, int* out_h,
                    int* out_w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return -2;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return -3;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return -3;
  }
  std::vector<uint8_t> raw;
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {  // libpng error path
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -4;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  const png_uint_32 w = png_get_image_width(png, info);
  const png_uint_32 h = png_get_image_height(png, info);
  const int bit_depth = png_get_bit_depth(png, info);
  const int color_type = png_get_color_type(png, info);

  // Only alpha-less 16-bit gray maps to Pillow's I;16 clamp semantics;
  // 16-bit gray+alpha is opened by Pillow as 8-bit-per-channel (high
  // byte), so it goes through strip_16 like RGB.
  const bool gray16 = bit_depth == 16 && color_type == PNG_COLOR_TYPE_GRAY;
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) {
    png_set_expand_gray_1_2_4_to_8(png);
  }
  // 16-bit RGB: Pillow's PNG plugin reads the high byte (raw RGB;16B).
  // 16-bit gray stays 16-bit: Pillow maps it to I;16 and convert('L')
  // saturates at 255, so we clamp below instead of stripping.
  if (bit_depth == 16 && !gray16) png_set_strip_16(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);

  const int channels = png_get_channels(png, info);
  const int out_depth = png_get_bit_depth(png, info);
  if ((channels != 1 && channels != 3) ||
      (out_depth == 16 && channels != 1) ||
      (out_depth != 8 && out_depth != 16)) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -5;
  }
  const size_t rowbytes = png_get_rowbytes(png, info);
  raw.resize(rowbytes * h);
  rows.resize(h);
  for (png_uint_32 y = 0; y < h; y++) rows[y] = raw.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  gray->resize(static_cast<size_t>(w) * h);
  if (channels == 1 && out_depth == 16) {
    // big-endian 16-bit gray, Pillow I;16 -> L saturating clamp
    for (png_uint_32 y = 0; y < h; y++) {
      const uint8_t* src = rows[y];
      uint8_t* dst = gray->data() + static_cast<size_t>(y) * w;
      for (png_uint_32 x = 0; x < w; x++) {
        const uint32_t v = (static_cast<uint32_t>(src[2 * x]) << 8) |
                           src[2 * x + 1];
        dst[x] = v > 255u ? 255u : static_cast<uint8_t>(v);
      }
    }
  } else if (channels == 1) {
    for (png_uint_32 y = 0; y < h; y++) {
      std::memcpy(gray->data() + static_cast<size_t>(y) * w, rows[y], w);
    }
  } else {  // RGB -> L, Pillow convert.c fixed-point ITU-R 601-2
    for (png_uint_32 y = 0; y < h; y++) {
      const uint8_t* src = rows[y];
      uint8_t* dst = gray->data() + static_cast<size_t>(y) * w;
      for (png_uint_32 x = 0; x < w; x++) {
        const uint32_t l24 = src[3 * x] * 19595u + src[3 * x + 1] * 38470u +
                             src[3 * x + 2] * 7471u;
        dst[x] = static_cast<uint8_t>((l24 + 0x8000u) >> 16);
      }
    }
  }
  *out_h = static_cast<int>(h);
  *out_w = static_cast<int>(w);
  return 0;
}

}  // namespace

extern "C" {

int tedm_png_decode_resize(const char* path, uint8_t* out, int oh, int ow,
                           int filter_id) {
  std::vector<uint8_t> gray;
  int h = 0, w = 0;
  const int rc = decode_png_gray(path, &gray, &h, &w);
  if (rc != 0) return rc;
  return tedm_resize_u8(gray.data(), h, w, out, oh, ow, filter_id);
}

// status[i] = 0 on success. Returns the number of failures.
int tedm_png_decode_resize_batch(const char* const* paths, int n, uint8_t* out,
                                 int oh, int ow, int filter_id, int nthreads,
                                 int* status) {
  const size_t stride = static_cast<size_t>(oh) * ow;
  int nt = nthreads < 1 ? 1 : (nthreads > n ? n : nthreads);
  auto worker = [&](int t) {
    for (int i = t; i < n; i += nt) {
      status[i] = tedm_png_decode_resize(paths[i], out + i * stride, oh, ow,
                                         filter_id);
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
  int failures = 0;
  for (int i = 0; i < n; i++) failures += (status[i] != 0);
  return failures;
}

}  // extern "C"
