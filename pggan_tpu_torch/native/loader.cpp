// Native host-side image loading for pggan_tpu_torch — the port's own copy
// of pggan_tpu/native/loader.cpp: the same arithmetic and the same C ABI, so
// the same flags give the same bytes.
//
// The data loader is the one CPU-bound native component of training
// (decode + antialiased resize + augmentation), so it is implemented in
// C++ (libjpeg/libpng + hand-rolled separable triangle-filter resampling)
// and exposed to Python over a C ABI via ctypes. Worker threads call into
// it with the GIL released, so an 8-worker pool scales on real cores.
//
// Built with -DPGGAN_NO_CODECS (where libjpeg's and libpng's headers are
// missing; Pillow's wheels bundle the libraries without them), the file
// entry points return 2 and pggan_has_codecs() returns 0: the caller
// decodes with PIL and passes the pixels to pggan_resize_pixels /
// pggan_load_pixels, which run the same resize and jitter as the file
// entry points on them.
//
// Semantics match the Python/PIL pipeline (pggan_tpu_torch/data/dataset.py):
//   * resize to (S, S) with PIL-BILINEAR-equivalent antialiased triangle
//     filtering (support widens by the downscale factor)
//   * horizontal flip
//   * torchvision-order color jitter: brightness/contrast/saturation
//     blends + HSV hue rotation, applied in a caller-provided order.
//     NOT bit-exact vs PIL/torchvision: ImageEnhance quantizes to uint8
//     between ops and rounds the contrast mean to int, while this chain
//     stays in float and uses continuous HSV — measured divergence up to
//     ~4 LSB (mean ~1.5) on random JPEGs; distributionally equivalent
//     augmentation, not a weight-for-weight parity surface. (On smooth
//     fields with per-pixel noise, 320² to 1280² sources: mean ~1.45-1.51,
//     with a tail above 8 LSB on ~0.01 % of the values, up to 18.)
//   * output: uint8 RGB, HWC
//
// Build: see build.py (g++ -O3 -fopenmp, a .so under pggan_tpu_torch/_build/
// keyed by a hash of this source and the flags).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifndef PGGAN_NO_CODECS
#include <jpeglib.h>
#include <png.h>
#include <csetjmp>
#endif

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // HWC, 3 channels
};

// ---------------------------------------------------------------------------
// Decoders
// ---------------------------------------------------------------------------

#ifndef PGGAN_NO_CODECS

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, Image* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // normalize to 8-bit RGB. Transparency is DISCARDED (tRNS chunks are
  // not expanded to an alpha channel — expanding then stripping only for
  // originally-alpha color types overflowed w*3 rows for palette/gray
  // PNGs with tRNS, a heap smash that aborted the process).
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  // Unconditional: alpha may also come from palette expansion (palette +
  // tRNS expands to RGBA inside png_set_palette_to_rgb), not only from
  // an alpha color_type; stripping is a no-op on 3-channel data.
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  // Hard guarantee before writing rows: whatever transform combination
  // libpng settled on must yield exactly 3 bytes/pixel — otherwise fail
  // the decode (IOError → per-image PIL fallback), never overflow.
  if (png_get_rowbytes(png, info) != size_t(w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }

  out->w = int(w);
  out->h = int(h);
  out->rgb.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->rgb.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8 && magic[2] == 0xFF) {
    ok = decode_jpeg(f, out);
  } else if (got >= 8 && !png_sig_cmp(magic, 0, 8)) {
    ok = decode_png(f, out);
  }
  fclose(f);
  return ok && out->w > 0 && out->h > 0;
}

constexpr bool kHasCodecs = true;
#else
bool decode_file(const char*, Image*) { return false; }

constexpr bool kHasCodecs = false;
#endif

// What the file entry points return when decode_file fails: 2 where there
// is no decoder to try.
constexpr int kDecodeError = kHasCodecs ? 1 : 2;

// ---------------------------------------------------------------------------
// Antialiased separable resize (PIL BILINEAR equivalent: triangle filter
// with support scaled by the downscale factor).
// ---------------------------------------------------------------------------

struct FilterTaps {
  std::vector<int> start;      // first source index per output index
  std::vector<int> count;      // tap count per output index
  std::vector<float> weights;  // taps, max_taps stride
  int max_taps = 0;
};

FilterTaps build_taps(int in_size, int out_size) {
  FilterTaps taps;
  const double scale = double(in_size) / out_size;
  const double support = std::max(1.0, scale);  // triangle radius
  taps.max_taps = int(std::ceil(support * 2.0)) + 2;
  taps.start.resize(out_size);
  taps.count.resize(out_size);
  taps.weights.assign(size_t(out_size) * taps.max_taps, 0.f);
  for (int o = 0; o < out_size; ++o) {
    const double center = (o + 0.5) * scale;
    int lo = std::max(0, int(std::floor(center - support + 0.5)));
    int hi = std::min(in_size, int(std::floor(center + support + 0.5)));
    double sum = 0.0;
    int n = 0;
    for (int i = lo; i < hi; ++i) {
      double x = (i + 0.5 - center) / std::max(1.0, scale);
      double wgt = 1.0 - std::fabs(x);
      if (wgt <= 0.0) continue;
      taps.weights[size_t(o) * taps.max_taps + n] = float(wgt);
      if (n == 0) taps.start[o] = i;
      ++n;
      sum += wgt;
    }
    if (n == 0) {  // degenerate: nearest
      taps.start[o] = std::min(in_size - 1, int(center));
      taps.weights[size_t(o) * taps.max_taps] = 1.f;
      n = 1;
      sum = 1.0;
    }
    taps.count[o] = n;
    for (int k = 0; k < n; ++k)
      taps.weights[size_t(o) * taps.max_taps + k] /= float(sum);
  }
  return taps;
}

void resize_rgb(const uint8_t* rgb, int w, int h, int out_size,
                std::vector<float>* out) {
  FilterTaps tx = build_taps(w, out_size);
  FilterTaps ty = build_taps(h, out_size);
  // horizontal pass: [h, out_size, 3] float
  std::vector<float> tmp(size_t(h) * out_size * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = rgb + size_t(y) * w * 3;
    float* trow = tmp.data() + size_t(y) * out_size * 3;
    for (int o = 0; o < out_size; ++o) {
      float acc[3] = {0.f, 0.f, 0.f};
      const int n = tx.count[o], s = tx.start[o];
      const float* w = &tx.weights[size_t(o) * tx.max_taps];
      for (int k = 0; k < n; ++k) {
        const uint8_t* px = row + size_t(s + k) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      trow[o * 3 + 0] = acc[0];
      trow[o * 3 + 1] = acc[1];
      trow[o * 3 + 2] = acc[2];
    }
  }
  // vertical pass → [out_size, out_size, 3]
  out->assign(size_t(out_size) * out_size * 3, 0.f);
  for (int o = 0; o < out_size; ++o) {
    const int n = ty.count[o], s = ty.start[o];
    const float* w = &ty.weights[size_t(o) * ty.max_taps];
    float* orow = out->data() + size_t(o) * out_size * 3;
    for (int k = 0; k < n; ++k) {
      const float* trow = tmp.data() + size_t(s + k) * out_size * 3;
      const float wk = w[k];
      for (int x = 0; x < out_size * 3; ++x) orow[x] += wk * trow[x];
    }
  }
}

// ---------------------------------------------------------------------------
// Color jitter (torchvision semantics) on float RGB in [0, 255]
// ---------------------------------------------------------------------------

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

void adjust_brightness(std::vector<float>& img, float f) {
  for (float& v : img) v = clampf(v * f, 0.f, 255.f);
}

void adjust_contrast(std::vector<float>& img, float f) {
  double mean = 0.0;
  const size_t n = img.size() / 3;
  for (size_t i = 0; i < n; ++i) {
    mean += 0.299 * img[i * 3] + 0.587 * img[i * 3 + 1] + 0.114 * img[i * 3 + 2];
  }
  const float m = float(mean / double(n));
  for (float& v : img) v = clampf(f * v + (1.f - f) * m, 0.f, 255.f);
}

void adjust_saturation(std::vector<float>& img, float f) {
  const size_t n = img.size() / 3;
  for (size_t i = 0; i < n; ++i) {
    float* px = &img[i * 3];
    const float gray = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
    px[0] = clampf(f * px[0] + (1.f - f) * gray, 0.f, 255.f);
    px[1] = clampf(f * px[1] + (1.f - f) * gray, 0.f, 255.f);
    px[2] = clampf(f * px[2] + (1.f - f) * gray, 0.f, 255.f);
  }
}

void adjust_hue(std::vector<float>& img, float shift /* in turns, [-0.5,0.5] */) {
  const size_t n = img.size() / 3;
  for (size_t i = 0; i < n; ++i) {
    float* px = &img[i * 3];
    const float r = px[0] / 255.f, g = px[1] / 255.f, b = px[2] / 255.f;
    const float mx = std::max({r, g, b}), mn = std::min({r, g, b});
    const float d = mx - mn;
    float h = 0.f;
    if (d > 0.f) {
      if (mx == r)      h = std::fmod((g - b) / d, 6.f);
      else if (mx == g) h = (b - r) / d + 2.f;
      else              h = (r - g) / d + 4.f;
      h /= 6.f;
      if (h < 0.f) h += 1.f;
    }
    const float s = mx > 0.f ? d / mx : 0.f;
    const float v = mx;
    h = h + shift;
    h -= std::floor(h);
    const float hh = h * 6.f;
    const int sector = int(hh) % 6;
    const float frac = hh - std::floor(hh);
    const float p = v * (1.f - s);
    const float q = v * (1.f - s * frac);
    const float t = v * (1.f - s * (1.f - frac));
    float nr, ng, nb;
    switch (sector) {
      case 0: nr = v; ng = t; nb = p; break;
      case 1: nr = q; ng = v; nb = p; break;
      case 2: nr = p; ng = v; nb = t; break;
      case 3: nr = p; ng = q; nb = v; break;
      case 4: nr = t; ng = p; nb = v; break;
      default: nr = v; ng = p; nb = q; break;
    }
    px[0] = clampf(nr * 255.f, 0.f, 255.f);
    px[1] = clampf(ng * 255.f, 0.f, 255.f);
    px[2] = clampf(nb * 255.f, 0.f, 255.f);
  }
}

// Round a float HWC buffer to uint8, once.
void store_rounded(const std::vector<float>& buf, int size, uint8_t* out) {
  const size_t total = size_t(size) * size * 3;
  for (size_t i = 0; i < total; ++i)
    out[i] = uint8_t(clampf(std::lround(buf[i]), 0.f, 255.f));
}

// Flip + color jitter on a float HWC buffer, then round once to uint8.
// Shared by the decode path and the decode-cache augment path.
void augment_and_store(std::vector<float>& buf, int size, int flip,
                       const float* factors, const int* order, uint8_t* out) {
  if (flip) {
    for (int y = 0; y < size; ++y) {
      float* row = buf.data() + size_t(y) * size * 3;
      for (int x = 0; x < size / 2; ++x) {
        for (int c = 0; c < 3; ++c)
          std::swap(row[x * 3 + c], row[(size - 1 - x) * 3 + c]);
      }
    }
  }

  if (factors && order) {
    for (int k = 0; k < 4; ++k) {
      switch (order[k]) {
        case 0: if (factors[0] >= 0) adjust_brightness(buf, factors[0]); break;
        case 1: if (factors[1] >= 0) adjust_contrast(buf, factors[1]); break;
        case 2: if (factors[2] >= 0) adjust_saturation(buf, factors[2]); break;
        case 3: if (factors[3] > -1.f) adjust_hue(buf, factors[3]); break;
        default: break;
      }
    }
  }

  store_rounded(buf, size, out);
}

}  // namespace

extern "C" {

// Decode + antialiased resize + augment one image.
//   path       : image file (JPEG or PNG)
//   size       : output side length (square)
//   flip       : 1 → horizontal flip
//   factors[4] : brightness, contrast, saturation (multipliers),
//                hue (turns); order[4]: op application order, entries 0-3
//                (torchvision permutes op order per sample); factor < 0
//                disables that op
//   out        : caller buffer, size*size*3 uint8 (HWC RGB)
// Returns 0 on success, non-zero error code otherwise.
int pggan_load_image(const char* path, int size, int flip,
                     const float* factors, const int* order, uint8_t* out) {
  Image img;
  if (!decode_file(path, &img)) return kDecodeError;
  std::vector<float> buf;
  resize_rgb(img.rgb.data(), img.w, img.h, size, &buf);
  augment_and_store(buf, size, flip, factors, order, out);
  return 0;
}

// Decode + antialiased resize only (no augmentation, single rounding) —
// fills the decode cache. Equivalent to pggan_load_image(flip=0, all ops
// disabled).
int pggan_resize_image(const char* path, int size, uint8_t* out) {
  Image img;
  if (!decode_file(path, &img)) return kDecodeError;
  std::vector<float> buf;
  resize_rgb(img.rgb.data(), img.w, img.h, size, &buf);
  store_rounded(buf, size, out);
  return 0;
}

// Flip + jitter a pre-resized square uint8 RGB image from memory — the
// per-draw fast path over the decode cache (decode+resize amortized to
// once per image per scale; augmentation stays per-draw). The jitter
// arithmetic runs in float exactly like the decode path; the only
// difference from pggan_load_image is one extra uint8 quantization at the
// cache boundary (the reference's PIL pipeline quantizes there too:
// Resize returns a uint8 image before ColorJitter, lib/dataset.py:103-108).
int pggan_augment_image(const uint8_t* img, int size, int flip,
                        const float* factors, const int* order,
                        uint8_t* out) {
  const size_t total = size_t(size) * size * 3;
  std::vector<float> buf(total);
  for (size_t i = 0; i < total; ++i) buf[i] = float(img[i]);
  augment_and_store(buf, size, flip, factors, order, out);
  return 0;
}

// Decode only (native decode microbench / tests): returns 0 and fills
// w/h; if rgb_out non-null it must hold w*h*3 bytes from a prior probe.
int pggan_probe_image(const char* path, int* w, int* h) {
  Image img;
  if (!decode_file(path, &img)) return kDecodeError;
  *w = img.w;
  *h = img.h;
  return 0;
}

int pggan_decode_image(const char* path, uint8_t* rgb_out) {
  Image img;
  if (!decode_file(path, &img)) return kDecodeError;
  std::memcpy(rgb_out, img.rgb.data(), img.rgb.size());
  return 0;
}

// 1 if the file entry points above decode (libjpeg/libpng linked), 0 if
// this library was built with -DPGGAN_NO_CODECS.
int pggan_has_codecs() { return kHasCodecs ? 1 : 0; }

// pggan_resize_image on pixels decoded by the caller: rgb is [h, w, 3]
// uint8 HWC, C-contiguous.
int pggan_resize_pixels(const uint8_t* rgb, int w, int h, int size,
                        uint8_t* out) {
  if (w <= 0 || h <= 0 || size <= 0) return 1;
  std::vector<float> buf;
  resize_rgb(rgb, w, h, size, &buf);
  store_rounded(buf, size, out);
  return 0;
}

// pggan_load_image on pixels decoded by the caller (arguments as above).
int pggan_load_pixels(const uint8_t* rgb, int w, int h, int size, int flip,
                      const float* factors, const int* order, uint8_t* out) {
  if (w <= 0 || h <= 0 || size <= 0) return 1;
  std::vector<float> buf;
  resize_rgb(rgb, w, h, size, &buf);
  augment_and_store(buf, size, flip, factors, order, out);
  return 0;
}

}  // extern "C"
