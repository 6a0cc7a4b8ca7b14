// Native data-loading runtime: multithreaded image decode + resize.
//
// Replaces the Python/PIL per-image hot path of the input pipeline with a
// C++ thread pool: PNG (libpng) and JPEG (libjpeg) decode, antialiased-ish
// bilinear resize, normalization to float32 [0,1], written directly into a
// caller-provided batch buffer. Exposed as a C ABI consumed via ctypes
// (lsi_tpu_torch/native/__init__.py). The TF1 reference fed images through
// queue-runner threads; this is the native equivalent for the TPU build's
// host side.
//
// Build: see lsi_tpu_torch/native/__init__.py (single g++ -shared
// invocation). A copy of lsi_tpu/native/loader.cc, owned by the port.

#include <cmath>
#include <csetjmp>
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;  // decoded as RGB (3) always
  std::vector<uint8_t> data;  // H*W*3
  bool ok = false;
};

bool has_suffix(const std::string& s, const char* suf) {
  size_t n = std::strlen(suf);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; i++) {
    char a = s[s.size() - n + i];
    char b = suf[i];
    if (a >= 'A' && a <= 'Z') a += 32;
    if (a != b) return false;
  }
  return true;
}

Image decode_png(const char* path) {
  Image img;
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return img;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return img;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return img;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return img;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  // Normalize every input to 8-bit RGB.
  if (bit_depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  img.width = static_cast<int>(w);
  img.height = static_cast<int>(h);
  img.channels = 3;
  img.data.resize(static_cast<size_t>(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; y++)
    rows[y] = img.data.data() + static_cast<size_t>(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  img.ok = true;
  return img;
}

// libjpeg's default error_exit calls exit(): a single corrupt/truncated
// JPEG would kill the whole training process. Recoverable handler via
// setjmp/longjmp (the libjpeg-documented idiom).
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  std::jmp_buf jump;
};

void jpeg_error_exit_recover(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  std::longjmp(err->jump, 1);
}

Image decode_jpeg(const char* path) {
  Image img;
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return img;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit_recover;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    img.ok = false;
    return img;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return img;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img.width = cinfo.output_width;
  img.height = cinfo.output_height;
  img.channels = 3;
  img.data.resize(static_cast<size_t>(img.width) * img.height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img.data.data()
        + static_cast<size_t>(cinfo.output_scanline) * img.width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  img.ok = true;
  return img;
}

Image decode(const char* path) {
  std::string p(path);
  if (has_suffix(p, ".png")) return decode_png(path);
  if (has_suffix(p, ".jpg") || has_suffix(p, ".jpeg"))
    return decode_jpeg(path);
  // magic-byte sniff
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return Image{};
  unsigned char magic[4] = {0, 0, 0, 0};
  size_t got = std::fread(magic, 1, 4, fp);
  std::fclose(fp);
  if (got >= 4 && magic[0] == 0x89 && magic[1] == 'P') return decode_png(path);
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8)
    return decode_jpeg(path);
  return Image{};
}

// Antialiased bilinear resize matching PIL's BILINEAR semantics: a
// separable triangle filter whose support scales with the downscale
// factor (plain 2-tap bilinear when upscaling). Pixel-center convention
// matches lsi_tpu_torch.geometry.projection.scale_intrinsics. Output is f32
// [0, 1].
struct Taps {
  std::vector<int> start;      // first source index per output index
  std::vector<int> count;      // taps per output index
  std::vector<float> weight;   // flattened normalized weights
  int max_taps = 0;
};

Taps make_taps(int in_size, int out_size) {
  Taps t;
  const float scale = static_cast<float>(in_size) / out_size;
  const float support = scale > 1.0f ? scale : 1.0f;
  t.start.resize(out_size);
  t.count.resize(out_size);
  std::vector<std::vector<float>> rows(out_size);
  for (int o = 0; o < out_size; o++) {
    float center = (o + 0.5f) * scale - 0.5f;
    int lo = static_cast<int>(std::floor(center - support)) + 1;
    int hi = static_cast<int>(std::floor(center + support));
    if (lo < 0) lo = 0;
    if (hi > in_size - 1) hi = in_size - 1;
    if (hi < lo) { lo = hi = (center < 0 ? 0 : in_size - 1); }
    float norm = 0.0f;
    std::vector<float> ws;
    for (int i = lo; i <= hi; i++) {
      float d = (i - center) / support;
      float w = 1.0f - (d < 0 ? -d : d);
      if (w < 0) w = 0;
      ws.push_back(w);
      norm += w;
    }
    if (norm <= 0) { ws.assign(ws.size(), 1.0f); norm = ws.size(); }
    for (auto& w : ws) w /= norm;
    t.start[o] = lo;
    t.count[o] = static_cast<int>(ws.size());
    if (t.count[o] > t.max_taps) t.max_taps = t.count[o];
    rows[o] = std::move(ws);
  }
  for (int o = 0; o < out_size; o++)
    for (float w : rows[o]) t.weight.push_back(w);
  return t;
}

void resize_to(const Image& src, int out_h, int out_w, float* out) {
  Taps tx = make_taps(src.width, out_w);
  Taps ty = make_taps(src.height, out_h);

  // Horizontal pass: (H, out_w, 3) f32.
  std::vector<float> tmp(static_cast<size_t>(src.height) * out_w * 3);
  for (int y = 0; y < src.height; y++) {
    const uint8_t* row = src.data.data()
        + static_cast<size_t>(y) * src.width * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    const float* wp = tx.weight.data();
    for (int ox = 0; ox < out_w; ox++) {
      float acc[3] = {0, 0, 0};
      int s = tx.start[ox], n = tx.count[ox];
      for (int k = 0; k < n; k++) {
        float w = wp[k];
        const uint8_t* p = row + (s + k) * 3;
        acc[0] += w * p[0];
        acc[1] += w * p[1];
        acc[2] += w * p[2];
      }
      wp += n;
      trow[ox * 3 + 0] = acc[0];
      trow[ox * 3 + 1] = acc[1];
      trow[ox * 3 + 2] = acc[2];
    }
  }

  // Vertical pass into the output.
  const float inv255 = 1.0f / 255.0f;
  const float* wp = ty.weight.data();
  for (int oy = 0; oy < out_h; oy++) {
    float* orow = out + static_cast<size_t>(oy) * out_w * 3;
    int s = ty.start[oy], n = ty.count[oy];
    for (int ox = 0; ox < out_w * 3; ox++) orow[ox] = 0.0f;
    for (int k = 0; k < n; k++) {
      float w = wp[k];
      const float* trow = tmp.data() + static_cast<size_t>(s + k) * out_w * 3;
      for (int ox = 0; ox < out_w * 3; ox++) orow[ox] += w * trow[ox];
    }
    wp += n;
    for (int ox = 0; ox < out_w * 3; ox++) orow[ox] *= inv255;
  }
}

}  // namespace

extern "C" {

// Decode + resize a batch of images into out (n, out_h, out_w, 3) float32.
// paths: array of n C strings. Returns the number of successfully loaded
// images (failures leave zeros in their slot).
int lsi_load_batch(const char** paths, int n, int out_h, int out_w,
                   float* out, int num_threads) {
  if (num_threads <= 0) num_threads = 4;
  std::atomic<int> next(0), ok_count(0);
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Image img = decode(paths[i]);
      float* dst = out + stride * i;
      if (!img.ok) {
        std::memset(dst, 0, stride * sizeof(float));
        continue;
      }
      resize_to(img, out_h, out_w, dst);
      ok_count.fetch_add(1);
    }
  };

  int t = num_threads < n ? num_threads : n;
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; i++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok_count.load();
}

// Decode one image at native size; caller provides probe call to get dims.
// Returns 1 on success. If out==nullptr, only fills *h/*w (probe mode).
int lsi_decode_image(const char* path, int* h, int* w, uint8_t* out,
                     long out_capacity) {
  Image img = decode(path);
  if (!img.ok) return 0;
  *h = img.height;
  *w = img.width;
  if (out == nullptr) return 1;
  long needed = static_cast<long>(img.height) * img.width * 3;
  if (out_capacity < needed) return 0;
  std::memcpy(out, img.data.data(), needed);
  return 1;
}

// Decode a 16-bit grayscale PNG (SYNTHIA depth) to uint16 centimeters.
// Probe mode when out==nullptr.
int lsi_decode_depth16(const char* path, int* h, int* w, uint16_t* out,
                       long out_capacity) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 0;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return 0;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return 0;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 0;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  png_uint_32 pw = png_get_image_width(png, info);
  png_uint_32 ph = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);
  *h = static_cast<int>(ph);
  *w = static_cast<int>(pw);
  if (out == nullptr) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 1;
  }
  long needed = static_cast<long>(ph) * pw;
  if (out_capacity < needed || color != PNG_COLOR_TYPE_GRAY) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 0;
  }
  if (bit_depth == 16) {
    png_set_swap(png);  // PNG is big-endian; we want host little-endian
    png_read_update_info(png, info);
    std::vector<png_bytep> rows(ph);
    for (png_uint_32 y = 0; y < ph; y++)
      rows[y] = reinterpret_cast<png_bytep>(out + static_cast<size_t>(y) * pw);
    png_read_image(png, rows.data());
  } else {  // 8-bit gray: upscale to the uint16 convention
    std::vector<uint8_t> tmp(static_cast<size_t>(ph) * pw);
    std::vector<png_bytep> rows(ph);
    for (png_uint_32 y = 0; y < ph; y++)
      rows[y] = tmp.data() + static_cast<size_t>(y) * pw;
    png_read_image(png, rows.data());
    for (size_t i = 0; i < tmp.size(); i++)
      out[i] = static_cast<uint16_t>(tmp[i]) * 257;
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 1;
}

}  // extern "C"
