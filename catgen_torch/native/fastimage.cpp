// A copy of native/fastimage.cpp, the native fill path of catgen's image
// cache (catgen/data/native_decode.py), for catgen_torch's loader
// (catgen_torch/data/native_decode.py builds it at first use). Keep the two
// files' code the same: the port's loader decodes the same bits as
// catgen's.
//
// fastimage — multithreaded JPEG decode + bilinear resize for the host
// input pipeline.
//
// The reference's train-time loader decodes JPEGs one by one in Lua on the
// host every epoch (dataset.lua:123-150, via the torch
// `image` package's libjpeg binding). catgen decodes each file once into a
// pinned uint8 RAM cache (catgen/data/loader.py); this library is the
// native fill path for that cache: a worker-thread pool decoding with
// libjpeg and resizing to the cache resolution, ~#cores times faster than
// the PIL fallback. Exposed as a plain C ABI for ctypes (no pybind11 in
// this image).
//
// Build: catgen_torch/data/native_decode.py::build_library (the host's C++
// compiler, -ljpeg, into catgen_torch/_build/)

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
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

// Decodes one JPEG file into an RGB buffer; returns true on success.
bool decode_jpeg(const char* path, std::vector<uint8_t>& rgb, int& width,
                 int& height) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  width = static_cast<int>(cinfo.output_width);
  height = static_cast<int>(cinfo.output_height);
  const int stride = width * 3;
  rgb.resize(static_cast<size_t>(stride) * height);

  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Bilinear resize (align-corners) RGB -> size x size.
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  const float ys = dh > 1 ? static_cast<float>(sh - 1) / (dh - 1) : 0.f;
  const float xs = dw > 1 ? static_cast<float>(sw - 1) / (dw - 1) : 0.f;
  for (int y = 0; y < dh; ++y) {
    float fy = y * ys;
    int y0 = static_cast<int>(fy);
    if (y0 > sh - 2) y0 = sh - 2 < 0 ? 0 : sh - 2;
    float wy = fy - y0;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    for (int x = 0; x < dw; ++x) {
      float fx = x * xs;
      int x0 = static_cast<int>(fx);
      if (x0 > sw - 2) x0 = sw - 2 < 0 ? 0 : sw - 2;
      float wx = fx - x0;
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      for (int c = 0; c < 3; ++c) {
        const float v00 = src[(static_cast<size_t>(y0) * sw + x0) * 3 + c];
        const float v01 = src[(static_cast<size_t>(y0) * sw + x1) * 3 + c];
        const float v10 = src[(static_cast<size_t>(y1) * sw + x0) * 3 + c];
        const float v11 = src[(static_cast<size_t>(y1) * sw + x1) * 3 + c];
        const float top = v00 + (v01 - v00) * wx;
        const float bot = v10 + (v11 - v10) * wx;
        const float v = top + (bot - top) * wy;
        dst[(static_cast<size_t>(y) * dw + x) * 3 + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decodes n JPEGs into out (n, size, size, 3) uint8 using `threads`
// workers. Failed files are zero-filled and recorded as 0 in `ok` (may be
// null). Returns the number of successfully decoded files.
int fi_decode_batch(const char** paths, int n, int size, uint8_t* out,
                    uint8_t* ok, int threads) {
  if (threads <= 0) threads = static_cast<int>(std::thread::hardware_concurrency());
  if (threads < 1) threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> good{0};
  const size_t frame = static_cast<size_t>(size) * size * 3;

  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, h = 0;
      uint8_t* dst = out + frame * i;
      if (decode_jpeg(paths[i], rgb, w, h) && w > 0 && h > 0) {
        resize_bilinear(rgb.data(), h, w, dst, size, size);
        if (ok) ok[i] = 1;
        good.fetch_add(1);
      } else {
        std::memset(dst, 0, frame);
        if (ok) ok[i] = 0;
      }
    }
  };

  std::vector<std::thread> pool;
  const int nt = threads < n ? threads : (n > 0 ? n : 1);
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return good.load();
}

// Version tag for the ctypes wrapper's sanity check.
int fi_abi_version() { return 1; }

}  // extern "C"
