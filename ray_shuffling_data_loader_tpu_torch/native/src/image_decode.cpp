// Native batch image decoder for the ImageNet-Parquet workload (the
// PyTorch port's own copy of the JAX package's decoder).
//
// The shuffle reducers decode encoded image bytes into fixed-shape pixel
// columns (workloads/imagenet.py). A Python/PIL loop decodes one image at
// a time under interpreter dispatch; this decodes a whole reducer batch
// with a thread pool over libjpeg/libpng directly. Built with g++ at first
// use by native/image.py.
//
// API (C, ctypes-friendly):
//   rsdl_decode_images(srcs, sizes, n, height, width, out, nthreads)
//     srcs:  n pointers to encoded payloads (JPEG or PNG, by magic bytes)
//     out:   n * height * width * 3 uint8, RGB, C-order
//     returns 0 on success, i+1 if payload i failed to decode or had the
//     wrong dimensions (first failing index wins best-effort).
//
// Build: g++ -O2 -shared -fPIC image_decode.cpp -ljpeg -lpng

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  std::jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* mgr = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  std::longjmp(mgr->jump, 1);
}

// Returns true on success; decodes RGB into dst (height*width*3).
bool decode_jpeg(const uint8_t* src, int64_t size, int64_t height,
                 int64_t width, uint8_t* dst) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = jpeg_error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(src),
               static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_width != static_cast<JDIMENSION>(width) ||
      cinfo.output_height != static_cast<JDIMENSION>(height) ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = dst + int64_t(cinfo.output_scanline) * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(const uint8_t* src, int64_t size, int64_t height,
                int64_t width, uint8_t* dst) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, src,
                                        static_cast<size_t>(size))) {
    return false;
  }
  image.format = PNG_FORMAT_RGB;
  if (image.width != static_cast<png_uint_32>(width) ||
      image.height != static_cast<png_uint_32>(height)) {
    png_image_free(&image);
    return false;
  }
  if (!png_image_finish_read(&image, nullptr, dst, 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}

bool decode_one(const uint8_t* src, int64_t size, int64_t height,
                int64_t width, uint8_t* dst) {
  if (size >= 3 && src[0] == 0xFF && src[1] == 0xD8 && src[2] == 0xFF) {
    return decode_jpeg(src, size, height, width, dst);
  }
  if (size >= 8 && src[0] == 0x89 && src[1] == 'P' && src[2] == 'N' &&
      src[3] == 'G') {
    return decode_png(src, size, height, width, dst);
  }
  return false;
}

}  // namespace

extern "C" {

int64_t rsdl_decode_images(const uint8_t* const* srcs, const int64_t* sizes,
                           int64_t n, int64_t height, int64_t width,
                           uint8_t* out, int nthreads) {
  if (n == 0) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = static_cast<int>(n);
  const int64_t row_bytes = height * width * 3;
  std::atomic<int64_t> failed{0};  // i+1 of a failing payload, 0 = none

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (failed.load(std::memory_order_relaxed)) return;
      if (!decode_one(srcs[i], sizes[i], height, width,
                      out + i * row_bytes)) {
        int64_t expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
        return;
      }
    }
  };

  if (nthreads == 1) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    const int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      const int64_t lo = t * chunk;
      const int64_t hi = std::min(n, lo + chunk);
      if (lo >= hi) break;
      threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  return failed.load();
}

}  // extern "C"
