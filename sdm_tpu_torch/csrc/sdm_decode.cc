// Native batched image decoder for the sdm_tpu_torch data pipeline (the
// port's own copy of the JAX package's csrc/sdm_decode.cc).
//
// Decodes a whole training batch of JPEG/PNG files straight into one
// contiguous NHWC uint8 buffer with a C++ thread pool: no Python threads,
// no per-image numpy allocations, no collate copy. Output matches
// cv2.imread() semantics (BGR channel order, alpha dropped, grayscale
// replicated to 3 channels), the reference's loading contract
// (custom_dataset/img_dataset.py:26-29); the Python side
// (sdm_tpu_torch/data/native.py) checks bit-identity against cv2 on a
// canary before routing any real batch here.
//
// Build (sdm_tpu_torch/data/native.py does this on demand, into
// sdm_tpu_torch/csrc/build/):
//   g++ -O2 -shared -fPIC -o libsdm_decode.so sdm_decode.cc -ljpeg -lpng

#include <atomic>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Buf {
  std::vector<unsigned char> data;
};

bool read_file(const char* path, Buf* buf, std::string* err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { *err = std::string("cannot open: ") + path; return false; }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) { std::fclose(f); *err = std::string("empty file: ") + path; return false; }
  buf->data.resize(static_cast<size_t>(n));
  size_t got = std::fread(buf->data.data(), 1, buf->data.size(), f);
  std::fclose(f);
  if (got != buf->data.size()) { *err = std::string("short read: ") + path; return false; }
  return true;
}

bool is_jpeg(const Buf& b) {
  return b.data.size() >= 2 && b.data[0] == 0xFF && b.data[1] == 0xD8;
}
bool is_png(const Buf& b) {
  static const unsigned char sig[4] = {0x89, 'P', 'N', 'G'};
  return b.data.size() >= 4 && std::memcmp(b.data.data(), sig, 4) == 0;
}

// ---------- JPEG (libjpeg-turbo, direct-to-BGR) ----------

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
  char msg[JMSG_LENGTH_MAX];
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, e->msg);
  longjmp(e->jb, 1);
}

// Decode to BGR uint8. When out==nullptr only probes dimensions.
bool decode_jpeg(const Buf& b, const char* path, unsigned char* out,
                 int* h, int* w, int expect_h, int expect_w,
                 std::string* err) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    *err = std::string(path) + ": " + jerr.msg;
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, b.data.data(), static_cast<unsigned long>(b.data.size()));
  jpeg_read_header(&cinfo, TRUE);
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  if (!out) { jpeg_destroy_decompress(&cinfo); return true; }
  if (*h != expect_h || *w != expect_w) {
    jpeg_destroy_decompress(&cinfo);
    char d[128];
    std::snprintf(d, sizeof d, ": size %dx%d != batch %dx%d", *h, *w,
                  expect_h, expect_w);
    *err = std::string(path) + d;
    return false;
  }
  cinfo.out_color_space = JCS_EXT_BGR;  // libjpeg-turbo; handles gray too
  jpeg_start_decompress(&cinfo);
  const int stride = expect_w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------- PNG (libpng simplified API) ----------

bool decode_png(const Buf& b, const char* path, unsigned char* out,
                int* h, int* w, int expect_h, int expect_w,
                std::string* err) {
  png_image image;
  std::memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, b.data.data(), b.data.size())) {
    *err = std::string(path) + ": " + image.message;
    return false;
  }
  *h = static_cast<int>(image.height);
  *w = static_cast<int>(image.width);
  if (!out) { png_image_free(&image); return true; }
  if (*h != expect_h || *w != expect_w) {
    png_image_free(&image);
    char d[128];
    std::snprintf(d, sizeof d, ": size %dx%d != batch %dx%d", *h, *w,
                  expect_h, expect_w);
    *err = std::string(path) + d;
    return false;
  }
  const bool has_alpha = (image.format & PNG_FORMAT_FLAG_ALPHA) != 0;
  if (!has_alpha) {
    image.format = PNG_FORMAT_BGR;  // gray is replicated, like cv2
    if (!png_image_finish_read(&image, nullptr, out, expect_w * 3, nullptr)) {
      *err = std::string(path) + ": " + image.message;
      return false;
    }
    return true;
  }
  // Alpha present: cv2.imread(IMREAD_COLOR) DROPS alpha (no compositing),
  // while libpng's non-alpha formats composite — so read BGRA and strip.
  image.format = PNG_FORMAT_BGRA;
  std::vector<unsigned char> tmp(static_cast<size_t>(expect_h) * expect_w * 4);
  if (!png_image_finish_read(&image, nullptr, tmp.data(), expect_w * 4, nullptr)) {
    *err = std::string(path) + ": " + image.message;
    return false;
  }
  const size_t npix = static_cast<size_t>(expect_h) * expect_w;
  for (size_t i = 0; i < npix; ++i) {
    out[i * 3 + 0] = tmp[i * 4 + 0];
    out[i * 3 + 1] = tmp[i * 4 + 1];
    out[i * 3 + 2] = tmp[i * 4 + 2];
  }
  return true;
}

bool decode_one(const char* path, unsigned char* out, int* h, int* w,
                int expect_h, int expect_w, std::string* err) {
  Buf b;
  if (!read_file(path, &b, err)) return false;
  if (is_jpeg(b)) return decode_jpeg(b, path, out, h, w, expect_h, expect_w, err);
  if (is_png(b))  return decode_png(b, path, out, h, w, expect_h, expect_w, err);
  *err = std::string(path) + ": unsupported format (not JPEG/PNG)";
  return false;
}

void set_err(char* errbuf, int errbuf_len, const std::string& msg) {
  if (errbuf && errbuf_len > 0) {
    std::snprintf(errbuf, static_cast<size_t>(errbuf_len), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// Probe dimensions without a full decode. Returns 0 on success.
int sdm_probe(const char* path, int* h, int* w,
              char* errbuf, int errbuf_len) {
  std::string err;
  if (!decode_one(path, nullptr, h, w, 0, 0, &err)) {
    set_err(errbuf, errbuf_len, err);
    return -1;
  }
  return 0;
}

// Decode n files into out (n * h * w * 3 bytes, NHWC BGR uint8) with a
// thread pool. Every file must decode to exactly (h, w). Returns 0 on
// success; on failure writes the first error into errbuf and returns -1
// (out contents are then unspecified).
int sdm_decode_batch(const char* const* paths, int n, int h, int w,
                     unsigned char* out, int num_threads,
                     char* errbuf, int errbuf_len) {
  if (n <= 0 || h <= 0 || w <= 0) {
    set_err(errbuf, errbuf_len, "bad arguments");
    return -1;
  }
  const size_t img_bytes = static_cast<size_t>(h) * w * 3;
  unsigned hc = std::thread::hardware_concurrency();
  int nt = num_threads > 0 ? num_threads : static_cast<int>(hc ? hc : 1);
  if (nt > n) nt = n;

  std::atomic<int> next(0);
  std::atomic<bool> failed(false);
  std::mutex err_mu;
  std::string first_err;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load(std::memory_order_relaxed)) return;
      int ih = 0, iw = 0;
      std::string err;
      if (!decode_one(paths[i], out + img_bytes * i, &ih, &iw, h, w, &err)) {
        std::lock_guard<std::mutex> g(err_mu);
        if (!failed.exchange(true)) first_err = err;
        return;
      }
    }
  };

  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(nt));
    for (int i = 0; i < nt; ++i) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  if (failed.load()) {
    set_err(errbuf, errbuf_len, first_err);
    return -1;
  }
  return 0;
}

}  // extern "C"
