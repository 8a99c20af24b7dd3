// Native I/O runtime for eppm: PPM/PGM image codec, Middlebury .flo
// codec, and a threaded batch frame loader.
//
// The reference's runtime does this in C++ too: PPM loading at
// basic/bao_basic.cpp:137-218 and the Middlebury flowIO (PIEH tag
// 202021.25, little-endian w/h + interleaved uv) in
// 3rdparty/middlebury/flowIO.cpp.  This is a fresh implementation of the
// same formats with a batch path the single-pair reference never needed:
// the streaming pipeline decodes hundreds of frame pairs, and Python-side
// decoding becomes the bottleneck long before the device does.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this toolchain).
// All functions return 0 on success, negative errno-style codes on error.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include <atomic>

namespace {

constexpr float kFloTag = 202021.25f;  // Middlebury "PIEH" sanity tag

// Skip PNM whitespace and '#' comments.
void skip_ws(FILE* f) {
  int c;
  while ((c = fgetc(f)) != EOF) {
    if (c == '#') {
      while ((c = fgetc(f)) != EOF && c != '\n') {
      }
    } else if (!isspace(c)) {
      ungetc(c, f);
      return;
    }
  }
}

bool read_int(FILE* f, long* out) {
  skip_ws(f);
  long v = 0;
  int c = fgetc(f);
  if (c < '0' || c > '9') return false;
  while (c >= '0' && c <= '9') {
    v = v * 10 + (c - '0');
    c = fgetc(f);
  }
  if (c != EOF) ungetc(c, f);
  *out = v;
  return true;
}

struct PnmHeader {
  int magic;  // 5 or 6
  long w, h, maxval;
  long data_off;
};

int parse_pnm_header(FILE* f, PnmHeader* hd) {
  int c0 = fgetc(f), c1 = fgetc(f);
  if (c0 != 'P' || (c1 != '5' && c1 != '6')) return -1;
  hd->magic = c1 - '0';
  if (!read_int(f, &hd->w) || !read_int(f, &hd->h) ||
      !read_int(f, &hd->maxval))
    return -2;
  if (hd->w <= 0 || hd->h <= 0 || hd->maxval <= 0 || hd->maxval > 65535)
    return -3;
  int c = fgetc(f);  // single whitespace before raster
  if (c == EOF) return -4;
  hd->data_off = ftell(f);
  return 0;
}

}  // namespace

extern "C" {

// ---- PPM/PGM -----------------------------------------------------------

// Probe dims: channels = 3 (P6) or 1 (P5); bytes_per_sample 1 or 2.
int eppm_ppm_probe(const char* path, int* h, int* w, int* channels,
                   int* bytes_per_sample) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  PnmHeader hd;
  int rc = parse_pnm_header(f, &hd);
  fclose(f);
  if (rc) return rc - 10;
  *h = (int)hd.h;
  *w = (int)hd.w;
  *channels = hd.magic == 6 ? 3 : 1;
  *bytes_per_sample = hd.maxval > 255 ? 2 : 1;
  return 0;
}

// Read into a caller-allocated uint8 buffer of h*w*channels (maxval<=255)
// or uint16 buffer (maxval>255; big-endian per spec, converted to host).
int eppm_ppm_read(const char* path, void* out, int h, int w, int channels,
                  int bytes_per_sample) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  PnmHeader hd;
  int rc = parse_pnm_header(f, &hd);
  if (rc) {
    fclose(f);
    return rc - 10;
  }
  int want_c = hd.magic == 6 ? 3 : 1;
  int want_b = hd.maxval > 255 ? 2 : 1;
  if (hd.h != h || hd.w != w || want_c != channels ||
      want_b != bytes_per_sample) {
    fclose(f);
    return -20;
  }
  size_t n = (size_t)h * w * channels;
  size_t got = fread(out, bytes_per_sample, n, f);
  fclose(f);
  if (got != n) return -21;
  if (bytes_per_sample == 2) {  // big-endian -> host (little) in place
    uint16_t* p = (uint16_t*)out;
    for (size_t i = 0; i < n; i++) p[i] = (uint16_t)((p[i] >> 8) | (p[i] << 8));
  }
  return 0;
}

int eppm_ppm_write(const char* path, const uint8_t* data, int h, int w,
                   int channels) {
  if (channels != 1 && channels != 3) return -2;
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "P%d\n%d %d\n255\n", channels == 3 ? 6 : 5, w, h);
  size_t n = (size_t)h * w * channels;
  size_t put = fwrite(data, 1, n, f);
  fclose(f);
  return put == n ? 0 : -21;
}

// Threaded batch read: n same-shaped uint8 frames into one contiguous
// buffer (n, h, w, c).  Returns 0 if every frame decoded, else the
// negative index-1 of the first failing frame.
int eppm_ppm_read_batch(const char** paths, int n, uint8_t* out, int h,
                        int w, int channels, int nthreads) {
  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads > n) nthreads = n > 0 ? n : 1;
  std::atomic<int> next(0), fail(0);
  size_t frame = (size_t)h * w * channels;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = eppm_ppm_read(paths[i], out + frame * i, h, w, channels, 1);
      if (rc) {
        int expected = 0;
        fail.compare_exchange_strong(expected, -(i + 1));
      }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
  return fail.load();
}

// ---- Middlebury .flo ----------------------------------------------------

int eppm_flo_probe(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  float tag;
  int32_t wi, hi;
  if (fread(&tag, 4, 1, f) != 1 || fread(&wi, 4, 1, f) != 1 ||
      fread(&hi, 4, 1, f) != 1) {
    fclose(f);
    return -2;
  }
  fclose(f);
  if (tag != kFloTag) return -3;
  if (wi <= 0 || hi <= 0 || wi > 99999 || hi > 99999) return -4;
  *w = wi;
  *h = hi;
  return 0;
}

int eppm_flo_read(const char* path, float* out, int h, int w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  float tag;
  int32_t wi, hi;
  if (fread(&tag, 4, 1, f) != 1 || fread(&wi, 4, 1, f) != 1 ||
      fread(&hi, 4, 1, f) != 1 || tag != kFloTag || wi != w || hi != h) {
    fclose(f);
    return -2;
  }
  size_t n = (size_t)h * w * 2;
  size_t got = fread(out, 4, n, f);
  fclose(f);
  return got == n ? 0 : -3;
}

// ---- PNG scanline unfilter ---------------------------------------------
//
// Undo PNG row filters (spec: RFC 2083 section 6) for the KITTI 16-bit
// flow PNG reader (eppm/io/kitti.py).  Average/Paeth predictors are
// sequentially dependent along the row, which makes them pathologically
// slow in Python; here each row is a trivial linear pass.
// `raw` is the zlib-inflated IDAT stream: h rows of (1 filter byte +
// `stride` data bytes).  Returns 0, or a negative code on a short buffer
// or unknown filter type.

int eppm_png_unfilter(const uint8_t* raw, long raw_len, int h, int stride,
                      int bpp, uint8_t* out) {
  if ((long)h * (stride + 1) > raw_len) return -1;
  const uint8_t* prev = nullptr;
  long pos = 0;
  for (int y = 0; y < h; ++y) {
    int ft = raw[pos++];
    uint8_t* cur = out + (long)y * stride;
    memcpy(cur, raw + pos, stride);
    pos += stride;
    switch (ft) {
      case 0:
        break;
      case 1:  // Sub
        for (int i = bpp; i < stride; ++i)
          cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
        break;
      case 2:  // Up
        if (prev)
          for (int i = 0; i < stride; ++i)
            cur[i] = (uint8_t)(cur[i] + prev[i]);
        break;
      case 3:  // Average
        for (int i = 0; i < stride; ++i) {
          int left = i >= bpp ? cur[i - bpp] : 0;
          int up = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(cur[i] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(cur[i] + pred);
        }
        break;
      default:
        return -2;
    }
    prev = cur;
  }
  return 0;
}

int eppm_flo_write(const char* path, const float* data, int h, int w) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  int32_t wi = w, hi = h;
  float tag = kFloTag;
  if (fwrite(&tag, 4, 1, f) != 1 || fwrite(&wi, 4, 1, f) != 1 ||
      fwrite(&hi, 4, 1, f) != 1) {
    fclose(f);
    return -2;
  }
  size_t n = (size_t)h * w * 2;
  size_t put = fwrite(data, 4, n, f);
  fclose(f);
  return put == n ? 0 : -3;
}

}  // extern "C"
