// Native depth-image I/O: 16-bit grayscale PNG codec + batch loader.
//
// The port's copy of the JAX package's codec (voxelhashing_demo_tpu/
// native/depthio.cpp), host code with a plain C interface: a small PNG16
// codec on zlib, and a multi-threaded batch decoder for dataset streaming
// (utils/stream.py).  kernels.build_host compiles it with the host C++
// compiler into _build/ at first use; utils/io.py binds it with ctypes.
//
// Supports the TUM RGB-D depth format: 8/16-bit grayscale, non-interlaced,
// all five PNG scanline filters.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
#include <atomic>
#include <zlib.h>

namespace {

constexpr uint8_t kPngSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void wbe32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24);
  p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);
  p[3] = uint8_t(v);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Undo PNG scanline filtering in place over raw inflated data.
bool unfilter(std::vector<uint8_t>& raw, int width, int height, int bpp) {
  const size_t stride = size_t(width) * bpp;
  if (raw.size() < (stride + 1) * height) return false;
  std::vector<uint8_t> out(stride * height);
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = raw.data() + (stride + 1) * y;
    uint8_t filter = src[0];
    ++src;
    uint8_t* dst = out.data() + stride * y;
    const uint8_t* prior = y > 0 ? dst - stride : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = prior ? prior[x] : 0;
      int c = (prior && x >= size_t(bpp)) ? prior[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v);
    }
  }
  raw.swap(out);
  raw.resize(stride * height);
  return true;
}

}  // namespace

extern "C" {

// Probe dimensions.  Returns 0 on success.
int png16_info(const uint8_t* buf, size_t n, int* width, int* height,
               int* bit_depth) {
  if (n < 33 || memcmp(buf, kPngSig, 8) != 0) return -1;
  if (be32(buf + 8) < 13 || memcmp(buf + 12, "IHDR", 4) != 0) return -2;
  *width = int(be32(buf + 16));
  *height = int(be32(buf + 20));
  *bit_depth = buf[24];
  int color_type = buf[25];
  if (color_type != 0) return -3;  // grayscale only
  if (*bit_depth != 8 && *bit_depth != 16) return -4;
  if (buf[28] != 0) return -5;     // no interlace
  return 0;
}

// Decode a grayscale PNG into uint16 row-major pixels (8-bit widened).
// out must hold width*height uint16.  Returns 0 on success.
int png16_decode(const uint8_t* buf, size_t n, uint16_t* out) {
  int width, height, bit_depth;
  int rc = png16_info(buf, n, &width, &height, &bit_depth);
  if (rc != 0) return rc;
  const int bpp = bit_depth / 8;

  // concatenate IDAT payloads
  std::vector<uint8_t> compressed;
  size_t off = 8;
  while (off + 12 <= n) {
    uint32_t len = be32(buf + off);
    const uint8_t* type = buf + off + 4;
    if (off + 12 + len > n) return -6;
    if (memcmp(type, "IDAT", 4) == 0) {
      compressed.insert(compressed.end(), buf + off + 8, buf + off + 8 + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + len;
  }
  if (compressed.empty()) return -7;

  std::vector<uint8_t> raw((size_t(width) * bpp + 1) * height);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, compressed.data(),
                 compressed.size()) != Z_OK) {
    return -8;
  }
  if (!unfilter(raw, width, height, bpp)) return -9;

  const size_t npx = size_t(width) * height;
  if (bit_depth == 16) {
    for (size_t i = 0; i < npx; ++i) {
      out[i] = uint16_t((raw[2 * i] << 8) | raw[2 * i + 1]);  // big-endian
    }
  } else {
    for (size_t i = 0; i < npx; ++i) out[i] = uint16_t(raw[i]) << 8 | raw[i];
  }
  return 0;
}

// Encode uint16 pixels as a 16-bit grayscale PNG.  out_cap is the capacity
// of out; on success returns the number of bytes written (>0), else <0.
long png16_encode(const uint16_t* pixels, int width, int height,
                  uint8_t* out, size_t out_cap) {
  const size_t stride = size_t(width) * 2;
  std::vector<uint8_t> raw((stride + 1) * height);
  for (int y = 0; y < height; ++y) {
    uint8_t* row = raw.data() + (stride + 1) * y;
    row[0] = 0;  // filter: none
    for (int x = 0; x < width; ++x) {
      uint16_t v = pixels[size_t(y) * width + x];
      row[1 + 2 * x] = uint8_t(v >> 8);
      row[2 + 2 * x] = uint8_t(v);
    }
  }
  uLongf comp_cap = compressBound(raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(), 6) != Z_OK) {
    return -1;
  }

  const size_t total = 8 + 25 + (12 + comp_cap) + 12;
  if (out_cap < total) return -2;
  uint8_t* p = out;
  memcpy(p, kPngSig, 8);
  p += 8;
  // IHDR
  wbe32(p, 13);
  memcpy(p + 4, "IHDR", 4);
  wbe32(p + 8, uint32_t(width));
  wbe32(p + 12, uint32_t(height));
  p[16] = 16;  // bit depth
  p[17] = 0;   // grayscale
  p[18] = p[19] = p[20] = 0;
  wbe32(p + 21, crc32(0, p + 4, 17));
  p += 25;
  // IDAT
  wbe32(p, uint32_t(comp_cap));
  memcpy(p + 4, "IDAT", 4);
  memcpy(p + 8, comp.data(), comp_cap);
  wbe32(p + 8 + comp_cap, crc32(crc32(0, p + 4, 4), comp.data(), comp_cap));
  p += 12 + comp_cap;
  // IEND
  wbe32(p, 0);
  memcpy(p + 4, "IEND", 4);
  wbe32(p + 8, crc32(0, p + 4, 4));
  p += 12;
  return long(p - out);
}

// Decode a batch of PNG files concurrently (the dataset prefetch path).
// paths: array of C strings; out: batch-major uint16 buffer of
// width*height per image (caller-probed, uniform size).  Returns 0 if all
// succeeded, else a negative count of failures.
int png16_decode_batch(const char** paths, int count, int width, int height,
                       uint16_t* out, int num_threads) {
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  const size_t npx = size_t(width) * height;
  if (num_threads <= 0) {
    num_threads = int(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 4;
  }
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= count) return;
      FILE* f = fopen(paths[i], "rb");
      if (!f) {
        failures.fetch_add(1);
        continue;
      }
      fseek(f, 0, SEEK_END);
      long sz = ftell(f);
      fseek(f, 0, SEEK_SET);
      std::vector<uint8_t> buf(static_cast<size_t>(sz), 0);
      size_t rd = fread(buf.data(), 1, size_t(sz), f);
      fclose(f);
      // the image must match the caller's buffer pitch exactly: decoding
      // a differently-sized PNG into the slot would scramble rows
      int w = 0, h = 0, bd = 0;
      if (rd != size_t(sz) ||
          png16_info(buf.data(), buf.size(), &w, &h, &bd) != 0 ||
          w != width || h != height ||
          png16_decode(buf.data(), buf.size(), out + npx * i) != 0) {
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return -failures.load();
}

}  // extern "C"
