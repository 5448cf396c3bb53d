// Native PNG RGB8 encoder (zlib). C ABI consumed via ctypes from
// sdtpu_torch/runtime/__init__.py. Mirrors the role of the Rust `image`
// crate in the reference (src/bin/sample/main.rs:116-125); the pure-Python
// encoder in sdtpu_torch/utils/image.py is the portable fallback.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <zlib.h>

namespace {

inline void put_u32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}

size_t chunk(uint8_t* dst, const char tag[4], const uint8_t* data, size_t len) {
  put_u32(dst, static_cast<uint32_t>(len));
  memcpy(dst + 4, tag, 4);
  if (len) memcpy(dst + 8, data, len);
  uLong crc = crc32(0L, dst + 4, static_cast<uInt>(4 + len));
  put_u32(dst + 8 + len, static_cast<uint32_t>(crc));
  return 12 + len;
}

}  // namespace

extern "C" {

void sdtpu_free(void* p) { free(p); }

// img: h*w*3 RGB8 rows. On success returns 0 and sets *out/*out_len
// (caller frees with sdtpu_free).
int sdtpu_png_encode_rgb8(const uint8_t* img, int h, int w,
                          uint8_t** out, size_t* out_len) {
  if (!img || h <= 0 || w <= 0) return -1;
  const size_t stride = static_cast<size_t>(w) * 3;
  const size_t raw_len = (stride + 1) * h;

  uint8_t* raw = static_cast<uint8_t*>(malloc(raw_len));
  if (!raw) return -2;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw + y * (stride + 1);
    row[0] = 0;  // filter: None
    memcpy(row + 1, img + y * stride, stride);
  }

  uLongf comp_cap = compressBound(static_cast<uLong>(raw_len));
  uint8_t* comp = static_cast<uint8_t*>(malloc(comp_cap));
  if (!comp) { free(raw); return -2; }
  if (compress2(comp, &comp_cap, raw, static_cast<uLong>(raw_len), 6) != Z_OK) {
    free(raw); free(comp); return -3;
  }
  free(raw);

  // signature + IHDR(13) + IDAT(comp) + IEND
  size_t total = 8 + (12 + 13) + (12 + comp_cap) + 12;
  uint8_t* png = static_cast<uint8_t*>(malloc(total));
  if (!png) { free(comp); return -2; }

  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  memcpy(png, sig, 8);
  size_t off = 8;

  uint8_t ihdr[13];
  put_u32(ihdr, static_cast<uint32_t>(w));
  put_u32(ihdr + 4, static_cast<uint32_t>(h));
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  off += chunk(png + off, "IHDR", ihdr, 13);
  off += chunk(png + off, "IDAT", comp, comp_cap);
  off += chunk(png + off, "IEND", nullptr, 0);
  free(comp);

  *out = png;
  *out_len = off;
  return 0;
}

}  // extern "C"
