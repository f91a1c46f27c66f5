// BMP, PNM (P1-P6) and PAM (P7) decoding for the data library, as OpenCV's
// own readers (grfmt_bmp.cpp, grfmt_pxm.cpp, grfmt_pam.cpp in OpenCV 5)
// decode them for cv2.imdecode, so that the pixels equal OpenCV's bit for
// bit:
//   - BMP: the BITMAPCOREHEADER (OS/2, 12 bytes) and BITMAPINFOHEADER and
//     its V4 / V5 successors; 1, 4 and 8 bits through the palette, RLE4 and
//     RLE8 with OpenCV's reading of the end-of-line, end-of-bitmap, delta
//     (a run of palette entry 0 in raster order) and absolute escapes; 16
//     bits as 555 or 565 (BI_BITFIELDS with those masks, read after the
//     header), 24 bits, 32 bits (the fourth byte dropped; through the R,
//     G, B masks of a BI_BITFIELDS V4 / V5 header, byte-wide ones only);
//     bottom-up and top-down rows. Gray is OpenCV's own icvCvt_BGR2Gray
//     (14-bit weights 4899, 9617, 1868), of the palette for palette
//     images, and for a masked 32-bit file OpenCV's float weights
//     (0.299, 0.587, 0.114) truncated.
//   - PNM: P1-P6, ASCII and binary, '#' comments; an ASCII sample is scaled
//     by 255 / maxval (and clamped to maxval), a binary one is taken as it
//     is; a 16-bit sample (maxval > 255) is cut to its high byte; P1 / P4
//     bits are black for 1. P3 / P6 are RGB: swapped to BGR, and turned to
//     gray by the 14-bit weights.
//   - PAM: P7 with WIDTH / HEIGHT / DEPTH / MAXVAL / TUPLTYPE / ENDHDR;
//     depth 1 (GRAYSCALE, BLACKANDWHITE or none) and depth 3 (RGB or none),
//     8 or 16 bits, and OpenCV's bit mode for maxval 1 (the first
//     ceil(width / 8) bytes of each row read as packed bits). OpenCV reads a
//     3-channel PAM in file order (no swap) but turns it to gray as RGB.
//     The *_ALPHA tuple types are refused: OpenCV 5.0's reader converts
//     only part of each row and leaves the rest of the image unwritten.
// Truncated data is refused, as OpenCV refuses it.

#include "image_codec.h"

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

using cris::Fault;
using cris::Image;
using cris::fail;

using cris::check_size;
using cris::gray14;

struct Stream {
  const uint8_t* p;
  size_t n, pos = 0;
  const char* what;
  Stream(const uint8_t* data, size_t size, const char* name)
      : p(data), n(size), what(name) {}
  [[noreturn]] void eof() const {
    throw Fault(std::string(what) + ": unexpected end of data");
  }
  int byte() {
    if (pos >= n) eof();
    return p[pos++];
  }
  uint32_t word() {
    const uint32_t lo = (uint32_t)byte();
    return lo | (uint32_t)byte() << 8;
  }
  uint32_t dword() {
    const uint32_t lo = word();
    return lo | word() << 16;
  }
  const uint8_t* bytes(size_t k) {
    if (k > n - pos || pos > n) eof();
    const uint8_t* q = p + pos;
    pos += k;
    return q;
  }
  void skip(size_t k) { bytes(k); }
};

Image make(int h, int w, bool gray) {
  Image img;
  img.height = h;
  img.width = w;
  img.channels = gray ? 1 : 3;
  img.pixels.assign((size_t)h * w * img.channels, 0);
  return img;
}

// ---------------------------------------------------------------- BMP

struct Pal {
  uint8_t b, g, r, a;
};

// A BMP's pixel rows: row y of the file goes to row (bottom-up ? h-1-y :
// y) of the image; x3 is the byte position in it (nch bytes a pixel).
struct BmpOut {
  Image& img;
  int nch, width3, h;
  bool bottom_up;
  int y = 0, x3 = 0;
  uint8_t* row() {
    const int r = bottom_up ? h - 1 - y : y;
    return &img.pixels[(size_t)r * width3];
  }
  void put(const Pal& c, uint8_t gray) {
    uint8_t* d = row() + x3;
    if (nch == 3) {
      d[0] = c.b;
      d[1] = c.g;
      d[2] = c.r;
    } else {
      d[0] = gray;
    }
    x3 += nch;
  }
  // FillUniColor / FillUniGray: count3 bytes of one colour in raster
  // order, wrapping to the next row; stops after the last row.
  void fill(int count3, const Pal& c, uint8_t gray) {
    do {
      int end = x3 + count3;
      if (end > width3) end = width3;
      count3 -= end - x3;
      while (x3 < end) put(c, gray);
      if (x3 >= width3) {
        x3 = 0;
        if (++y >= h) break;
      }
    } while (count3 > 0);
  }
};

Image decode_bmp_impl(const uint8_t* data, size_t size, bool gray) {
  Stream s(data, size, "BMP");
  s.skip(10);
  const uint32_t offset = s.dword();
  const int hsize = (int)s.dword();
  if (hsize <= 0) fail("BMP: bad header size");
  int width = 0, height = 0, bpp = 0, rle = 0;
  bool ok = false;
  Pal palette[256] = {};
  int shift[3] = {16, 8, 0};  // R, G, B of a 32-bit pixel
  bool masked = false;
  if (hsize >= 36) {
    width = (int)s.dword();
    height = (int)s.dword();
    bpp = (int)(s.dword() >> 16);
    rle = (int)s.dword();
    if (rle < 0 || rle > 3) fail("BMP: compression %d is not supported", rle);
    s.skip(12);
    const int clrused = (int)s.dword();
    if (bpp == 32 && rle == 3 && hsize >= 56) {
      // OpenCV reads the R, G, B (and A) masks of a 32-bit BI_BITFIELDS
      // file only here; it decodes byte-wide, byte-aligned ones exactly
      s.skip(4);
      for (int c = 0; c < 3; ++c) {
        const uint32_t m = s.dword();
        int k = 0;
        while (k < 32 && m != (0xffu << k)) k += 8;
        if (k >= 32) fail("BMP: 32-bit channel mask 0x%08X is not supported", (int)m);
        shift[c] = k;
      }
      s.skip(4);
      masked = true;
    } else {
      s.skip((size_t)(hsize - 36));
    }
    if (width > 0 && height != 0 &&
        (((bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32) && rle == 0) ||
         ((bpp == 16 || bpp == 32) && (rle == 0 || rle == 3)) ||
         (bpp == 4 && rle == 2) || (bpp == 8 && rle == 1))) {
      ok = true;
      if (bpp <= 8) {
        if (clrused < 0 || clrused > 256) fail("BMP: %d palette entries", clrused);
        const int n = clrused == 0 ? 1 << bpp : clrused;
        const uint8_t* p = s.bytes((size_t)n * 4);
        std::memcpy(palette, p, (size_t)n * 4);
      } else if (bpp == 16 && rle == 3) {
        const uint32_t rm = s.dword(), gm = s.dword(), bm = s.dword();
        if (bm == 0x1f && gm == 0x3e0 && rm == 0x7c00) {
          bpp = 15;
        } else if (!(bm == 0x1f && gm == 0x7e0 && rm == 0xf800)) {
          fail("BMP: 16-bit masks other than 555 and 565 are not supported");
        }
      } else if (bpp == 16) {
        bpp = 15;
      }
    }
  } else if (hsize == 12) {
    width = (int)s.word();
    height = (int)s.word();
    bpp = (int)(s.dword() >> 16);
    if (width > 0 && height != 0 &&
        (bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32)) {
      if (bpp <= 8) {
        const int n = 1 << bpp;
        const uint8_t* p = s.bytes((size_t)n * 3);
        for (int j = 0; j < n; ++j) palette[j] = {p[3 * j], p[3 * j + 1], p[3 * j + 2], 0};
      }
      ok = true;
    }
  }
  if (!ok) {
    fail("BMP: %d bits per pixel with compression %d is not supported", bpp, rle);
  }
  const bool bottom_up = height > 0;
  if (height < 0) height = -height;
  check_size("BMP", width, height);
  uint8_t gray_palette[256];
  for (int i = 0; i < 256; ++i) {
    gray_palette[i] = gray14(palette[i].b, palette[i].g, palette[i].r);
  }
  Image img = make(height, width, gray);
  const int nch = gray ? 1 : 3;
  BmpOut out{img, nch, width * nch, height, bottom_up};
  const size_t pitch = ((size_t)(((long long)width * (bpp != 15 ? bpp : 16) + 7) / 8) + 3) & ~(size_t)3;
  if (offset > size) s.eof();
  s.pos = offset;
  auto index_row = [&](auto index_of) {  // a palette row, pixel x -> index
    const uint8_t* src = s.bytes(pitch);
    out.x3 = 0;
    for (int x = 0; x < width; ++x) {
      const int k = index_of(src, x);
      out.put(palette[k], gray_palette[k]);
    }
  };
  if (bpp == 1 || (bpp == 4 && rle == 0) || (bpp == 8 && rle == 0)) {
    for (out.y = 0; out.y < height; ++out.y) {
      if (bpp == 1) {
        index_row([](const uint8_t* r, int x) { return (r[x >> 3] >> (7 - (x & 7))) & 1; });
      } else if (bpp == 4) {
        index_row([](const uint8_t* r, int x) { return (r[x >> 1] >> (x & 1 ? 0 : 4)) & 15; });
      } else {
        index_row([](const uint8_t* r, int x) { return (int)r[x]; });
      }
    }
  } else if (bpp == 4 || bpp == 8) {  // RLE4 / RLE8
    const bool rle4 = bpp == 4;
    bool line_end_flag = false;
    for (;;) {
      const int len = s.byte();
      const int code = s.byte();
      if (len != 0) {  // encoded run
        if (out.x3 + len * nch > out.width3) fail("BMP: RLE run beyond the row");
        if (rle4) {
          const int c[2] = {code >> 4, code & 15};
          for (int k = 0; k < len; ++k) out.put(palette[c[k & 1]], gray_palette[c[k & 1]]);
        } else {
          const int prev = out.y;
          out.fill(len * nch, palette[code], gray_palette[code]);
          line_end_flag = out.y != prev;
          if (out.y >= height) break;
        }
      } else if (code > 2) {  // absolute run
        if (out.x3 + code * nch > out.width3) fail("BMP: RLE run beyond the row");
        const int sz = rle4 ? (((code + 1) >> 1) + 1) & ~1 : (code + 1) & ~1;
        const uint8_t* src = s.bytes((size_t)sz);
        for (int k = 0; k < code; ++k) {
          const int i = rle4 ? (src[k >> 1] >> (k & 1 ? 0 : 4)) & 15 : src[k];
          out.put(palette[i], gray_palette[i]);
        }
        line_end_flag = false;
      } else if (rle4) {
        // OpenCV's RLE4: end of line and end of bitmap both end the row,
        // a delta fills dx pixels and drops dy
        int shift3 = out.width3 - out.x3;
        if (code == 2) {
          shift3 = s.byte() * nch;
          s.byte();
        }
        out.fill(shift3, palette[0], gray_palette[0]);
        if (out.y >= height) break;
      } else {  // RLE8: end of line (0), end of bitmap (1), delta (2)
        int shift3 = out.width3 - out.x3;
        int yshift = height - out.y;
        if (code || !line_end_flag || shift3 < out.width3) {
          if (code == 2) {
            shift3 = s.byte() * nch;
            yshift = s.byte();
          }
          if (code != 0) shift3 += yshift * out.width3;
          out.fill(shift3, palette[0], gray_palette[0]);
        }
        line_end_flag = false;
        if (out.y >= height) break;
      }
    }
  } else {  // 15, 16, 24, 32 bits
    for (out.y = 0; out.y < height; ++out.y) {
      const uint8_t* src = s.bytes(pitch);
      uint8_t* d = out.row();
      for (int x = 0; x < width; ++x) {
        int b, g, r;
        if (bpp == 15 || bpp == 16) {
          const int t = src[2 * x] | src[2 * x + 1] << 8;
          b = (t << 3) & 0xf8;
          g = bpp == 15 ? (t >> 2) & 0xf8 : (t >> 3) & 0xfc;
          r = bpp == 15 ? (t >> 7) & 0xf8 : (t >> 8) & 0xf8;
        } else if (masked) {
          const uint8_t* q = src + (size_t)x * 4;
          const uint32_t t = q[0] | (uint32_t)q[1] << 8 | (uint32_t)q[2] << 16 | (uint32_t)q[3] << 24;
          r = (int)((t >> shift[0]) & 255);
          g = (int)((t >> shift[1]) & 255);
          b = (int)((t >> shift[2]) & 255);
          if (gray) {  // OpenCV's float weights, truncated
            d[x] = (uint8_t)((float)r * 0.299f + (float)g * 0.587f + (float)b * 0.114f);
            continue;
          }
        } else {
          const uint8_t* q = src + (size_t)x * (bpp / 8);
          b = q[0];
          g = q[1];
          r = q[2];
        }
        if (gray) {
          d[x] = gray14(b, g, r);
        } else {
          d[3 * x] = (uint8_t)b;
          d[3 * x + 1] = (uint8_t)g;
          d[3 * x + 2] = (uint8_t)r;
        }
      }
    }
  }
  return img;
}

// ---------------------------------------------------------- PNM / PAM

inline bool is_space(int c) { return c == ' ' || (c >= '\t' && c <= '\r'); }
inline bool is_digit(int c) { return c >= '0' && c <= '9'; }

// ReadNumber of grfmt_pxm.cpp: skips blanks and '#' comments, reads at most
// maxdigits digits (0: any), and consumes the byte after the last digit
// unless maxdigits stopped it.
int read_number(Stream& s, int maxdigits = 0) {
  int code = s.byte();
  while (!is_digit(code)) {
    if (code == '#') {
      do {
        code = s.byte();
      } while (code != '\n' && code != '\r');
      code = s.byte();
    } else if (is_space(code)) {
      while (is_space(code)) code = s.byte();
    } else {
      fail("PNM: unexpected byte 0x%02X where a number should be", code);
    }
  }
  long long v = 0;
  int digits = 0;
  do {
    v = v * 10 + (code - '0');
    if (v > 0x7fffffff) fail("PNM: a number is too large");
    if (maxdigits != 0 && ++digits >= maxdigits) break;
    code = s.byte();
  } while (is_digit(code));
  return (int)v;
}

// Sample rows of a PNM or PAM image, each read to 8 bits per channel in
// file order, then written as gray or BGR. chans is 1 or 3.
void write_row(Image& img, int y, const uint8_t* src, int chans, bool rgb_order_swap) {
  const int w = img.width;
  uint8_t* d = &img.pixels[(size_t)y * w * img.channels];
  if (img.channels == 1) {
    if (chans == 1) {
      std::memcpy(d, src, (size_t)w);
    } else {
      for (int x = 0; x < w; ++x) d[x] = gray14(src[3 * x + 2], src[3 * x + 1], src[3 * x]);
    }
  } else if (chans == 1) {
    for (int x = 0; x < w; ++x) d[3 * x] = d[3 * x + 1] = d[3 * x + 2] = src[x];
  } else if (rgb_order_swap) {
    for (int x = 0; x < w; ++x) {
      d[3 * x] = src[3 * x + 2];
      d[3 * x + 1] = src[3 * x + 1];
      d[3 * x + 2] = src[3 * x];
    }
  } else {
    std::memcpy(d, src, (size_t)w * 3);
  }
}

// 1-bit rows: the first ceil(width / 8) bytes, MSB first; value -> 8 bits.
void write_bits(Image& img, int y, const uint8_t* src, uint8_t zero, uint8_t one) {
  const int w = img.width, c = img.channels;
  uint8_t* d = &img.pixels[(size_t)y * w * c];
  for (int x = 0; x < w; ++x) {
    const uint8_t v = (src[x >> 3] >> (7 - (x & 7))) & 1 ? one : zero;
    for (int k = 0; k < c; ++k) d[c * x + k] = v;
  }
}

// Binary samples of 1 or 2 bytes (big-endian) to 8 bits: the high byte.
void narrow(const uint8_t* src, size_t count, bool wide, uint8_t* out) {
  if (!wide) {
    std::memcpy(out, src, count);
  } else {
    for (size_t i = 0; i < count; ++i) out[i] = src[2 * i];
  }
}

Image decode_pnm_impl(const uint8_t* data, size_t size, bool gray) {
  Stream s(data, size, "PNM");
  if (s.byte() != 'P') fail("PNM: bad header");
  const int kind = s.byte() - '0';
  if (kind < 1 || kind > 6) fail("PNM: bad header");
  const int bpp = kind == 1 || kind == 4 ? 1 : kind == 2 || kind == 5 ? 8 : 24;
  const bool binary = kind >= 4;
  const int width = read_number(s);
  const int height = read_number(s);
  int maxval = 1;
  if (bpp > 1) maxval = read_number(s);
  if (maxval > 65535) fail("PNM: maxval %d is too large", maxval);
  if (width <= 0 || height <= 0 || maxval <= 0) fail("PNM: bad header");
  check_size("PNM", width, height);
  const bool wide = maxval > 255;
  Image img = make(height, width, gray);
  const int chans = bpp == 24 ? 3 : 1;
  const size_t n = (size_t)width * chans;
  std::vector<uint8_t> row(n);
  uint8_t scale[256] = {};  // ASCII 8-bit samples: i * 255 / maxval
  if (!wide) {
    for (int i = 0; i <= maxval; ++i) scale[i] = (uint8_t)(i * 255 / maxval);
  }
  for (int y = 0; y < height; ++y) {
    if (bpp == 1) {
      if (binary) {
        write_bits(img, y, s.bytes(((size_t)width + 7) / 8), 255, 0);
      } else {
        for (int x = 0; x < width; ++x) row[x] = read_number(s, 1) != 0 ? 0 : 255;
        write_row(img, y, row.data(), 1, false);
      }
      continue;
    }
    if (binary) {
      narrow(s.bytes(n * (wide ? 2 : 1)), n, wide, row.data());
    } else {
      for (size_t x = 0; x < n; ++x) {
        int code = read_number(s);
        if ((unsigned)code > (unsigned)maxval) code = maxval;
        row[x] = wide ? (uint8_t)(code >> 8) : scale[code];
      }
    }
    write_row(img, y, row.data(), chans, true);
  }
  return img;
}

// ReadPAMHeaderLine: a field name and its value, a comment, or a blank
// line. Returns the field ("" for a comment), value in *value.
bool pam_line(Stream& s, std::string* field, std::string* value) {
  field->clear();
  value->clear();
  int code;
  do {
    code = s.byte();
  } while (is_space(code));
  if (code == '#') {
    do {
      code = s.byte();
    } while (code != '\n' && code != '\r');
    return true;
  }
  for (int pos = 0; pos < 16 && !is_space(code); ++pos) {
    field->push_back((char)code);
    code = s.byte();
  }
  if (!is_space(code)) return false;
  if (code == '\n' || code == '\r') return true;
  do {
    code = s.byte();
  } while (is_space(code));
  for (int pos = 0; pos < 255 && code != '\n' && code != '\r'; ++pos) {
    value->push_back((char)code);
    code = s.byte();
  }
  if (code != '\n' && code != '\r') return false;
  while (!value->empty() && is_space((unsigned char)value->back())) value->pop_back();
  return true;
}

Image decode_pam_impl(const uint8_t* data, size_t size, bool gray) {
  Stream s(data, size, "PAM");
  if (s.byte() != 'P' || s.byte() != '7' || s.byte() != '\n') fail("PAM: bad header");
  long long width = -1, height = -1, depth = -1, maxval = -1;
  std::string tuple, field, value;
  bool have_tuple = false, end = false;
  auto number = [&](long long* v) {
    if (*v >= 0 || value.empty() || value.size() > 9) fail("PAM: bad header field");
    long long x = 0;
    for (char c : value) {
      if (!is_digit(c)) fail("PAM: bad header field");
      x = x * 10 + (c - '0');
    }
    *v = x;
  };
  while (!end) {
    if (!pam_line(s, &field, &value)) fail("PAM: bad header line");
    if (field.empty()) continue;
    if (field == "ENDHDR") {
      end = true;
    } else if (field == "WIDTH") {
      number(&width);
    } else if (field == "HEIGHT") {
      number(&height);
    } else if (field == "DEPTH") {
      number(&depth);
    } else if (field == "MAXVAL") {
      number(&maxval);
      if (maxval > 65535) fail("PAM: maxval is too large");
    } else if (field == "TUPLTYPE") {
      if (have_tuple) fail("PAM: a second TUPLTYPE");
      tuple = value;
      have_tuple = true;
    } else {
      throw Fault("PAM: unknown header field " + field);
    }
  }
  if (width < 0 || height < 0 || depth < 0 || maxval < 0) fail("PAM: incomplete header");
  if (have_tuple && tuple.find("_ALPHA") != std::string::npos) {
    throw Fault("PAM: TUPLTYPE " + tuple +
                " is not supported (OpenCV's reader leaves pixels unwritten)");
  }
  if (have_tuple && tuple != "GRAYSCALE" && tuple != "BLACKANDWHITE" && tuple != "RGB") {
    throw Fault("PAM: TUPLTYPE " + tuple + " is not supported");
  }
  const bool rgb = depth == 3;
  if (depth != 1 && depth != 3) fail("PAM: depth %d is not supported", (int)depth);
  if (have_tuple && (tuple == "RGB") != rgb) {
    throw Fault("PAM: TUPLTYPE " + tuple + " with depth " + std::to_string(depth));
  }
  if (!have_tuple && maxval > 255) fail("PAM: no TUPLTYPE for a 16-bit image");
  if (maxval < 1) fail("PAM: maxval %d", (int)maxval);
  check_size("PAM", width, height);
  const bool wide = maxval > 255;
  const size_t n = (size_t)width * depth;
  const size_t stride = n * (wide ? 2 : 1);
  Image img = make((int)height, (int)width, gray);
  std::vector<uint8_t> row(n);
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = s.bytes(stride);
    if (maxval == 1) {  // OpenCV's bit mode
      write_bits(img, y, src, 0, 255);
      continue;
    }
    narrow(src, n, wide, row.data());
    write_row(img, y, row.data(), (int)depth, false);
  }
  return img;
}

}  // namespace

namespace cris {

Image decode_bmp(const uint8_t* data, size_t size, bool gray) {
  return decode_bmp_impl(data, size, gray);
}

Image decode_pnm(const uint8_t* data, size_t size, bool gray) {
  if (size >= 2 && data[1] == '7') return decode_pam_impl(data, size, gray);
  return decode_pnm_impl(data, size, gray);
}

}  // namespace cris
