// Radiance HDR and PFM decoding for the data library, as OpenCV 5.0's own
// readers (grfmt_hdr.cpp over rgbe.cpp, grfmt_pfm.cpp) decode them for
// cv2.imdecode, so that the pixels equal OpenCV's bit for bit:
//   - HDR: RGBE_ReadHeader as OpenCV runs it (lines read as fgets reads
//     them, 127 bytes at most; header lines up to a blank one, of which
//     one must be "FORMAT=32-bit_rle_rgbe"; then "-Y <h> +X <w>" as
//     sscanf reads it, the one orientation OpenCV takes), then
//     RGBE_ReadPixels_RLE: flat pixels for widths under 8 or over 32767,
//     else per scanline new-style RLE (2, 2, width), and from the first
//     scanline that is not, flat pixels to the end (an old-style run
//     (1, 1, 1, n) is read as a pixel, as rgbe.cpp reads it). rgbe2float,
//     then convertTo(CV_8U, 255) (x * 255 in float, rounded half to even
//     and saturated as cvRound does: NaN and values past 2^31 give 0) into
//     BGR, and IMREAD_GRAYSCALE as cvtColor(BGR2GRAY) of that (15-bit
//     weights). Any fault OpenCV meets (a short file, a bad run) refuses.
//   - PFM: "PF" (3 channels) or "Pf" (1), a line break, then width,
//     height and scale, each ended by one blank and read by atoi / atof;
//     rows bottom-up, little-endian when the scale is negative; RGB to
//     BGR; every sample times (float)(1 / |scale|), then rounded and
//     saturated as above. The result keeps the file's channels under
//     either flag, as cv2.imdecode gives it.
// No global state; float arithmetic as OpenCV's (the library is built
// with -ffp-contract=off).

#include "image_codec.h"

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

using cris::Fault;
using cris::fail;

// saturate_cast<uchar>(float): cvRound (cvtss2si: half to even, and the
// integer indefinite 0x80000000 for NaN and anything out of int range),
// then clamped to 0..255.
inline uint8_t saturate_u8(float y) {
  if (!(y < 2147483648.0f) || y <= 0.0f) return 0;
  const long r = std::lrintf(y);
  return (uint8_t)(r > 255 ? 255 : r);
}

inline bool is_space(uint8_t c) { return c == ' ' || (c >= '\t' && c <= '\r'); }

// ------------------------------------------------------------------ HDR

struct File {  // fgets / fread over the bytes
  const uint8_t* p;
  const uint8_t* end;
  // fgets(buf, 128): up to 127 bytes, through the first newline; false at
  // the end of the data. The line is cut at its first NUL, as the string
  // functions that read buf see it.
  bool gets(std::string& line) {
    if (p == end) return false;
    const uint8_t* q = p;
    while (q < end && q - p < 127 && *q != '\n') ++q;
    if (q < end && q - p < 127) ++q;  // the newline
    line.assign((const char*)p, (size_t)(q - p));
    p = q;
    const size_t nul = line.find('\0');
    if (nul != std::string::npos) line.resize(nul);
    return true;
  }
  bool read(uint8_t* out, size_t n) {
    if ((size_t)(end - p) < n) return false;
    std::memcpy(out, p, n);
    p += n;
    return true;
  }
};

// sscanf(line, "-Y %d +X %d", &h, &w) == 2
bool scan_size(const std::string& line, int* h, int* w) {
  const char* s = line.c_str();
  auto lit = [&](const char* t) {
    for (; *t; ++t) {
      if (*t == ' ') {
        while (is_space((uint8_t)*s)) ++s;
      } else if (*s++ != *t) {
        return false;
      }
    }
    return true;
  };
  auto num = [&](int* out) {
    while (is_space((uint8_t)*s)) ++s;
    char* after;
    const long v = std::strtol(s, &after, 10);
    if (after == s) return false;
    s = after;
    *out = (int)v;
    return true;
  };
  return lit("-Y ") && num(h) && lit(" +X ") && num(w);
}

// rgbe2float, then * 255 into BGR.
inline void rgbe_to_bgr(const uint8_t* rgbe, uint8_t* bgr) {
  if (!rgbe[3]) {
    bgr[0] = bgr[1] = bgr[2] = 0;
    return;
  }
  const float f = (float)std::ldexp(1.0, rgbe[3] - (128 + 8));
  for (int c = 0; c < 3; ++c) bgr[2 - c] = saturate_u8(rgbe[c] * f * 255.0f);
}

}  // namespace

namespace cris {

Image decode_hdr(const uint8_t* data, size_t size, bool gray) {
  File f{data, data + size};
  std::string line;
  // RGBE_ReadHeader: lines up to a blank one (or one that starts with a
  // NUL), the FORMAT line among them, then the size line
  if (!f.gets(line)) fail("Radiance HDR: no header");
  bool format = false;
  while (!line.empty() && line[0] != '\n') {
    if (line == "FORMAT=32-bit_rle_rgbe\n") format = true;
    if (!f.gets(line)) fail("Radiance HDR: the header ends before its blank line");
  }
  if (!format) fail("Radiance HDR: no FORMAT=32-bit_rle_rgbe line");
  if (line != "\n") fail("Radiance HDR: no blank line after the header");
  int h = 0, w = 0;
  if (!f.gets(line) || !scan_size(line, &h, &w)) {
    throw Fault("Radiance HDR: the resolution line is not \"-Y <height> +X <width>\" "
                "(the one orientation OpenCV reads)");
  }
  if (w <= 0 || h <= 0) fail("Radiance HDR: image size %d x %d is not supported", w, h);
  check_size("Radiance HDR", w, h);
  Image img;
  img.height = h;
  img.width = w;
  img.channels = 3;
  img.pixels.resize((size_t)w * h * 3);
  uint8_t* out = img.pixels.data();
  uint8_t rgbe[4];
  auto flat = [&](size_t n) {  // RGBE_ReadPixels
    for (; n > 0; --n, out += 3) {
      if (!f.read(rgbe, 4)) fail("Radiance HDR: unexpected end of data");
      rgbe_to_bgr(rgbe, out);
    }
  };
  if (w < 8 || w > 0x7fff) {
    flat((size_t)w * h);
  } else {
    std::vector<uint8_t> line_buf((size_t)4 * w);
    for (int y = 0; y < h; ++y) {
      if (!f.read(rgbe, 4)) fail("Radiance HDR: unexpected end of data");
      if (rgbe[0] != 2 || rgbe[1] != 2 || (rgbe[2] & 0x80)) {  // flat from here on
        rgbe_to_bgr(rgbe, out);
        out += 3;
        flat((size_t)w * (h - y) - 1);
        break;
      }
      if ((rgbe[2] << 8 | rgbe[3]) != w) fail("Radiance HDR: wrong scanline width");
      for (int c = 0; c < 4; ++c) {
        uint8_t* p = &line_buf[(size_t)c * w];
        uint8_t* const p_end = p + w;
        while (p < p_end) {
          uint8_t run[2];
          if (!f.read(run, 2)) fail("Radiance HDR: unexpected end of data");
          int count = run[0] > 128 ? run[0] - 128 : run[0];
          if (count == 0 || count > p_end - p) fail("Radiance HDR: bad scanline data");
          if (run[0] > 128) {
            std::memset(p, run[1], (size_t)count);
            p += count;
          } else {
            *p++ = run[1];
            if (--count > 0) {
              if (!f.read(p, (size_t)count)) fail("Radiance HDR: unexpected end of data");
              p += count;
            }
          }
        }
      }
      for (int x = 0; x < w; ++x, out += 3) {
        for (int c = 0; c < 4; ++c) rgbe[c] = line_buf[(size_t)c * w + x];
        rgbe_to_bgr(rgbe, out);
      }
    }
  }
  if (gray) {
    std::vector<uint8_t> g((size_t)w * h);
    const uint8_t* p = img.pixels.data();
    for (size_t i = 0; i < g.size(); ++i, p += 3) g[i] = gray15(p[0], p[1], p[2]);
    img.pixels.swap(g);
    img.channels = 1;
  }
  return img;
}

Image decode_pfm(const uint8_t* data, size_t size, bool gray) {
  (void)gray;  // the channels are the file's under either flag
  if (size < 3 || data[0] != 'P' || (data[1] != 'F' && data[1] != 'f')) fail("PFM: no PF / Pf header");
  if (data[2] != '\n') fail("PFM: no line break after PF / Pf");
  const int channels = data[1] == 'F' ? 3 : 1;
  size_t at = 3;
  // read_number: bytes up to the first blank (which is consumed), 2048 at
  // most, each under 128
  auto word = [&]() {
    std::string s;
    for (int i = 0; i < 2048; ++i) {
      if (at == size) fail("PFM: unexpected end of data in the header");
      const uint8_t c = data[at++];
      if (c >= 128) fail("PFM: byte 0x%02X in the header", c);
      if (is_space(c)) break;
      s.push_back((char)c);
    }
    return s;
  };
  const int w = (int)std::strtol(word().c_str(), nullptr, 10);
  const int h = (int)std::strtol(word().c_str(), nullptr, 10);
  const double scale = std::strtod(word().c_str(), nullptr);
  check_size("PFM", w, h);
  const bool big_endian = scale >= 0.0;
  const size_t row = (size_t)w * channels * 4;
  if ((size - at) / row < (size_t)h) fail("PFM: unexpected end of data");
  if (!(std::fabs(scale) > 0.0)) throw Fault("PFM: the scale is 0 or not a number");
  const float k = (float)(1.0 / std::fabs(scale));
  Image img;
  img.height = h;
  img.width = w;
  img.channels = channels;
  img.pixels.resize((size_t)w * h * channels);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = data + at + (size_t)(h - 1 - y) * row;
    uint8_t* dst = &img.pixels[(size_t)y * w * channels];
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < channels; ++c, src += 4) {
        const uint32_t bits = big_endian
            ? (uint32_t)src[0] << 24 | (uint32_t)src[1] << 16 | (uint32_t)src[2] << 8 | src[3]
            : (uint32_t)src[3] << 24 | (uint32_t)src[2] << 16 | (uint32_t)src[1] << 8 | src[0];
        float v;
        std::memcpy(&v, &bits, 4);
        dst[x * channels + (channels == 3 ? 2 - c : 0)] = saturate_u8(v * k);
      }
    }
  }
  return img;
}

}  // namespace cris
