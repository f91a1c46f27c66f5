// Host image coding for the data path, with a plain C interface for ctypes:
// baseline / extended-sequential Huffman JPEG decoding with the EXIF
// orientation, PNG decoding (the chunk walk, a self-contained inflate and
// the row filters), and a baseline JPEG encoder.
//
// The JPEG decoder follows libjpeg-turbo's default decompression (the
// library behind cv2.imdecode) operation for operation, so that its output
// equals OpenCV's bit for bit:
//   - jidctint.c jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2, the
//     post-IDCT range-limit table indexed by value & 1023);
//   - jdsample.c fancy upsampling: h2v1_fancy_upsample and
//     h2v2_fancy_upsample (the 8/7 bias alternating along a row, the row
//     above or below as context, the top and bottom rows replicated as
//     jdmainct.c does), and box replication when a component is at most
//     two samples wide, as jinit_upsampler picks it;
//   - jdcolor.c's YCbCr -> RGB tables in 16-bit fixed point.
// Only integer arithmetic is used, so the bits do not depend on the compiler.
// Progressive, lossless, arithmetic-coded and hierarchical frames, 12-bit
// samples, CMYK and RGB-coded JPEGs, and corrupt streams are refused with a
// message that names the marker or the fault. The APP1 orientation tag is
// applied as OpenCV's ApplyExifOrientation applies it.
//
// PNG: 8-bit gray and RGB, not interlaced, as libpng reads them: an
// ancillary chunk with a bad CRC is dropped, a critical one refused. The
// inflate is RFC 1950/1951 (stored, fixed and dynamic blocks, Adler-32),
// written here because the zlib header is not known to exist on every host.
//
// The encoder writes baseline JPEG (SOF0) as libjpeg's defaults do: a JFIF
// APP0, the Annex K tables scaled by IJG quality, 4:2:0 for color, the
// standard Huffman tables, jfdctint's integer DCT.
//
// No global state: every call owns what it allocates, so concurrent calls
// from several threads are safe.

#include "image_codec.h"

#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

namespace cris {

void fail(const char* fmt, int a, int b) {
  char buf[256];
  std::snprintf(buf, sizeof buf, fmt, a, b);
  throw Fault(buf);
}

}  // namespace cris

namespace {

using cris::Fault;
using cris::fail;

int report(const char* what, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "%s", what);
  return 1;
}

// ----------------------------------------------------------------- JPEG

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;
// OpenCV's CV_IO_MAX_IMAGE_PIXELS: larger images are refused.
constexpr long long kMaxPixels = 1 << 30;

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  uint16_t look[1 << kLookBits];  // (length << 8) | value; 0: longer code
};

void build_huffman(Huffman& h, const uint8_t* bits, const uint8_t* vals,
                   int nvals) {
  std::memcpy(h.vals, vals, (size_t)nvals);
  std::memset(h.look, 0, sizeof h.look);
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    h.valptr[len] = k;
    h.mincode[len] = code;
    code += bits[len - 1];
    k += bits[len - 1];
    if (code > (1 << len)) fail("DHT: bad Huffman table");
    h.maxcode[len] = bits[len - 1] ? code - 1 : -1;
    if (len <= kLookBits) {
      for (int c = h.mincode[len]; c <= h.maxcode[len]; ++c) {
        int v = h.vals[h.valptr[len] + c - h.mincode[len]];
        int lo = c << (kLookBits - len), n = 1 << (kLookBits - len);
        for (int i = 0; i < n; ++i) h.look[lo + i] = (uint16_t)(len << 8 | v);
      }
    }
    code <<= 1;
  }
  h.maxcode[17] = INT32_MAX;
  h.defined = true;
}

// Entropy-coded data: 0xFF00 is a stuffed 0xFF; at a marker (or the end of
// the data) zero bits are fed, and consuming one of them is a fault.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t acc = 0;
  int nbits = 0;
  int fake = 0;  // zero bits at the tail of acc that are not in the stream
  bool at_marker = false;

  BitReader(const uint8_t* p_, const uint8_t* e_) : p(p_), end(e_) {}

  void fill() {
    while (nbits <= 24) {
      uint32_t byte = 0;
      if (!at_marker) {
        if (p >= end) {
          at_marker = true;
        } else if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            byte = 0xFF;
            p += 2;
          } else {
            at_marker = true;
          }
        } else {
          byte = *p++;
        }
      }
      if (at_marker) fake += 8;
      acc |= byte << (24 - nbits);
      nbits += 8;
    }
  }

  void consume(int n) {
    acc <<= n;
    nbits -= n;
    if (nbits < fake) fail("SOS: corrupt entropy-coded data (premature end)");
  }

  int bits(int n) {
    if (n == 0) return 0;
    fill();
    int v = (int)(acc >> (32 - n));
    consume(n);
    return v;
  }

  int decode(const Huffman& h) {
    fill();
    int e = h.look[acc >> (32 - kLookBits)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    for (int len = kLookBits + 1; len <= 16; ++len) {
      int32_t code = (int32_t)(acc >> (32 - len));
      if (code <= h.maxcode[len]) {
        consume(len);
        return h.vals[h.valptr[len] + code - h.mincode[len]];
      }
    }
    fail("SOS: corrupt entropy-coded data (bad Huffman code)");
  }

  // After a restart interval: drop the padding bits and read RSTn.
  void restart(int expect) {
    if (nbits - fake >= 8) fail("RST%d: marker expected", expect);
    if (!(p + 1 < end && p[0] == 0xFF && p[1] == 0xD0 + expect)) {
      fail("RST%d: marker expected", expect);
    }
    p += 2;
    acc = 0;
    nbits = 0;
    fake = 0;
    at_marker = false;
  }
};

int extend(int v, int s) {
  return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id, h, v, tq;
  int bw = 0, bh = 0;       // blocks allocated across and down
  int dw = 0, dh = 0;       // downsampled_width / downsampled_height
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // (bw * 8) x (bh * 8) samples after the IDCT
};

struct Jpeg {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  int restart = 0;
  bool frame = false, scanned = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  long long app1_off = -1, app1_len = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];

  Jpeg(const uint8_t* d, size_t n) : data(d), size(n) {}

  int u8() {
    if (pos >= size) fail("JPEG: unexpected end of data");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return hi << 8 | u8();
  }

  int next_marker() {
    // skip to 0xFF, then past fill bytes
    while (pos < size && data[pos] != 0xFF) ++pos;
    while (pos < size && data[pos] == 0xFF) ++pos;
    if (pos >= size) fail("JPEG: no EOI marker (truncated data)");
    return data[pos++];
  }

  size_t segment(int marker) {
    int len = u16();
    if (len < 2 || pos + (size_t)len - 2 > size) {
      fail("marker 0x%02X: bad segment length", marker);
    }
    return pos + (size_t)len - 2;
  }

  void read_sof(int marker) {
    size_t stop = segment(marker);
    if (frame) fail("SOF%d: a second frame header", marker - 0xC0);
    int precision = u8();
    if (precision != 8) {
      fail("SOF%d: %d-bit samples are not supported", marker - 0xC0, precision);
    }
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) fail("SOF%d: height 0 (DNL) is not supported", marker - 0xC0);
    if (width == 0) fail("SOF%d: width 0", marker - 0xC0);
    if ((long long)width * height > kMaxPixels) {
      fail("SOF: %d x %d pixels is too large", width, height);
    }
    if (ncomp != 1 && ncomp != 3) {
      fail("SOF%d: %d components (CMYK or other) are not supported",
           marker - 0xC0, ncomp);
    }
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) {
        fail("SOF%d: bad component parameters", marker - 0xC0);
      }
    }
    if (pos != stop) fail("SOF%d: bad segment length", marker - 0xC0);
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      hmax = comp[i].h > hmax ? comp[i].h : hmax;
      vmax = comp[i].v > vmax ? comp[i].v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((long long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long long)height * c.v + vmax - 1) / vmax);
    }
    frame = true;
  }

  void read_dqt() {
    size_t stop = segment(0xDB);
    while (pos < stop) {
      int pq_tq = u8(), pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) fail("DQT: bad table");
      for (int k = 0; k < 64; ++k) {
        qt[tq][kZigzag[k]] = (uint16_t)(pq ? u16() : u8());
      }
      qt_defined[tq] = true;
    }
    if (pos != stop) fail("DQT: bad segment length");
  }

  void read_dht() {
    size_t stop = segment(0xC4);
    while (pos < stop) {
      int tc_th = u8(), tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("DHT: bad table class or index");
      uint8_t bits[16], vals[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        bits[i] = (uint8_t)u8();
        total += bits[i];
      }
      if (total > 256) fail("DHT: bad Huffman table");
      for (int i = 0; i < total; ++i) vals[i] = (uint8_t)u8();
      build_huffman(tc ? ac[th] : dc[th], bits, vals, total);
    }
    if (pos != stop) fail("DHT: bad segment length");
  }

  void read_app(int marker) {
    size_t stop = segment(marker);
    size_t len = stop - pos;
    const uint8_t* d = data + pos;
    if (marker == 0xE0 && len >= 5 && std::memcmp(d, "JFIF\0", 5) == 0) {
      jfif = true;
    } else if (marker == 0xE1 && app1_off < 0 && !scanned) {
      // the first APP1 segment before the scan, as libjpeg saves it for
      // OpenCV's EXIF reader
      app1_off = (long long)pos;
      app1_len = (long long)len;
    } else if (marker == 0xEE && len >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[11];
    }
    pos = stop;
  }

  void read_sos() {
    size_t stop = segment(0xDA);
    if (!frame) fail("SOS: no frame header before the scan");
    int ns = u8();
    if (ns < 1 || ns > ncomp) fail("SOS: bad component count %d", ns);
    Component* sc[3];
    int td[3], ta[3];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j) {
        if (comp[j].id == id) sc[i] = &comp[j];
      }
      if (!sc[i]) fail("SOS: unknown component id %d", id);
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3 || !dc[td[i]].defined || !ac[ta[i]].defined) {
        fail("SOS: Huffman table not defined");
      }
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) {
      fail("SOS: spectral selection %d..%d is not sequential", ss, se);
    }
    if (pos != stop) fail("SOS: bad segment length");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }

    BitReader br(data + pos, data + size);
    int pred[3] = {0, 0, 0};
    auto block = [&](int i, int bx, int by) {
      Component& c = *sc[i];
      int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
      int s = br.decode(dc[td[i]]);
      if (s > 15) fail("SOS: corrupt entropy-coded data (DC size %d)", s);
      pred[i] += extend(br.bits(s), s);
      blk[0] = (int16_t)pred[i];
      const Huffman& h = ac[ta[i]];
      for (int k = 1; k < 64;) {
        int rs = br.decode(h), r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) fail("SOS: corrupt entropy-coded data (AC index)");
          blk[kZigzag[k]] = (int16_t)extend(br.bits(s), s);
          ++k;
        } else if (r == 15) {
          k += 16;
        } else {
          break;
        }
      }
    };

    long long units, across;
    if (ns == 1) {  // non-interleaved: the component's own block grid
      Component& c = *sc[0];
      across = (c.dw + 7) / 8;
      units = across * ((c.dh + 7) / 8);
    } else {
      across = mcux;
      units = (long long)mcux * mcuy;
    }
    int rst = 0;
    for (long long u = 0; u < units; ++u) {
      if (restart && u > 0 && u % restart == 0) {
        br.restart(rst);
        rst = (rst + 1) & 7;
        pred[0] = pred[1] = pred[2] = 0;
      }
      int ux = (int)(u % across), uy = (int)(u / across);
      if (ns == 1) {
        block(0, ux, uy);
      } else {
        for (int i = 0; i < ns; ++i) {
          for (int y = 0; y < sc[i]->v; ++y) {
            for (int x = 0; x < sc[i]->h; ++x) {
              block(i, ux * sc[i]->h + x, uy * sc[i]->v + y);
            }
          }
        }
      }
    }
    pos = (size_t)(br.p - data);
    scanned = true;
  }

  // A frame or coding marker this decoder refuses, named in the message.
  static bool is_sof(int m) {
    return m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC;
  }

  [[noreturn]] static void refuse(int m) {
    if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
      fail("SOF%d: progressive JPEG is not supported", m - 0xC0);
    }
    if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
      fail("SOF%d: lossless JPEG is not supported", m - 0xC0);
    }
    if (m == 0xCC) fail("DAC: arithmetic coding is not supported");
    if (m == 0xC8) fail("JPG (0xFFC8): reserved marker");
    fail("SOF%d: arithmetic-coded or hierarchical JPEG is not supported",
         m - 0xC0);
  }

  void parse() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("JPEG: no SOI marker");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1) {
        read_sof(m);
      } else if (is_sof(m) || m == 0xCC || m == 0xC8) {
        refuse(m);
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        size_t stop = segment(m);
        restart = u16();
        if (pos != stop) fail("DRI: bad segment length");
      } else if (m == 0xDA) {
        read_sos();
      } else if (m == 0xD9) {
        break;
      } else if (m == 0xDC) {
        fail("DNL: height from a DNL marker is not supported");
      } else if (m == 0xDE || m == 0xDF) {
        fail("marker 0x%02X: hierarchical JPEG is not supported", m);
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xFE || (m >= 0xF0 && m <= 0xFD)) {
        pos = segment(m);
      } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
        // TEM, or a stray RSTn between segments: no payload
      } else if (m == 0xD8) {
        fail("SOI: a second SOI marker");
      } else {
        fail("marker 0x%02X: unexpected", m);
      }
    }
    if (!frame) fail("JPEG: no SOF marker");
    if (!scanned) fail("JPEG: no SOS marker");
  }

  // libjpeg's default_decompress_parms: is a 3-component image YCbCr?
  bool ycbcr() const {
    if (jfif) return true;
    if (adobe) return adobe_transform != 0;
    return !(comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B');
  }
};

// jidctint.c
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// The post-IDCT range-limit table of jdmaster.c, indexed by x & 1023:
// x + 128 clamped to [0, 255] for |x| < 512, wrapping beyond.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int x = i < 512 ? i : i - 1024;
      int v = x + 128;
      t[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};

// One 8-point pass of jpeg_idct_islow on x[0..7] (coefficients scaled as
// that pass takes them): y[k] is output k before its descale.
inline void idct_pass(const int32_t* x, int32_t* y) {
  int32_t z2 = x[2], z3 = x[6];
  int32_t z1 = (z2 + z3) * FIX_0_541196100;
  int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
  int32_t tmp3 = z1 + z2 * FIX_0_765366865;
  int32_t tmp0 = (x[0] + x[4]) * (1 << kConstBits);
  int32_t tmp1 = (x[0] - x[4]) * (1 << kConstBits);
  int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  tmp0 = x[7];
  tmp1 = x[5];
  tmp2 = x[3];
  tmp3 = x[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int32_t z4 = tmp1 + tmp3;
  int32_t z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 *= FIX_0_298631336;
  tmp1 *= FIX_2_053119869;
  tmp2 *= FIX_3_072711026;
  tmp3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 *= -FIX_1_961570560;
  z4 *= -FIX_0_390180644;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  y[0] = tmp10 + tmp3;
  y[7] = tmp10 - tmp3;
  y[1] = tmp11 + tmp2;
  y[6] = tmp11 - tmp2;
  y[2] = tmp12 + tmp1;
  y[5] = tmp12 - tmp1;
  y[3] = tmp13 + tmp0;
  y[4] = tmp13 - tmp0;
}

// jpeg_idct_islow: columns (dequantized) into the workspace, then rows
// into the range-limited output; a column or row whose AC terms are all
// zero takes the shortcut, which gives the same values.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride, const RangeLimit& rl) {
  int32_t ws[64], x[8], y[8];
  for (int c = 0; c < 8; ++c) {
    for (int r = 0; r < 8; ++r) x[r] = (int32_t)in[8 * r + c] * q[8 * r + c];
    if (!x[1] && !x[2] && !x[3] && !x[4] && !x[5] && !x[6] && !x[7]) {
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = x[0] * (1 << kPass1Bits);
      continue;
    }
    idct_pass(x, y);
    for (int r = 0; r < 8; ++r) {
      ws[8 * r + c] = descale(y[r], kConstBits - kPass1Bits);
    }
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = rl.t[descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    idct_pass(w, y);
    for (int c = 0; c < 8; ++c) {
      op[c] = rl.t[descale(y[c], kConstBits + kPass1Bits + 3) & 1023];
    }
  }
}

void inverse_dct(Jpeg& j, Component& c) {
  if (!j.qt_defined[c.tq]) fail("DQT: quantization table %d not defined", c.tq);
  static const RangeLimit rl;
  int stride = c.bw * 8;
  c.plane.assign((size_t)stride * c.bh * 8, 0);
  if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
  for (int by = 0; by < c.bh; ++by) {
    for (int bx = 0; bx < c.bw; ++bx) {
      idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], j.qt[c.tq],
                 &c.plane[(size_t)by * 8 * stride + bx * 8], stride, rl);
    }
  }
}

// One component at full resolution (width x height), as jdsample.c
// upsamples it.
std::vector<uint8_t> upsample(const Jpeg& j, const Component& c) {
  int W = j.width, H = j.height, stride = c.bw * 8;
  int hx = j.hmax / c.h, vx = j.vmax / c.v;
  if (j.hmax % c.h || j.vmax % c.v || hx > 2 || vx > 2 || (hx == 1 && vx == 2)) {
    fail("SOF: sampling factors %dx%d are not supported", c.h, c.v);
  }
  std::vector<uint8_t> out((size_t)W * H);
  auto row = [&](int y) {  // downsampled row y, rows outside replicated
    y = y < 0 ? 0 : y >= c.dh ? c.dh - 1 : y;
    return &c.plane[(size_t)y * stride];
  };
  bool fancy = c.dw > 2;
  std::vector<uint8_t> line((size_t)c.dw * 2);
  for (int y = 0; y < H; ++y) {
    uint8_t* o = &out[(size_t)y * W];
    if (hx == 1) {  // and vx == 1
      std::memcpy(o, row(y), (size_t)W);
      continue;
    }
    if (!fancy) {  // box replication
      const uint8_t* in = row(vx == 2 ? y / 2 : y);
      for (int x = 0; x < W; ++x) o[x] = in[x / 2];
      continue;
    }
    uint8_t* l = line.data();
    if (vx == 1) {  // h2v1_fancy_upsample
      const uint8_t* in = row(y);
      int v = in[0];
      l[0] = (uint8_t)v;
      l[1] = (uint8_t)((v * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < c.dw - 1; ++i) {
        v = in[i] * 3;
        l[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
        l[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
      }
      int last = c.dw - 1;
      l[2 * last] = (uint8_t)((in[last] * 3 + in[last - 1] + 1) >> 2);
      l[2 * last + 1] = in[last];
    } else {  // h2v2_fancy_upsample
      int r = y / 2;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row(y % 2 == 0 ? r - 1 : r + 1);
      int thiscol = in0[0] * 3 + in1[0];
      int nextcol = in0[1] * 3 + in1[1];
      l[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
      l[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int i = 1; i < c.dw - 1; ++i) {
        nextcol = in0[i + 1] * 3 + in1[i + 1];
        l[2 * i] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        l[2 * i + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      int last = c.dw - 1;
      l[2 * last] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      l[2 * last + 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
    }
    std::memcpy(o, l, (size_t)W);
  }
  return out;
}

void decode_jpeg(Jpeg& j, cris::Image& img, int channels) {
  j.parse();
  int W = j.width, H = j.height;
  size_t n = (size_t)W * H;
  img.height = H;
  img.width = W;
  img.channels = channels;
  img.pixels.resize(n * channels);
  uint8_t* out = img.pixels.data();
  if (j.ncomp == 3 && !j.ycbcr()) fail("APP14: RGB-coded JPEG is not supported");
  int used = channels == 1 ? 1 : j.ncomp;
  for (int i = 0; i < used; ++i) inverse_dct(j, j.comp[i]);
  std::vector<uint8_t> y = upsample(j, j.comp[0]);
  if (channels == 1) {
    std::memcpy(out, y.data(), n);
    return;
  }
  if (j.ncomp == 1) {
    for (size_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    return;
  }
  std::vector<uint8_t> cb = upsample(j, j.comp[1]), cr = upsample(j, j.comp[2]);
  // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  const int32_t one_half = 1 << 15;
  for (int i = 0; i < 256; ++i) {
    int32_t x = i - 128;
    cr_r[i] = (int)((91881 * x + one_half) >> 16);   // FIX(1.40200)
    cb_b[i] = (int)((116130 * x + one_half) >> 16);  // FIX(1.77200)
    cr_g[i] = -46802 * x;                            // -FIX(0.71414)
    cb_g[i] = -22554 * x + one_half;                 // -FIX(0.34414)
  }
  auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (size_t i = 0; i < n; ++i) {
    int yy = y[i], b = cb[i], r = cr[i];
    out[3 * i + 2] = clamp(yy + cr_r[r]);
    out[3 * i + 1] = clamp(yy + (int)((cb_g[b] + cr_g[r]) >> 16));
    out[3 * i + 0] = clamp(yy + cb_b[b]);
  }
}


// ----------------------------------------------------------------- EXIF

inline uint32_t get16(const uint8_t* p, bool le) {
  return le ? (uint32_t)(p[0] | p[1] << 8) : (uint32_t)(p[0] << 8 | p[1]);
}

inline uint32_t get32(const uint8_t* p, bool le) {
  return le ? ((uint32_t)p[3] << 24 | (uint32_t)p[2] << 16 |
               (uint32_t)p[1] << 8 | p[0])
            : ((uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 |
               (uint32_t)p[2] << 8 | p[3]);
}

// The orientation tag (0x0112) of an APP1 payload, read as OpenCV's EXIF
// reader reads it: a TIFF header 6 bytes in, IFD0's entries; 1 when there
// is none or the header is not TIFF.
int exif_orientation(const uint8_t* payload, size_t len) {
  if (len < 6 + 8) return 1;
  const uint8_t* t = payload + 6;
  const uint64_t n = len - 6;
  bool le;
  if (t[0] == 'I' && t[1] == 'I') {
    le = true;
  } else if (t[0] == 'M' && t[1] == 'M') {
    le = false;
  } else {
    return 1;
  }
  if (get16(t + 2, le) != 42) return 1;
  const uint64_t ifd = get32(t + 4, le);
  if (ifd + 2 > n) return 1;
  const uint32_t count = get16(t + ifd, le);
  for (uint32_t k = 0; k < count; ++k) {
    const uint64_t e = ifd + 2 + 12ull * k;
    if (e + 12 > n) break;
    if (get16(t + e, le) == 0x0112) return (int)get16(t + e + 8, le);
  }
  return 1;
}

// OpenCV's ApplyExifOrientation: flips for 2-4, a transpose then the flips
// of 1-4 for 5-8, nothing for 1 or an unknown value.
void apply_orientation(cris::Image& img, int orientation) {
  if (orientation < 2 || orientation > 8) return;
  const bool transpose = orientation >= 5;
  const int o = transpose ? orientation - 4 : orientation;
  const bool flip_x = o == 2 || o == 3, flip_y = o == 3 || o == 4;
  const int H = img.height, W = img.width, C = img.channels;
  const int oh = transpose ? W : H, ow = transpose ? H : W;
  std::vector<uint8_t> out(img.pixels.size());
  for (int y = 0; y < oh; ++y) {
    const int ty = flip_y ? oh - 1 - y : y;
    for (int x = 0; x < ow; ++x) {
      const int tx = flip_x ? ow - 1 - x : x;
      const int sy = transpose ? tx : ty, sx = transpose ? ty : tx;
      std::memcpy(&out[((size_t)y * ow + x) * C],
                  &img.pixels[((size_t)sy * W + sx) * C], (size_t)C);
    }
  }
  img.pixels.swap(out);
  img.height = oh;
  img.width = ow;
}

cris::Image decode_jpeg_image(const uint8_t* data, size_t size, bool gray) {
  Jpeg j(data, size);
  cris::Image img;
  decode_jpeg(j, img, gray ? 1 : 3);
  if (j.app1_off >= 0) {
    apply_orientation(img, exif_orientation(data + j.app1_off,
                                            (size_t)j.app1_len));
  }
  return img;
}

// -------------------------------------------------------------- inflate

// LSB-first bits of a deflate stream. Past the end, zero bits are fed;
// consuming one of them is a fault.
struct InBits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;  // bits in buf
  int pad = 0;  // of them, fed past the end

  InBits(const uint8_t* p_, const uint8_t* e_) : p(p_), end(e_) {}

  uint32_t peek(int n) {
    while (cnt <= 56 && cnt < n + 32) {
      uint64_t b = 0;
      if (p < end) {
        b = *p++;
      } else {
        pad += 8;
      }
      buf |= b << cnt;
      cnt += 8;
    }
    return (uint32_t)(buf & ((1ull << n) - 1));
  }

  void drop(int n) {
    buf >>= n;
    cnt -= n;
    if (cnt < pad) fail("incomplete or truncated stream");
  }

  uint32_t bits(int n) {
    uint32_t v = peek(n);
    drop(n);
    return v;
  }
};

constexpr int kFastBits = 10;

// A canonical Huffman code (puff.c's layout) with a kFastBits lookup.
struct InflateHuffman {
  int16_t count[16];
  int16_t symbol[288];
  uint16_t fast[1 << kFastBits];  // (length << 9) | symbol; 0: longer code
};

// Returns 0 for a complete code, > 0 for an incomplete one, < 0 for an
// over-subscribed one.
int build_code(InflateHuffman& h, const uint8_t* length, int n) {
  std::memset(h.count, 0, sizeof h.count);
  std::memset(h.fast, 0, sizeof h.fast);
  for (int s = 0; s < n; ++s) h.count[length[s]]++;
  if (h.count[0] == n) return 0;
  int left = 1;
  for (int len = 1; len < 16; ++len) {
    left <<= 1;
    left -= h.count[len];
    if (left < 0) return left;
  }
  int offs[16], next[16];
  offs[1] = 0;
  for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + h.count[len];
  int code = 0;
  next[0] = 0;
  for (int len = 1; len < 16; ++len) {
    code = (code + h.count[len - 1]) << 1;
    next[len] = code;
  }
  for (int s = 0; s < n; ++s) {
    int len = length[s];
    if (!len) continue;
    h.symbol[offs[len]++] = (int16_t)s;
    int c = next[len]++;
    if (len <= kFastBits) {
      int rev = 0;
      for (int i = 0; i < len; ++i) rev |= ((c >> i) & 1) << (len - 1 - i);
      for (int i = rev; i < (1 << kFastBits); i += 1 << len) {
        h.fast[i] = (uint16_t)(len << 9 | s);
      }
    }
  }
  return left;
}

int decode_symbol(InBits& in, const InflateHuffman& h) {
  uint32_t v = in.peek(15);
  int e = h.fast[v & ((1 << kFastBits) - 1)];
  if (e) {
    in.drop(e >> 9);
    return e & 511;
  }
  int code = 0, first = 0, index = 0;
  for (int len = 1; len < 16; ++len) {
    code |= (int)((v >> (len - 1)) & 1);
    int count = h.count[len];
    if (code - count < first) {
      in.drop(len);
      return h.symbol[index + (code - first)];
    }
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  fail("invalid Huffman code");
}

const uint16_t kLengthBase[29] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  13,
                                  15, 17, 19, 23, 27, 31, 35, 43,  51,  59,
                                  67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLengthExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                  2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,
                                13,   17,   25,   33,   49,   65,    97,
                                129,  193,  257,  385,  513,  769,   1025,
                                1537, 2049, 3073, 4097, 6145, 8193,  12289,
                                16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

struct Output {
  std::vector<uint8_t> v;
  size_t n = 0;

  void grow(size_t k) {
    if (n + k > v.size()) {
      size_t want = v.size() * 2;
      if (want < n + k) want = n + k;
      if (want < 4096) want = 4096;
      v.resize(want);
    }
  }
};

void inflate_codes(InBits& in, Output& out, const InflateHuffman& lencode,
                   const InflateHuffman& distcode) {
  for (;;) {
    int sym = decode_symbol(in, lencode);
    if (sym < 256) {
      out.grow(1);
      out.v[out.n++] = (uint8_t)sym;
      continue;
    }
    if (sym == 256) return;
    sym -= 257;
    if (sym >= 29) fail("invalid literal/length code");
    size_t len = kLengthBase[sym] + in.bits(kLengthExtra[sym]);
    int dsym = decode_symbol(in, distcode);
    if (dsym >= 30) fail("invalid distance code");
    size_t dist = kDistBase[dsym] + in.bits(kDistExtra[dsym]);
    if (dist > out.n) fail("invalid distance too far back");
    out.grow(len);
    uint8_t* o = out.v.data() + out.n;
    const uint8_t* from = o - dist;
    for (size_t i = 0; i < len; ++i) o[i] = from[i];
    out.n += len;
  }
}

void inflate_stored(InBits& in, Output& out) {
  in.drop(in.cnt & 7);
  uint32_t len = in.bits(16), nlen = in.bits(16);
  if (len != (~nlen & 0xFFFF)) fail("invalid stored block lengths");
  out.grow(len);
  while (len > 0 && in.cnt - in.pad >= 8) {  // the bytes already buffered
    out.v[out.n++] = (uint8_t)in.buf;
    in.buf >>= 8;
    in.cnt -= 8;
    --len;
  }
  if (len > 0) {  // the rest straight from the stream
    if ((size_t)(in.end - in.p) < len) fail("incomplete or truncated stream");
    std::memcpy(out.v.data() + out.n, in.p, len);
    out.n += len;
    in.p += len;
    in.buf = 0;
    in.cnt = in.pad = 0;
  }
}

void inflate_fixed(InBits& in, Output& out) {
  uint8_t length[288];
  int s = 0;
  for (; s < 144; ++s) length[s] = 8;
  for (; s < 256; ++s) length[s] = 9;
  for (; s < 280; ++s) length[s] = 7;
  for (; s < 288; ++s) length[s] = 8;
  InflateHuffman lencode, distcode;
  build_code(lencode, length, 288);
  for (s = 0; s < 30; ++s) length[s] = 5;
  build_code(distcode, length, 30);
  inflate_codes(in, out, lencode, distcode);
}

void inflate_dynamic(InBits& in, Output& out) {
  static const uint8_t order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                    11, 4,  12, 3, 13, 2, 14, 1, 15};
  int nlen = (int)in.bits(5) + 257, ndist = (int)in.bits(5) + 1;
  int ncode = (int)in.bits(4) + 4;
  if (nlen > 286 || ndist > 30) fail("too many length or distance symbols");
  uint8_t length[320] = {0};
  for (int i = 0; i < ncode; ++i) length[order[i]] = (uint8_t)in.bits(3);
  InflateHuffman lencode, distcode;
  if (build_code(lencode, length, 19) != 0) fail("invalid code lengths set");
  for (int i = 0; i < nlen + ndist;) {
    int sym = decode_symbol(in, lencode);
    if (sym < 16) {
      length[i++] = (uint8_t)sym;
      continue;
    }
    int value = 0, repeat;
    if (sym == 16) {
      if (i == 0) fail("invalid bit length repeat");
      value = length[i - 1];
      repeat = 3 + (int)in.bits(2);
    } else if (sym == 17) {
      repeat = 3 + (int)in.bits(3);
    } else {
      repeat = 11 + (int)in.bits(7);
    }
    if (i + repeat > nlen + ndist) fail("invalid bit length repeat");
    while (repeat--) length[i++] = (uint8_t)value;
  }
  if (length[256] == 0) fail("invalid code -- missing end-of-block");
  int err = build_code(lencode, length, nlen);
  if (err < 0 || (err > 0 && nlen != lencode.count[0] + lencode.count[1])) {
    fail("invalid literal/lengths set");
  }
  err = build_code(distcode, length + nlen, ndist);
  if (err < 0 || (err > 0 && ndist != distcode.count[0] + distcode.count[1])) {
    fail("invalid distances set");
  }
  inflate_codes(in, out, lencode, distcode);
}

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n > 0) {
    size_t k = n < 5552 ? n : 5552;
    n -= k;
    while (k--) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return b << 16 | a;
}

// ------------------------------------------------------------------ PNG

const uint8_t kPngMagic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

struct Crc32 {
  uint32_t t[256];
  Crc32() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
  uint32_t operator()(const uint8_t* p, size_t n) const {
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < n; ++i) c = t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
  }
};

[[noreturn]] void fail_chunk(const uint8_t* kind, const char* what) {
  char name[5];
  for (int i = 0; i < 4; ++i) {
    name[i] = kind[i] >= 0x20 && kind[i] < 0x7F ? (char)kind[i] : '?';
  }
  name[4] = 0;
  throw Fault(std::string("PNG ") + name + ": " + what);
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

void png_unfilter(const uint8_t* raw, size_t n, int height, int width,
                  int bpp, uint8_t* out) {
  size_t stride = (size_t)width * bpp;
  if (n < (size_t)height * (stride + 1)) fail("IDAT: not enough image data");
  std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prev = zero.data();
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = raw + (size_t)y * (stride + 1);
    int filter = src[0];
    ++src;
    uint8_t* cur = out + (size_t)y * stride;
    for (size_t i = 0; i < stride; ++i) {
      int a = i >= (size_t)bpp ? cur[i - bpp] : 0;
      int b = prev[i];
      int c = i >= (size_t)bpp ? prev[i - bpp] : 0;
      int v = src[i];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) >> 1; break;
        case 4: v += paeth(a, b, c); break;
        default: fail("IDAT: unknown PNG filter type %d in row %d", filter, y);
      }
      cur[i] = (uint8_t)v;
    }
    prev = cur;
  }
}

inline uint32_t be32(const uint8_t* p) { return get32(p, false); }

// 8-bit gray or RGB PNG -> gray (1 channel) or BGR (3 channels).
cris::Image decode_png(const uint8_t* buf, size_t size, bool gray) {
  static const Crc32 crc32;
  size_t pos = sizeof kPngMagic;
  bool header = false;
  uint32_t width = 0, height = 0;
  int depth = 0, color = 0, method = 0, filter = 0, interlace = 0;
  std::vector<uint8_t> idat;
  for (;;) {
    if (pos + 12 > size) fail("PNG: truncated data (no IEND chunk)");
    const uint32_t length = be32(buf + pos);
    const uint8_t* kind = buf + pos + 4;
    if (length > size - pos - 12) fail_chunk(kind, "truncated chunk");
    const uint8_t* data = buf + pos + 8;
    const uint32_t crc = be32(data + length);
    pos += 12 + (size_t)length;
    const bool critical = !(kind[0] & 0x20);
    if (crc32(kind, 4 + (size_t)length) != crc) {
      if (critical) fail_chunk(kind, "CRC mismatch");
      continue;  // libpng drops an ancillary chunk with a bad CRC
    }
    if (std::memcmp(kind, "IHDR", 4) == 0) {
      if (length != 13) fail("PNG IHDR: bad length %d", (int)length);
      width = be32(data);
      height = be32(data + 4);
      depth = data[8];
      color = data[9];
      method = data[10];
      filter = data[11];
      interlace = data[12];
      header = true;
    } else if (std::memcmp(kind, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + length);
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      break;
    } else if (critical) {
      fail_chunk(kind, "chunk not supported (palette images are not)");
    }
  }
  if (!header) fail("PNG: no IHDR chunk");
  if (depth != 8 || (color != 0 && color != 2) || interlace || method ||
      filter) {
    char msg[160];
    std::snprintf(msg, sizeof msg,
                  "PNG IHDR: bit depth %d, color type %d, interlace %d: only "
                  "8-bit gray or RGB, not interlaced, is supported",
                  depth, color, interlace);
    throw Fault(msg);
  }
  if (width == 0 || height == 0 ||
      (unsigned long long)width * height > (unsigned long long)kMaxPixels) {
    fail("PNG IHDR: %d x %d pixels is not supported", (int)width, (int)height);
  }
  if (gray && color == 2) fail("PNG: RGB to grayscale is not supported");
  const int bpp = color == 0 ? 1 : 3;
  const size_t stride = (size_t)width * bpp;
  std::vector<uint8_t> raw;
  try {
    raw = cris::zlib_inflate(idat.data(), idat.size(),
                             (size_t)height * (stride + 1));
  } catch (const Fault& f) {
    throw Fault(std::string("PNG IDAT: ") + f.what());
  }
  cris::Image img;
  img.height = (int)height;
  img.width = (int)width;
  img.channels = gray ? 1 : 3;
  std::vector<uint8_t> rows((size_t)height * stride);
  png_unfilter(raw.data(), raw.size(), (int)height, (int)width, bpp,
               rows.data());
  if (bpp == img.channels) {
    img.pixels.swap(rows);
    if (bpp == 3) {  // RGB -> BGR
      uint8_t* p = img.pixels.data();
      for (size_t i = 0; i < (size_t)width * height; ++i) {
        uint8_t r = p[3 * i];
        p[3 * i] = p[3 * i + 2];
        p[3 * i + 2] = r;
      }
    }
    return img;
  }
  img.pixels.resize((size_t)width * height * 3);  // gray -> BGR
  for (size_t i = 0; i < (size_t)width * height; ++i) {
    img.pixels[3 * i] = img.pixels[3 * i + 1] = img.pixels[3 * i + 2] = rows[i];
  }
  return img;
}

// --------------------------------------------------------- JPEG encoder

const uint8_t kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3's tables: code counts by length 1..16, then the symbols.
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncodeTable {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint16_t code[256];
  uint8_t size[256];

  EncodeTable(const uint8_t* b, const uint8_t* v, int n)
      : bits(b), vals(v), nvals(n) {
    std::memset(size, 0, sizeof size);
    int c = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        code[vals[k]] = (uint16_t)c++;
        size[vals[k]] = (uint8_t)len;
      }
      c <<= 1;
    }
  }
};

// MSB-first entropy-coded bits with 0xFF stuffed by 0x00.
struct OutBits {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;

  explicit OutBits(std::vector<uint8_t>& o) : out(o) {}

  void put(uint32_t value, int len) {
    acc = acc << len | (value & ((1u << len) - 1));
    n += len;
    while (n >= 8) {
      uint8_t b = (uint8_t)(acc >> (n - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      n -= 8;
    }
    acc &= (1u << n) - 1;
  }

  void flush() {  // pad the last byte with 1 bits
    if (n > 0) put((1u << (8 - n)) - 1, 8 - n);
  }
};

// jfdctint.c jpeg_fdct_islow on level-shifted samples: the output is the
// DCT scaled up by 8.
void fdct_islow(int32_t* d) {
  constexpr int kC = kConstBits, kP = kPass1Bits;
  for (int pass = 0; pass < 2; ++pass) {
    for (int r = 0; r < 8; ++r) {
      int32_t* x = pass == 0 ? d + 8 * r : d + r;
      const int s = pass == 0 ? 1 : 8;
      int32_t tmp0 = x[0] + x[7 * s], tmp7 = x[0] - x[7 * s];
      int32_t tmp1 = x[s] + x[6 * s], tmp6 = x[s] - x[6 * s];
      int32_t tmp2 = x[2 * s] + x[5 * s], tmp5 = x[2 * s] - x[5 * s];
      int32_t tmp3 = x[3 * s] + x[4 * s], tmp4 = x[3 * s] - x[4 * s];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int odd = pass == 0 ? kC - kP : kC + kP;
      if (pass == 0) {
        x[0] = (tmp10 + tmp11) * (1 << kP);
        x[4 * s] = (tmp10 - tmp11) * (1 << kP);
      } else {
        x[0] = descale(tmp10 + tmp11, kP);
        x[4 * s] = descale(tmp10 - tmp11, kP);
      }
      int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      x[2 * s] = descale(z1 + tmp13 * FIX_0_765366865, odd);
      x[6 * s] = descale(z1 + tmp12 * -FIX_1_847759065, odd);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      x[7 * s] = descale(tmp4 + z1 + z3, odd);
      x[5 * s] = descale(tmp5 + z2 + z4, odd);
      x[3 * s] = descale(tmp6 + z2 + z3, odd);
      x[s] = descale(tmp7 + z1 + z4, odd);
    }
  }
}

struct Encoder {
  uint16_t qt[2][64];
  EncodeTable dc[2] = {{kDcLumaBits, kDcVals, 12}, {kDcChromaBits, kDcVals, 12}};
  EncodeTable ac[2] = {{kAcLumaBits, kAcLumaVals, 162},
                       {kAcChromaBits, kAcChromaVals, 162}};

  explicit Encoder(int q) {
    // jcparam.c jpeg_quality_scaling and jpeg_add_quant_table (baseline)
    const int scale = q < 50 ? 5000 / q : 200 - q * 2;
    for (int i = 0; i < 64; ++i) {
      for (int t = 0; t < 2; ++t) {
        long v = ((long)(t ? kChromaQuant : kLumaQuant)[i] * scale + 50) / 100;
        qt[t][i] = (uint16_t)(v < 1 ? 1 : v > 255 ? 255 : v);
      }
    }
  }

  // One 8 x 8 block of samples (row stride `stride`), its DC predictor.
  void block(const uint8_t* p, size_t stride, int t, int& last_dc,
             OutBits& bits) const {
    int32_t d[64];
    for (int r = 0; r < 8; ++r) {
      for (int c = 0; c < 8; ++c) d[8 * r + c] = p[r * stride + c] - 128;
    }
    fdct_islow(d);
    int coef[64];
    for (int i = 0; i < 64; ++i) {  // jcdctmgr.c's rounding division
      const int32_t q = (int32_t)qt[t][i] << 3;
      int32_t v = d[i] < 0 ? -d[i] : d[i];
      v = (v + (q >> 1)) / q;
      coef[i] = d[i] < 0 ? -v : v;
    }
    auto magnitude = [](int v) {
      int n = 0;
      for (v = v < 0 ? -v : v; v; v >>= 1) ++n;
      return n;
    };
    int diff = coef[0] - last_dc;
    last_dc = coef[0];
    int n = magnitude(diff);
    bits.put(dc[t].code[n], dc[t].size[n]);
    if (n) bits.put((uint32_t)(diff < 0 ? diff - 1 : diff), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = coef[kZigzag[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      for (; run > 15; run -= 16) bits.put(ac[t].code[0xF0], ac[t].size[0xF0]);
      n = magnitude(v);
      int sym = run << 4 | n;
      bits.put(ac[t].code[sym], ac[t].size[sym]);
      bits.put((uint32_t)(v < 0 ? v - 1 : v), n);
      run = 0;
    }
    if (run) bits.put(ac[t].code[0], ac[t].size[0]);
  }
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

void put_dht(std::vector<uint8_t>& o, int cls, int id, const EncodeTable& t) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + t.nvals);
  o.push_back((uint8_t)(cls << 4 | id));
  o.insert(o.end(), t.bits, t.bits + 16);
  o.insert(o.end(), t.vals, t.vals + t.nvals);
}

// A component plane padded to (pw, ph) by replicating its last column and
// row, as libjpeg's edge expansion does.
std::vector<uint8_t> padded(const std::vector<uint8_t>& plane, int w, int h,
                            int pw, int ph) {
  std::vector<uint8_t> out((size_t)pw * ph);
  for (int y = 0; y < ph; ++y) {
    const uint8_t* src = &plane[(size_t)(y < h ? y : h - 1) * w];
    uint8_t* dst = &out[(size_t)y * pw];
    std::memcpy(dst, src, (size_t)w);
    std::memset(dst + w, src[w - 1], (size_t)(pw - w));
  }
  return out;
}

// Baseline JPEG of (height, width) gray or BGR pixels.
std::vector<uint8_t> encode_jpeg(const uint8_t* img, int height, int width,
                                 int channels, int quality) {
  if (channels != 1 && channels != 3) fail("JPEG encode: channels must be 1 or 3");
  if (height < 1 || width < 1 || height > 65535 || width > 65535) {
    fail("JPEG encode: %d x %d is not a JPEG size", height, width);
  }
  if (quality < 1 || quality > 100) fail("JPEG encode: quality %d", quality);
  const Encoder enc(quality);
  const int ncomp = channels, mcu = ncomp == 3 ? 16 : 8;
  const int pw = (width + mcu - 1) / mcu * mcu, ph = (height + mcu - 1) / mcu * mcu;
  const size_t n = (size_t)width * height;

  // jccolor.c rgb_ycc_convert in 16-bit fixed point
  std::vector<uint8_t> planes[3];
  if (ncomp == 1) {
    planes[0].assign(img, img + n);
  } else {
    auto fix = [](double x) { return (int32_t)(x * 65536 + 0.5); };
    const int32_t half = 1 << 15, offset = (128 << 16) + half - 1;
    for (auto& p : planes) p.resize(n);
    for (size_t i = 0; i < n; ++i) {
      const int32_t b = img[3 * i], g = img[3 * i + 1], r = img[3 * i + 2];
      planes[0][i] = (uint8_t)((fix(0.29900) * r + fix(0.58700) * g +
                                fix(0.11400) * b + half) >> 16);
      planes[1][i] = (uint8_t)((-fix(0.16874) * r - fix(0.33126) * g +
                                fix(0.5) * b + offset) >> 16);
      planes[2][i] = (uint8_t)((fix(0.5) * r - fix(0.41869) * g -
                                fix(0.08131) * b + offset) >> 16);
    }
  }
  for (int c = 0; c < ncomp; ++c) {
    planes[c] = padded(planes[c], width, height, pw, ph);
  }
  // jcsample.c h2v2_downsample: 2 x 2 means, the bias alternating 1, 2
  const int cw = pw / 2, ch = ph / 2;
  for (int c = 1; c < ncomp; ++c) {
    std::vector<uint8_t> half((size_t)cw * ch);
    for (int y = 0; y < ch; ++y) {
      const uint8_t* r0 = &planes[c][(size_t)2 * y * pw];
      const uint8_t* r1 = r0 + pw;
      int bias = 1;
      for (int x = 0; x < cw; ++x, bias ^= 3) {
        half[(size_t)y * cw + x] = (uint8_t)(
            (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
      }
    }
    planes[c].swap(half);
  }

  std::vector<uint8_t> o;
  o.reserve(n / 4 + 1024);
  o.insert(o.end(), {0xFF, 0xD8, 0xFF, 0xE0});  // SOI, APP0 (JFIF 1.01)
  put16(o, 16);
  o.insert(o.end(), {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  const int ntables = ncomp == 3 ? 2 : 1;
  for (int t = 0; t < ntables; ++t) {  // DQT, zigzag order
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 2 + 65);
    o.push_back((uint8_t)t);
    for (int k = 0; k < 64; ++k) o.push_back((uint8_t)enc.qt[t][kZigzag[k]]);
  }
  o.push_back(0xFF);  // SOF0
  o.push_back(0xC0);
  put16(o, 8 + 3 * ncomp);
  o.push_back(8);
  put16(o, height);
  put16(o, width);
  o.push_back((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    o.push_back((uint8_t)(c + 1));
    o.push_back(c == 0 && ncomp == 3 ? 0x22 : 0x11);
    o.push_back(c == 0 ? 0 : 1);
  }
  for (int t = 0; t < ntables; ++t) put_dht(o, 0, t, enc.dc[t]);
  for (int t = 0; t < ntables; ++t) put_dht(o, 1, t, enc.ac[t]);
  o.push_back(0xFF);  // SOS
  o.push_back(0xDA);
  put16(o, 6 + 2 * ncomp);
  o.push_back((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    o.push_back((uint8_t)(c + 1));
    o.push_back(c == 0 ? 0x00 : 0x11);
  }
  o.insert(o.end(), {0, 63, 0});

  OutBits bits(o);
  int last[3] = {0, 0, 0};
  for (int my = 0; my < ph / mcu; ++my) {
    for (int mx = 0; mx < pw / mcu; ++mx) {
      const int v = mcu / 8;  // Y blocks across and down an MCU
      for (int by = 0; by < v; ++by) {
        for (int bx = 0; bx < v; ++bx) {
          enc.block(&planes[0][((size_t)my * mcu + by * 8) * pw + mx * mcu + bx * 8],
                    (size_t)pw, 0, last[0], bits);
        }
      }
      for (int c = 1; c < ncomp; ++c) {
        enc.block(&planes[c][(size_t)my * 8 * cw + mx * 8], (size_t)cw, 1,
                  last[c], bits);
      }
    }
  }
  bits.flush();
  o.push_back(0xFF);  // EOI
  o.push_back(0xD9);
  return o;
}

// A copy in memory the caller frees with cris_free.
uint8_t* to_malloc(const uint8_t* p, size_t n) {
  uint8_t* out = (uint8_t*)std::malloc(n ? n : 1);
  if (!out) throw std::bad_alloc();
  if (n) std::memcpy(out, p, n);
  return out;
}

}  // namespace

namespace cris {

std::vector<uint8_t> zlib_inflate(const uint8_t* data, size_t size,
                                  size_t reserve) {
  InBits in(data, data + size);
  const uint32_t cmf = in.bits(8), flg = in.bits(8);
  if ((cmf & 0x0F) != 8 || (cmf >> 4) > 7 || (cmf << 8 | flg) % 31 != 0) {
    fail("incorrect header check");
  }
  if (flg & 0x20) fail("a preset dictionary is not supported");
  Output out;
  out.v.resize(reserve);
  for (;;) {
    const uint32_t last = in.bits(1), type = in.bits(2);
    if (type == 0) {
      inflate_stored(in, out);
    } else if (type == 1) {
      inflate_fixed(in, out);
    } else if (type == 2) {
      inflate_dynamic(in, out);
    } else {
      fail("invalid block type");
    }
    if (last) break;
  }
  in.drop(in.cnt & 7);
  uint32_t want = 0;
  for (int i = 0; i < 4; ++i) want = want << 8 | in.bits(8);
  if (adler32(out.v.data(), out.n) != want) fail("incorrect data check");
  out.v.resize(out.n);
  return std::move(out.v);
}

Image decode(const uint8_t* data, size_t size, bool gray) {
  if (size >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF) {
    return decode_jpeg_image(data, size, gray);
  }
  if (size >= sizeof kPngMagic &&
      std::memcmp(data, kPngMagic, sizeof kPngMagic) == 0) {
    return decode_png(data, size, gray);
  }
  fail("not a JPEG or PNG image");
}

}  // namespace cris

extern "C" {

// Decode JPEG or PNG bytes as cv2.imdecode does (gray 0: IMREAD_COLOR, BGR;
// gray 1: IMREAD_GRAYSCALE) into *out (height x width x channels, freed
// with cris_free). Returns 0, or 1 with a message in err.
int cris_decode(const uint8_t* data, long long n, int gray, uint8_t** out,
                int* height, int* width, int* channels, char* err,
                int errlen) {
  try {
    cris::Image img = cris::decode(data, (size_t)n, gray != 0);
    *out = to_malloc(img.pixels.data(), img.pixels.size());
    *height = img.height;
    *width = img.width;
    *channels = img.channels;
    return 0;
  } catch (const Fault& f) {
    return report(f.what(), err, errlen);
  } catch (const std::bad_alloc&) {
    return report("image: out of memory", err, errlen);
  }
}

// Baseline JPEG of height x width x channels pixels (1: gray, 3: BGR) at
// IJG quality 1-100 into *out (*out_len bytes, freed with cris_free).
int cris_jpeg_encode(const uint8_t* img, int height, int width, int channels,
                     int quality, uint8_t** out, long long* out_len, char* err,
                     int errlen) {
  try {
    std::vector<uint8_t> o = encode_jpeg(img, height, width, channels, quality);
    *out = to_malloc(o.data(), o.size());
    *out_len = (long long)o.size();
    return 0;
  } catch (const Fault& f) {
    return report(f.what(), err, errlen);
  } catch (const std::bad_alloc&) {
    return report("JPEG encode: out of memory", err, errlen);
  }
}

// A zlib stream inflated into *out (*out_len bytes, freed with cris_free).
int cris_zlib_inflate(const uint8_t* data, long long n, uint8_t** out,
                      long long* out_len, char* err, int errlen) {
  try {
    std::vector<uint8_t> o = cris::zlib_inflate(data, (size_t)n, 0);
    *out = to_malloc(o.data(), o.size());
    *out_len = (long long)o.size();
    return 0;
  } catch (const Fault& f) {
    return report(f.what(), err, errlen);
  } catch (const std::bad_alloc&) {
    return report("inflate: out of memory", err, errlen);
  }
}

void cris_free(void* p) { std::free(p); }

}  // extern "C"
