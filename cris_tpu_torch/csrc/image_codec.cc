// Host image decoding for the data path: baseline / extended-sequential
// Huffman JPEG and the PNG row filters, with a plain C interface for ctypes.
//
// The JPEG path follows libjpeg-turbo's default decompression (the library
// behind cv2.imdecode) operation for operation, so that its output equals
// OpenCV's bit for bit:
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
// message that names the marker or the fault.
//
// No global state: every call owns what it allocates, so concurrent calls
// from several threads are safe.

#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Fault : std::runtime_error {
  explicit Fault(const std::string& what) : std::runtime_error(what) {}
};

[[noreturn]] void fail(const char* fmt, int a = 0, int b = 0) {
  char buf[256];
  std::snprintf(buf, sizeof buf, fmt, a, b);
  throw Fault(buf);
}

int report(const Fault& f, char* err, int errlen) {
  if (err && errlen > 0) {
    std::snprintf(err, (size_t)errlen, "%s", f.what());
  }
  return 1;
}

// ----------------------------------------------------------------- JPEG

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

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
    } else if (marker == 0xE1 && app1_off < 0) {
      // the first APP1 segment, as OpenCV takes it for its EXIF reader
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

  // Headers only, through the frame header.
  void parse_header() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("JPEG: no SOI marker");
    pos = 2;
    while (!frame) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1) {
        read_sof(m);
      } else if (is_sof(m)) {
        refuse(m);
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xD9 || m == 0xDA) {
        fail("JPEG: no SOF marker before marker 0x%02X", m);
      } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD8)) {
        if (m == 0xD8) fail("SOI: a second SOI marker");
      } else {
        pos = segment(m);
      }
    }
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

void decode_jpeg(Jpeg& j, uint8_t* out, int channels) {
  j.parse();
  int W = j.width, H = j.height;
  size_t n = (size_t)W * H;
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

// ------------------------------------------------------------------ PNG

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

void png_unfilter(const uint8_t* raw, long long n, int height, int width,
                  int bpp, uint8_t* out) {
  size_t stride = (size_t)width * bpp;
  if ((unsigned long long)n < (unsigned long long)height * (stride + 1)) {
    fail("IDAT: not enough image data");
  }
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

}  // namespace

extern "C" {

// Header of a JPEG: its stored height and width, and the offset and
// length of the payload of its first APP1 segment (-1 and 0 when it has
// none). Returns 0, or 1 with a message in err.
int cris_jpeg_info(const uint8_t* data, long long n, int* height, int* width,
                   long long* app1_off, long long* app1_len, char* err,
                   int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    j.parse_header();
    *height = j.height;
    *width = j.width;
    *app1_off = j.app1_off;
    *app1_len = j.app1_len;
    return 0;
  } catch (const Fault& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Fault("JPEG: out of memory"), err, errlen);
  }
}

// Decode a JPEG into out: height x width x 3 BGR (channels 3) or
// height x width gray (channels 1), in stored orientation.
int cris_jpeg_decode(const uint8_t* data, long long n, uint8_t* out,
                     int channels, char* err, int errlen) {
  try {
    if (channels != 1 && channels != 3) fail("JPEG: channels must be 1 or 3");
    Jpeg j(data, (size_t)n);
    decode_jpeg(j, out, channels);
    return 0;
  } catch (const Fault& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Fault("JPEG: out of memory"), err, errlen);
  }
}

// Undo the PNG row filters of inflated image data (height rows of a filter
// byte and width * bpp bytes) into out (height x width * bpp).
int cris_png_unfilter(const uint8_t* raw, long long n, int height, int width,
                      int bpp, uint8_t* out, char* err, int errlen) {
  try {
    png_unfilter(raw, n, height, width, bpp, out);
    return 0;
  } catch (const Fault& f) {
    return report(f, err, errlen);
  }
}

}  // extern "C"
