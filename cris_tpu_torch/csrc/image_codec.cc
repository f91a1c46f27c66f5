// Host image coding for the data path, with a plain C interface for ctypes:
// Huffman JPEG decoding (baseline, extended-sequential and progressive) with
// the EXIF orientation, PNG decoding of every colour type, bit depth and
// interlace (the chunk walk, a self-contained inflate, the row filters,
// Adam7), and a baseline JPEG encoder.
//
// The JPEG decoder follows libjpeg-turbo's default decompression (the
// library behind cv2.imdecode) operation for operation, so that its output
// equals OpenCV's bit for bit:
//   - jdhuff.c / jdphuff.c entropy decoding: sequential scans, and the four
//     progressive scan kinds (DC first, DC refinement, AC first with
//     end-of-band runs, AC refinement) into a whole-image coefficient
//     buffer, each component's quantization table latched at its first scan;
//   - the islow inverse DCT as libjpeg-turbo's x86 SIMD runs it
//     (jsimd_idct_islow: 16-bit lanes that wrap and saturate, see
//     idct_islow);
//   - jdsample.c fancy upsampling: h2v1_fancy_upsample and
//     h2v2_fancy_upsample (the 8/7 bias alternating along a row, the row
//     above or below as context, the top and bottom rows replicated as
//     jdmainct.c does), and box replication when a component is at most
//     two samples wide, as jinit_upsampler picks it;
//   - jdcolor.c's YCbCr -> RGB tables in 16-bit fixed point, an RGB-coded
//     file (Adobe transform 0, or 'R' 'G' 'B' components and no JFIF) read
//     as is (gray by rgb_gray_convert), and for 4 components libjpeg's
//     CMYK output (YCCK through ycck_cmyk_convert) turned to BGR or gray
//     as OpenCV's icvCvt_CMYK2BGR / icvCvt_CMYK2Gray turn it.
// A progressive file is absorbed whole before the output pass, as libjpeg
// does it outside buffered-image mode; when its scans leave every
// coefficient exact, libjpeg's block smoothing has nothing to do and the
// IDCT of the final coefficients is its output. One whose scans leave
// low-frequency coefficients approximate (which libjpeg would smooth) is
// refused.
// A damaged stream decodes as libjpeg-turbo decodes it where it only warns
// (see BitReader and the scan decoders): a run past the last coefficient,
// a bad Huffman code, data that runs into a marker (the rest of the
// interval from zero bits), RSTn missing or out of order (its resync),
// bytes before a marker, a sequential scan's odd Ss / Se / Ah / Al, a
// progression out of order, and anything after the scan of a one-pass
// file (jdinput.c: one scan of every component). Where OpenCV's source
// runs out (a fill past the end of the data) cv2.imdecode gives None,
// and the decoder refuses.
// Only integer arithmetic is used for JPEG, so its bits do not depend on
// the compiler.
// Lossless, arithmetic-coded and hierarchical frames, 12-bit samples, and
// what libjpeg refuses are refused with a message that names the marker or
// the fault. The APP1 orientation tag is applied as OpenCV's
// ApplyExifOrientation applies it.
//
// PNG: colour types 0, 2, 3, 4 and 6 at every bit depth they allow, with or
// without Adam7, read as OpenCV asks libpng to read them (decode_png says
// how: palette to RGB, low depths to 8 bits, 16 bits to their high byte,
// alpha dropped, gray replicated, colour to gray by libpng's fixed-point
// weights, through its gamma tables when a gAMA or sRGB chunk gives a file
// gamma); an eXIf orientation is applied. An ancillary chunk with a bad
// CRC is dropped, a critical one refused; a critical chunk other than
// IHDR, PLTE, IDAT and IEND is refused. 16-bit colour read as gray under a
// file gamma is refused (libpng's 16-bit gamma tables are not reproduced).
// A fault in the IDAT stream after the call that inflated the last row (a
// bad Adler-32 among them) is libpng's warning, and the image is read.
// The inflate is RFC 1950/1951 (stored, fixed and dynamic blocks,
// Adler-32), written here because the zlib header is not known to exist on
// every host.
//
// decode() sniffs the format from its magic bytes and hands WebP, BMP,
// PNM / PAM, TIFF, GIF and Sun raster to webp_decode.cc,
// bmp_pnm_decode.cc, tiff_decode.cc and gif_ras_decode.cc; BigTIFF and
// anything else are refused with a message naming what the first bytes
// say it is. decode_jpeg_samples serves tiff_decode.cc's JPEG-compressed
// strips and tiles (a JPEGTables stream, then each strip's own) with
// libjpeg's YCbCr to RGB or the components as coded, as libtiff asks.
//
// The encoder writes baseline JPEG (SOF0) as libjpeg's defaults do: a JFIF
// APP0, the Annex K tables scaled by IJG quality, 4:2:0 for color, the
// standard Huffman tables, jfdctint's integer DCT.
//
// No global state: every call owns what it allocates, so concurrent calls
// from several threads are safe.

#include "image_codec.h"

#include <climits>
#include <cmath>
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

// OpenCV's CV_IO_MAX_IMAGE_WIDTH / HEIGHT and CV_IO_MAX_IMAGE_PIXELS.
constexpr long long kMaxSide = 1 << 20;
constexpr long long kMaxPixels = 1ll << 30;

void check_size(const char* what, long long w, long long h) {
  if (w <= 0 || h <= 0 || w > kMaxSide || h > kMaxSide || w * h > kMaxPixels) {
    throw Fault(std::string(what) + ": image size " + std::to_string(w) + " x " +
                std::to_string(h) + " is not supported");
  }
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

// jpeg_natural_order with libjpeg's 16 extra entries: a corrupt run that
// takes the zigzag index past 63 writes coefficient 63.
struct Natural {
  int at[80];
  Natural() {
    for (int k = 0; k < 80; ++k) at[k] = k < 64 ? kZigzag[k] : 63;
  }
};
const Natural kNatural;

constexpr int kLookBits = 8;  // HUFF_LOOKAHEAD
using cris::kMaxPixels;

// A DHT table as get_dht keeps it: checked only when a scan uses it.
struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

// jdhuff.c's d_derived_tbl.
struct Huffman {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << kLookBits];  // (length << 8) | value; length 9: longer
  uint8_t vals[256];
};

// jpeg_make_d_derived_tbl, run at the start of each scan for the tables
// it uses: a code set that overflows its lengths (or uses the all-ones
// code), or a DC symbol above 15, is refused.
void build_huffman(Huffman& h, const HuffSpec& spec, bool dc) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < spec.bits[l]; ++i) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  const int nsymbols = p;
  int32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      ++code;
    }
    if (code >= (1 << si)) fail("DHT: bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (spec.bits[l]) {
      h.valoffset[l] = p - huffcode[p];
      p += spec.bits[l];
      h.maxcode[l] = huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0xFFFFF;
  for (uint16_t& e : h.look) e = (kLookBits + 1) << 8;
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < spec.bits[l]; ++i, ++p) {
      int lookbits = huffcode[p] << (kLookBits - l);
      for (int n = 1 << (kLookBits - l); n > 0; --n) {
        h.look[lookbits++] = (uint16_t)(l << 8 | spec.vals[p]);
      }
    }
  }
  if (dc) {
    for (int i = 0; i < nsymbols; ++i) {
      if (spec.vals[i] > 15) fail("DHT: bad Huffman table");
    }
  }
  std::memcpy(h.vals, spec.vals, sizeof h.vals);
}

// jdmarker.c next_marker from p: skip to an 0xFF, past fill bytes, and
// over a stuffed 0xFF00; the marker code, or -1 at the end of the data.
int find_marker(const uint8_t*& p, const uint8_t* end) {
  for (;;) {
    while (p < end && *p != 0xFF) ++p;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) return -1;
    const int c = *p++;
    if (c != 0) return c;
  }
}

// Entropy-coded data as libjpeg-turbo reads it (jdhuff.c
// jpeg_fill_bit_buffer, HUFF_DECODE, jpeg_huff_decode): a fill loads
// whole bytes up to 57 bits, an 0xFF followed by 0xFFs and 0x00 is one
// 0xFF byte, and any other 0xFF pair is a marker, after which the buffer
// is padded with zero bits. A fill that needs bits past the marker sets
// `insufficient` (JWRN_HIT_MARKER): the MCU goes on from the zeros, and
// the MCUs after it are left as they are until a restart. A fill that
// reaches the end of the data is where OpenCV's source suspends, and
// cv2.imdecode gives None: a fault. (Sequential scans take libjpeg's fast
// path when 512 bytes a block are left; it fills in other steps, which
// moves no fill near the end of the data, where this matters.)
constexpr const char* kDataEnds =
    "SOS: corrupt entropy-coded data (premature end: the data ends with no EOI marker)";

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // get_buffer: the low `left` bits are unread
  int left = 0;
  int marker = 0;  // unread_marker
  bool insufficient = false;
  // decode_mcu_fast's reading (GET_BYTE): an 0xFF not followed by 0x00,
  // another 0xFF included, is a marker
  bool fast = false;

  BitReader(const uint8_t* p_, const uint8_t* e_) : p(p_), end(e_) {}

  int byte() {
    if (p >= end) fail(kDataEnds);
    return *p++;
  }

  void fill(int nbits) {
    if (!marker) {
      while (left < 57) {
        int c = byte();
        if (c == 0xFF && fast) {
          if (p < end && *p == 0) {
            ++p;
          } else {
            marker = p < end ? *p : 0xD9;
            --p;
            break;
          }
        } else if (c == 0xFF) {
          do {
            c = byte();
          } while (c == 0xFF);
          if (c != 0) {
            marker = c;
            break;
          }
          c = 0xFF;
        }
        buf = buf << 8 | (uint64_t)c;
        left += 8;
      }
      if (!marker) return;
    }
    if (nbits > left) {
      insufficient = true;
      buf <<= 57 - left;
      left = 57;
    }
  }

  int take(int n) {  // GET_BITS
    left -= n;
    return (int)(buf >> left) & ((1 << n) - 1);
  }

  int bits(int n) {  // CHECK_BIT_BUFFER, then GET_BITS
    if (n == 0) return 0;
    if (left < n) fill(n);
    return take(n);
  }

  // HUFF_DECODE: a code that no length matches ends at 17 bits and
  // decodes as 0 (JWRN_HUFF_BAD_CODE).
  int decode(const Huffman& h) {
    int nb = 1;
    if (left < kLookBits) fill(0);
    if (left >= kLookBits) {
      const int e = h.look[(buf >> (left - kLookBits)) & ((1 << kLookBits) - 1)];
      nb = e >> 8;
      if (nb <= kLookBits) {
        left -= nb;
        return e & 0xFF;
      }
    }
    int32_t code;
    if (left >= 17) {  // the longest search, 17 bits, needs no fill
      code = (int32_t)(buf >> (left - nb)) & ((1 << nb) - 1);
      while (code > h.maxcode[nb]) {
        ++nb;
        code = (int32_t)(buf >> (left - nb)) & ((1 << nb) - 1);
      }
      left -= nb;
    } else {
      code = bits(nb);
      while (code > h.maxcode[nb]) {
        code = code << 1 | bits(1);
        ++nb;
      }
    }
    if (nb > 16) return 0;
    return h.vals[(code + h.valoffset[nb]) & 0xFF];
  }

  // jdhuff.c process_restart: drop the buffered bits, read RSTn
  // (jdmarker.c read_restart_marker, or jpeg_resync_to_restart when it is
  // not the one expected), and resume unless a marker is still ahead.
  void restart(int& next) {
    left = 0;
    if (!marker) marker = next_marker();
    if (marker == 0xD0 + next) {
      marker = 0;
    } else {
      for (;;) {
        int action = 1;  // take it as RSTn and go on
        if (marker < 0xC0) {
          action = 2;  // not a marker: scan to the next
        } else if (marker < 0xD0 || marker > 0xD7) {
          action = 3;  // a marker after the scan: leave it for later
        } else if (marker == 0xD0 + ((next + 1) & 7) ||
                   marker == 0xD0 + ((next + 2) & 7)) {
          action = 3;
        } else if (marker == 0xD0 + ((next - 1) & 7) ||
                   marker == 0xD0 + ((next - 2) & 7)) {
          action = 2;
        }
        if (action == 1) marker = 0;
        if (action != 2) break;
        marker = next_marker();
      }
    }
    next = (next + 1) & 7;
    if (!marker) insufficient = false;
  }

  int next_marker() {
    const int m = find_marker(p, end);
    if (m < 0) fail(kDataEnds);
    return m;
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
  // The quantization table as the component's first scan found it
  // (jdinput.c latch_quant_tables); all zero if it never had a scan.
  uint16_t q[64] = {};
  bool latched = false;
};

struct Jpeg {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  int restart = 0;
  bool frame = false, scanned = false, progressive = false;
  // jdinput.c initial_setup: a file whose first scan holds every component
  // of a sequential frame is decoded in one pass, as OpenCV reads it, and
  // nothing after that scan is read (jpeg_finish_decompress's faults are
  // not OpenCV's); any other is absorbed to its EOI.
  bool one_pass = false;
  int pending = 0;  // a marker the last scan's data ran into (unread_marker)
  int scans = 0;
  // Progressive: the Al of each coefficient's (zigzag index) last scan,
  // -1 before its first, as libjpeg's coef_bits.
  int coef_bits[4][64];
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  long long app1_off = -1, app1_len = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffSpec dc[4], ac[4];
  Component comp[4];

  Jpeg(const uint8_t* d, size_t n) : data(d), size(n) {
    for (auto& bits : coef_bits) {
      for (int& b : bits) b = -1;
    }
  }

  int u8() {
    if (pos >= size) fail("JPEG: unexpected end of data");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return hi << 8 | u8();
  }

  int next_marker() {
    if (pending) {
      const int m = pending;
      pending = 0;
      return m;
    }
    const uint8_t* p = data + pos;
    const int m = find_marker(p, data + size);
    if (m < 0) fail("JPEG: no EOI marker (truncated data)");
    pos = (size_t)(p - data);
    return m;
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
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) {
      fail("SOF%d: %d components are not supported", marker - 0xC0, ncomp);
    }
    if (stop - pos != 3 * (size_t)ncomp) {
      fail("SOF%d: %d components do not fit the segment length", marker - 0xC0,
           ncomp);
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
    progressive = marker == 0xC2;
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
      if (tq > 3) fail("DQT: bad table");  // any Pq but 0 reads 16-bit values (get_dqt)
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
      HuffSpec& h = tc ? ac[th] : dc[th];
      int total = 0;
      for (int i = 1; i <= 16; ++i) {
        h.bits[i] = (uint8_t)u8();
        total += h.bits[i];
      }
      if (total > 256 || pos + (size_t)total > stop) fail("DHT: bad Huffman table");
      std::memset(h.vals, 0, sizeof h.vals);
      for (int i = 0; i < total; ++i) h.vals[i] = (uint8_t)u8();
      h.defined = true;
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

  void latch(Component& c) {
    if (c.latched) return;
    if (!qt_defined[c.tq]) fail("DQT: quantization table %d not defined", c.tq);
    std::memcpy(c.q, qt[c.tq], sizeof c.q);
    c.latched = true;
  }

  // jdphuff.c start_pass_phuff_decoder's checks of a progressive scan, and
  // the coefficients' progression, which libjpeg only warns about
  // (JWRN_BOGUS_PROGRESSION) and records as it comes.
  void check_progression(Component* const* sc, int ns, int ss, int se,
                         int ah, int al) {
    bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad) {
      char msg[128];
      std::snprintf(msg, sizeof msg,
                    "SOS: bad progression parameters Ss %d, Se %d, Ah %d, "
                    "Al %d", ss, se, ah, al);
      throw Fault(msg);
    }
    for (int i = 0; i < ns; ++i) {
      int* bits = coef_bits[sc[i] - comp];
      for (int k = ss; k <= se; ++k) bits[k] = al;
    }
  }

  // Calls mcu(u) for every MCU u of the scan in stream order (a
  // one-component scan's MCU is one of that component's own
  // ceil(dw / 8) x ceil(dh / 8) blocks). At each restart interval it reads
  // RSTn and calls reset(). Once the data has run out (br.insufficient),
  // an MCU is left as it is.
  template <class Mcu, class Reset>
  void each_mcu(Component* const* sc, int ns, BitReader& br, Mcu&& mcu,
                Reset&& reset) {
    const long long units =
        ns == 1 ? (long long)((sc[0]->dw + 7) / 8) * ((sc[0]->dh + 7) / 8)
                : (long long)mcux * mcuy;
    int rst = 0;
    for (long long u = 0; u < units; ++u) {
      if (restart && u > 0 && u % restart == 0) {
        br.restart(rst);
        reset();
      }
      if (!br.insufficient) mcu(u);
    }
  }

  // Calls block(i, coefficients) for every block of MCU u.
  template <class Block>
  void mcu_blocks(Component* const* sc, int ns, long long u, Block&& block) {
    auto at = [](Component& c, int bx, int by) {
      return &c.coef[((size_t)by * c.bw + bx) * 64];
    };
    const long long across = ns == 1 ? (sc[0]->dw + 7) / 8 : mcux;
    const int ux = (int)(u % across), uy = (int)(u / across);
    if (ns == 1) {
      block(0, at(*sc[0], ux, uy));
      return;
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      for (int y = 0; y < c.v; ++y) {
        for (int x = 0; x < c.h; ++x) {
          block(i, at(c, ux * c.h + x, uy * c.v + y));
        }
      }
    }
  }

  template <class Block, class Reset>
  void each_block(Component* const* sc, int ns, BitReader& br, Block&& block,
                  Reset&& reset) {
    each_mcu(sc, ns, br, [&](long long u) { mcu_blocks(sc, ns, u, block); },
             reset);
  }

  // A baseline / extended-sequential scan: all 64 coefficients of each
  // block (jdhuff.c decode_mcu_slow). Where libjpeg-turbo takes its fast
  // path (no restart interval, 512 bytes a block left, no marker met) and
  // that path reads an 0xFF 0xFF 0x00 as a marker, it gives up the MCU to
  // the slow path, which decodes it again over the coefficients the fast
  // one wrote: the blocks keep those the slow path does not write.
  void sequential_scan(Component* const* sc, int ns, const Huffman* dct,
                       const Huffman* act, BitReader& br) {
    unsigned pred[4] = {0, 0, 0, 0};
    auto block = [&](BitReader& in, unsigned* last, int i, int16_t* blk) {
      int s = in.decode(dct[i]);
      last[i] += (unsigned)extend(in.bits(s), s);
      blk[0] = (int16_t)last[i];
      for (int k = 1; k < 64; ++k) {
        const int rs = in.decode(act[i]), r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural.at[k]] = (int16_t)extend(in.bits(s), s);
        } else if (r == 15) {
          k += 15;
        } else {
          break;
        }
      }
    };
    size_t blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += ns == 1 ? 1 : sc[i]->h * sc[i]->v;
    bool doubled_ahead = false;  // an 0xFF 0xFF anywhere after the scan's start
    for (const uint8_t* q = br.p; q + 1 < br.end && !doubled_ahead; ++q) {
      q = (const uint8_t*)std::memchr(q, 0xFF, (size_t)(br.end - q));
      if (!q) break;
      doubled_ahead = q + 1 < br.end && q[1] == 0xFF;
    }
    each_mcu(sc, ns, br, [&](long long u) {
      if (!doubled_ahead) {
        mcu_blocks(sc, ns, u, [&](int i, int16_t* blk) { block(br, pred, i, blk); });
        return;
      }
      const BitReader start = br;
      unsigned before[4];
      std::memcpy(before, pred, sizeof pred);
      mcu_blocks(sc, ns, u, [&](int i, int16_t* blk) { block(br, pred, i, blk); });
      if (restart || start.marker || (size_t)(start.end - start.p) < 512 * blocks) return;
      const uint8_t* to = br.p + 16 < br.end ? br.p + 16 : br.end;
      bool doubled = false;
      for (const uint8_t* q = start.p; q + 1 < to && !doubled; ++q) {
        doubled = q[0] == 0xFF && q[1] == 0xFF;
      }
      if (!doubled) return;
      BitReader fast = start;
      fast.fast = true;
      unsigned last[4];
      std::memcpy(last, before, sizeof last);
      mcu_blocks(sc, ns, u, [&](int i, int16_t* blk) { block(fast, last, i, blk); });
      if (!fast.marker) return;
      br = start;
      std::memcpy(pred, before, sizeof pred);
      mcu_blocks(sc, ns, u, [&](int i, int16_t* blk) { block(br, pred, i, blk); });
    }, [&] { pred[0] = pred[1] = pred[2] = pred[3] = 0; });
  }

  // One scan of a progressive frame, as jdphuff.c decodes it: DC first
  // (the difference shifted up by Al), DC refinement (one bit), AC first
  // over Ss..Se with end-of-band runs, AC refinement (a correction bit for
  // each coefficient already nonzero, new coefficients of +-2^Al). The
  // predictors and the end-of-band run restart at each RSTn. A run past Se
  // writes the coefficient it lands on, and a new refinement coefficient
  // of a size other than 1 is taken as 1 (libjpeg warns).
  void progressive_scan(Component* const* sc, int ns, const Huffman* dct,
                        const Huffman& act, int ss, int se, int ah, int al,
                        BitReader& br) {
    unsigned pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    const int p1 = 1 << al, m1 = -p1;
    auto reset = [&] { pred[0] = pred[1] = pred[2] = pred[3] = eobrun = 0; };
    // a run of 2^r plus r more bits of end-of-band, this block included
    auto eob_run = [&](int r) { return (1 << r) + br.bits(r); };
    auto refine = [&](int16_t& c) {  // a correction bit of a nonzero c
      if (br.bits(1) && (c & p1) == 0) c = (int16_t)(c + (c >= 0 ? p1 : m1));
    };
    if (ss == 0 && ah == 0) {
      each_block(sc, ns, br, [&](int i, int16_t* blk) {
        const int s = br.decode(dct[i]);
        const int d = extend(br.bits(s), s);
        const int last = (int)pred[i];
        if ((last >= 0 && d > INT_MAX - last) || (last < 0 && d < INT_MIN - last)) {
          fail("SOS: corrupt entropy-coded data (DC overflow)");
        }
        pred[i] += (unsigned)d;
        blk[0] = (int16_t)(pred[i] << al);
      }, reset);
    } else if (ss == 0) {
      each_block(sc, ns, br, [&](int, int16_t* blk) {
        if (br.bits(1)) blk[0] = (int16_t)(blk[0] | p1);
      }, reset);
    } else if (ah == 0) {
      each_block(sc, ns, br, [&](int, int16_t* blk) {
        if (eobrun > 0) {
          --eobrun;
          return;
        }
        for (int k = ss; k <= se; ++k) {
          const int rs = br.decode(act), r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[kNatural.at[k]] = (int16_t)((unsigned)extend(br.bits(s), s) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = eob_run(r) - 1;
            break;
          }
        }
      }, reset);
    } else {
      each_block(sc, ns, br, [&](int, int16_t* blk) {
        int k = ss;
        if (eobrun == 0) {
          for (; k <= se; ++k) {
            int rs = br.decode(act), r = rs >> 4, s = rs & 15;
            if (s) {
              s = br.bits(1) ? p1 : m1;
            } else if (r != 15) {
              eobrun = eob_run(r);
              break;
            }
            // skip r zero coefficients, refining the nonzero ones on the way
            for (; k <= se; ++k) {
              int16_t& c = blk[kNatural.at[k]];
              if (c != 0) {
                refine(c);
              } else if (--r < 0) {
                break;
              }
            }
            if (s) blk[kNatural.at[k]] = (int16_t)s;
          }
        }
        if (eobrun > 0) {  // the rest of the band: only refinement bits
          for (; k <= se; ++k) {
            if (blk[kNatural.at[k]] != 0) refine(blk[kNatural.at[k]]);
          }
          --eobrun;
        }
      }, reset);
    }
  }

  void read_sos() {
    size_t stop = segment(0xDA);
    if (!frame) fail("SOS: no frame header before the scan");
    int ns = u8();
    if (ns < 1 || ns > ncomp) fail("SOS: bad component count %d", ns);
    Component* sc[4];
    int td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j) {
        if (comp[j].id == id) sc[i] = &comp[j];
      }
      if (!sc[i]) fail("SOS: unknown component id %d", id);
      td[i] = t >> 4;
      ta[i] = t & 15;
    }
    int ss = u8(), se = u8(), ahal = u8(), ah = ahal >> 4, al = ahal & 15;
    if (pos != stop) fail("SOS: bad segment length");
    if (ns > 1) {  // jdinput.c per_scan_setup: D_MAX_BLOCKS_IN_MCU
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) fail("SOS: %d blocks in an MCU (libjpeg allows 10)", blocks);
    }
    if (!scanned) one_pass = !progressive && ns == ncomp;
    // a sequential scan's Ss, Se, Ah and Al are not read (libjpeg warns
    // when they are not 0, 63, 0, 0)
    if (progressive) check_progression(sc, ns, ss, se, ah, al);
    // the tables the scan decodes with, built as it starts
    const bool dc_coded = !progressive || (ss == 0 && ah == 0);
    const bool ac_coded = !progressive || ss > 0;
    Huffman dct[4], act[4];
    for (int i = 0; i < ns; ++i) {
      if ((dc_coded && (td[i] > 3 || !dc[td[i]].defined)) ||
          (ac_coded && (ta[i] > 3 || !ac[ta[i]].defined))) {
        fail("SOS: Huffman table not defined");
      }
      if (dc_coded) build_huffman(dct[i], dc[td[i]], true);
      if (ac_coded) build_huffman(act[i], ac[ta[i]], false);
    }
    for (int i = 0; i < ns; ++i) latch(*sc[i]);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }

    BitReader br(data + pos, data + size);
    if (!progressive) {
      sequential_scan(sc, ns, dct, act, br);
    } else {
      try {
        progressive_scan(sc, ns, dct, act[0], ss, se, ah, al, br);
      } catch (const Fault& f) {
        char where[96];
        std::snprintf(where, sizeof where,
                      "scan %d (Ss %d, Se %d, Ah %d, Al %d): ", scans + 1, ss,
                      se, ah, al);
        throw Fault(where + std::string(f.what()));
      }
    }
    pos = (size_t)(br.p - data);
    pending = br.marker;
    scanned = true;
    ++scans;
  }

  // jdcoefct.c smoothing_ok: after the whole file, would libjpeg smooth the
  // blocks of a progressive image? Only when every component's DC is known
  // and some coefficient of zigzag index 1..9 is still approximate.
  bool smoothing_on() const {
    static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      if (!comp[i].latched) return false;
      for (int k : kQ) {
        if (comp[i].q[k] == 0) return false;
      }
      if (coef_bits[i][0] < 0) return false;
      for (int k = 1; k < 10; ++k) useful |= coef_bits[i][k] != 0;
    }
    return useful;
  }

  // A frame or coding marker this decoder refuses, named in the message.
  static bool is_sof(int m) {
    return m >= 0xC3 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC;
  }

  [[noreturn]] static void refuse(int m) {
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
    try {
      segments();
    } catch (const Fault& f) {
      if (!progressive) throw;
      throw Fault(std::string("SOF2: progressive JPEG: ") + f.what());
    }
    if (!frame) fail("JPEG: no SOF marker");
    if (!scanned) fail("JPEG: no SOS marker");
    if (progressive && smoothing_on()) {
      fail("SOF2: progressive JPEG: its scans leave coefficients approximate, "
           "which libjpeg would smooth; that is not supported");
    }
  }

  void segments() {
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
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
        if (one_pass) break;
      } else if (m == 0xD9) {
        break;
      } else if (m == 0xDC) {
        pos = segment(m);  // a DNL after the frame is skipped (libjpeg reads no height from it)
      } else if (m == 0xDE || m == 0xDF) {
        fail("marker 0x%02X: hierarchical JPEG is not supported", m);
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xFE) {
        pos = segment(m);
      } else if (m >= 0xF0 && m <= 0xFD) {
        fail("marker 0x%02X: a JPGn extension marker (libjpeg refuses it)", m);
      } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
        // TEM, or a stray RSTn between segments: no payload
      } else if (m == 0xD8) {
        fail("SOI: a second SOI marker");
      } else {
        fail("marker 0x%02X: unexpected", m);
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

// libjpeg-turbo's SIMD jsimd_idct_islow (jidctint-sse2.asm and its AVX2
// twin, which OpenCV's build runs) in 16-bit lanes: jidctint.c's islow
// arithmetic, except that
//   - dequantisation is a 16-bit multiply that wraps (pmullw), and so are
//     in0 +- in4 and the odd part's two sums (paddw);
//   - a block whose rows 1-7 of coefficients are all zero takes pass 1's
//     shortcut: the DC row's dequantised values shifted up by PASS1_BITS in
//     16 bits (psllw, which wraps); otherwise every column runs;
//   - each pass's outputs are descaled and packed to int16 with saturation
//     (packssdw), and pass 2's again to int8 (packsswb) before 128 is
//     added, so an output past [-128, 127] clamps;
//   - pass 2 has no shortcut.
// jidctint.c's and jfdctint.c's constants: FIX(x) = x * 2^13, rounded
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

constexpr int kPass1Shift = 13 - 2, kPass2Shift = 13 + 2 + 3;

inline int16_t wrap16(int64_t v) { return (int16_t)(uint16_t)(uint64_t)v; }

inline int16_t sat16(int32_t v) {
  return (int16_t)(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}

// One 8-point pass over eight int16 lanes x[0..7]: y[k] is output k,
// descaled by shift and saturated to int16. jidctint.c's products and
// sums, in 32 bits that wrap as the SIMD's pmaddwd / paddd do (taken
// unsigned), with its 16-bit wraps of in0 +- in4, in7 + in3 and in5 + in1
// (paddw); the SIMD's pmaddwd pairs are the same sums of products. Lanes
// whose AC inputs are all zero give the DC term's value in every output,
// computed alone.
template <int shift>
inline void idct_lanes(const int16_t* x, int16_t* y) {
  using u32 = uint32_t;
  constexpr u32 round = (u32)1 << (shift - 1);
  if (!(x[1] | x[2] | x[3] | x[4] | x[5] | x[6] | x[7])) {
    const int16_t v = sat16((int32_t)((u32)x[0] * 8192u + round) >> shift);
    for (int k = 0; k < 8; ++k) y[k] = v;
    return;
  }
  // even part
  const u32 z1 = (u32)(x[2] + x[6]) * (u32)FIX_0_541196100;
  const u32 tmp2 = z1 - (u32)x[6] * (u32)FIX_1_847759065;
  const u32 tmp3 = z1 + (u32)x[2] * (u32)FIX_0_765366865;
  const u32 tmp0 = (u32)wrap16(x[0] + x[4]) * 8192u;
  const u32 tmp1 = (u32)wrap16(x[0] - x[4]) * 8192u;
  const u32 tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const u32 tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  // odd part: x[7], x[5], x[3], x[1] are jidctint.c's tmp0..tmp3
  const int32_t z3 = wrap16(x[7] + x[3]), z4 = wrap16(x[5] + x[1]);
  const u32 z5 = (u32)(z3 + z4) * (u32)FIX_1_175875602;
  const u32 zz3 = z5 - (u32)z3 * (u32)FIX_1_961570560;
  const u32 zz4 = z5 - (u32)z4 * (u32)FIX_0_390180644;
  const u32 za = (u32)(x[7] + x[1]) * (u32)FIX_0_899976223;
  const u32 zb = (u32)(x[5] + x[3]) * (u32)FIX_2_562915447;
  const u32 o0 = (u32)x[7] * (u32)FIX_0_298631336 - za + zz3;
  const u32 o1 = (u32)x[5] * (u32)FIX_2_053119869 - zb + zz4;
  const u32 o2 = (u32)x[3] * (u32)FIX_3_072711026 - zb + zz3;
  const u32 o3 = (u32)x[1] * (u32)FIX_1_501321110 - za + zz4;
  const u32 d[8] = {tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
                    tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3};
  for (int k = 0; k < 8; ++k) y[k] = sat16((int32_t)(d[k] + round) >> shift);
}

// jsimd_idct_islow: columns of the dequantised block, then rows, into
// out (8 x 8 samples at the given stride).
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int16_t ws[64], x[8], y[8];
  bool ac = false;
  for (int k = 8; k < 64; ++k) ac |= in[k] != 0;
  for (int c = 0; c < 8; ++c) {
    if (!ac) {
      const int16_t v = wrap16((int32_t)wrap16((uint32_t)in[c] * q[c]) * 4);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
      continue;
    }
    for (int r = 0; r < 8; ++r) x[r] = wrap16((uint32_t)in[8 * r + c] * q[8 * r + c]);
    idct_lanes<kPass1Shift>(x, y);
    for (int r = 0; r < 8; ++r) ws[8 * r + c] = y[r];
  }
  for (int r = 0; r < 8; ++r) {
    idct_lanes<kPass2Shift>(ws + 8 * r, y);
    uint8_t* op = out + (size_t)r * stride;
    for (int c = 0; c < 8; ++c) {
      op[c] = (uint8_t)((y[c] < -128 ? -128 : y[c] > 127 ? 127 : y[c]) + 128);
    }
  }
}

void inverse_dct(Component& c) {
  int stride = c.bw * 8;
  c.plane.assign((size_t)stride * c.bh * 8, 0);
  if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
  for (int by = 0; by < c.bh; ++by) {
    for (int bx = 0; bx < c.bw; ++bx) {
      idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.q,
                 &c.plane[(size_t)by * 8 * stride + bx * 8], stride);
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

// jdcolor.c build_ycc_rgb_table, SCALEBITS 16
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int32_t one_half = 1 << 15;
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = (int)((91881 * x + one_half) >> 16);   // FIX(1.40200)
      cb_b[i] = (int)((116130 * x + one_half) >> 16);  // FIX(1.77200)
      cr_g[i] = -46802 * x;                            // -FIX(0.71414)
      cb_g[i] = -22554 * x + one_half;                 // -FIX(0.34414)
    }
  }
};

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// The output pass: libjpeg's colour conversion to what OpenCV asks of it
// (JCS_EXT_BGR or JCS_GRAYSCALE; JCS_CMYK for 4 components, then OpenCV's
// icvCvt_CMYK2BGR / icvCvt_CMYK2Gray).
void decode_jpeg(Jpeg& j, cris::Image& img, int channels) {
  j.parse();
  int W = j.width, H = j.height;
  size_t n = (size_t)W * H;
  img.height = H;
  img.width = W;
  img.channels = channels;
  img.pixels.resize(n * channels);
  uint8_t* out = img.pixels.data();
  const bool rgb = j.ncomp == 3 && !j.ycbcr();
  const bool cmyk = j.ncomp == 4;
  // gray from YCbCr is the Y plane alone; every other case needs them all
  const int used = channels == 1 && !rgb && !cmyk ? 1 : j.ncomp;
  for (int i = 0; i < used; ++i) inverse_dct(j.comp[i]);
  std::vector<uint8_t> y = upsample(j, j.comp[0]);
  if (used == 1) {
    if (channels == 1) {
      std::memcpy(out, y.data(), n);
    } else {
      for (size_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    }
    return;
  }
  std::vector<uint8_t> c1 = upsample(j, j.comp[1]), c2 = upsample(j, j.comp[2]);
  static const YccTables t;
  if (rgb) {
    for (size_t i = 0; i < n; ++i) {
      const int r = y[i], g = c1[i], b = c2[i];
      if (channels == 1) {  // rgb_gray_convert: FIX(0.299), FIX(0.587), FIX(0.114)
        out[i] = (uint8_t)((19595 * r + 38470 * g + 7471 * b + (1 << 15)) >> 16);
      } else {
        out[3 * i] = (uint8_t)b;
        out[3 * i + 1] = (uint8_t)g;
        out[3 * i + 2] = (uint8_t)r;
      }
    }
    return;
  }
  if (!cmyk) {
    for (size_t i = 0; i < n; ++i) {
      int yy = y[i], b = c1[i], r = c2[i];
      out[3 * i + 2] = clamp255(yy + t.cr_r[r]);
      out[3 * i + 1] = clamp255(yy + (int)((t.cb_g[b] + t.cr_g[r]) >> 16));
      out[3 * i + 0] = clamp255(yy + t.cb_b[b]);
    }
    return;
  }
  std::vector<uint8_t> k = upsample(j, j.comp[3]);
  // Adobe transform 0: CMYK as stored; no Adobe marker: CMYK; any other
  // transform: YCCK, turned to CMYK by ycck_cmyk_convert
  const bool ycck = j.adobe && j.adobe_transform != 0;
  for (size_t i = 0; i < n; ++i) {
    int c = y[i], m = c1[i], ye = c2[i];
    const int kk = k[i];
    if (ycck) {
      const int yy = y[i], cb = c1[i], cr = c2[i];
      c = clamp255(255 - (yy + t.cr_r[cr]));
      m = clamp255(255 - (yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
      ye = clamp255(255 - (yy + t.cb_b[cb]));
    }
    c = kk - ((255 - c) * kk >> 8);
    m = kk - ((255 - m) * kk >> 8);
    ye = kk - ((255 - ye) * kk >> 8);
    if (channels == 1) {  // OpenCV's 14-bit weights, c as red
      out[i] = (uint8_t)((ye * 1868 + m * 9617 + c * 4899 + (1 << 13)) >> 14);
    } else {
      out[3 * i] = (uint8_t)ye;
      out[3 * i + 1] = (uint8_t)m;
      out[3 * i + 2] = (uint8_t)c;
    }
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

}  // namespace

namespace cris {

// The orientation tag (0x0112) of a TIFF-structured EXIF block, read as
// OpenCV's EXIF reader reads it: IFD0's entries; 1 when there is none or
// the header is not TIFF.
int exif_orientation_tiff(const uint8_t* t, size_t len) {
  if (len < 8) return 1;
  const uint64_t n = len;
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
void apply_orientation(Image& img, int orientation) {
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

}  // namespace cris

namespace {

using cris::apply_orientation;
using cris::exif_orientation_tiff;

// The orientation of an APP1 payload: its TIFF header 6 bytes in (after
// "Exif\0\0").
int exif_orientation(const uint8_t* payload, size_t len) {
  return len < 6 ? 1 : exif_orientation_tiff(payload + 6, len - 6);
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

}  // namespace

namespace cris {

JpegSamples decode_jpeg_samples(const uint8_t* tables, size_t tables_len,
                                const uint8_t* data, size_t size,
                                bool ycbcr_to_rgb) {
  if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("JPEG: no SOI marker");
  // the tables stream without its EOI, then the stream without its SOI:
  // one stream whose tables precede the frame, as libjpeg keeps them; then
  // the EOI that libtiff's source inserts where the data runs out
  std::vector<uint8_t> joined;
  if (tables_len >= 4) {
    if (tables[0] != 0xFF || tables[1] != 0xD8) fail("JPEGTables: no SOI marker");
    size_t keep = tables_len;
    if (tables[keep - 2] == 0xFF && tables[keep - 1] == 0xD9) keep -= 2;
    joined.assign(tables, tables + keep);
    joined.insert(joined.end(), data + 2, data + size);
  } else {
    joined.assign(data, data + size);
  }
  joined.push_back(0xFF);
  joined.push_back(0xD9);
  Jpeg j(joined.data(), joined.size());
  j.parse();
  JpegSamples out;
  out.width = j.width;
  out.height = j.height;
  out.components = j.ncomp;
  out.h0 = j.comp[0].h;
  out.v0 = j.comp[0].v;
  const bool convert = ycbcr_to_rgb && j.ncomp == 3;
  if (!convert) {
    for (int i = 0; i < j.ncomp; ++i) {
      if (j.comp[i].h != 1 || j.comp[i].v != 1) {
        fail("JPEG: subsampled components (%dx%d) without a YCbCr to RGB conversion",
             j.comp[i].h, j.comp[i].v);
      }
    }
  }
  const size_t n = (size_t)j.width * j.height;
  const int nc = j.ncomp;
  out.samples.resize(n * nc);
  std::vector<uint8_t> planes[4];
  for (int i = 0; i < nc; ++i) {
    inverse_dct(j.comp[i]);
    planes[i] = upsample(j, j.comp[i]);
  }
  uint8_t* o = out.samples.data();
  if (!convert) {
    for (size_t k = 0; k < n; ++k) {
      for (int i = 0; i < nc; ++i) *o++ = planes[i][k];
    }
    return out;
  }
  static const YccTables t;
  for (size_t k = 0; k < n; ++k, o += 3) {
    const int yy = planes[0][k], b = planes[1][k], r = planes[2][k];
    o[0] = clamp255(yy + t.cr_r[r]);
    o[1] = clamp255(yy + (int)((t.cb_g[b] + t.cr_g[r]) >> 16));
    o[2] = clamp255(yy + t.cb_b[b]);
  }
  return out;
}

}  // namespace cris

namespace {

// -------------------------------------------------------------- inflate

// What libpng's sequential reader makes of a zlib stream once every row
// has inflated. zlib inflates into a row per call, and a call goes on past
// a full row until it must write a byte, runs out of the piece of IDAT
// data it was given, or ends the stream; an error in that call (a bad code, a
// bad Adler-32) is fatal. After it, png_read_finish_IDAT inflates the rest
// into a scratch buffer: an error there is only a warning, but a stream
// that runs out of IDAT data before its end is fatal.
struct RowsDone {
  const std::vector<size_t>* ends;  // where each piece of IDAT data ends
  int phase = 0;  // 0: rows not all in; 1: in the call that completed them; 2: after
  uint64_t boundary = 0;  // the end of phase 1's piece, in bits
  bool truncated = false;  // the data ran out before the stream ended
};

// LSB-first bits of a deflate stream. Past the end, zero bits are fed;
// consuming one of them is a fault.
struct InBits {
  const uint8_t* p;
  const uint8_t* end;
  const uint8_t* start;
  uint64_t buf = 0;
  int cnt = 0;  // bits in buf
  int pad = 0;  // of them, fed past the end
  RowsDone* rows = nullptr;  // PNG IDAT only
  const size_t* out_n = nullptr;
  size_t need = 0;

  InBits(const uint8_t* p_, const uint8_t* e_) : p(p_), end(e_), start(p_) {}

  uint64_t consumed() const { return (uint64_t)(p - start) * 8 - (uint64_t)(cnt - pad); }

  void truncated() {
    if (rows) rows->truncated = true;
    fail("incomplete or truncated stream");
  }

  // Phase 1 starts when the rows are all in; it ends at the first bit
  // past the piece of IDAT data that the completing call was reading.
  void watch(uint64_t before, uint64_t after) {
    if (rows->phase == 0) {
      const uint64_t byte = (before + 7) / 8;
      rows->boundary = UINT64_MAX;
      for (size_t e : *rows->ends) {
        if (e >= byte) {
          rows->boundary = (uint64_t)e * 8;
          break;
        }
      }
      rows->phase = 1;
    }
    if (rows->phase == 1 && after > rows->boundary) rows->phase = 2;
  }

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
    const uint64_t before = rows ? consumed() : 0;
    buf >>= n;
    cnt -= n;
    if (cnt < pad) truncated();
    if (rows && rows->phase < 2 && *out_n >= need) watch(before, before + (uint64_t)n);
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
  size_t limit = SIZE_MAX;  // PNG IDAT: the rows' bytes; writing past them ends the call
  RowsDone* rows = nullptr;

  void room(size_t k) {
    if (rows && n + k > limit) rows->phase = 2;
  }

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
      out.room(1);
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
    if (out.n >= out.limit) out.room(len);  // a full row ends the call before the copy
    if (dist > out.n) fail("invalid distance too far back");
    out.room(len);
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
  out.room(len);
  out.grow(len);
  while (len > 0 && in.cnt - in.pad >= 8) {  // the bytes already buffered
    out.v[out.n++] = (uint8_t)in.buf;
    in.buf >>= 8;
    in.cnt -= 8;
    --len;
  }
  if (len > 0) {  // the rest straight from the stream
    if ((size_t)(in.end - in.p) < len) in.truncated();
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

// One row of a PNG (or of an Adam7 pass) with its filter undone; prev is
// the row above in the same pass (zeros for its first row).
void png_unfilter_row(const uint8_t* src, int filter, const uint8_t* prev,
                      size_t stride, int bpp, int y, uint8_t* cur) {
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
}

inline uint32_t be32(const uint8_t* p) { return get32(p, false); }

// OpenCV reads a PNG through libpng with png_set_strip_16,
// png_set_strip_alpha, png_set_palette_to_rgb,
// png_set_expand_gray_1_2_4_to_8, and then png_set_bgr (IMREAD_COLOR of a
// colour image), png_set_gray_to_rgb (IMREAD_COLOR of a gray one) or
// png_set_rgb_to_gray(png, 1, 0.299, 0.587) (IMREAD_GRAYSCALE). libpng runs
// them in this order: palette and low-depth gray expanded to 8 bits (tRNS
// has no effect once alpha is stripped), alpha dropped without
// compositing, colour to gray on the 8- or 16-bit samples, 16 bits cut to
// their high byte.
//
// png_set_rgb_to_gray_fixed truncates the weights to 32768ths; blue takes
// the rest.
constexpr uint32_t kGrayR = 9797, kGrayG = 19234, kGrayB = 32768 - 9797 - 19234;

// png.c's fixed-point gamma helpers (PNG_FP_1 = 100000).
int32_t png_reciprocal(int32_t a) {
  const double r = std::floor(1e10 / a + .5);
  return r <= 2147483647. && r >= -2147483648. ? (int32_t)r : 0;
}

bool png_gamma_significant(int32_t g) { return g < 95000 || g > 105000; }

// png_build_8bit_table with png_gamma_8bit_correct's floating-point form.
void png_gamma_table(int32_t g, uint8_t* t) {
  for (int i = 0; i < 256; ++i) {
    t[i] = (uint8_t)i;
    if (png_gamma_significant(g) && i > 0 && i < 255) {
      t[i] = (uint8_t)std::floor(255 * std::pow(i / 255., g * .00001) + .5);
    }
  }
}

// png_do_rgb_to_gray on 8-bit samples. With a significant file gamma (gAMA
// or sRGB) libpng builds gamma_to_1 and gamma_from_1 and converts the
// linearised samples; a pixel with r == g == b passes unchanged either way
// (its gamma_table is the identity here).
struct RgbToGray {
  bool gamma = false;
  uint8_t to1[256], from1[256];

  explicit RgbToGray(int32_t file_gamma) {
    if (file_gamma <= 0) return;
    const int32_t screen = png_reciprocal(file_gamma);
    if (!png_gamma_significant(file_gamma) && !png_gamma_significant(screen)) {
      return;
    }
    gamma = true;
    png_gamma_table(screen, to1);
    png_gamma_table(png_reciprocal(screen), from1);
  }

  uint8_t operator()(uint32_t r, uint32_t g, uint32_t b) const {
    if (r == g && r == b) return (uint8_t)r;
    if (!gamma) return (uint8_t)((kGrayR * r + kGrayG * g + kGrayB * b) >> 15);
    return from1[(kGrayR * to1[r] + kGrayG * to1[g] + kGrayB * to1[b] + 16384) >>
                 15];
  }
};

// The 16-bit form: rounded, then the high byte (png_set_strip_16 runs
// after it). Without a file gamma only; decode_png refuses the other case.
inline uint8_t rgb16_to_gray(uint32_t r, uint32_t g, uint32_t b) {
  return (uint8_t)(((kGrayR * r + kGrayG * g + kGrayB * b + 16384) >> 15) >> 8);
}

// Adam7: (x0, y0, dx, dy) of each pass.
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

// Any PNG (colour types 0, 2, 3, 4 and 6 at every depth PNG allows, Adam7
// or not) -> gray (1 channel) or BGR (3 channels), as cv2.imdecode reads it.
cris::Image decode_png(const uint8_t* buf, size_t size, bool gray) {
  static const Crc32 crc32;
  size_t pos = sizeof kPngMagic;
  bool header = false, have_plte = false, srgb = false;
  uint32_t width = 0, height = 0;
  int depth = 0, color = 0, method = 0, filter = 0, interlace = 0;
  int32_t gamma = 0;  // gAMA's value, 0 when there is none
  uint8_t palette[256][3] = {};  // libpng's: entries past PLTE's are black
  const uint8_t* exif = nullptr;
  size_t exif_len = 0;
  std::vector<uint8_t> idat;
  std::vector<size_t> idat_ends;  // where each piece of IDAT data ends in idat
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
    const bool before_idat = idat.empty();
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
    } else if (std::memcmp(kind, "PLTE", 4) == 0) {
      if (have_plte) fail_chunk(kind, "duplicate chunk");
      if (length == 0 || length % 3 || length > 768) {
        fail_chunk(kind, "invalid length");
      }
      for (uint32_t i = 0; i < length / 3; ++i) {
        std::memcpy(palette[i], data + 3 * i, 3);
      }
      have_plte = true;
    } else if (std::memcmp(kind, "IDAT", 4) == 0) {
      // libpng hands zlib an IDAT chunk in pieces of up to
      // PNG_IDAT_READ_SIZE (8192) bytes
      for (size_t at = 0; at < length; at += 8192) {
        const size_t piece = length - at < 8192 ? length - at : 8192;
        idat.insert(idat.end(), data + at, data + at + piece);
        idat_ends.push_back(idat.size());
      }
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      break;
    } else if (critical) {
      fail_chunk(kind, "critical chunk not supported");
    } else if (std::memcmp(kind, "eXIf", 4) == 0) {  // OpenCV reads it anywhere
      if (!exif) exif = data, exif_len = length;
    } else if (!before_idat) {
      // libpng sets up its transformations at the first IDAT
    } else if (std::memcmp(kind, "gAMA", 4) == 0) {
      const uint32_t g = length == 4 ? be32(data) : 0;
      if (gamma == 0 && g >= 16 && g <= 625000000) gamma = (int32_t)g;
    } else if (std::memcmp(kind, "sRGB", 4) == 0) {
      srgb = srgb || length == 1;
    }
  }
  if (!header) fail("PNG: no IHDR chunk");
  if (srgb) gamma = 45455;  // sRGB's gamma takes precedence over gAMA
  static const int kSamples[7] = {1, 0, 3, 1, 2, 0, 4};
  const bool valid =
      color <= 6 && kSamples[color] &&
      (depth == 8 || (depth == 16 && color != 3) ||
       ((depth == 1 || depth == 2 || depth == 4) && (color == 0 || color == 3)));
  char what[96];
  std::snprintf(what, sizeof what, "%u x %u, bit depth %d, color type %d, "
                "interlace %d", width, height, depth, color, interlace);
  if (!valid || method || filter || interlace > 1) {
    throw Fault(std::string("PNG IHDR: ") + what + " is not a valid PNG");
  }
  if (width == 0 || height == 0 ||
      (unsigned long long)width * height > (unsigned long long)kMaxPixels) {
    fail("PNG IHDR: %d x %d pixels is not supported", (int)width, (int)height);
  }
  if (color == 3 && !have_plte) {
    throw Fault(std::string("PNG PLTE: missing for ") + what);
  }
  const bool colour = color & 2;
  if (gray && colour && depth == 16 && png_gamma_significant(gamma ? gamma : 100000)) {
    fail("PNG gAMA: 16-bit RGB to grayscale under a file gamma is not "
         "supported");
  }
  const int spp = kSamples[color], bits = spp * depth;
  const int bpp = bits < 8 ? 1 : bits / 8;  // the filters' bytes per pixel
  const int npass = interlace ? 7 : 1;
  int pass[7][4] = {{0, 0, 1, 1}};
  if (interlace) std::memcpy(pass, kAdam7, sizeof pass);
  size_t need = 0;  // filter bytes and rows of every non-empty pass
  int pw[7], ph[7];
  for (int k = 0; k < npass; ++k) {
    pw[k] = (int)(((long long)width - pass[k][0] + pass[k][2] - 1) / pass[k][2]);
    ph[k] = (int)(((long long)height - pass[k][1] + pass[k][3] - 1) / pass[k][3]);
    if (pw[k] > 0 && ph[k] > 0) {
      need += (size_t)ph[k] * (1 + ((size_t)pw[k] * bits + 7) / 8);
    }
  }
  std::vector<uint8_t> raw;
  try {
    raw = cris::zlib_inflate(idat.data(), idat.size(), need, &idat_ends);
  } catch (const Fault& f) {
    throw Fault(std::string("PNG IDAT: ") + f.what());
  }
  if (raw.size() < need) {
    throw Fault(std::string("PNG IDAT: not enough image data for ") + what);
  }

  cris::Image img;
  img.height = (int)height;
  img.width = (int)width;
  img.channels = gray ? 1 : 3;
  img.pixels.resize((size_t)width * height * img.channels);
  const RgbToGray to_gray(gamma);
  const unsigned low_scale = depth < 8 ? 255 / ((1 << depth) - 1) : 1;
  auto sample = [&](const uint8_t* row, size_t j) -> uint32_t {
    if (depth == 8) return row[j];
    if (depth == 16) return (uint32_t)row[2 * j] << 8 | row[2 * j + 1];
    const int per = 8 / depth, shift = 8 - depth * (int)(j % per + 1);
    return (row[j / per] >> shift) & ((1u << depth) - 1);
  };
  const uint8_t* src = raw.data();
  std::vector<uint8_t> prev, cur;
  for (int k = 0; k < npass; ++k) {
    if (pw[k] <= 0 || ph[k] <= 0) continue;
    const size_t stride = ((size_t)pw[k] * bits + 7) / 8;
    prev.assign(stride, 0);
    cur.assign(stride, 0);
    for (int r = 0; r < ph[k]; ++r, src += stride + 1) {
      png_unfilter_row(src + 1, src[0], prev.data(), stride, bpp, r, cur.data());
      const int y = pass[k][1] + r * pass[k][3];
      for (int i = 0; i < pw[k]; ++i) {
        const int x = pass[k][0] + i * pass[k][2];
        uint8_t* o = &img.pixels[((size_t)y * width + x) * img.channels];
        const size_t j = (size_t)i * spp;
        if (!colour) {  // gray or gray + alpha
          uint32_t v = sample(cur.data(), j);
          v = depth == 16 ? v >> 8 : v * low_scale;
          o[0] = (uint8_t)v;
          if (!gray) o[1] = o[2] = (uint8_t)v;
          continue;
        }
        uint32_t rgb[3];
        if (color == 3) {
          const uint8_t* p = palette[sample(cur.data(), j)];
          rgb[0] = p[0], rgb[1] = p[1], rgb[2] = p[2];
        } else {
          for (int c = 0; c < 3; ++c) rgb[c] = sample(cur.data(), j + c);
        }
        if (gray) {
          o[0] = depth == 16 ? rgb16_to_gray(rgb[0], rgb[1], rgb[2])
                             : to_gray(rgb[0], rgb[1], rgb[2]);
        } else {
          const int shift = depth == 16 ? 8 : 0;
          for (int c = 0; c < 3; ++c) o[2 - c] = (uint8_t)(rgb[c] >> shift);
        }
      }
      prev.swap(cur);
    }
  }
  if (exif) apply_orientation(img, exif_orientation_tiff(exif, exif_len));
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

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

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
                                  size_t reserve, const std::vector<size_t>* idat_ends,
                                  bool whole_at_reserve) {
  InBits in(data, data + size);
  Output out;
  out.v.resize(reserve);
  RowsDone rows{idat_ends};
  if (idat_ends) {
    in.rows = out.rows = &rows;
    in.out_n = &out.n;
    in.need = reserve;
    out.limit = reserve;
  }
  try {
    const uint32_t cmf = in.bits(8), flg = in.bits(8);
    if ((cmf & 0x0F) != 8 || (cmf >> 4) > 7 || (cmf << 8 | flg) % 31 != 0) {
      fail("incorrect header check");
    }
    if (flg & 0x20) fail("a preset dictionary is not supported");
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
  } catch (const Fault&) {
    if (whole_at_reserve && out.n >= reserve) {
      out.v.resize(reserve);
      return std::move(out.v);
    }
    if (!idat_ends || out.n < reserve || rows.truncated) throw;
    // an error in the completing call (found before it left its piece)
    // loses the last row; after that call it is a warning
    if (rows.phase < 2) throw;
  }
  out.v.resize(out.n);
  return std::move(out.v);
}

// What the first bytes of an unknown format say, for the refusal.
std::string magic_name(const uint8_t* data, size_t size) {
  struct Known {
    const char* magic;
    size_t len;
    const char* name;
  };
  static const Known kKnown[] = {
      {"II+\0", 4, "BigTIFF"}, {"MM\0+", 4, "BigTIFF"},
      {"RIFF", 4, "RIFF (not WebP)"}};
  if (size >= 12 && std::memcmp(data + 4, "ftyp", 4) == 0 &&
      (std::memcmp(data + 8, "avif", 4) == 0 || std::memcmp(data + 8, "avis", 4) == 0)) {
    return "AVIF";
  }
  for (const Known& k : kKnown) {
    if (size >= k.len && std::memcmp(data, k.magic, k.len) == 0) return k.name;
  }
  char hex[3 * 8 + 1] = {};
  for (size_t i = 0; i < size && i < 8; ++i) {
    std::snprintf(hex + 3 * i, 4, i ? " %02X" : "%02X", data[i]);
  }
  return size ? std::string("bytes ") + hex : std::string("nothing (empty data)");
}

Image decode(const uint8_t* data, size_t size, bool gray) {
  if (size >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF) {
    return decode_jpeg_image(data, size, gray);
  }
  if (size >= sizeof kPngMagic &&
      std::memcmp(data, kPngMagic, sizeof kPngMagic) == 0) {
    return decode_png(data, size, gray);
  }
  if (size >= 12 && std::memcmp(data, "RIFF", 4) == 0 &&
      std::memcmp(data + 8, "WEBP", 4) == 0) {
    return decode_webp(data, size, gray);
  }
  if (size >= 2 && data[0] == 'B' && data[1] == 'M') return decode_bmp(data, size, gray);
  if (size >= 4 && (std::memcmp(data, "II*\0", 4) == 0 || std::memcmp(data, "MM\0*", 4) == 0)) {
    return decode_tiff(data, size, gray);
  }
  if (size >= 6 && (std::memcmp(data, "GIF87a", 6) == 0 || std::memcmp(data, "GIF89a", 6) == 0)) {
    return decode_gif(data, size, gray);
  }
  if (size >= 4 && std::memcmp(data, "\x59\xA6\x6A\x95", 4) == 0) return decode_ras(data, size, gray);
  if ((size >= 12 && std::memcmp(data, "\0\0\0\x0CjP  \r\n\x87\n", 12) == 0) ||
      (size >= 4 && std::memcmp(data, "\xFF\x4F\xFF\x51", 4) == 0)) {
    return decode_jp2(data, size, gray);
  }
  if ((size >= 6 && std::memcmp(data, "#?RGBE", 6) == 0) ||
      (size >= 10 && std::memcmp(data, "#?RADIANCE", 10) == 0)) {
    return decode_hdr(data, size, gray);
  }
  // OpenCV's PFM signature: 'P', 'F' or 'f', a blank
  if (size >= 3 && data[0] == 'P' && (data[1] == 'F' || data[1] == 'f') &&
      (data[2] == ' ' || (data[2] >= '\t' && data[2] <= '\r'))) {
    return decode_pfm(data, size, gray);
  }
  // OpenCV's PxM and PAM signatures: 'P', '1'-'7', a blank
  if (size >= 3 && data[0] == 'P' && data[1] >= '1' && data[1] <= '7' &&
      (data[2] == ' ' || (data[2] >= '\t' && data[2] <= '\r'))) {
    return decode_pnm(data, size, gray);
  }
  if (magic_name(data, size) == "BigTIFF") {
    throw Fault("TIFF: BigTIFF (64-bit offsets) is not supported (OpenCV reads it)");
  }
  throw Fault("not a JPEG or PNG image, nor WebP, BMP, PNM / PAM, TIFF, GIF, Sun raster, "
              "JPEG 2000, Radiance HDR or PFM: the data starts with " + magic_name(data, size));
}

}  // namespace cris

extern "C" {

// Decode image bytes (any format decode() takes) as cv2.imdecode does (gray 0:
// IMREAD_COLOR, BGR; gray 1: IMREAD_GRAYSCALE) into *out (height x width x
// channels, freed with cris_free). Returns 0, or 1 with a message in err.
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
