// TIFF decoding for the data library, as OpenCV 5.0's TiffDecoder reads a
// TIFF for cv2.imdecode through libtiff 4.7.1, so that the pixels equal
// OpenCV's bit for bit.
//
// Which path OpenCV takes: IMREAD_COLOR and IMREAD_GRAYSCALE ask for 8-bit
// samples, and for 8-bit output OpenCV reads every layout through libtiff's
// RGBA interface (TIFFReadRGBAStrip / TIFFReadRGBATile, tif_getimage.c),
// then turns each RGBA row to BGR (alpha dropped, no compositing) or to gray
// by its 14-bit weights (4899, 9617, 1868). Probing cv2 5.0.0 found no
// layout, among every (photometric, bits, samples, compression, planar
// configuration) below, that goes another way: OpenCV's TIFFReadScanline
// path is taken only for a single strip of at least 1 GiB, which
// CV_IO_MAX_IMAGE_PIXELS and the tile size check leave no room for here.
// So the pixels are libtiff's RGBA conversion, which this file follows:
//   - OpenCV's header checks first: bits per sample 1, 4 (palette only), 8,
//     10, 12, 14, 16, 32 or 64, at most 4 samples a pixel (1 at 1 bit), the
//     tile (or strip) under 1 GiB; then TIFFRGBAImageOK: 1, 2, 4, 8 or 16
//     bits and no floating point, so 2-bit gray and palette, 10-16-bit
//     odd depths, 32 and 64 bits and IEEE samples are refused, as cv2
//     returns None for them. Signed samples (SampleFormat 2) read as
//     unsigned.
//   - Gray (WhiteIsZero, BlackIsZero) at 1, 8 and 16 bits through libtiff's
//     map ((range - x) * 255 / range for WhiteIsZero; 16 bits by their high
//     byte); a planar gray image with extra samples is read as libtiff's
//     separate RGB path reads it: the raw samples (WhiteIsZero not
//     inverted), 16 bits rounded by (v + 128) / 257, unassociated alpha
//     premultiplied.
//   - RGB at 8 and 16 bits (16 rounded by (v + 128) / 257) with 0, 1 or 2
//     extra samples as libtiff reads ExtraSamples: unassociated alpha
//     premultiplied ((c * a + 127) / 255), associated or unspecified alpha
//     (a fourth sample with no ExtraSamples is associated) left alone.
//   - Palette at 1, 4 and 8 bits: the 16-bit colormap cut to its high byte,
//     or taken as 8-bit values when every entry is below 256.
//   - CMYK (Separated, InkSet 1, 8 bits): k = 255 - K, R = k (255 - C) / 255.
//   - YCbCr, 8 bits: uncompressed (or LZW / Deflate / PackBits) through
//     libtiff's own conversion (TIFFYCbCrToRGBInit's fixed-point tables
//     from YCbCrCoefficients and ReferenceBlackWhite, in float as libtiff
//     computes them), each chroma sample covering its block (no
//     interpolation), subsampling 1x1, 1x2, 2x1, 2x2, 4x1, 4x2 and 4x4 (4x4
//     refused where libtiff's strip size drops bytes); JPEG-compressed
//     through libjpeg's YCbCr to RGB (libtiff sets JPEGCOLORMODE_RGB).
//   - Compression: none, LZW (libtiff's MSB-first codes with early change;
//     old-style LSB-first LZW refused), Deflate (8 and 32946), PackBits,
//     JPEG (7: the JPEGTables stream, then each strip's or tile's stream,
//     through the JPEG decoder of image_codec.cc); Predictor 2 (horizontal
//     differencing) at 8 and 16 bits for LZW and Deflate. FillOrder 2 is
//     undone on the stored bytes before decoding, as libtiff does (not for
//     JPEG).
//   - Strips (the last one ragged) and tiles (edge tiles cut), planar
//     configuration 1 and 2, byte orders II and MM, the first IFD of a
//     multi-page file.
//   - The Orientation tag (1-8): libtiff's mirroring of each strip or tile,
//     OpenCV's flip and its EXIF rotation (see the end of decode_tiff_impl);
//     for strips the same as OpenCV's ApplyExifOrientation.
// Refused with a message that names the kind: CCITT RLE / G3 / G4, old-style
// JPEG, LogLuv / SGILog, JBIG, LZMA, ZSTD, WebP and other compressions;
// CIELab and other photometrics; InkSet 2; and truncated or corrupt strips
// (libtiff would go on with a part-filled buffer). Where OpenCV decodes the
// file, the message says so.

#include "image_codec.h"

#include <cstdint>
#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

namespace {

using cris::Fault;
using cris::Image;
using cris::fail;

const char kOpenCvReads[] = " is not supported (OpenCV reads it)";

[[noreturn]] void refuse(const std::string& what, bool opencv_reads) {
  throw Fault("TIFF: " + what + (opencv_reads ? kOpenCvReads : " is not supported"));
}

// ------------------------------------------------------------ the IFD

struct Field {
  uint16_t type = 0;
  uint32_t count = 0;
  size_t at = 0;  // where the values are
};

struct Ifd {
  const uint8_t* p;
  size_t n;
  bool le;
  std::vector<std::pair<uint16_t, Field>> all;

  uint32_t u16(size_t off) const {
    if (off + 2 > n) fail("TIFF: unexpected end of data");
    return le ? (uint32_t)(p[off] | p[off + 1] << 8) : (uint32_t)(p[off] << 8 | p[off + 1]);
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > n) fail("TIFF: unexpected end of data");
    const uint32_t a = u16(off), b = u16(off + 2);
    return le ? a | b << 16 : a << 16 | b;
  }

  const Field* find(uint16_t tag) const {
    for (const auto& f : all) {
      if (f.first == tag) return &f.second;
    }
    return nullptr;
  }

  static size_t type_size(int type) {
    static const size_t kSizes[] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8};
    return type >= 1 && type <= 12 ? kSizes[type] : 0;
  }

  void read(size_t ifd) {
    const uint32_t count = u16(ifd);
    for (uint32_t k = 0; k < count; ++k) {
      const size_t e = ifd + 2 + 12 * (size_t)k;
      if (e + 12 > n) fail("TIFF: the IFD runs past the end of the data");
      Field f;
      const uint16_t tag = (uint16_t)u16(e);
      f.type = (uint16_t)u16(e + 2);
      f.count = u32(e + 4);
      const size_t unit = type_size(f.type);
      if (unit == 0) continue;  // libtiff ignores an unknown type
      const uint64_t bytes = (uint64_t)unit * f.count;
      f.at = bytes <= 4 ? e + 8 : u32(e + 8);
      if (f.at > n || bytes > n - f.at) {
        throw Fault("TIFF: tag " + std::to_string(tag) + " points past the end of the data");
      }
      all.emplace_back(tag, f);
    }
  }

  // An integer field (BYTE, SHORT, LONG and their signed kinds).
  std::vector<uint32_t> ints(uint16_t tag) const {
    const Field* f = find(tag);
    std::vector<uint32_t> v;
    if (!f) return v;
    for (uint32_t i = 0; i < f->count; ++i) {
      switch (f->type) {
        case 1: case 6: case 7: v.push_back(p[f->at + i]); break;
        case 3: case 8: v.push_back(u16(f->at + 2 * (size_t)i)); break;
        case 4: case 9: v.push_back(u32(f->at + 4 * (size_t)i)); break;
        default:
          throw Fault("TIFF: tag " + std::to_string(tag) + " has type " +
                      std::to_string(f->type) + ", not an integer type");
      }
    }
    return v;
  }

  uint32_t one(uint16_t tag, uint32_t dflt) const {
    const std::vector<uint32_t> v = ints(tag);
    return v.empty() ? dflt : v[0];
  }

  // A float field as libtiff reads a RATIONAL one, (float)((double)n / d)
  // and 0 for d = 0; integer types as they are.
  std::vector<float> floats(uint16_t tag) const {
    const Field* f = find(tag);
    std::vector<float> v;
    if (f && f->type == 5) {
      for (uint32_t i = 0; i < f->count; ++i) {
        const uint32_t a = u32(f->at + 8 * (size_t)i), b = u32(f->at + 8 * (size_t)i + 4);
        v.push_back(b == 0 ? 0.0f : (float)((double)a / (double)b));
      }
      return v;
    }
    for (uint32_t x : ints(tag)) v.push_back((float)x);
    return v;
  }
};

// ------------------------------------------------------- decompression

// PackBits as libtiff's PackBitsDecode: runs past the end are cut.
std::vector<uint8_t> unpackbits(const uint8_t* s, size_t cc, size_t occ) {
  std::vector<uint8_t> out;
  out.reserve(occ);
  size_t i = 0;
  while (i < cc && out.size() < occ) {
    int c = s[i++];
    if (c >= 128) c -= 256;
    if (c < 0) {
      if (c == -128) continue;
      size_t run = (size_t)(1 - c);
      if (i >= cc) break;
      run = run < occ - out.size() ? run : occ - out.size();
      out.insert(out.end(), run, s[i++]);
    } else {
      size_t len = (size_t)c + 1;
      len = len < occ - out.size() ? len : occ - out.size();
      if (cc - i < len) break;
      out.insert(out.end(), s + i, s + i + len);
      i += len;
    }
  }
  if (out.size() < occ) fail("TIFF: PackBits data end before the strip or tile does");
  return out;
}

// LZW as libtiff's LZWDecode: MSB-first codes of 9 to 12 bits, widened one
// code early, decoded until occ bytes are out (a string that runs past
// them is cut). Each string is written backwards from its known length.
std::vector<uint8_t> unlzw(const uint8_t* s, size_t cc, size_t occ) {
  if (cc >= 2 && s[0] == 0 && (s[1] & 1)) {
    refuse("old-style (LSB-first) LZW", true);
  }
  constexpr int kClear = 256, kEoi = 257, kFirst = 258;
  // libtiff's table has 1024 spare entries past 4096 for writers that
  // clear late; codes never reach them
  constexpr int kTableEnd = 4096 + 1024;
  uint16_t prefix[4096];
  uint8_t suffix[4096], first_of[4096];
  uint16_t length[4096];
  for (int i = 0; i < 256; ++i) {
    suffix[i] = first_of[i] = (uint8_t)i;
    length[i] = 1;
  }
  std::vector<uint8_t> out(occ);
  size_t o = 0;
  uint64_t acc = 0;
  int bits = 0, nbits = 9, next = kFirst, prev = -1;
  size_t i = 0;
  auto code_in = [&]() -> int {
    if (bits < nbits) {
      while (bits <= 56 && i < cc) {
        acc = acc << 8 | s[i++];
        bits += 8;
      }
      if (bits < nbits) return kEoi;  // libtiff: "not terminated with EOI code"
    }
    bits -= nbits;
    return (int)((acc >> bits) & ((1u << nbits) - 1));
  };
  auto put = [&](int code) {  // the string of code, cut at occ
    const size_t len = length[code];
    if (len <= occ - o) {
      uint8_t* q = &out[o + len - 1];
      int c = code;
      while (c >= kFirst) {
        *q-- = suffix[c];
        c = prefix[c];
      }
      *q = (uint8_t)c;
      o += len;
      return;
    }
    std::vector<uint8_t> tmp(len);
    for (size_t k = len, c = (size_t)code; k-- > 0; c = prefix[c]) tmp[k] = suffix[c];
    std::memcpy(&out[o], tmp.data(), occ - o);
    o = occ;
  };
  while (o < occ) {
    int code = code_in();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        next = kFirst;
        nbits = 9;
        code = code_in();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) fail("TIFF: corrupt LZW data (code %d after a clear)", code);
      out[o++] = (uint8_t)code;
      prev = code;
      continue;
    }
    if (prev < 0) {
      fail("TIFF: LZW data that do not start with a clear code (libtiff fails on them and "
           "OpenCV reads an all-zero strip)");
    }
    if (next >= kTableEnd) fail("TIFF: corrupt LZW data (the code table overflows)");
    if (code > next) fail("TIFF: corrupt LZW data (code %d, next free %d)", code, next);
    if (next < 4096) {
      prefix[next] = (uint16_t)prev;
      first_of[next] = first_of[prev];
      length[next] = (uint16_t)(length[prev] + 1);
      suffix[next] = code < next ? first_of[code] : first_of[prev];
    }
    if (++next > (1 << nbits) - 2 && nbits < 12) ++nbits;
    put(code);
    prev = code;
  }
  if (o < occ) {
    fail("TIFF: LZW data end before the strip or tile does (OpenCV reads a part-filled image)");
  }
  return out;
}

const char* compression_name(uint32_t c) {
  switch (c) {
    case 2: return "CCITT modified Huffman RLE (compression 2)";
    case 3: return "CCITT Group 3 fax (compression 3)";
    case 4: return "CCITT Group 4 fax (compression 4)";
    case 6: return "old-style JPEG (compression 6)";
    case 32771: return "CCITT RLEW (compression 32771)";
    case 32809: return "ThunderScan (compression 32809)";
    case 32766: return "NeXT 2-bit RLE (compression 32766)";
    case 32908: case 32909: return "Pixar log (compression 32908 / 32909)";
    case 34676: return "SGILog (compression 34676)";
    case 34677: return "SGILog24 (compression 34677)";
    case 34661: return "JBIG (compression 34661)";
    case 34712: return "JPEG 2000 (compression 34712)";
    case 34925: return "LZMA (compression 34925)";
    case 50000: return "ZSTD (compression 50000)";
    case 50001: return "WebP (compression 50001)";
    case 50002: return "JPEG XL (compression 50002)";
    default: return nullptr;
  }
}

// Compressions OpenCV's libtiff build decodes (its codecs for them are
// built in), so the refusal says that OpenCV reads the file.
bool opencv_codec(uint32_t c) {
  return c == 2 || c == 3 || c == 4 || c == 32771 || c == 32809 || c == 32766 ||
         c == 32908 || c == 32909 || c == 34676 || c == 34677;
}

// ---------------------------------------------------------- YCbCr

// tif_color.c TIFFYCbCrToRGBInit and TIFFYCbCrtoRGB, float as libtiff
// computes in float.
struct YCbCr {
  int32_t y_tab[256], cr_r[256], cb_b[256], cr_g[256], cb_g[256];

  static int32_t fix(float x) { return (int32_t)((double)(x * (float)65536L) + 0.5); }
  static float clamp(float f, float lo, float hi) { return !(f >= lo) ? lo : f > hi ? hi : f; }
  static float clampw(float f, float lo, float hi) { return f < lo ? lo : f > hi ? hi : f; }
  static float code2v(int32_t c, float rb, float rw, float cr) {
    const float den = (rw - rb != 0) ? rw - rb : 1.0f;
    return ((float)(c - (int32_t)rb) * cr) / den;
  }

  YCbCr(const float* luma, const float* rbw) {
    const float lr = luma[0], lg = luma[1], lb = luma[2];
    const float f1 = 2 - 2 * lr;
    const int32_t d1 = fix(clamp(f1, 0.0f, 2.0f));
    const float f2 = lr * f1 / lg;
    const int32_t d2 = -fix(clamp(f2, 0.0f, 2.0f));
    const float f3 = 2 - 2 * lb;
    const int32_t d3 = fix(clamp(f3, 0.0f, 2.0f));
    const float f4 = lb * f3 / lg;
    const int32_t d4 = -fix(clamp(f4, 0.0f, 2.0f));
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t cr = (int32_t)clampw(code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127),
                                         -128.0f * 32, 128.0f * 32);
      const int32_t cb = (int32_t)clampw(code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127),
                                         -128.0f * 32, 128.0f * 32);
      cr_r[i] = (d1 * cr + (1 << 15)) >> 16;
      cb_b[i] = (d3 * cb + (1 << 15)) >> 16;
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + (1 << 15);
      y_tab[i] = (int32_t)clampw(code2v(x + 128, rbw[0], rbw[1], 255), -128.0f * 32, 128.0f * 32);
    }
  }

  void rgb(int y, int cb, int cr, uint8_t* o) const {
    auto c = [](int32_t v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    o[0] = c(y_tab[y] + cr_r[cr]);
    o[1] = c(y_tab[y] + (int32_t)((cb_g[cb] + cr_g[cr]) >> 16));
    o[2] = c(y_tab[y] + cb_b[cb]);
  }
};

// ---------------------------------------------------------- decoding

void reverse(uint8_t* p, size_t n) {  // the bits of each byte
  for (size_t i = 0; i < n; ++i) {
    uint8_t r = 0;
    for (int k = 0; k < 8; ++k) r = (uint8_t)(r << 1 | (p[i] >> k & 1));
    p[i] = r;
  }
}

inline uint8_t ua(int c, int a) { return (uint8_t)((c * a + 127) / 255); }
inline uint8_t to8(uint32_t v) { return (uint8_t)((v + 128) / 257); }

Image decode_tiff_impl(const uint8_t* data, size_t size, bool gray) {
  if (size < 8) fail("TIFF: unexpected end of data");
  Ifd d{data, size, data[0] == 'I', {}};
  d.read(d.u32(4));

  if (!d.find(256) || !d.find(257)) fail("TIFF: no ImageWidth or ImageLength tag");
  const uint32_t width = d.one(256, 0), height = d.one(257, 0);
  const std::vector<uint32_t> bps_v = d.ints(258);
  const uint32_t bps = bps_v.empty() ? 1 : bps_v[0];
  for (uint32_t b : bps_v) {
    if (b != bps) fail("TIFF: different BitsPerSample per sample");
  }
  const uint32_t spp = d.one(277, 1);
  const uint32_t compression = d.one(259, 1);
  if (!d.find(262)) fail("TIFF: no PhotometricInterpretation tag");
  uint32_t photometric = d.one(262, 0);
  // the tags TIFFReadDirectory fetches first, failing the directory on a
  // value _TIFFVSetField refuses
  const uint32_t planar_tag = d.one(284, 1);
  if (planar_tag != 1 && planar_tag != 2) {
    fail("TIFF: PlanarConfiguration %d (libtiff refuses any value but 1 or 2, and cv2 "
         "gives None)", (int)planar_tag);
  }
  if (d.find(278) && d.one(278, 1) == 0) {
    fail("TIFF: RowsPerStrip 0 (libtiff refuses it, and cv2 gives None)");
  }
  if (d.find(32998) && d.one(32998, 1) == 0) {
    fail("TIFF: TileDepth 0 (libtiff refuses it, and cv2 gives None)");
  }
  const bool planar = planar_tag == 2 && spp > 1;
  const std::vector<uint32_t> sf_v = d.ints(339);
  const uint32_t sample_format = sf_v.empty() ? 1 : sf_v[0];

  // OpenCV's readHeader
  if (!(bps == 1 || bps == 4 || bps == 8 || bps == 10 || bps == 12 || bps == 14 ||
        bps == 16 || bps == 32 || bps == 64)) {
    fail("TIFF: %d bits per sample is not supported (OpenCV 5.0 refuses it)", (int)bps);
  }
  if (bps == 4 && photometric != 3) {
    fail("TIFF: 4 bits per sample without a palette is not supported (OpenCV 5.0 refuses it)");
  }
  if (spp < 1 || spp > 4 || (bps == 1 && spp != 1)) {
    fail("TIFF: %d samples per pixel at %d bits is not supported (OpenCV 5.0 refuses it)",
         (int)spp, (int)bps);
  }
  cris::check_size("TIFF", width, height);
  // TIFFRGBAImageOK
  if (bps != 1 && bps != 2 && bps != 4 && bps != 8 && bps != 16) {
    fail("TIFF: %d-bit samples are not supported (libtiff's RGBA interface, which "
         "OpenCV reads 8-bit output through, refuses them)", (int)bps);
  }
  if (sample_format == 3) {
    fail("TIFF: floating-point samples are not supported (OpenCV 5.0 refuses them)");
  }
  if (sample_format != 1 && sample_format != 2) {
    fail("TIFF: SampleFormat %d is not supported", (int)sample_format);
  }
  if (compression_name(compression)) {
    refuse(compression_name(compression), opencv_codec(compression));
  }
  if (compression != 1 && compression != 5 && compression != 7 && compression != 8 &&
      compression != 32946 && compression != 32773) {
    fail("TIFF: compression %d is not supported (libtiff has no decoder for it, and cv2 "
         "gives an all-zero image)", (int)compression);
  }
  const bool jpeg = compression == 7;

  // ExtraSamples as TIFFReadDirectory fixes them up (samples beyond the
  // photometric's colour channels become unspecified extra samples), then
  // TIFFRGBAImageBegin's alpha: 1 associated, 2 unassociated
  const int max_color = photometric <= 1 || photometric == 3 ? 1 : photometric == 5 ? 4 : 3;
  std::vector<uint32_t> extra = d.ints(338);
  if (extra.size() > spp) fail("TIFF: %d extra samples of %d samples", (int)extra.size(), (int)spp);
  for (uint32_t& e : extra) {  // setExtraSamples: Corel Draw's 999 is unassociated
    if (e == 999) e = 2;
    if (e > 2) {
      fail("TIFF: ExtraSamples value %d (libtiff refuses any above 2, and cv2 gives None)",
           (int)e);
    }
  }
  if ((int)spp - (int)extra.size() > max_color) extra.resize(spp - max_color, 0);
  const int colorchannels = (int)spp - (int)extra.size();
  int alpha = 0;
  if (!extra.empty()) {
    if (extra[0] == 0 && spp > 3) alpha = 1;
    if (extra[0] == 1 || extra[0] == 2) alpha = (int)extra[0];
  }
  if (photometric == 2 && colorchannels < 3) {
    fail("TIFF: RGB with %d colour channels is not supported (OpenCV 5.0 refuses it)",
         colorchannels);
  }
  std::vector<uint32_t> cmap;
  switch (photometric) {
    case 0: case 1: break;
    case 2: break;
    case 3:
      if (spp != 1) fail("TIFF: a palette image with %d samples per pixel", (int)spp);
      if (bps != 1 && bps != 4 && bps != 8) {  // 2 bits fail OpenCV's readHeader
        fail("TIFF: a %d-bit palette is not supported (libtiff's RGBA interface has no putter "
             "for it, so OpenCV 5.0 refuses it too)", (int)bps);
      }
      cmap = d.ints(320);
      if (cmap.size() != 3u << bps) fail("TIFF: no Colormap of 3 x %d entries", 1 << bps);
      break;
    case 5:
      if (d.one(332, 1) != 1) {
        fail("TIFF: Separated with InkSet %d is not supported (OpenCV 5.0 refuses it)",
             (int)d.one(332, 1));
      }
      if (spp != 4 || bps != 8) fail("TIFF: CMYK at %d bits, %d samples is not supported",
                                     (int)bps, (int)spp);
      break;
    case 6:
      if (spp != 3 || bps != 8) fail("TIFF: YCbCr at %d bits, %d samples is not supported",
                                     (int)bps, (int)spp);
      break;
    case 8: refuse("CIELab (photometric 8)", true);
    case 9: refuse("ICCLab (photometric 9)", false);
    case 10: refuse("ITULab (photometric 10)", false);
    case 32844: refuse("LogL (photometric 32844)", compression == 34676);
    case 32845: refuse("LogLuv (photometric 32845)", compression == 34676 || compression == 34677);
    default: fail("TIFF: photometric interpretation %d is not supported", (int)photometric);
  }
  if ((photometric == 0 || photometric == 1 || photometric == 2) && !(bps == 1 || bps == 8 || bps == 16)) {
    fail("TIFF: %d-bit gray or RGB is not supported", (int)bps);
  }
  if (planar && !(bps == 8 || bps == 16)) fail("TIFF: planar %d-bit samples are not supported", (int)bps);
  if (planar && photometric == 5 && bps != 8) fail("TIFF: planar 16-bit CMYK is not supported");

  // YCbCr: subsampling, coefficients, reference black and white
  uint32_t hs = 1, vs = 1;
  const bool ycbcr = photometric == 6;
  if (ycbcr) {
    const std::vector<uint32_t> sub = d.ints(530);
    hs = sub.size() >= 2 ? sub[0] : 2;
    vs = sub.size() >= 2 ? sub[1] : 2;
    if (!((hs == 1 || hs == 2 || hs == 4) && (vs == 1 || vs == 2 || vs == 4))) {
      fail("TIFF: YCbCr subsampling %dx%d is not supported", (int)hs, (int)vs);
    }
  }
  const bool subsampled = ycbcr && !jpeg && (hs != 1 || vs != 1);
  if (subsampled && planar) fail("TIFF: planar YCbCr subsampled %dx%d is not supported", (int)hs, (int)vs);

  if (jpeg && planar) fail("TIFF: planar JPEG-compressed images are not supported");
  if (jpeg && bps != 8) fail("TIFF: %d-bit JPEG is not supported", (int)bps);

  // chunks: strips or tiles
  const bool tiled = d.find(322) != nullptr;
  uint32_t tw, th;
  std::vector<uint32_t> offsets, counts;
  if (tiled) {
    tw = d.one(322, 0);
    th = d.one(323, 0);
    if (tw == 0 || th == 0 || tw > (1 << 24) || th > (1 << 24)) fail("TIFF: tile size %d x %d", (int)tw, (int)th);
    offsets = d.ints(324);
    counts = d.ints(325);
  } else {
    tw = width;
    th = d.one(278, 0xFFFFFFFFu);
    if (th == 0 || th == 0xFFFFFFFFu) th = height;
    if (th > (1 << 24)) fail("TIFF: %u rows per strip (OpenCV refuses more than 2^24)", (int)th);
    offsets = d.ints(273);
    counts = d.ints(279);
  }
  if ((uint64_t)tw * th * spp * (bps / 8 ? bps / 8 : 1) >= (1ull << 30)) {
    fail("TIFF: a tile or strip of %d x %d is too large (OpenCV refuses 1 GiB)", (int)tw, (int)th);
  }
  if (!tiled && th > height) th = height;
  if (tiled && compression == 1 && ((size_t)th * (((size_t)tw * (planar ? 1 : spp) * bps + 7) / 8)) % 1024) {
    fail("TIFF: uncompressed tiles of %d x %d that are not a multiple of 1024 bytes are not "
         "supported (cv2.imdecode refuses them)", (int)tw, (int)th);
  }
  // libtiff's scanline size for YCbCr is a block row over vs, rounded
  // down: at vs 4 with an odd number of blocks a row, TIFFReadRGBAStrip
  // reads the strip short and converts bytes it did not read
  if (subsampled && vs == 4 && ((tw + hs - 1) / hs) % 2 == 1) {
    fail("TIFF: YCbCr subsampling %dx4 with an odd number of blocks a row is not supported "
         "(libtiff reads such strips short)", (int)hs);
  }
  const bool skew_bug = tiled && !planar && (photometric == 0 || photometric == 1) &&
                        (bps == 16 || spp > 1);
  const uint32_t across = (width + tw - 1) / tw, down = (height + th - 1) / th;
  const uint32_t planes = planar ? spp : 1;
  const size_t nchunks = (size_t)across * down * planes;
  if (offsets.size() < nchunks || counts.size() < nchunks) {
    fail("TIFF: %d strip or tile offsets for %d strips or tiles", (int)offsets.size(),
         (int)nchunks);
  }
  const uint32_t predictor = (compression == 5 || compression == 8 || compression == 32946)
                                 ? d.one(317, 1) : 1;
  if (predictor != 1 && predictor != 2) fail("TIFF: predictor %d is not supported", (int)predictor);
  if (predictor == 2 && bps != 8 && bps != 16) {
    fail("TIFF: horizontal differencing at %d bits is not supported", (int)bps);
  }
  // FillOrder 2: libtiff reverses the bits of each stored byte before
  // decoding (its JPEG codec asks it not to)
  const bool reverse_bits = d.one(266, 1) == 2 && !jpeg;
  std::vector<uint8_t> tables;
  if (jpeg) {
    if (const Field* f = d.find(347)) {
      tables.assign(data + f->at, data + f->at + (size_t)f->count * Ifd::type_size(f->type));
    }
  }

  // samples per chunk row: the samples of a plane (planar) or of all of a
  // pixel's samples (contig); YCbCr blocks for subsampled YCbCr
  const uint32_t sps = planar ? 1 : spp;
  const size_t row_bytes = ((size_t)tw * sps * bps + 7) / 8;
  const size_t img_row = (size_t)width * sps * (bps < 8 ? 8 : bps) / 8;
  const size_t block = hs * vs + 2;
  // the whole image's samples, file order, per plane (1- and 4-bit
  // samples a byte each); RGB for subsampled YCbCr, converted chunk by
  // chunk
  std::vector<std::vector<uint8_t>> buf(planes, std::vector<uint8_t>(img_row * height));
  std::vector<uint8_t> rgb;
  float luma[3] = {0.299f, 0.587f, 0.114f};
  float rbw[6] = {0, 255, 128, 255, 128, 255};
  if (ycbcr) {
    const std::vector<float> l = d.floats(529), r = d.floats(532);
    if (l.size() >= 3) std::copy(l.begin(), l.begin() + 3, luma);
    if (r.size() >= 6) std::copy(r.begin(), r.begin() + 6, rbw);
    if (luma[1] == 0 || luma[0] != luma[0] || luma[1] != luma[1] || luma[2] != luma[2]) {
      fail("TIFF: invalid YCbCrCoefficients");
    }
  }
  const YCbCr ycc(luma, rbw);
  if (subsampled) rgb.assign((size_t)width * height * 3, 0);

  for (size_t k = 0; k < nchunks; ++k) {
    const uint32_t plane = (uint32_t)(k / ((size_t)across * down));
    const uint32_t cy = (uint32_t)(k % ((size_t)across * down) / across);
    const uint32_t cx = (uint32_t)(k % across);
    const uint32_t x0 = cx * tw, y0 = cy * th;
    // rows the chunk holds: a full tile, or the strip's rows
    const uint32_t rows = tiled ? th : (height - y0 < th ? height - y0 : th);
    const uint32_t vis_rows = height - y0 < rows ? height - y0 : rows;
    const uint32_t vis_cols = width - x0 < tw ? width - x0 : tw;
    const size_t expect = subsampled ? (size_t)((rows + vs - 1) / vs) * ((tw + hs - 1) / hs) * block
                                     : (size_t)rows * row_bytes;
    if (offsets[k] > size || counts[k] > size - offsets[k]) {
      fail("TIFF: strip or tile %d runs past the end of the data", (int)k);
    }
    const uint8_t* src = data + offsets[k];
    size_t cc = counts[k];
    std::vector<uint8_t> rev;
    if (reverse_bits) {
      rev.assign(src, src + cc);
      reverse(rev.data(), rev.size());
      src = rev.data();
    }
    std::vector<uint8_t> raw;
    if (jpeg) {
      const bool to_rgb = ycbcr;
      cris::JpegSamples js = cris::decode_jpeg_samples(tables.data(), tables.size(), src, cc, to_rgb);
      if (js.components != (int)spp) {
        fail("TIFF: a JPEG strip or tile of %d components for %d samples", js.components, (int)spp);
      }
      if (ycbcr && (js.h0 > (int)hs || js.v0 > (int)vs)) {
        fail("TIFF: JPEG sampling %dx%d beyond YCbCrSubsampling", js.h0, js.v0);
      }
      const bool last_strip = !tiled && y0 + rows == height;
      if ((uint32_t)js.width != tw ||
          !((uint32_t)js.height == rows || (last_strip && (uint32_t)js.height > rows))) {
        throw Fault("TIFF: a JPEG strip or tile of " + std::to_string(js.width) + " x " +
                    std::to_string(js.height) + " where " + std::to_string(tw) + " x " +
                    std::to_string(rows) + " is expected");
      }
      raw.assign(js.samples.begin(), js.samples.begin() + expect);
    } else {
      switch (compression) {
        case 1:
          if (cc < expect) fail("TIFF: a strip or tile shorter than its rows");
          raw.assign(src, src + expect);
          break;
        case 5: raw = unlzw(src, cc, expect); break;
        case 32773: raw = unpackbits(src, cc, expect); break;
        default: {  // 8, 32946
          raw = cris::zlib_inflate(src, cc, expect, nullptr, true);
          if (raw.size() < expect) fail("TIFF: Deflate data end before the strip or tile does");
          raw.resize(expect);
        }
      }
    }
    if (bps == 16 && !d.le) {  // to host (little-endian) order
      for (size_t i = 0; i + 1 < raw.size(); i += 2) std::swap(raw[i], raw[i + 1]);
    }
    if (predictor == 2) {
      // PredictorDecodeTile: horAcc over the chunk in rows of libtiff's
      // row size, the samples of a pixel apart. For subsampled YCbCr that
      // row is a block row over vs (strips) or tw * 3 bytes (tiles, where
      // TIFFTileRowSize ignores the subsampling); where the chunk is not
      // whole such rows, or a row not whole pixels, libtiff fails the
      // predictor before it writes, and the RGBA interface (which does not
      // stop on errors) converts the undifferenced bytes
      const size_t rowsize = !subsampled ? row_bytes
                             : tiled     ? (size_t)tw * 3
                                         : (size_t)((tw + hs - 1) / hs) * block / vs;
      const size_t nrows = subsampled && (expect % rowsize || rowsize % 3) ? 0
                                                                           : expect / rowsize;
      const size_t n = rowsize * 8 / bps;
      for (size_t r = 0; r < nrows; ++r) {
        uint8_t* row = &raw[r * rowsize];
        if (bps == 8) {
          for (size_t i = sps; i < n; ++i) row[i] = (uint8_t)(row[i] + row[i - sps]);
        } else {
          for (size_t i = sps; i < n; ++i) {
            const uint32_t v = (row[2 * i] | row[2 * i + 1] << 8) +
                               (row[2 * (i - sps)] | row[2 * (i - sps) + 1] << 8);
            row[2 * i] = (uint8_t)v;
            row[2 * i + 1] = (uint8_t)(v >> 8);
          }
        }
      }
    }
    if (subsampled) {  // blocks of hs x vs luma, then Cb, Cr
      // a block row of the chunk; for a clipped tile, the blocks shown and
      // then libtiff's skip over the hidden ones, which its 4x4 putter
      // counts as 10 bytes a block, not 18
      const size_t shown = (vis_cols + hs - 1) / hs;
      const size_t hidden = (tw - vis_cols) / hs;
      const size_t block_row = shown * block + hidden * (hs == 4 && vs == 4 ? 10 : block);
      for (uint32_t y = 0; y < vis_rows; ++y) {
        for (uint32_t x = 0; x < vis_cols; ++x) {
          const uint8_t* b = &raw[(size_t)(y / vs) * block_row + (size_t)(x / hs) * block];
          ycc.rgb(b[(y % vs) * hs + x % hs], b[hs * vs], b[hs * vs + 1],
                  &rgb[((size_t)(y0 + y) * width + x0 + x) * 3]);
        }
      }
      continue;
    }
    const size_t nbytes = ((size_t)vis_cols * sps * bps + 7) / 8;
    // libtiff's gray putters for 16 bits or extra samples (put16bitbwtile,
    // putagreytile, putgreytile) step over a clipped tile's hidden columns
    // by one byte a pixel, not by the pixel's size, and its 1- and 4-bit
    // putters by the hidden bits' whole bytes, which falls short of a
    // padded row: OpenCV reads the rows of a right-edge tile from those
    // offsets
    size_t stride = row_bytes;
    if (vis_cols < tw && skew_bug) stride = nbytes + (tw - vis_cols);
    if (vis_cols < tw && bps < 8) stride = nbytes + (size_t)(tw - vis_cols) * bps / 8;
    if (bps < 8) {  // unpacked, a byte a sample
      const uint32_t mask = (1u << bps) - 1;
      for (uint32_t y = 0; y < vis_rows; ++y) {
        const uint8_t* q = &raw[(size_t)y * stride];
        uint8_t* o = &buf[plane][(size_t)(y0 + y) * img_row + x0];
        for (uint32_t x = 0; x < vis_cols; ++x) {
          o[x] = (uint8_t)(q[x * bps / 8] >> (8 - bps - x * bps % 8) & mask);
        }
      }
      continue;
    }
    const size_t col_off = (size_t)x0 * sps * bps / 8;
    for (uint32_t y = 0; y < vis_rows; ++y) {
      std::memcpy(&buf[plane][(size_t)(y0 + y) * img_row + col_off], &raw[(size_t)y * stride],
                  nbytes);
    }
  }
  if (jpeg && ycbcr) photometric = 2;  // libjpeg gave RGB

  // libtiff's RGBA conversion (tif_getimage.c) into RGB
  if (!subsampled) rgb.assign((size_t)width * height * 3, 0);
  uint8_t palette[256][3] = {};
  if (photometric == 3) {
    const size_t n = (size_t)1 << bps;
    bool wide = false;  // checkcmap: any entry of 256 or more
    for (size_t i = 0; i < 3 * n; ++i) wide |= cmap[i] >= 256;
    for (size_t i = 0; i < n; ++i) {
      for (int c = 0; c < 3; ++c) {
        const uint32_t v = cmap[c * n + i];
        palette[i][c] = (uint8_t)((wide ? v >> 8 : v) & 0xff);
      }
    }
  }
  auto sample = [&](uint32_t p, uint32_t y, uint32_t x, uint32_t s) -> uint32_t {
    const uint8_t* r = &buf[p][(size_t)y * img_row];
    const size_t i = (size_t)x * sps + s;
    return bps == 8 ? r[i] : (uint32_t)(r[2 * i] | r[2 * i + 1] << 8);
  };
  const bool rgb8 = photometric == 2 && bps == 8 && !planar && alpha != 2;
  for (uint32_t y = 0; y < height && !subsampled; ++y) {
    uint8_t* o = &rgb[(size_t)y * width * 3];
    const uint8_t* r0 = buf[0].data() + (size_t)y * img_row;
    if (rgb8) {  // the common case: putRGBcontig8bittile's copy
      for (uint32_t x = 0; x < width; ++x, o += 3, r0 += spp) {
        o[0] = r0[0];
        o[1] = r0[1];
        o[2] = r0[2];
      }
      continue;
    }
    for (uint32_t x = 0; x < width; ++x, o += 3) {
      if (photometric == 3) {  // PALmap
        std::memcpy(o, palette[r0[x]], 3);
        continue;
      }
      if (planar) {  // gtStripSeparate / gtTileSeparate: the planes as RGB
        if (photometric == 6) {  // putseparate8bitYCbCr11tile
          ycc.rgb(sample(0, y, x, 0), sample(1, y, x, 0), sample(2, y, x, 0), o);
          continue;
        }
        uint32_t c[3];
        for (int s = 0; s < 3; ++s) c[s] = sample(colorchannels == 1 ? 0 : s, y, x, 0);
        if (photometric == 5) {  // putCMYKseparate8bittile
          const uint32_t kk = 255 - sample(3, y, x, 0);
          for (int s = 0; s < 3; ++s) o[s] = (uint8_t)(kk * (255 - c[s]) / 255);
          continue;
        }
        uint32_t a = alpha ? sample(colorchannels, y, x, 0) : 255;
        if (bps == 16) {
          for (uint32_t& v : c) v = to8(v);
          a = to8(a);
        }
        for (int s = 0; s < 3; ++s) o[s] = (uint8_t)(alpha == 2 ? ua((int)c[s], (int)a) : c[s]);
        continue;
      }
      if (photometric == 0 || photometric == 1) {  // BWmap
        uint32_t v;
        if (bps == 1) {
          v = r0[x] ? 255 : 0;
        } else {
          v = bps == 8 ? r0[(size_t)x * spp] : sample(0, y, x, 0) >> 8;
        }
        o[0] = o[1] = o[2] = (uint8_t)(photometric == 0 ? 255 - v : v);
        continue;
      }
      if (photometric == 5) {  // putRGBcontig8bitCMYKtile
        const uint8_t* q = r0 + (size_t)x * 4;
        const uint32_t kk = 255 - q[3];
        for (int s = 0; s < 3; ++s) o[s] = (uint8_t)(kk * (255 - q[s]) / 255);
        continue;
      }
      if (photometric == 6) {  // 1x1 YCbCr
        const uint8_t* q = r0 + (size_t)x * 3;
        ycc.rgb(q[0], q[1], q[2], o);
        continue;
      }
      // RGB, 8 or 16 bits; unassociated alpha is the fourth sample
      uint32_t c[3];
      for (int s = 0; s < 3; ++s) c[s] = sample(0, y, x, s);
      uint32_t a = alpha == 2 ? sample(0, y, x, 3) : 255;
      if (bps == 16) {
        for (uint32_t& v : c) v = to8(v);
        a = to8(a);
      }
      for (int s = 0; s < 3; ++s) o[s] = (uint8_t)(alpha == 2 ? ua((int)c[s], (int)a) : c[s]);
    }
  }
  Image img;
  img.height = (int)height;
  img.width = (int)width;
  img.channels = 3;
  img.pixels.swap(rgb);
  // The orientation, as libtiff's TIFFRGBAImage and OpenCV combine it:
  // libtiff mirrors each strip or tile (its visible width) for the
  // orientations whose first row runs right to left (2, 3, 6, 7); OpenCV
  // flips the image vertically for those whose first row is the bottom
  // (3, 4, 7, 8), then applies its EXIF rotation as a transpose (5, 7) or
  // a transpose with a half turn (6, 8). For strips this is
  // ApplyExifOrientation of the stored image; for tiles the mirroring stays
  // within each tile.
  const uint32_t orientation = d.one(274, 1);
  if (orientation == 2 || orientation == 3 || orientation == 6 || orientation == 7) {
    for (uint32_t y = 0; y < height; ++y) {
      for (uint32_t x0 = 0; x0 < width; x0 += tw) {
        uint8_t* a = &img.pixels[((size_t)y * width + x0) * 3];
        uint8_t* b = a + ((size_t)(width - x0 < tw ? width - x0 : tw) - 1) * 3;
        for (; a < b; a += 3, b -= 3) {
          for (int c = 0; c < 3; ++c) std::swap(a[c], b[c]);
        }
      }
    }
  }
  if (orientation == 3 || orientation == 4 || orientation == 7 || orientation == 8) {
    const size_t row = (size_t)width * 3;
    for (uint32_t y = 0; y < height / 2; ++y) {
      std::swap_ranges(&img.pixels[y * row], &img.pixels[(y + 1) * row],
                       &img.pixels[(height - 1 - y) * row]);
    }
  }
  if (orientation >= 5 && orientation <= 8) {
    cris::apply_orientation(img, orientation == 5 || orientation == 7 ? 5 : 7);
  }
  const size_t n = (size_t)img.width * img.height;
  if (gray) {  // icvCvt_BGRA2Gray_8u_C4C1R of the RGBA raster
    std::vector<uint8_t> g(n);
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* q = &img.pixels[3 * i];
      g[i] = cris::gray14(q[2], q[1], q[0]);
    }
    img.pixels.swap(g);
    img.channels = 1;
  } else {
    for (size_t i = 0; i < n; ++i) std::swap(img.pixels[3 * i], img.pixels[3 * i + 2]);
  }
  return img;
}

}  // namespace

namespace cris {

Image decode_tiff(const uint8_t* data, size_t size, bool gray) {
  return decode_tiff_impl(data, size, gray);
}

}  // namespace cris
