// WebP decoding for the data library, as libwebp's WebPDecodeBGR(A)Into
// decodes a still image for cv2.imdecode, so that the pixels equal
// OpenCV's bit for bit:
//   - the RIFF container: a simple file ("VP8 " or "VP8L" after "WEBP") or
//     an extended one (VP8X, then ICCP / ALPH / EXIF / XMP / unknown
//     chunks before the bitstream, each padded to an even size); chunk
//     sizes against the RIFF size, the VP8X canvas against the bitstream's
//     size. OpenCV applies the orientation of the first EXIF chunk (a
//     TIFF header, no "Exif\0\0") when the VP8X EXIF flag is set.
//   - an animated file (the VP8X animation flag): WebPDemux's checks of
//     every chunk and frame, then the first frame (ANMF: its offset, an
//     optional ALPH, its VP8 or VP8L bitstream) decoded as a still image
//     and put on a canvas of transparent black, as OpenCV 5 takes it from
//     WebPAnimDecoder; the first frame is a key frame, so its blending and
//     disposal bits and ANIM's background colour change nothing.
//   - VP8L (lossless): the prefix-coded ARGB stream with its colour cache,
//     meta prefix codes, LZ77 copies through the 120-entry distance map,
//     and the four transforms undone in reverse order (predictor with its
//     14 modes, cross-colour, subtract-green, colour indexing with pixel
//     bundling), as vp8l_dec.c and lossless.c do them.
//   - VP8 (lossy key frames, RFC 6386 as libwebp's vp8 decoder reads it):
//     the boolean decoder, segments, token partitions, coefficient
//     probabilities and their updates, the 16x16, 4x4 and chroma intra
//     predictors with libwebp's edge samples (127 above, 129 left), the
//     exact inverse WHT and DCT, the simple and normal loop filters with
//     per-segment and per-mode levels; then libwebp's "fancy" 4:2:0
//     upsampling and fixed-point VP8YUVToR/G/B into BGR.
//   - ALPH (the alpha of a lossy file; raw or VP8L-coded): its header is
//     checked and a coded plane decoded, so that a file libwebp refuses is
//     refused, then dropped: OpenCV's IMREAD_COLOR drops alpha without
//     compositing.
// IMREAD_GRAYSCALE is OpenCV 5's cvtColor(BGR2GRAY) of the colour image
// (15-bit weights 9798, 19235, 3735).
// Integer arithmetic only; no global state.

#include "image_codec.h"

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

using cris::Fault;
using cris::fail;

inline uint32_t le16(const uint8_t* p) { return p[0] | (uint32_t)p[1] << 8; }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (uint32_t)p[2] << 16; }
inline uint32_t le32(const uint8_t* p) { return le24(p) | (uint32_t)p[3] << 24; }

// OpenCV's CV_IO_MAX_IMAGE_PIXELS.
constexpr long long kMaxPixels = 1 << 30;

// ----------------------------------------------------------- VP8L

// LSB-first bits; past the end zero bits are read, and eos() says so.
struct LBits {
  const uint8_t* p;
  size_t n;
  uint64_t pos = 0;  // bits consumed
  LBits(const uint8_t* data, size_t size) : p(data), n(size) {}
  uint64_t window() const {
    const size_t byte = (size_t)(pos >> 3);
    uint64_t v = 0;
    if (byte + 8 <= n) {
      for (int i = 7; i >= 0; --i) v = v << 8 | p[byte + i];
    } else {
      for (int i = 7; i >= 0; --i) v = v << 8 | (byte + i < n ? p[byte + i] : 0);
    }
    return v >> (pos & 7);
  }
  uint32_t read(int nbits) {  // nbits <= 32
    if (nbits == 0) return 0;
    const uint32_t v = (uint32_t)(window() & ((1ull << nbits) - 1));
    pos += nbits;
    return v;
  }
  bool eos() const { return pos > (uint64_t)n * 8; }
};

// A canonical prefix code as huffman_utils.c builds it: complete, at most
// 15 bits, or a single symbol read with no bits.
struct LCode {
  static constexpr int kRoot = 8;
  uint16_t count[16] = {};
  std::vector<uint16_t> sorted;
  uint32_t table[1 << kRoot];  // (length << 16) | symbol; 0: longer code
  int single = -1;

  // false where VP8LBuildHuffmanTable returns 0
  bool build(const int* lengths, int n) {
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      ++count[lengths[s]];
    }
    if (count[0] == n) return false;
    for (int len = 1; len < 15; ++len) {
      if (count[len] > (1 << len)) return false;
    }
    int offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    sorted.assign((size_t)(n - count[0]), 0);
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 0) sorted[offs[lengths[s]]++] = (uint16_t)s;
    }
    if (sorted.size() == 1) {
      single = sorted[0];
      return true;
    }
    int open = 1;
    for (int len = 1; len <= 15; ++len) {
      open = open * 2 - count[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    std::memset(table, 0, sizeof table);
    int code = 0, k = 0;
    for (int len = 1; len <= 15; ++len) {
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        if (len > kRoot) continue;
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int r = rev; r < (1 << kRoot); r += 1 << len) {
          table[r] = (uint32_t)len << 16 | sorted[k];
        }
      }
      code <<= 1;
    }
    return true;
  }

  int decode(LBits& br) const {
    if (single >= 0) return single;
    const uint32_t e = table[br.window() & ((1 << kRoot) - 1)];
    if (e) {
      br.pos += e >> 16;
      return (int)(e & 0xFFFF);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= (int)br.read(1);
      const int c = count[len];
      if (code - c < first) return sorted[index + (code - first)];
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return 0;  // not reached for a complete code
  }
};

const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};

enum { kGreen = 0, kRed = 1, kBlue = 2, kAlpha = 3, kDist = 4 };

struct LTransform {
  int type = 0, bits = 0, xsize = 0;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

struct VP8L {
  LBits br;
  int seen = 0;  // transform types read

  VP8L(const uint8_t* data, size_t size) : br(data, size) {}

  void check_eos(const char* where) {
    if (br.eos()) throw Fault(std::string("VP8L: truncated data (") + where + ")");
  }

  void read_code(int alphabet, LCode& code) {
    std::vector<int> lengths((size_t)alphabet, 0);
    if (br.read(1)) {  // simple code: one or two symbols
      const int num = (int)br.read(1) + 1;
      const int first_bits = br.read(1) ? 8 : 1;
      // ReadHuffmanCode writes a symbol past the alphabet where the table
      // build does not look: it is ignored, not refused
      int s = (int)br.read(first_bits);
      if (s < alphabet) lengths[s] = 1;
      if (num == 2) {
        s = (int)br.read(8);
        if (s < alphabet) lengths[s] = 1;
      }
    } else {
      int cl_lengths[19] = {};
      const int num_codes = (int)br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) {
        cl_lengths[kCodeLengthOrder[i]] = (int)br.read(3);
      }
      LCode cl;
      if (!cl.build(cl_lengths, 19)) fail("VP8L: bad code-length code");
      int max_symbol = alphabet;
      if (br.read(1)) {
        const int nbits = 2 + 2 * (int)br.read(3);
        max_symbol = 2 + (int)br.read(nbits);
        if (max_symbol > alphabet) fail("VP8L: bad code lengths");
      }
      int prev = 8, s = 0;
      while (s < alphabet) {
        if (max_symbol-- == 0) break;
        const int len = cl.decode(br);
        if (len < 16) {
          lengths[s++] = len;
          if (len) prev = len;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          int repeat = (int)br.read(kExtra[len - 16]) + kOffset[len - 16];
          if (s + repeat > alphabet) fail("VP8L: bad code lengths");
          const int v = len == 16 ? prev : 0;
          while (repeat-- > 0) lengths[s++] = v;
        }
      }
    }
    check_eos("prefix code");
    if (!code.build(lengths.data(), alphabet)) fail("VP8L: bad prefix code");
  }

  // DecodeImageStream: the transforms (level 0 only), the colour cache, the
  // prefix codes (meta codes at level 0 only), then the pixels, each a
  // literal, a copy or a cache hit; at level 0 the transforms are undone,
  // so the result is xsize x ysize ARGB.
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    int tx = xsize;
    std::vector<LTransform> transforms;
    if (level0) {
      while (br.read(1)) transforms.push_back(read_transform(&tx, ysize));
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = (int)br.read(4);
      if (cache_bits < 1 || cache_bits > 11) fail("VP8L: bad colour cache size %d", cache_bits);
    }
    int meta_bits = 0, meta_xsize = 0;
    std::vector<uint32_t> meta;
    int groups = 1;
    if (level0 && br.read(1)) {
      meta_bits = (int)br.read(3) + 2;
      meta_xsize = subsample(tx, meta_bits);
      meta = decode_stream(meta_xsize, subsample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xFFFF;
        if ((int)m + 1 > groups) groups = (int)m + 1;
      }
    }
    std::vector<LCode> codes((size_t)groups * 5);
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    for (int g = 0; g < groups; ++g) {
      for (int j = 0; j < 5; ++j) {
        read_code(kAlphabetSize[j] + (j == 0 ? cache_size : 0), codes[(size_t)g * 5 + j]);
      }
    }
    std::vector<uint32_t> px((size_t)tx * ysize);
    std::vector<uint32_t> cache((size_t)cache_size);
    const size_t total = px.size();
    size_t i = 0;
    const uint32_t shift = 32 - cache_bits;
    auto insert = [&](uint32_t argb) {
      if (cache_size) cache[(0x1e35a7bdu * argb) >> shift] = argb;
    };
    while (i < total) {
      const int x = (int)(i % tx), y = (int)(i / tx);
      const LCode* g = &codes[0];
      if (meta_bits) {
        g = &codes[(size_t)meta[(size_t)(y >> meta_bits) * meta_xsize + (x >> meta_bits)] * 5];
      }
      const int code = g[kGreen].decode(br);
      if (code < 256) {
        const uint32_t red = (uint32_t)g[kRed].decode(br);
        const uint32_t blue = (uint32_t)g[kBlue].decode(br);
        const uint32_t alpha = (uint32_t)g[kAlpha].decode(br);
        if (br.eos()) break;
        px[i] = alpha << 24 | red << 16 | (uint32_t)code << 8 | blue;
        insert(px[i++]);
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256);
        const int dsym = g[kDist].decode(br);
        const int dcode = copy_value(dsym);
        int dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          const int d = kCodeToPlane[dcode - 1];
          dist = (d >> 4) * tx + (8 - (d & 15));
          if (dist < 1) dist = 1;
        }
        if (br.eos()) break;
        if ((size_t)dist > i || total - i < (size_t)length) fail("VP8L: bad backward reference");
        for (int k = 0; k < length; ++k, ++i) {
          px[i] = px[i - dist];
          insert(px[i]);
        }
      } else if (code < 256 + 24 + cache_size) {
        if (br.eos()) break;
        px[i] = cache[code - 256 - 24];
        insert(px[i++]);
      } else {
        fail("VP8L: bad symbol");
      }
    }
    check_eos("pixels");
    for (size_t t = transforms.size(); t-- > 0;) undo(transforms[t], px, ysize);
    return px;
  }

  int copy_value(int sym) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    const int offset = (2 + (sym & 1)) << extra;
    return offset + (int)br.read(extra) + 1;
  }

  LTransform read_transform(int* xsize, int ysize) {
    const int type = (int)br.read(2);
    if (seen & (1 << type)) fail("VP8L: transform %d appears twice", type);
    seen |= 1 << type;
    LTransform t;
    t.type = type;
    t.xsize = *xsize;
    if (type == 0 || type == 1) {  // predictor, cross-colour
      t.bits = (int)br.read(3) + 2;
      t.data = decode_stream(subsample(*xsize, t.bits), subsample(ysize, t.bits), false);
    } else if (type == 3) {  // colour indexing
      const int num = (int)br.read(8) + 1;
      t.bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> pal = decode_stream(num, 1, false);
      // ExpandColorMap: delta-coded entries, the rest transparent black
      t.data.assign((size_t)1 << (8 >> t.bits), 0);
      uint8_t* d = reinterpret_cast<uint8_t*>(t.data.data());
      const uint8_t* s = reinterpret_cast<const uint8_t*>(pal.data());
      std::memcpy(d, s, 4);
      for (int k = 4; k < 4 * num; ++k) d[k] = (uint8_t)(s[k] + d[k - 4]);
    }
    return t;
  }

  static uint32_t add(uint32_t a, uint32_t b) {
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
  }
  static uint32_t avg2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
  static uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // T, L, TL
    int d = 0;
    for (int s = 0; s < 32; s += 8) {
      const int ac = (int)((a >> s) & 255), bc = (int)((b >> s) & 255),
                cc = (int)((c >> s) & 255);
      d += std::abs(bc - cc) - std::abs(ac - cc);
    }
    return d <= 0 ? a : b;
  }
  static uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int v = (int)((a >> s) & 255) + (int)((b >> s) & 255) - (int)((c >> s) & 255);
      out |= (uint32_t)clip255(v) << s;
    }
    return out;
  }
  static uint32_t add_sub_half(uint32_t a, uint32_t b, uint32_t c) {
    const uint32_t ave = avg2(a, b);
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int x = (int)((ave >> s) & 255), y = (int)((c >> s) & 255);
      out |= (uint32_t)clip255(x + (x - y) / 2) << s;
    }
    return out;
  }
  static uint32_t predict(int mode, const uint32_t* px, size_t i, int width) {
    const uint32_t L = px[i - 1], T = px[i - width], TL = px[i - width - 1],
                   TR = px[i - width + 1];
    switch (mode) {
      case 1: return L;
      case 2: return T;
      case 3: return TR;
      case 4: return TL;
      case 5: return avg2(avg2(L, TR), T);
      case 6: return avg2(L, TL);
      case 7: return avg2(L, T);
      case 8: return avg2(TL, T);
      case 9: return avg2(T, TR);
      case 10: return avg2(avg2(L, TL), avg2(T, TR));
      case 11: return select(T, L, TL);
      case 12: return add_sub_full(L, T, TL);
      case 13: return add_sub_half(L, T, TL);
      default: return 0xff000000u;  // 0, and 14 and 15 as libwebp pads them
    }
  }

  void undo(const LTransform& t, std::vector<uint32_t>& px, int ysize) {
    const int w = t.xsize;
    if (t.type == 0) {  // predictor
      const int tiles = subsample(w, t.bits);
      px[0] = add(px[0], 0xff000000u);
      for (int x = 1; x < w; ++x) px[x] = add(px[x], px[x - 1]);
      for (int y = 1; y < ysize; ++y) {
        const uint32_t* modes = &t.data[(size_t)(y >> t.bits) * tiles];
        const size_t row = (size_t)y * w;
        px[row] = add(px[row], px[row - w]);
        for (int x = 1; x < w; ++x) {
          const int mode = (int)((modes[x >> t.bits] >> 8) & 15);
          px[row + x] = add(px[row + x], predict(mode, px.data(), row + x, w));
        }
      }
    } else if (t.type == 1) {  // cross-colour
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < ysize; ++y) {
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
          const int g2r = (int8_t)(m & 255), g2b = (int8_t)((m >> 8) & 255),
                    r2b = (int8_t)((m >> 16) & 255);
          uint32_t& p = px[(size_t)y * w + x];
          const int green = (int8_t)((p >> 8) & 255);
          int red = (int)((p >> 16) & 255), blue = (int)(p & 255);
          red = (red + ((g2r * green) >> 5)) & 255;
          blue += (g2b * green) >> 5;
          blue += (r2b * (int8_t)red) >> 5;
          blue &= 255;
          p = (p & 0xff00ff00u) | (uint32_t)red << 16 | (uint32_t)blue;
        }
      }
    } else if (t.type == 2) {  // subtract green
      for (uint32_t& p : px) {
        const uint32_t g = (p >> 8) & 255;
        const uint32_t rb = ((p & 0x00ff00ffu) + (g << 16 | g)) & 0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
    } else {  // colour indexing, unbundling 8 >> bits bits per pixel
      const int packed_w = subsample(w, t.bits);
      const int bpp = 8 >> t.bits, per_byte = 1 << t.bits;
      const uint32_t mask = (1u << bpp) - 1;
      std::vector<uint32_t> out((size_t)w * ysize);
      for (int y = 0; y < ysize; ++y) {
        const uint32_t* src = &px[(size_t)y * packed_w];
        uint32_t* dst = &out[(size_t)y * w];
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & (per_byte - 1)) == 0) packed = (*src++ >> 8) & 255;
          dst[x] = t.data[packed & mask];
          packed >>= bpp;
        }
      }
      px.swap(out);
    }
  }
};

// A VP8L bitstream (with its 5-byte header) -> ARGB.
std::vector<uint32_t> decode_vp8l(const uint8_t* data, size_t size, int* width,
                                  int* height) {
  VP8L d(data, size);
  if (d.br.read(8) != 0x2f) fail("VP8L: bad signature");
  *width = (int)d.br.read(14) + 1;
  *height = (int)d.br.read(14) + 1;
  d.br.read(1);  // alpha_is_used
  if (d.br.read(3) != 0) fail("VP8L: unknown version");
  d.check_eos("header");
  if ((long long)*width * *height > kMaxPixels) {
    fail("VP8L: %d x %d pixels is too large", *width, *height);
  }
  return d.decode_stream(*width, *height, true);
}

// ------------------------------------------------------------ VP8

const uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
     {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
     {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
     {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
     {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
     {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
     {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
     {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
     {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
     {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
     {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
     {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
     {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
     {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
     {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
     {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
     {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
     {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
     {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
     {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
     {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
     {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
     {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
     {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
     {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
     {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
     {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
     {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
  },
  {
    {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
     {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
     {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
     {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
     {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
     {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
     {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
     {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
     {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
     {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
     {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
     {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
     {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
     {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
     {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
     {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
     {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
     {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
     {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
     {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
     {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
     {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
     {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
     {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
     {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
     {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
     {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
     {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
     {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
};

const uint8_t kBModesProba[10][10][9] = {
  {{231, 120, 48, 89, 115, 113, 120, 152, 112},
   {152, 179, 64, 126, 170, 118, 46, 70, 95},
   {175, 69, 143, 80, 85, 82, 72, 155, 103},
   {56, 58, 10, 171, 218, 189, 17, 13, 152},
   {114, 26, 17, 163, 44, 195, 21, 10, 173},
   {121, 24, 80, 195, 26, 62, 44, 64, 85},
   {144, 71, 10, 38, 171, 213, 144, 34, 26},
   {170, 46, 55, 19, 136, 160, 33, 206, 71},
   {63, 20, 8, 114, 114, 208, 12, 9, 226},
   {81, 40, 11, 96, 182, 84, 29, 16, 36}},
  {{134, 183, 89, 137, 98, 101, 106, 165, 148},
   {72, 187, 100, 130, 157, 111, 32, 75, 80},
   {66, 102, 167, 99, 74, 62, 40, 234, 128},
   {41, 53, 9, 178, 241, 141, 26, 8, 107},
   {74, 43, 26, 146, 73, 166, 49, 23, 157},
   {65, 38, 105, 160, 51, 52, 31, 115, 128},
   {104, 79, 12, 27, 217, 255, 87, 17, 7},
   {87, 68, 71, 44, 114, 51, 15, 186, 23},
   {47, 41, 14, 110, 182, 183, 21, 17, 194},
   {66, 45, 25, 102, 197, 189, 23, 18, 22}},
  {{88, 88, 147, 150, 42, 46, 45, 196, 205},
   {43, 97, 183, 117, 85, 38, 35, 179, 61},
   {39, 53, 200, 87, 26, 21, 43, 232, 171},
   {56, 34, 51, 104, 114, 102, 29, 93, 77},
   {39, 28, 85, 171, 58, 165, 90, 98, 64},
   {34, 22, 116, 206, 23, 34, 43, 166, 73},
   {107, 54, 32, 26, 51, 1, 81, 43, 31},
   {68, 25, 106, 22, 64, 171, 36, 225, 114},
   {34, 19, 21, 102, 132, 188, 16, 76, 124},
   {62, 18, 78, 95, 85, 57, 50, 48, 51}},
  {{193, 101, 35, 159, 215, 111, 89, 46, 111},
   {60, 148, 31, 172, 219, 228, 21, 18, 111},
   {112, 113, 77, 85, 179, 255, 38, 120, 114},
   {40, 42, 1, 196, 245, 209, 10, 25, 109},
   {88, 43, 29, 140, 166, 213, 37, 43, 154},
   {61, 63, 30, 155, 67, 45, 68, 1, 209},
   {100, 80, 8, 43, 154, 1, 51, 26, 71},
   {142, 78, 78, 16, 255, 128, 34, 197, 171},
   {41, 40, 5, 102, 211, 183, 4, 1, 221},
   {51, 50, 17, 168, 209, 192, 23, 25, 82}},
  {{138, 31, 36, 171, 27, 166, 38, 44, 229},
   {67, 87, 58, 169, 82, 115, 26, 59, 179},
   {63, 59, 90, 180, 59, 166, 93, 73, 154},
   {40, 40, 21, 116, 143, 209, 34, 39, 175},
   {47, 15, 16, 183, 34, 223, 49, 45, 183},
   {46, 17, 33, 183, 6, 98, 15, 32, 183},
   {57, 46, 22, 24, 128, 1, 54, 17, 37},
   {65, 32, 73, 115, 28, 128, 23, 128, 205},
   {40, 3, 9, 115, 51, 192, 18, 6, 223},
   {87, 37, 9, 115, 59, 77, 64, 21, 47}},
  {{104, 55, 44, 218, 9, 54, 53, 130, 226},
   {64, 90, 70, 205, 40, 41, 23, 26, 57},
   {54, 57, 112, 184, 5, 41, 38, 166, 213},
   {30, 34, 26, 133, 152, 116, 10, 32, 134},
   {39, 19, 53, 221, 26, 114, 32, 73, 255},
   {31, 9, 65, 234, 2, 15, 1, 118, 73},
   {75, 32, 12, 51, 192, 255, 160, 43, 51},
   {88, 31, 35, 67, 102, 85, 55, 186, 85},
   {56, 21, 23, 111, 59, 205, 45, 37, 192},
   {55, 38, 70, 124, 73, 102, 1, 34, 98}},
  {{125, 98, 42, 88, 104, 85, 117, 175, 82},
   {95, 84, 53, 89, 128, 100, 113, 101, 45},
   {75, 79, 123, 47, 51, 128, 81, 171, 1},
   {57, 17, 5, 71, 102, 57, 53, 41, 49},
   {38, 33, 13, 121, 57, 73, 26, 1, 85},
   {41, 10, 67, 138, 77, 110, 90, 47, 114},
   {115, 21, 2, 10, 102, 255, 166, 23, 6},
   {101, 29, 16, 10, 85, 128, 101, 196, 26},
   {57, 18, 10, 102, 102, 213, 34, 20, 43},
   {117, 20, 15, 36, 163, 128, 68, 1, 26}},
  {{102, 61, 71, 37, 34, 53, 31, 243, 192},
   {69, 60, 71, 38, 73, 119, 28, 222, 37},
   {68, 45, 128, 34, 1, 47, 11, 245, 171},
   {62, 17, 19, 70, 146, 85, 55, 62, 70},
   {37, 43, 37, 154, 100, 163, 85, 160, 1},
   {63, 9, 92, 136, 28, 64, 32, 201, 85},
   {75, 15, 9, 9, 64, 255, 184, 119, 16},
   {86, 6, 28, 5, 64, 255, 25, 248, 1},
   {56, 8, 17, 132, 137, 255, 55, 116, 128},
   {58, 15, 20, 82, 135, 57, 26, 121, 40}},
  {{164, 50, 31, 137, 154, 133, 25, 35, 218},
   {51, 103, 44, 131, 131, 123, 31, 6, 158},
   {86, 40, 64, 135, 148, 224, 45, 183, 128},
   {22, 26, 17, 131, 240, 154, 14, 1, 209},
   {45, 16, 21, 91, 64, 222, 7, 1, 197},
   {56, 21, 39, 155, 60, 138, 23, 102, 213},
   {83, 12, 13, 54, 192, 255, 68, 47, 28},
   {85, 26, 85, 85, 128, 128, 32, 146, 171},
   {18, 11, 7, 63, 144, 171, 4, 4, 246},
   {35, 27, 10, 146, 174, 171, 12, 26, 128}},
  {{190, 80, 35, 99, 180, 80, 126, 54, 45},
   {85, 126, 47, 87, 176, 51, 41, 20, 32},
   {101, 75, 128, 139, 118, 146, 116, 128, 85},
   {56, 41, 15, 176, 236, 85, 37, 9, 62},
   {71, 30, 17, 119, 118, 255, 17, 18, 138},
   {101, 38, 60, 138, 55, 70, 43, 26, 142},
   {146, 36, 19, 30, 171, 255, 97, 27, 20},
   {138, 45, 61, 62, 219, 1, 81, 188, 64},
   {32, 41, 20, 117, 151, 142, 20, 21, 163},
   {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};


const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag16[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's intra modes: the 4x4 ones, and DC / TM / V / H sharing values
// with B_DC / B_TM / B_VE / B_HE for the 16x16 and chroma predictors.
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

// The boolean decoder of bit_reader_utils.c / bit_reader_inl_utils.h:
// range holds range - 1; 7 bytes are loaded at a time, the last 7 one by
// one; past the end one zero byte is fed and eof set.
struct BoolDec {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 255 - 1;
  bool eof = false;

  void init(const uint8_t* p, size_t n) {
    buf = p;
    end = p + n;
    value = 0;
    bits = -8;
    range = 255 - 1;
    eof = false;
    load();
  }
  void load() {
    if (end - buf >= 8) {  // 7 bytes at once, as libwebp's 56-bit loads
      uint64_t v = 0;
      for (int i = 0; i < 7; ++i) v = v << 8 | buf[i];
      buf += 7;
      value = value << 56 | v;
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = value << 8 | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    int b;
    if (v > split) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  uint32_t value_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = (int)value_bits(n);
    return bit(0x80) ? -v : v;
  }
};

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t uvmode = 0, is_i4x4 = 0, segment = 0, skip = 0;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// The inverse DCT as libwebp runs it on x86-64: Transform_SSE2 (dsp/
// dec_sse2.c) for the full transform, every sum wrapped to 16 bits and the
// constants' products taken by _mm_mulhi_epi16, which equals dsp/dec.c's
// TransformOne until a corrupt stream overflows 16 bits; TransformAC3 and
// TransformDC in dsp/dec.c's int arithmetic. Each adds to dst.
constexpr int BPS = 32;
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline int16_t w16(int v) { return (int16_t)v; }
inline int16_t mulhi(int16_t a, int k) { return (int16_t)(((int32_t)a * k) >> 16); }
void transform_one(const int16_t* in, uint8_t* dst) {
  constexpr int k1 = 20091, k2 = -30068;
  int16_t T[4][4];  // T[k][j]: the vertical pass's column j, row k
  for (int j = 0; j < 4; ++j) {
    const int16_t i0 = in[j], i1 = in[4 + j], i2 = in[8 + j], i3 = in[12 + j];
    const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, k2) - mulhi(i3, k1)));
    const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, k1) + mulhi(i3, k2)));
    T[j][0] = w16(a + d);
    T[j][1] = w16(b + c);
    T[j][2] = w16(b - c);
    T[j][3] = w16(a - d);
  }
  for (int j = 0; j < 4; ++j, dst += BPS) {
    const int16_t dc = w16(T[0][j] + 4);
    const int16_t a = w16(dc + T[2][j]), b = w16(dc - T[2][j]);
    const int16_t t1 = T[1][j], t3 = T[3][j];
    const int16_t c = w16(w16(t1 - t3) + w16(mulhi(t1, k2) - mulhi(t3, k1)));
    const int16_t d = w16(w16(t1 + t3) + w16(mulhi(t1, k1) + mulhi(t3, k2)));
    dst[0] = clip8(dst[0] + (w16(a + d) >> 3));
    dst[1] = clip8(dst[1] + (w16(b + c) >> 3));
    dst[2] = clip8(dst[2] + (w16(b - c) >> 3));
    dst[3] = clip8(dst[3] + (w16(a - d) >> 3));
  }
}

void transform_dc(const int16_t* in, uint8_t* dst) {
  const int dc = (in[0] + 4) >> 3;
  for (int y = 0; y < 4; ++y, dst += BPS) {
    for (int x = 0; x < 4; ++x) dst[x] = clip8(dst[x] + dc);
  }
}

// TransformAC3: in[0], in[1] and in[4] alone.
void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y, dst += BPS) {
    dst[0] = clip8(dst[0] + ((rows[y] + d1) >> 3));
    dst[1] = clip8(dst[1] + ((rows[y] + c1) >> 3));
    dst[2] = clip8(dst[2] + ((rows[y] - c1) >> 3));
    dst[3] = clip8(dst[3] + ((rows[y] - d1) >> 3));
  }
}

// DoTransform: a luma block's residual by its code (ParseResiduals' 2
// bits: 0 all zero, 1 the DC alone, 2 up to the third zigzag position, 3
// more).
void add_residual(uint32_t code, const int16_t* in, uint8_t* dst) {
  if (code == 3) {
    transform_one(in, dst);
  } else if (code == 2) {
    transform_ac3(in, dst);
  } else if (code == 1) {
    transform_dc(in, dst);
  }
}

// DoUVTransform: the four blocks of a chroma plane (their codes in the 8
// bits, the first block's highest) all through the full transform when any
// has an AC coefficient, else each non-zero DC alone.
void add_residual_uv(uint32_t bits, const int16_t* in, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* at = dst + (n >> 1) * 4 * BPS + (n & 1) * 4;
    if (bits & 0xaa) {
      transform_one(in + n * 16, at);
    } else if (in[n * 16]) {
      transform_dc(in + n * 16, at);
    }
  }
}

// TransformWHT: the 16 luma DCs of an i16 macroblock into out[16 * k].
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
  }
}

// ------------------------------------------------ intra predictors

inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    const int base = dst[-1] - top[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + base);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, (size_t)size);
}

#define DST(x, y) dst[(x) + (y) * BPS]
void predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3],
            E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE: {
      const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, v[i], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
      break;
    default:  // B_HD
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
  }
}
#undef DST

// The 16x16 (size 16) and chroma (size 8) predictors; DC takes the
// samples that exist (CheckMode), 0x80 with neither.
void predict_block(int mode, uint8_t* dst, int size, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc = 0;
      if (has_top && has_left) {
        for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
        dc = (dc + size) >> (shift + 1);
      } else if (has_top || has_left) {
        for (int i = 0; i < size; ++i) dc += has_top ? dst[i - BPS] : dst[-1 + i * BPS];
        dc = (dc + (size >> 1)) >> shift;
      } else {
        dc = 0x80;
      }
      fill(dst, dc, size);
      break;
    }
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, (size_t)size);
      break;
    default:  // B_HE
      for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], (size_t)size);
      break;
  }
}

// ------------------------------------------------------ loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// hstride across the edge, vstride along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride) {
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
  }
}

void edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
          int ithresh, int hev_t, bool inner) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) {
      do_filter2(p, hstride);
    } else if (inner) {
      do_filter4(p, hstride);
    } else {
      do_filter6(p, hstride);
    }
  }
}

// ---------------------------------------------------------- YUV->BGR

// yuv.h: 14-bit-ish fixed point (YUV_FIX2 6), MultHi as _mm_mulhi_epu16.
inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t yuv_clip(int v) {
  return (uint8_t)(((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255);
}
inline void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
  bgr[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  bgr[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  bgr[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UpsampleRgbLinePair (dsp/upsampling.c): one or two rows of len pixels from
// the chroma rows above (top_u/v) and below (cur_u/v) them.
void upsample_pair(const uint8_t* top_y, const uint8_t* bot_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bot_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_bgr(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bot_y) {
    yuv_to_bgr(bot_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bot_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_bgr(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
               top_dst + 3 * (2 * x - 1));
    yuv_to_bgr(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 3 * (2 * x));
    if (bot_y) {
      yuv_to_bgr(bot_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 bot_dst + 3 * (2 * x - 1));
      yuv_to_bgr(bot_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bot_dst + 3 * (2 * x));
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_bgr(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst + 3 * (len - 1));
    if (bot_y) {
      yuv_to_bgr(bot_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                 bot_dst + 3 * (len - 1));
    }
  }
}

struct VP8 {
  int width = 0, height = 0, mbw = 0, mbh = 0;
  BoolDec br;
  std::vector<BoolDec> parts;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {}, filter_strength[4] = {};
  uint8_t segment_proba[3] = {255, 255, 255};
  // filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, filter_type = 0;
  int ref_lf_delta[4] = {}, mode_lf_delta[4] = {};
  // quantizers: y1 (dc, ac), y2, uv per segment
  int y1_mat[4][2], y2_mat[4][2], uv_mat[4][2];
  uint8_t proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];
  // planes, macroblock aligned
  int ystride = 0, uvstride = 0;
  std::vector<uint8_t> Y, U, V;
  std::vector<FInfo> finfo;  // per macroblock

  void parse(const uint8_t* data, size_t size);
  void parse_modes(MBData& b, uint8_t* top, uint8_t* left);
  int get_coeffs(BoolDec& t, int type, int ctx, const int* dq, int n, int16_t* out);
  bool parse_residuals(MBData& b, uint8_t* tnz, uint8_t* lnz, uint8_t& tdc, uint8_t& ldc, BoolDec& t);
  void reconstruct(const MBData& b, int mb_x, int mb_y);
  void filter_all();
  void to_bgr(uint8_t* out) const;
};

void VP8::parse(const uint8_t* data, size_t size) {
  if (size < 10) fail("VP8: truncated frame header");
  const uint32_t bits = le24(data);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t part0 = bits >> 5;
  if (!key_frame) fail("VP8: not a key frame");
  if (profile > 3) fail("VP8: incorrect keyframe parameters (profile %d)", profile);
  if (!show) fail("VP8: frame not displayable");
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) fail("VP8: bad code word");
  width = (int)(le16(data + 6) & 0x3fff);
  height = (int)(le16(data + 8) & 0x3fff);
  if (width == 0 || height == 0) fail("VP8: %d x %d frame", width, height);
  mbw = (width + 15) >> 4;
  mbh = (height + 15) >> 4;
  data += 10;
  size -= 10;
  if (part0 > size) fail("VP8: bad partition length");
  br.init(data, part0);
  data += part0;
  size -= part0;
  br.value_bits(1);  // colorspace
  br.value_bits(1);  // clamp type
  // segment header
  use_segment = br.value_bits(1);
  if (use_segment) {
    update_map = br.value_bits(1);
    if (br.value_bits(1)) {
      absolute_delta = br.value_bits(1);
      for (int& q : quantizer) q = br.value_bits(1) ? br.signed_value(7) : 0;
      for (int& f : filter_strength) f = br.value_bits(1) ? br.signed_value(6) : 0;
    }
    if (update_map) {
      for (uint8_t& p : segment_proba) p = br.value_bits(1) ? (uint8_t)br.value_bits(8) : 255;
    }
  }
  if (br.eof) fail("VP8: cannot parse segment header");
  // filter header
  simple = br.value_bits(1);
  level = (int)br.value_bits(6);
  sharpness = (int)br.value_bits(3);
  use_lf_delta = br.value_bits(1);
  if (use_lf_delta && br.value_bits(1)) {
    for (int& d : ref_lf_delta) {
      if (br.value_bits(1)) d = br.signed_value(6);
    }
    for (int& d : mode_lf_delta) {
      if (br.value_bits(1)) d = br.signed_value(6);
    }
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) fail("VP8: cannot parse filter header");
  // token partitions
  const size_t last = ((size_t)1 << br.value_bits(2)) - 1;
  if (size < 3 * last) fail("VP8: cannot parse partitions");
  const uint8_t* sz = data;
  const uint8_t* start = data + 3 * last;
  size_t left = size - 3 * last;
  parts.resize(last + 1);
  for (size_t p = 0; p < last; ++p, sz += 3) {
    size_t psize = le24(sz);
    if (psize > left) psize = left;
    parts[p].init(start, psize);
    start += psize;
    left -= psize;
  }
  parts[last].init(start, left);
  if (start >= data + size) fail("VP8: cannot parse partitions (no data)");
  // quantizers (VP8ParseQuant)
  const int base_q0 = (int)br.value_bits(7);
  auto delta = [&]() { return br.value_bits(1) ? br.signed_value(4) : 0; };
  const int dqy1_dc = delta(), dqy2_dc = delta(), dqy2_ac = delta();
  const int dquv_dc = delta(), dquv_ac = delta();
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int s = 0; s < 4; ++s) {
    int q;
    if (use_segment) {
      q = quantizer[s] + (absolute_delta ? 0 : base_q0);
    } else {
      if (s > 0) {
        std::memcpy(y1_mat[s], y1_mat[0], sizeof y1_mat[0]);
        std::memcpy(y2_mat[s], y2_mat[0], sizeof y2_mat[0]);
        std::memcpy(uv_mat[s], uv_mat[0], sizeof uv_mat[0]);
        continue;
      }
      q = base_q0;
    }
    y1_mat[s][0] = kDcTable[clip(q + dqy1_dc, 127)];
    y1_mat[s][1] = kAcTable[clip(q, 127)];
    y2_mat[s][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    y2_mat[s][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (y2_mat[s][1] < 8) y2_mat[s][1] = 8;
    uv_mat[s][0] = kDcTable[clip(q + dquv_dc, 117)];
    uv_mat[s][1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.value_bits(1);  // update_proba, ignored for a key frame
  for (int t = 0; t < 4; ++t) {
    for (int b = 0; b < 8; ++b) {
      for (int c = 0; c < 3; ++c) {
        for (int p = 0; p < 11; ++p) {
          proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[t][b][c][p])
                                  ? (uint8_t)br.value_bits(8)
                                  : kCoeffsProba0[t][b][c][p];
        }
      }
    }
  }
  use_skip_proba = br.value_bits(1);
  if (use_skip_proba) skip_p = (int)br.value_bits(8);
  // PrecomputeFilterStrengths
  for (int s = 0; s < 4; ++s) {
    int base = level;
    if (use_segment) base = filter_strength[s] + (absolute_delta ? 0 : level);
    for (int i4 = 0; i4 <= 1; ++i4) {
      FInfo& f = fstrengths[s][i4];
      int lvl = base;
      if (use_lf_delta) {
        lvl += ref_lf_delta[0];
        if (i4) lvl += mode_lf_delta[0];
      }
      lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
      if (lvl > 0) {
        int il = lvl;
        if (sharpness > 0) {
          il >>= sharpness > 4 ? 2 : 1;
          if (il > 9 - sharpness) il = 9 - sharpness;
        }
        if (il < 1) il = 1;
        f.ilevel = (uint8_t)il;
        f.limit = (uint8_t)(2 * lvl + il);
        f.hev = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
      } else {
        f.limit = 0;
      }
      f.inner = (uint8_t)i4;
    }
  }
  // the frame
  ystride = mbw * 16;
  uvstride = mbw * 8;
  Y.assign((size_t)ystride * mbh * 16, 0);
  U.assign((size_t)uvstride * mbh * 8, 0);
  V.assign(U.size(), 0);
  finfo.assign((size_t)mbw * mbh, FInfo());
  std::vector<MBData> row((size_t)mbw);
  std::vector<uint8_t> intra_t((size_t)mbw * 4, B_DC);
  std::vector<uint8_t> top_nz((size_t)mbw * 8, 0), top_dc((size_t)mbw, 0);
  for (int mb_y = 0; mb_y < mbh; ++mb_y) {
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < mbw; ++mb_x) parse_modes(row[mb_x], &intra_t[4 * mb_x], intra_l);
    if (br.eof) fail("VP8: premature end of partition 0");
    BoolDec& tokens = parts[mb_y & last];
    uint8_t left_nz[8] = {}, left_dc = 0;
    for (int mb_x = 0; mb_x < mbw; ++mb_x) {
      MBData& b = row[mb_x];
      bool skip = use_skip_proba ? b.skip : false;
      if (!skip) {
        skip = parse_residuals(b, &top_nz[8 * mb_x], left_nz, top_dc[mb_x], left_dc, tokens);
      } else {
        std::memset(&top_nz[8 * mb_x], 0, 8);
        std::memset(left_nz, 0, 8);
        if (!b.is_i4x4) top_dc[mb_x] = left_dc = 0;
        b.non_zero_y = b.non_zero_uv = 0;
      }
      if (filter_type > 0) {
        FInfo f = fstrengths[b.segment][b.is_i4x4];
        f.inner |= !skip;
        finfo[(size_t)mb_y * mbw + mb_x] = f;
      }
      if (tokens.eof) fail("VP8: premature end of file");
    }
    for (int mb_x = 0; mb_x < mbw; ++mb_x) reconstruct(row[mb_x], mb_x, mb_y);
  }
  if (filter_type > 0) filter_all();
}

void VP8::parse_modes(MBData& b, uint8_t* top, uint8_t* left) {
  if (update_map) {
    b.segment = !br.bit(segment_proba[0]) ? (uint8_t)br.bit(segment_proba[1])
                                          : (uint8_t)(br.bit(segment_proba[2]) + 2);
  } else {
    b.segment = 0;
  }
  b.skip = use_skip_proba ? (uint8_t)br.bit(skip_p) : 0;
  b.is_i4x4 = !br.bit(145);
  if (!b.is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE) : (br.bit(163) ? B_VE : B_DC);
    b.imodes[0] = (uint8_t)ymode;
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = b.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* p = kBModesProba[top[x]][ymode];
        ymode = !br.bit(p[0]) ? B_DC
              : !br.bit(p[1]) ? B_TM
              : !br.bit(p[2]) ? B_VE
              : !br.bit(p[3]) ? (!br.bit(p[4]) ? B_HE : (!br.bit(p[5]) ? B_RD : B_VR))
              : (!br.bit(p[6]) ? B_LD
                 : (!br.bit(p[7]) ? B_VL : (!br.bit(p[8]) ? B_HD : B_HU)));
        top[x] = (uint8_t)ymode;
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  b.uvmode = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE : br.bit(183) ? B_TM : B_HE;
}

// GetCoeffs: tokens from position n on, dequantized into out (raster
// order); returns the position after the last token read.
int VP8::get_coeffs(BoolDec& t, int type, int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = proba[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!t.bit(p[0])) return n;
    while (!t.bit(p[1])) {
      p = proba[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    const int band = kBands[n + 1];
    if (!t.bit(p[2])) {
      v = 1;
      p = proba[type][band][1];
    } else {
      if (!t.bit(p[3])) {
        v = !t.bit(p[4]) ? 2 : 3 + t.bit(p[5]);
      } else if (!t.bit(p[6])) {
        if (!t.bit(p[7])) {
          v = 5 + t.bit(159);
        } else {
          v = 7 + 2 * t.bit(165);
          v += t.bit(145);
        }
      } else {
        const int bit1 = t.bit(p[8]);
        const int bit0 = t.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + t.bit(*tab);
        v += 3 + (8 << cat);
      }
      p = proba[type][band][2];
    }
    const int sv = t.bit(0x80) ? -v : v;
    out[kZigzag16[n]] = (int16_t)(sv * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code(uint32_t bits, int nz, bool dc_nz) {
  return bits << 2 | (nz > 3 ? 3u : nz > 1 ? 2u : (uint32_t)dc_nz);
}

// ParseResiduals; tnz / lnz are the 4 luma, 2 u and 2 v flags above and
// to the left, tdc / ldc the Y2 ones. Returns true when no coefficient is
// non-zero (libwebp's skip for the filter's inner edges).
bool VP8::parse_residuals(MBData& b, uint8_t* tnz, uint8_t* lnz, uint8_t& tdc,
                          uint8_t& ldc, BoolDec& t) {
  const int s = b.segment;
  int16_t* dst = b.coeffs;
  std::memset(dst, 0, sizeof b.coeffs);
  int first, ac_type;
  if (!b.is_i4x4) {
    int16_t dc[16] = {};
    const int nz = get_coeffs(t, 1, tdc + ldc, y2_mat[s], 0, dc);
    tdc = ldc = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  for (int y = 0; y < 4; ++y) {
    uint32_t codes = 0;
    for (int x = 0; x < 4; ++x) {
      const int nz = get_coeffs(t, ac_type, tnz[x] + lnz[y], y1_mat[s], first, dst);
      tnz[x] = lnz[y] = nz > first;
      codes = nz_code(codes, nz, dst[0] != 0);
      dst += 16;
    }
    non_zero_y = non_zero_y << 8 | codes;
  }
  for (int ch = 0; ch < 2; ++ch) {
    uint32_t codes = 0;
    uint8_t* tz = tnz + 4 + 2 * ch;
    uint8_t* lz = lnz + 4 + 2 * ch;
    for (int y = 0; y < 2; ++y) {
      for (int x = 0; x < 2; ++x) {
        const int nz = get_coeffs(t, 2, tz[x] + lz[y], uv_mat[s], 0, dst);
        tz[x] = lz[y] = nz > 0;
        codes = nz_code(codes, nz, dst[0] != 0);
        dst += 16;
      }
    }
    non_zero_uv |= codes << (8 * ch);
  }
  b.non_zero_y = non_zero_y;
  b.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// ReconstructRow for one macroblock: the work buffer gets libwebp's edge
// samples, the prediction and residuals are added in it, and it is
// copied to the (still unfiltered) planes.
void VP8::reconstruct(const MBData& b, int mb_x, int mb_y) {
  uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
  uint8_t* y_dst = ybuf + BPS + 8;
  uint8_t* u_dst = ubuf + BPS + 8;
  uint8_t* v_dst = vbuf + BPS + 8;
  const size_t y0 = (size_t)mb_y * 16 * ystride + (size_t)mb_x * 16;
  const size_t c0 = (size_t)mb_y * 8 * uvstride + (size_t)mb_x * 8;
  // left column and top-left
  for (int j = 0; j < 16; ++j) {
    y_dst[j * BPS - 1] = mb_x > 0 ? Y[y0 + (size_t)j * ystride - 1] : 129;
  }
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = mb_x > 0 ? U[c0 + (size_t)j * uvstride - 1] : 129;
    v_dst[j * BPS - 1] = mb_x > 0 ? V[c0 + (size_t)j * uvstride - 1] : 129;
  }
  if (mb_y > 0) {
    const uint8_t* ty = &Y[y0 - ystride];
    const uint8_t* tu = &U[c0 - uvstride];
    const uint8_t* tv = &V[c0 - uvstride];
    y_dst[-BPS - 1] = mb_x > 0 ? ty[-1] : 129;
    u_dst[-BPS - 1] = mb_x > 0 ? tu[-1] : 129;
    v_dst[-BPS - 1] = mb_x > 0 ? tv[-1] : 129;
    std::memcpy(y_dst - BPS, ty, 16);
    std::memcpy(u_dst - BPS, tu, 8);
    std::memcpy(v_dst - BPS, tv, 8);
    if (mb_x >= mbw - 1) {
      std::memset(y_dst - BPS + 16, ty[15], 4);
    } else {
      std::memcpy(y_dst - BPS + 16, ty + 16, 4);
    }
  } else {
    std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - BPS - 1, 127, 8 + 1);
    std::memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  const int16_t* coeffs = b.coeffs;
  if (b.is_i4x4) {
    uint8_t* top_right = y_dst - BPS + 16;
    for (int r = 4; r < 16; r += 4) std::memcpy(top_right + r * BPS, top_right, 4);
    for (int n = 0; n < 16; ++n) {
      uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
      predict4(b.imodes[n], dst);
      add_residual((b.non_zero_y >> (30 - 2 * n)) & 3, coeffs + n * 16, dst);
    }
  } else {
    predict_block(b.imodes[0], y_dst, 16, mb_y > 0, mb_x > 0);
    for (int n = 0; n < 16; ++n) {
      add_residual((b.non_zero_y >> (30 - 2 * n)) & 3, coeffs + n * 16,
                   y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
  }
  predict_block(b.uvmode, u_dst, 8, mb_y > 0, mb_x > 0);
  predict_block(b.uvmode, v_dst, 8, mb_y > 0, mb_x > 0);
  add_residual_uv(b.non_zero_uv, coeffs + 256, u_dst);
  add_residual_uv(b.non_zero_uv >> 8, coeffs + 320, v_dst);
  for (int j = 0; j < 16; ++j) std::memcpy(&Y[y0 + (size_t)j * ystride], y_dst + j * BPS, 16);
  for (int j = 0; j < 8; ++j) {
    std::memcpy(&U[c0 + (size_t)j * uvstride], u_dst + j * BPS, 8);
    std::memcpy(&V[c0 + (size_t)j * uvstride], v_dst + j * BPS, 8);
  }
}

// DoFilter over every macroblock in decoding order.
void VP8::filter_all() {
  for (int mb_y = 0; mb_y < mbh; ++mb_y) {
    for (int mb_x = 0; mb_x < mbw; ++mb_x) {
      const FInfo& f = finfo[(size_t)mb_y * mbw + mb_x];
      const int limit = f.limit;
      if (limit == 0) continue;
      uint8_t* yd = &Y[(size_t)mb_y * 16 * ystride + (size_t)mb_x * 16];
      const int ys = ystride;
      if (filter_type == 1) {
        if (mb_x > 0) simple_edge(yd, 1, ys, limit + 4);
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) simple_edge(yd + k, 1, ys, limit);
        }
        if (mb_y > 0) simple_edge(yd, ys, 1, limit + 4);
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) simple_edge(yd + k * ys, ys, 1, limit);
        }
        continue;
      }
      const int us = uvstride;
      uint8_t* ud = &U[(size_t)mb_y * 8 * us + (size_t)mb_x * 8];
      uint8_t* vd = &V[(size_t)mb_y * 8 * us + (size_t)mb_x * 8];
      const int il = f.ilevel, hv = f.hev;
      if (mb_x > 0) {
        edge(yd, 1, ys, 16, limit + 4, il, hv, false);
        edge(ud, 1, us, 8, limit + 4, il, hv, false);
        edge(vd, 1, us, 8, limit + 4, il, hv, false);
      }
      if (f.inner) {
        for (int k = 4; k < 16; k += 4) edge(yd + k, 1, ys, 16, limit, il, hv, true);
        edge(ud + 4, 1, us, 8, limit, il, hv, true);
        edge(vd + 4, 1, us, 8, limit, il, hv, true);
      }
      if (mb_y > 0) {
        edge(yd, ys, 1, 16, limit + 4, il, hv, false);
        edge(ud, us, 1, 8, limit + 4, il, hv, false);
        edge(vd, us, 1, 8, limit + 4, il, hv, false);
      }
      if (f.inner) {
        for (int k = 4; k < 16; k += 4) edge(yd + k * ys, ys, 1, 16, limit, il, hv, true);
        edge(ud + 4 * us, us, 1, 8, limit, il, hv, true);
        edge(vd + 4 * us, us, 1, 8, limit, il, hv, true);
      }
    }
  }
}

// EmitFancyRGB over the whole frame: row 0 and an even height's last row
// alone with their chroma row mirrored, the rows between in pairs.
void VP8::to_bgr(uint8_t* out) const {
  const int W = width, H = height;
  const size_t ostride = (size_t)W * 3;
  auto yrow = [&](int y) { return &Y[(size_t)y * ystride]; };
  auto urow = [&](int r) { return &U[(size_t)r * uvstride]; };
  auto vrow = [&](int r) { return &V[(size_t)r * uvstride]; };
  upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), out, nullptr, W);
  int y = 1;
  for (; y + 1 < H; y += 2) {
    const int r = (y + 1) / 2;
    upsample_pair(yrow(y), yrow(y + 1), urow(r - 1), vrow(r - 1), urow(r), vrow(r),
                  out + y * ostride, out + (y + 1) * ostride, W);
  }
  if (y < H) {  // H even: the last row
    const int r = (H - 1) / 2;
    upsample_pair(yrow(y), nullptr, urow(r), vrow(r), urow(r), vrow(r), out + y * ostride,
                  nullptr, W);
  }
}

// ----------------------------------------------------------- container

// ALPHInit / ALPHDecode's checks: the header byte, then a raw plane of at
// least width * height bytes or a VP8L stream (no header) decoded whole.
void check_alpha(const uint8_t* data, size_t size, int width, int height) {
  if (size <= 1) fail("WebP ALPH: empty chunk");
  const int method = data[0] & 3, prefilter = (data[0] >> 4) & 3, rsrv = data[0] >> 6;
  if (method > 1 || prefilter > 1 || rsrv != 0) fail("WebP ALPH: bad header byte 0x%02X", data[0]);
  if (method == 0) {
    if (size - 1 < (size_t)width * height) fail("WebP ALPH: truncated raw alpha plane");
    return;
  }
  VP8L d(data + 1, size - 1);
  d.decode_stream(width, height, true);
}

// OpenCV 5's cvtColor(COLOR_BGR2GRAY) on 8-bit data.
void bgr_to_gray(cris::Image& img) {
  const size_t n = (size_t)img.width * img.height;
  std::vector<uint8_t> g(n);
  const uint8_t* p = img.pixels.data();
  for (size_t i = 0; i < n; ++i, p += 3) {
    g[i] = (uint8_t)((p[0] * 3735 + p[1] * 19235 + p[2] * 9798 + (1 << 14)) >> 15);
  }
  img.pixels.swap(g);
  img.channels = 1;
}

// The BGR pixels of one bitstream: a VP8L chunk's payload, or a VP8 one
// with its ALPH payload (alpha null when there is none); avail is every byte
// from the bitstream on that libwebp hands the decoder.
cris::Image decode_bitstream(bool lossless, const uint8_t* bits, size_t bits_size,
                             size_t avail, const uint8_t* alpha, size_t alpha_size) {
  cris::Image img;
  img.channels = 3;
  if (lossless) {
    if (bits_size < 5 || bits[0] != 0x2f || (bits[4] >> 5) != 0) fail("VP8L: bad header");
    int w, h;
    std::vector<uint32_t> argb = decode_vp8l(bits, avail, &w, &h);
    img.height = h;
    img.width = w;
    img.pixels.resize((size_t)w * h * 3);
    uint8_t* o = img.pixels.data();
    for (uint32_t v : argb) {
      *o++ = (uint8_t)v;
      *o++ = (uint8_t)(v >> 8);
      *o++ = (uint8_t)(v >> 16);
    }
    return img;
  }
  if (bits_size < 10) fail("VP8: truncated frame header");
  if ((le24(bits) >> 5) >= bits_size) fail("VP8: partition 0 beyond the chunk");
  VP8 d;
  d.parse(bits, avail);
  if ((long long)d.width * d.height > kMaxPixels) {
    fail("VP8: %d x %d pixels is too large", d.width, d.height);
  }
  if (alpha) check_alpha(alpha, alpha_size, d.width, d.height);
  img.height = d.height;
  img.width = d.width;
  img.pixels.resize((size_t)d.width * d.height * 3);
  d.to_bgr(img.pixels.data());
  return img;
}

// VP8GetInfo / VP8LGetInfo (what WebPGetFeatures checks of a frame's
// bitstream chunk): the frame's size, or a Fault.
void bitstream_size(const uint8_t* c, size_t avail, int* w, int* h) {
  const uint8_t* b = c + 8;
  const size_t n = avail - 8;
  if (std::memcmp(c, "VP8L", 4) == 0) {
    if (n < 5 || b[0] != 0x2f || (b[4] >> 5) != 0) fail("animated WebP: ANMF with a bad VP8L header");
    const uint32_t v = le32(b + 1);
    *w = (int)(v & 0x3fff) + 1;
    *h = (int)((v >> 14) & 0x3fff) + 1;
    return;
  }
  if (n < 10) fail("animated WebP: ANMF with a truncated VP8 frame header");
  const uint32_t bits = le24(b);
  *w = (int)(le16(b + 6) & 0x3fff);
  *h = (int)(le16(b + 8) & 0x3fff);
  if (b[3] != 0x9d || b[4] != 0x01 || b[5] != 0x2a || (bits & 1) || ((bits >> 1) & 7) > 3 ||
      !((bits >> 4) & 1) || (bits >> 5) >= le32(c + 4) || *w == 0 || *h == 0) {
    fail("animated WebP: ANMF with a bad VP8 frame header");
  }
}

struct Frame {
  int x = 0, y = 0, width = 0, height = 0;
  const uint8_t* alpha = nullptr;  // the ALPH chunk
  const uint8_t* image = nullptr;  // the VP8 / VP8L chunk
};

// The first frame of an animated file as WebPAnimDecoder gives it to
// OpenCV 5: WebPDemux's checks of every chunk and frame (ParseVP8XChunks,
// ParseAnimationFrame, StoreFrame, IsValidExtendedFormat), then the first
// frame decoded as a still bitstream and put at its offset on a canvas of
// transparent black. The first frame is a key frame, so it is neither
// blended nor disposed, and ANIM's background colour is not used.
cris::Image decode_animation(const uint8_t* data, const uint8_t* end, uint32_t flags,
                             int canvas_w, int canvas_h, const uint8_t** exif) {
  cris::check_size("WebP", canvas_w, canvas_h);
  if (flags & ~0x3Eu & 0xFF) fail("animated WebP: unknown VP8X feature flags 0x%02X", (int)(flags & 0xFF));
  auto padded = [](size_t n) { return n + (n & 1); };
  const uint8_t* p = data + 12 + 18;
  bool anim = false;
  Frame first;  // the first frame; the others are only checked
  while (p != end) {
    if (end - p < 8) fail("WebP: truncated chunk header");
    const size_t n = le32(p + 4);
    if (n > 0xFFFFFFF6u || padded(n) > (size_t)(end - p) - 8) {
      fail("WebP: chunk size beyond the RIFF data");
    }
    if (!std::memcmp(p, "VP8X", 4) || !std::memcmp(p, "ALPH", 4) ||
        !std::memcmp(p, "VP8 ", 4) || !std::memcmp(p, "VP8L", 4)) {
      throw Fault(std::string("animated WebP: a '") +
                  std::string((const char*)p, 4) + "' chunk outside its frames");
    }
    if (!std::memcmp(p, "ANIM", 4)) {
      if (padded(n) < 6) fail("animated WebP: ANIM chunk size %d is under 6", (int)n);
      anim = true;
      p += 8 + padded(n);
    } else if (!std::memcmp(p, "ANMF", 4)) {
      if (!anim) fail("animated WebP: ANMF before ANIM");
      if (padded(n) < 16) fail("animated WebP: ANMF chunk size %d is under 16", (int)n);
      const uint8_t* q = p + 8;
      Frame f;
      f.x = 2 * (int)le24(q);
      f.y = 2 * (int)le24(q + 3);
      if ((uint64_t)(le24(q + 6) + 1) * (le24(q + 9) + 1) >= (1ull << 32)) {
        fail("animated WebP: ANMF frame size is too large");
      }
      const size_t payload = padded(n) - 16;
      const uint8_t* s = q + 16;
      if ((size_t)(end - s) < 8 || (size_t)(end - s) < payload) fail("animated WebP: ANMF truncated frame");
      // StoreFrame: an optional ALPH, then one VP8 / VP8L chunk; parsing
      // stops (and goes on at the top level) at any other chunk
      bool got_image = false;
      while (s != end) {
        if (end - s < 8) fail("WebP: truncated chunk header");
        const size_t m = le32(s + 4);
        if (m > 0xFFFFFFF6u || padded(m) > (size_t)(end - s) - 8) {
          fail("WebP: chunk size beyond the RIFF data");
        }
        if (!std::memcmp(s, "ALPH", 4) && !f.alpha) {
          f.alpha = s;
        } else if ((!std::memcmp(s, "VP8 ", 4) || !std::memcmp(s, "VP8L", 4)) && !got_image) {
          if (!std::memcmp(s, "VP8L", 4) && f.alpha) fail("animated WebP: ANMF ALPH before a VP8L bitstream");
          bitstream_size(s, 8 + padded(m), &f.width, &f.height);
          f.image = s;
          got_image = true;
        } else {
          break;
        }
        s += 8 + padded(m);
      }
      if ((size_t)(s - q - 16) > payload) fail("animated WebP: ANMF frame chunks run past the ANMF chunk");
      if (f.alpha || f.image) {
        if (!f.image) fail("animated WebP: ANMF a frame with ALPH and no bitstream");
        if (f.alpha && f.alpha > f.image) fail("animated WebP: ANMF ALPH after the bitstream");
        if (f.x + f.width > canvas_w || f.y + f.height > canvas_h) {
          fail("animated WebP: ANMF a %d x %d frame does not lie inside the canvas", f.width, f.height);
        }
        if (!first.image) first = f;
      }
      p = s;
    } else {
      // the demuxer's first EXIF chunk, met in this walk (where a frame's
      // chunks, not its ANMF size, set the next chunk)
      if (!*exif && !std::memcmp(p, "EXIF", 4)) *exif = p;
      p += 8 + padded(n);
    }
  }
  if (!first.image) fail("animated WebP: no frame");
  const Frame& f = first;
  const bool lossless = !std::memcmp(f.image, "VP8L", 4);
  const size_t bits_size = le32(f.image + 4);
  const uint8_t* frame_end = f.image + 8 + padded(bits_size);
  cris::Image frame = decode_bitstream(lossless, f.image + 8, bits_size,
                                       (size_t)(frame_end - f.image - 8),
                                       f.alpha ? f.alpha + 8 : nullptr,
                                       f.alpha ? le32(f.alpha + 4) : 0);
  if (frame.width != f.width || frame.height != f.height) fail("animated WebP: ANMF frame size changed");
  cris::Image img;
  img.height = canvas_h;
  img.width = canvas_w;
  img.channels = 3;
  img.pixels.assign((size_t)canvas_w * canvas_h * 3, 0);
  for (int y = 0; y < f.height; ++y) {
    std::memcpy(&img.pixels[((size_t)(f.y + y) * canvas_w + f.x) * 3],
                &frame.pixels[(size_t)y * f.width * 3], (size_t)f.width * 3);
  }
  return img;
}

}  // namespace

namespace cris {

// ParseHeadersInternal (webp_dec.c) over a RIFF file, then the bitstream.
Image decode_webp(const uint8_t* data, size_t size, bool gray) {
  if (size < 12 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WEBP", 4)) {
    fail("WebP: no RIFF/WEBP header");
  }
  // OpenCV's reader asks for WEBP_HEADER_SIZE bytes before it looks
  if (size < 32) fail("WebP: %d bytes is shorter than OpenCV's 32-byte minimum", (int)size);
  const uint32_t riff = le32(data + 4);
  if (riff < 4 + 8) fail("WebP: RIFF size %d is too small", (int)riff);
  if (riff > 0xFFFFFFF6u - 8 || riff > size - 8) fail("WebP: truncated RIFF data");
  const uint8_t* end = data + 8 + riff;  // chunks past the RIFF size are ignored
  const uint8_t* p = data + 12;
  auto chunk_size = [&](const uint8_t* c) -> size_t {
    if (end - c < 8) fail("WebP: truncated chunk header");
    return le32(c + 4);
  };
  bool vp8x = false;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
  Image img;
  if (end - p >= 8 && std::memcmp(p, "VP8X", 4) == 0) {
    if (chunk_size(p) != 10) fail("WebP VP8X: chunk size %d is not 10", (int)le32(p + 4));
    if (end - p < 18) fail("WebP VP8X: truncated chunk");
    flags = le32(p + 8);
    canvas_w = (int)le24(p + 12) + 1;
    canvas_h = (int)le24(p + 15) + 1;
    if ((long long)canvas_w * canvas_h > kMaxPixels) {
      fail("WebP VP8X: %d x %d pixels is too large", canvas_w, canvas_h);
    }
    vp8x = true;
  }
  const uint8_t* anim_exif = nullptr;
  if (vp8x && (flags & 0x02)) {
    img = decode_animation(data, end, flags, canvas_w, canvas_h, &anim_exif);
  } else {
    if (vp8x) {
      p += 18;
      // ParseOptionalChunks: everything up to the bitstream (ANIM and ANMF
      // of a file without the animation flag too), each chunk padded to an
      // even size; the last ALPH is the alpha
      for (;;) {
        const size_t n = chunk_size(p);
        if (std::memcmp(p, "VP8 ", 4) == 0 || std::memcmp(p, "VP8L", 4) == 0) break;
        const size_t disk = (8 + n + 1) & ~(size_t)1;
        if (disk > (size_t)(end - p)) fail("WebP: chunk size beyond the RIFF data");
        if (std::memcmp(p, "ALPH", 4) == 0) {
          alpha = p + 8;
          alpha_size = n;
        }
        p += disk;
      }
    }
    if (end - p < 8) fail("WebP: no VP8 or VP8L chunk");
    const bool lossless = std::memcmp(p, "VP8L", 4) == 0;
    if (!lossless && std::memcmp(p, "VP8 ", 4) != 0) {
      char tag[5] = {};
      for (int i = 0; i < 4; ++i) tag[i] = (p[i] >= 32 && p[i] < 127) ? (char)p[i] : '?';
      throw Fault(std::string("WebP: unexpected chunk '") + tag +
                  "' where the VP8 or VP8L bitstream should be");
    }
    const size_t bits_size = le32(p + 4);
    if (vp8x && ((8 + bits_size + 1) & ~(size_t)1) > (size_t)(end - p)) {
      fail("WebP: chunk size beyond the RIFF data");
    }
    if (riff >= 12 && bits_size > riff - 12) fail("WebP: bitstream size beyond the RIFF size");
    if (bits_size > (size_t)(end - p) - 8) fail("WebP: truncated bitstream");
    const uint8_t* bits = p + 8;
    // libwebp hands the decoder every byte from the bitstream on
    img = decode_bitstream(lossless, bits, bits_size, (size_t)(data + size - bits),
                           lossless ? nullptr : alpha, alpha_size);
    if (vp8x && (img.width != canvas_w || img.height != canvas_h)) {
      fail("WebP: VP8X canvas %d x %d differs from the bitstream's", canvas_w, canvas_h);
    }
  }
  if (gray) bgr_to_gray(img);
  if (anim_exif && (flags & 0x08)) {
    apply_orientation(img, exif_orientation_tiff(anim_exif + 8, le32(anim_exif + 4)));
  } else if (vp8x && !(flags & 0x02) && (flags & 0x08)) {  // the first EXIF chunk's orientation
    const uint8_t* c = data + 12;
    while (end - c >= 8) {
      const size_t n = le32(c + 4);
      if (n > (size_t)(end - c) - 8) break;
      if (std::memcmp(c, "EXIF", 4) == 0) {
        apply_orientation(img, exif_orientation_tiff(c + 8, n));
        break;
      }
      c += (8 + n + 1) & ~(size_t)1;
    }
  }
  return img;
}

}  // namespace cris
