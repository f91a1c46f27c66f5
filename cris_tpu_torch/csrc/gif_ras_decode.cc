// GIF and Sun raster decoding for the data library, as OpenCV 5.0's own
// readers (grfmt_gif.cpp, grfmt_sunras.cpp) decode them for cv2.imdecode,
// so that the pixels equal OpenCV's bit for bit. Each rule below was
// found by probing cv2 5.0.0:
//   - GIF: GIF87a and GIF89a; the first image of the file is decoded onto a
//     canvas of the logical screen's size, filled with the global colour
//     table's entry at the background index (black without a global
//     table); a background index outside the global table is refused. The
//     whole file is walked to its trailer first (OpenCV counts the frames),
//     so a file cut anywhere, or a block of unknown type, is refused. The
//     last Graphic Control Extension before the image gives its
//     transparency (disposal methods above 3 are refused); a transparent
//     pixel keeps the canvas colour. A pixel's colour is the local table's
//     entry when the index is inside it, else the global table's, else the
//     image is refused; with neither table OpenCV's default one maps index
//     i to gray i, and 1 to white. Interlaced rows; the image must lie
//     inside the screen. LZW at minimum code sizes 2-11: clear codes, the
//     4096-code limit (a deferred clear), and OpenCV's reading of the
//     end-of-information code, which resets the table like a clear code
//     while decoding goes on to the end of the data sub-blocks; too few
//     pixels, or more than OpenCV lets pass (gif_lzw), are refused. Gray
//     is OpenCV 5's cvtColor(BGR2GRAY) (15-bit weights 9798, 19235, 3735).
//   - Sun raster: RT_OLD (0) and RT_STANDARD (1) at depths 1, 8, 24 and 32,
//     rows padded to 16 bits; 24 bits stored B, G, R, 32 bits as X, B, G,
//     R. An RMT_EQUAL_RGB colormap (depths 1 and 8) of at most 2^depth
//     entries: maplength / 3 entries, the rest of the palette black.
//     Without a colormap, IMREAD_COLOR reads 1 and 8 bits as gray levels
//     but IMREAD_GRAYSCALE gives an all-zero image (OpenCV 5.0's gray
//     palette is only filled from a colormap). Gray is OpenCV's 14-bit
//     icvCvt_BGR2Gray (4899, 9617, 1868). OpenCV 5.0's header check
//     refuses RT_BYTE_ENCODED (2, RLE) and RT_FORMAT_RGB (3) at every
//     depth, and so does this reader. Truncated data is refused.
// Integer arithmetic only; no global state.

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
using cris::gray15;

// ---------------------------------------------------------------- GIF

struct GifStream {
  const uint8_t* p;
  size_t n, pos = 0;
  int byte() {
    if (pos >= n) fail("GIF: unexpected end of data");
    return p[pos++];
  }
  int word() {
    const int lo = byte();
    return lo | byte() << 8;
  }
  const uint8_t* bytes(size_t k) {
    if (k > n - pos) fail("GIF: unexpected end of data");
    const uint8_t* q = p + pos;
    pos += k;
    return q;
  }
  void skip_sub_blocks() {
    for (int len = byte(); len != 0; len = byte()) bytes((size_t)len);
  }
};

// OpenCV's frame count: every block to the trailer must be well formed.
void walk_to_trailer(GifStream s) {
  for (;;) {
    const int b = s.byte();
    if (b == 0x3B) return;
    if (b == 0x21) {
      s.byte();
      s.skip_sub_blocks();
    } else if (b == 0x2C) {
      s.bytes(8);
      const int flags = s.byte();
      if (flags & 0x80) s.bytes((size_t)3 << ((flags & 7) + 1));
      s.byte();
      s.skip_sub_blocks();
    } else {
      fail("GIF: unknown block 0x%02X", b);
    }
  }
}

// The image's LZW data (its sub-blocks) decoded as OpenCV's lzwDecode
// does, into count colour indices. OpenCV reads a byte only when fewer
// bits than a code are in hand, then decodes every whole code; an end code
// stops that, so the bits after it wait for the next byte (and are dropped
// at the end of the data). A string that starts inside the image must end
// inside it. Codes past the image are tolerated, bad ones too (each counts
// as a pixel), until the next byte is due: more than the image by then, or
// fewer pixels at the end, is refused. (Fitted to cv2 5.0.0 on hand-made
// and mutated streams.)
std::vector<uint16_t> gif_lzw(GifStream& s, int min_size, size_t count) {
  if (min_size < 2 || min_size > 11) fail("GIF: LZW minimum code size %d", min_size);
  const int clear = 1 << min_size, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096), out;
  std::vector<uint8_t> suffix(4096), stack(4097);
  out.reserve(count + 4096);
  int size = min_size + 1, next = eoi + 1, prev = -1;
  uint8_t first = 0;
  uint32_t acc = 0;
  int bits = 0;
  for (int left = s.byte(); left != 0;) {
    if (out.size() > count) fail("GIF: more LZW data than the image holds");
    if (bits < size) {
      acc |= (uint32_t)s.byte() << bits;
      bits += 8;
      --left;
    }
    while (bits >= size) {
      const int code = (int)(acc & ((1u << size) - 1));
      acc >>= size;
      bits -= size;
      if (code == clear || code == eoi) {
        size = min_size + 1;
        next = eoi + 1;
        prev = -1;
        if (code == eoi) break;
        continue;
      }
      if (prev < 0) {
        if (code >= clear && out.size() >= count) {  // past the image: counted
          out.push_back(0);
          continue;
        }
        if (code >= clear) fail("GIF: corrupt LZW data (code %d after a clear)", code);
        out.push_back((uint16_t)code);
        prev = code;
        first = (uint8_t)code;
        continue;
      }
      if (code > next || (code == next && next >= 4096)) {
        if (out.size() >= count) {  // past the image: counted, not checked
          out.push_back(0);
          continue;
        }
        fail("GIF: corrupt LZW data (code %d, next free %d)", code, next);
      }
      int c = code, sp = 0;
      if (code == next) {  // KwKwK: the previous string and its first index
        stack[sp++] = first;
        c = prev;
      }
      while (c >= clear) {
        stack[sp++] = suffix[c];
        c = prefix[c];
      }
      stack[sp++] = (uint8_t)c;
      first = (uint8_t)c;
      if (out.size() < count && out.size() + sp > count) {
        fail("GIF: more LZW data than the image holds");
      }
      while (sp > 0) out.push_back(stack[--sp]);
      if (next < 4096) {
        prefix[next] = (uint16_t)prev;
        suffix[next] = first;
        ++next;
        if (next == (1 << size) && size < 12) ++size;
      }
      prev = code;
    }
    if (left == 0) left = s.byte();
  }
  if (out.size() < count) fail("GIF: the LZW data end before the image does");
  out.resize(count);
  return out;
}

Image decode_gif_impl(const uint8_t* data, size_t size, bool gray) {
  GifStream s{data, size};
  s.bytes(6);
  const int sw = s.word(), sh = s.word();
  const int flags = s.byte(), bg = s.byte();
  s.byte();
  if (sw == 0 || sh == 0) fail("GIF: logical screen %d x %d", sw, sh);
  check_size("GIF", sw, sh);
  const uint8_t* global = nullptr;
  int gsize = 0;
  if (flags & 0x80) {
    gsize = 2 << (flags & 7);
    global = s.bytes((size_t)gsize * 3);
    if (bg >= gsize) {
      fail("GIF: background index %d is outside the global colour table of %d", bg, gsize);
    }
  }
  walk_to_trailer(s);
  bool transparent = false;
  int trans = 0;
  for (int b = s.byte(); b != 0x2C; b = s.byte()) {
    if (b != 0x21) fail("GIF: block 0x%02X where the first image should be", b);
    if (s.byte() == 0xF9) {
      if (s.byte() != 4) fail("GIF: bad Graphic Control Extension");
      const int gce = s.byte();
      s.word();
      trans = s.byte();
      transparent = gce & 1;
      if (((gce >> 2) & 7) > 3) fail("GIF: disposal method %d", (gce >> 2) & 7);
    }
    s.skip_sub_blocks();
  }
  const int left = s.word(), top = s.word(), w = s.word(), h = s.word();
  const int iflags = s.byte();
  if (w == 0 || h == 0 || left + w > sw || top + h > sh) {
    throw Fault("GIF: the first image (" + std::to_string(w) + " x " + std::to_string(h) +
                " at " + std::to_string(left) + ", " + std::to_string(top) +
                ") does not lie inside the logical screen");
  }
  const uint8_t* local = nullptr;
  int lsize = 0;
  if (iflags & 0x80) {
    lsize = 2 << (iflags & 7);
    local = s.bytes((size_t)lsize * 3);
  }
  const std::vector<uint16_t> idx = gif_lzw(s, s.byte(), (size_t)w * h);

  Image img;
  img.height = sh;
  img.width = sw;
  img.channels = 3;
  img.pixels.assign((size_t)sw * sh * 3, 0);
  if (global) {
    for (size_t i = 0; i < (size_t)sw * sh; ++i) {
      img.pixels[3 * i] = global[3 * bg + 2];
      img.pixels[3 * i + 1] = global[3 * bg + 1];
      img.pixels[3 * i + 2] = global[3 * bg];
    }
  }
  // the rows in stream order: interlaced passes start at 0, 4, 2, 1
  std::vector<int> rows;
  if (iflags & 0x40) {
    static const int kStart[4] = {0, 4, 2, 1}, kStep[4] = {8, 8, 4, 2};
    for (int pass = 0; pass < 4; ++pass) {
      for (int y = kStart[pass]; y < h; y += kStep[pass]) rows.push_back(y);
    }
  } else {
    for (int y = 0; y < h; ++y) rows.push_back(y);
  }
  size_t k = 0;
  for (int y : rows) {
    uint8_t* d = &img.pixels[((size_t)(top + y) * sw + left) * 3];
    for (int x = 0; x < w; ++x, d += 3) {
      const int i = idx[k++];
      if (transparent && i == trans) continue;
      const uint8_t* c;
      uint8_t dflt[3];
      if (i < lsize) {
        c = local + 3 * i;
      } else if (i < gsize) {
        c = global + 3 * i;
      } else if (!local && !global && i < 256) {
        dflt[0] = dflt[1] = dflt[2] = (uint8_t)(i == 1 ? 255 : i);
        c = dflt;
      } else {
        fail("GIF: colour index %d is outside the colour tables", i);
      }
      d[0] = c[2];
      d[1] = c[1];
      d[2] = c[0];
    }
  }
  if (gray) {
    std::vector<uint8_t> g((size_t)sw * sh);
    for (size_t i = 0; i < g.size(); ++i) {
      const uint8_t* p = &img.pixels[3 * i];
      g[i] = gray15(p[0], p[1], p[2]);
    }
    img.pixels.swap(g);
    img.channels = 1;
  }
  return img;
}

// ---------------------------------------------------------- Sun raster

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

Image decode_ras_impl(const uint8_t* data, size_t size, bool gray) {
  if (size < 32) fail("Sun raster: unexpected end of data");
  const int32_t width = (int32_t)be32(data + 4), height = (int32_t)be32(data + 8);
  const int32_t depth = (int32_t)be32(data + 12);
  const uint32_t type = be32(data + 20), maptype = be32(data + 24);
  const uint32_t maplength = be32(data + 28);
  if (type == 2) fail("Sun raster: RT_BYTE_ENCODED (RLE) is not supported (OpenCV 5.0 refuses it)");
  if (type == 3) fail("Sun raster: RT_FORMAT_RGB is not supported (OpenCV 5.0 refuses it)");
  if (type > 1) fail("Sun raster: type %d is not supported", (int)type);
  if (depth != 1 && depth != 8 && depth != 24 && depth != 32) {
    fail("Sun raster: depth %d is not supported", depth);
  }
  const uint32_t palsize = depth <= 8 ? 3u << depth : 0;
  if (!((maptype == 0 && maplength == 0) ||
        (maptype == 1 && maplength > 0 && maplength <= palsize))) {
    fail("Sun raster: colormap type %d of %d bytes is not supported", (int)maptype,
         (int)maplength);
  }
  check_size("Sun raster", width, height);
  uint8_t pal[256][3] = {};  // B, G, R
  uint8_t gray_pal[256] = {};
  if (maplength) {
    if (size - 32 < maplength) fail("Sun raster: unexpected end of data");
    const uint8_t* m = data + 32;
    const uint32_t n = maplength / 3;
    for (uint32_t i = 0; i < n; ++i) {
      pal[i][0] = m[i + 2 * n];
      pal[i][1] = m[i + n];
      pal[i][2] = m[i];
    }
    for (int i = 0; i < 256; ++i) gray_pal[i] = gray14(pal[i][0], pal[i][1], pal[i][2]);
  } else if (depth <= 8) {
    for (int i = 0; i < (1 << depth); ++i) {
      pal[i][0] = pal[i][1] = pal[i][2] = (uint8_t)(i * 255 / ((1 << depth) - 1));
    }
  }
  const size_t pitch = (((size_t)width * depth + 7) / 8 + 1) & ~(size_t)1;
  const size_t offset = 32 + (size_t)maplength;
  if ((size - offset) / pitch < (size_t)height) fail("Sun raster: unexpected end of data");
  Image img;
  img.height = height;
  img.width = width;
  img.channels = gray ? 1 : 3;
  img.pixels.resize((size_t)width * height * img.channels);
  uint8_t* d = img.pixels.data();
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = data + offset + (size_t)y * pitch;
    for (int x = 0; x < width; ++x) {
      if (depth <= 8) {
        const int i = depth == 8 ? src[x] : (src[x >> 3] >> (7 - (x & 7))) & 1;
        if (gray) {
          *d++ = gray_pal[i];
        } else {
          *d++ = pal[i][0];
          *d++ = pal[i][1];
          *d++ = pal[i][2];
        }
        continue;
      }
      const uint8_t* q = depth == 24 ? src + 3 * x : src + 4 * x + 1;
      if (gray) {
        *d++ = gray14(q[0], q[1], q[2]);
      } else {
        *d++ = q[0];
        *d++ = q[1];
        *d++ = q[2];
      }
    }
  }
  return img;
}

}  // namespace

namespace cris {

Image decode_gif(const uint8_t* data, size_t size, bool gray) {
  return decode_gif_impl(data, size, gray);
}

Image decode_ras(const uint8_t* data, size_t size, bool gray) {
  return decode_ras_impl(data, size, gray);
}

}  // namespace cris
