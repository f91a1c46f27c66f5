// The image codec's in-process interface, for the other host translation
// units of the data library (batch_preprocess.cc). Python reaches the same
// code through the extern "C" functions of image_codec.cc.
#pragma once

#include <cstddef>
#include <cstdint>
#include <stdexcept>
#include <string>
#include <vector>

namespace cris {

// A decoding fault; what() names the marker, chunk or fault.
struct Fault : std::runtime_error {
  explicit Fault(const std::string& what) : std::runtime_error(what) {}
};

[[noreturn]] void fail(const char* fmt, int a = 0, int b = 0);

// An 8-bit image, rows of width * channels bytes: BGR when channels is 3.
struct Image {
  int height = 0, width = 0, channels = 0;
  std::vector<uint8_t> pixels;
};

// cv2.imdecode of JPEG, PNG, WebP (still or animated), BMP, PNM / PAM,
// TIFF, GIF, Sun raster, JPEG 2000, Radiance HDR or PFM bytes: with gray
// false as IMREAD_COLOR (BGR, a gray image replicated to 3 channels), with
// gray true as IMREAD_GRAYSCALE (1 channel); a PFM keeps its own channels
// under either flag, as cv2 does. An orientation (JPEG, PNG and WebP EXIF,
// the TIFF tag) is applied. Throws Fault (or std::bad_alloc).
Image decode(const uint8_t* data, size_t size, bool gray);

// The decoders of the other formats, called by decode once the magic bytes
// name them: webp_decode.cc (RIFF WebP, lossy and lossless, the first
// frame of an animated file),
// bmp_pnm_decode.cc (BMP, PNM P1-P6, PAM P7). Same contract as decode.
Image decode_webp(const uint8_t* data, size_t size, bool gray);
Image decode_bmp(const uint8_t* data, size_t size, bool gray);
Image decode_pnm(const uint8_t* data, size_t size, bool gray);
// tiff_decode.cc (TIFF, as OpenCV reads it through libtiff's RGBA
// interface) and gif_ras_decode.cc (GIF, Sun raster).
Image decode_tiff(const uint8_t* data, size_t size, bool gray);
Image decode_gif(const uint8_t* data, size_t size, bool gray);
Image decode_ras(const uint8_t* data, size_t size, bool gray);
// hdr_pfm_decode.cc (Radiance HDR and PFM, as OpenCV's own readers). A PFM
// keeps its file's channels under either flag, as cv2.imdecode does: 3
// for "PF" under IMREAD_GRAYSCALE too, 1 for "Pf" under IMREAD_COLOR.
Image decode_hdr(const uint8_t* data, size_t size, bool gray);
Image decode_pfm(const uint8_t* data, size_t size, bool gray);
// jpeg2000_decode.cc (a JP2 file or a raw J2K codestream, as OpenJPEG 2.5.3
// decodes it and OpenCV 5.0 converts it).
Image decode_jp2(const uint8_t* data, size_t size, bool gray);

// A JPEG stream's samples as libtiff's JPEG codec gets them from libjpeg
// (compression 7 in a TIFF): the tables of a JPEGTables stream (tables_len
// 0 for none), then the strip's or tile's own stream. With ycbcr_to_rgb
// three components are YCbCr, upsampled and turned to RGB as libjpeg does
// (JPEGCOLORMODE_RGB); else the components are given as coded, which needs
// every sampling factor 1. Samples are interleaved, width x height x
// components; h0 and v0 are the first component's sampling factors.
struct JpegSamples {
  int width = 0, height = 0, components = 0, h0 = 1, v0 = 1;
  std::vector<uint8_t> samples;
};
JpegSamples decode_jpeg_samples(const uint8_t* tables, size_t tables_len,
                                const uint8_t* data, size_t size,
                                bool ycbcr_to_rgb);

// OpenCV's CV_IO_MAX_IMAGE_WIDTH / HEIGHT and CV_IO_MAX_IMAGE_PIXELS: a
// Fault naming `what` unless 0 < w, h <= 2^20 and w * h <= 2^30.
void check_size(const char* what, long long w, long long h);

// BGR to gray as OpenCV's readers do it (icvCvt_BGR2Gray, 14-bit weights)
// and as cvtColor(COLOR_BGR2GRAY) does (15-bit weights).
inline uint8_t gray14(int b, int g, int r) {
  return (uint8_t)((b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14);
}
inline uint8_t gray15(int b, int g, int r) {
  return (uint8_t)((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15);
}

// The orientation tag of a TIFF-structured EXIF block (1 when absent), and
// OpenCV's ApplyExifOrientation of it.
int exif_orientation_tiff(const uint8_t* tiff, size_t len);
void apply_orientation(Image& img, int orientation);

// A zlib stream (RFC 1950 around RFC 1951 deflate data), inflated; the
// Adler-32 checksum is checked, bytes after it are ignored. reserve is the
// expected output size, 0 when unknown. Throws Fault.
// With idat_ends (a PNG's IDAT data, joined, and where each piece of it
// that libpng hands zlib ends), reserve is the rows' bytes and the stream
// is read as libpng's sequential reader reads it: the output stops at the
// rows, and an error or a bad Adler-32 after the call that completed them
// is a warning. With whole_at_reserve (a TIFF strip or tile, as libtiff's
// ZIPDecode inflates it into a buffer of reserve bytes), a fault once
// reserve bytes are out is not one: libtiff reports it, but the buffer is
// whole and OpenCV reads it.
std::vector<uint8_t> zlib_inflate(const uint8_t* data, size_t size,
                                  size_t reserve,
                                  const std::vector<size_t>* idat_ends = nullptr,
                                  bool whole_at_reserve = false);

}  // namespace cris
