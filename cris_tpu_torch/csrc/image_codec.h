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

// cv2.imdecode of JPEG or PNG bytes: with gray false as IMREAD_COLOR (BGR,
// a gray image replicated to 3 channels), with gray true as
// IMREAD_GRAYSCALE (1 channel). A JPEG's EXIF orientation is applied.
// Throws Fault (or std::bad_alloc).
Image decode(const uint8_t* data, size_t size, bool gray);

// A zlib stream (RFC 1950 around RFC 1951 deflate data), inflated; the
// Adler-32 checksum is checked, bytes after it are ignored. reserve is the
// expected output size, 0 when unknown. Throws Fault.
std::vector<uint8_t> zlib_inflate(const uint8_t* data, size_t size,
                                  size_t reserve);

}  // namespace cris
