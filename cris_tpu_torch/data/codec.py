"""Image decoding and encoding on the host, without OpenCV or PIL.

``decode_image`` and ``decode_mask`` are the port's ``cv2.imdecode`` with
``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE``: the format is sniffed from the
magic bytes, an orientation (a JPEG's APP1, a PNG's eXIf, a WebP's EXIF
chunk, a TIFF's Orientation tag) is applied as OpenCV applies it, and
the output is BGR (gray replicated to 3 channels) or gray uint8 (a PFM
keeps its own channels under either flag, as cv2 gives it). The C++
decoders follow the libraries and readers behind OpenCV 5.0
(libjpeg-turbo, libpng, libwebp, libtiff 4.7.1, OpenJPEG 2.5.3, OpenCV's
own BMP / PxM / PAM / GIF / Sun raster / HDR / PFM readers), so the
pixels equal ``cv2.imdecode``'s bit for bit.

- JPEG (``csrc/image_codec.cc``): Huffman-coded baseline,
  extended-sequential and progressive frames (SOF0, SOF1, SOF2), 8-bit,
  1, 3 or 4 components, 4:4:4, 4:2:2 and 4:2:0 sampling, restart
  intervals; YCbCr, RGB-coded (Adobe transform 0, or components 'R', 'G',
  'B' with no JFIF marker) and CMYK / YCCK (Adobe transform 0 / 2) as
  libjpeg converts them, then OpenCV's CMYK to BGR and to gray. Refused
  with a ``ValueError`` naming the marker or the fault: arithmetic-coded,
  lossless, hierarchical and 12-bit frames, a progressive file whose scans
  leave low-frequency coefficients approximate (libjpeg would smooth
  them), corrupt or truncated data.
- PNG (``csrc/image_codec.cc``): colour types 0, 2, 3, 4 and 6 at every
  bit depth PNG allows (1, 2, 4, 8, 16), with or without Adam7 interlace,
  with or without tRNS: the palette expanded, low depths scaled to 8
  bits, 16 bits cut to their high byte, alpha dropped without
  compositing, colour turned to gray under ``IMREAD_GRAYSCALE`` by
  libpng's fixed-point weights (and its gamma tables when gAMA or sRGB
  gives a file gamma). The chunk walk drops an ancillary chunk with a bad
  CRC and refuses a critical one, or a critical chunk other than IHDR,
  PLTE, IDAT and IEND. Refused: 16-bit colour read as gray under a file
  gamma.
- WebP (``csrc/webp_decode.cc``): simple and extended (VP8X) RIFF files,
  lossy (VP8 key frames, libwebp's fancy upsampling and fixed-point
  YUV to BGR) and lossless (VP8L), with or without alpha (ALPH checked,
  then dropped); gray is OpenCV 5's ``cvtColor(BGR2GRAY)``. An animated
  file (the VP8X animation flag) gives its first frame as OpenCV 5 takes
  it from WebPAnimDecoder: WebPDemux's checks of every chunk and frame,
  then the frame (ANMF: its offset, an optional ALPH, its VP8 or VP8L)
  decoded as a still and put on a canvas of transparent black (a key
  frame: not blended, ANIM's background colour unused, a transparent
  pixel's colour kept). The lossy inverse DCT is libwebp's SSE2 one,
  which wraps at 16 bits where a damaged stream overflows. Refused:
  files under OpenCV's 32-byte minimum, what WebPDemux refuses (frames
  outside the canvas, ANMF before ANIM, a bad frame header anywhere).
- BMP (``csrc/bmp_pnm_decode.cc``): OS/2 and Windows V3 / V4 / V5
  headers; 1, 4, 8 bits with a palette, RLE4 and RLE8 (OpenCV's reading
  of their escapes), 16 (555 / 565), 24 and 32 bits; bottom-up and
  top-down. Gray as OpenCV's reader computes it.
- PNM / PAM (``csrc/bmp_pnm_decode.cc``): P1-P6 ASCII and binary, any
  maxval (ASCII samples scaled by 255 / maxval, binary ones taken as they
  are, 16-bit ones cut to the high byte); P7 of depth 1 or 3 (GRAYSCALE,
  BLACKANDWHITE, RGB or no TUPLTYPE), OpenCV's bit mode at maxval 1.
  Refused: the *_ALPHA tuple types (OpenCV's reader leaves pixels
  unwritten).
- TIFF (``csrc/tiff_decode.cc``): the first IFD, II or MM, strips or
  tiles, planar configuration 1 or 2; gray (1, 8, 16 bits), RGB (8, 16)
  with extra samples, palette (1, 4, 8), CMYK, YCbCr (libtiff's own
  conversion, or libjpeg's under JPEG); none, LZW, Deflate, PackBits and
  JPEG compression, Predictor 2, FillOrder 2; the Orientation tag. All
  read as OpenCV reads them through libtiff's RGBA interface: 16-bit
  gray by its high byte but 16-bit colour rounded by (v + 128) / 257,
  unassociated alpha premultiplied, a colormap with no entry of 256 or
  more taken as 8-bit, the putters' skew on a clipped tile (gray at 16
  bits or with alpha, and 1- and 4-bit tiles), Predictor 2 on
  subsampled YCbCr over libtiff's row size, each tile mirrored in place
  for orientations 2, 3, 6, 7; gray by the 14-bit weights. Refused,
  naming the kind: CCITT, old-style JPEG, LogLuv, JBIG, LZMA, ZSTD,
  WebP-in-TIFF, BigTIFF, 32-bit or float samples, 2-bit and 4-bit gray,
  2- and 16-bit palettes, CIELab, and what cv2 decodes only into
  a part-filled or zero image (truncated or corrupt LZW).
- GIF (``csrc/gif_ras_decode.cc``): the first image on a canvas of the
  logical screen filled with the background index's colour (which the
  transparent pixels keep), local / global / OpenCV's default colour
  table, interlace, LZW as OpenCV's reader reads it (codes past the end
  code, past the image); gray by ``cvtColor``'s 15-bit weights. Refused:
  files cut anywhere, streams OpenCV refuses.
- Sun raster (``csrc/gif_ras_decode.cc``): RT_OLD and RT_STANDARD at 1,
  8, 24 and 32 bits, with or without a colormap (without one,
  IMREAD_GRAYSCALE of 1 and 8 bits is all zero in OpenCV 5.0). Refused:
  RLE and RT_FORMAT_RGB, which OpenCV 5.0's header check refuses.
- JPEG 2000 (``csrc/jpeg2000_decode.cc``): JP2 files and raw J2K
  codestreams as OpenJPEG 2.5.3 decodes them: the JP2 boxes (ihdr, colr,
  pclr with cmap, cdef, boxes out of place), SIZ with 1-4 components of
  8-16 bits and tiles, COD / COC (all five progression orders, 0-32
  decomposition levels, code-block sizes, precincts, SOP / EPH), QCD /
  QCC (none, scalar derived, scalar expounded), tile-parts, every
  code-block style; tier 2, the MQ coder and tier 1's passes; the 5/3
  wavelet with the RCT in integers and the 9/7 with the ICT in float,
  with OpenJPEG's constants and order of operations; then OpenCV's
  conversion: the largest precision shifted to 8 bits, sRGB or
  unspecified colour as RGB(A) to BGR, greyscale replicated, sYCC by
  ``cvtColor(YUV2BGR)``; gray by ``cvtColor``'s 15-bit weights (sRGB) or
  the first component. Refused, by name: HTJ2K, RGN, POC, PPM / PPT,
  Part 2 wavelets, component transforms and MCT / MCC / MCO / CBD
  markers, and what cv2 refuses (signed or
  subsampled components, under 8 bits, an image offset, CMYK, e-sYCC, a
  cut file, a missing EPH).
- Radiance HDR (``csrc/hdr_pfm_decode.cc``): OpenCV's RGBE reader (its
  header lines, "-Y h +X w" only, flat, new-style RLE and flat after a
  non-RLE scanline, an old-style run read as a pixel), rgbe2float, then
  x 255 in float rounded and saturated to BGR; gray by ``cvtColor``.
- PFM (``csrc/hdr_pfm_decode.cc``): "PF" / "Pf" with atoi / atof header
  numbers, rows bottom-up, the scale's sign as the byte order, samples
  times (float)(1 / |scale|), rounded and saturated (no x 255).
- Any other format (AVIF, ...) is refused with a message naming what the
  first bytes say it is.

``encode_jpeg`` writes baseline JPEG as ``cv2.imencode(".jpg")`` does
with its defaults; ``encode_png`` (filter 0 + ``zlib``) is pure Python.

The C++ library (the decoders above and the JPEG encoder, the batched
data plane, ``csrc/batch_preprocess.cc``, see ``data/native.py``, and the
polygon fill, ``csrc/rasterize.cc``, see ``data/refer.py``) is built with the
host's C++ compiler at first use (a few seconds, no torch headers) under
``build/cris_tpu_torch/`` at the repository root, named by a digest of its
sources and flags, and loaded with ``ctypes``. It is written under a
temporary name and renamed into place, so processes that build it at once
do not race. If it cannot be built, decoding raises: there is no other
decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
SOURCES = (CSRC / "image_codec.cc", CSRC / "webp_decode.cc",
           CSRC / "bmp_pnm_decode.cc", CSRC / "tiff_decode.cc",
           CSRC / "gif_ras_decode.cc", CSRC / "hdr_pfm_decode.cc",
           CSRC / "jpeg2000_decode.cc", CSRC / "batch_preprocess.cc",
           CSRC / "rasterize.cc")
HEADERS = (CSRC / "image_codec.h",)
BUILD_DIR = PACKAGE_DIR.parent / "build" / "cris_tpu_torch"
# -ffp-contract=off: the data plane's warps must round as numpy does, so
# no multiply-add may be fused (and no -ffast-math, no -march=native)
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off",
             "-pthread"]

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_ERRLEN = 512

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in SOURCES + HEADERS:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libcris_data_{digest.hexdigest()[:16]}.so"


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) to build the image codec")


def build() -> Path:
    """Compile the library unless one for these sources exists."""
    target = library_path()
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=target.name + ".", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_compiler(), *CXX_FLAGS, "-o", tmp, *map(str, SOURCES)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {', '.join(s.name for s in SOURCES)}"
                               f" failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load_library() -> ctypes.CDLL:
    """The data library, built on first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            pi, pll, pp = (ctypes.POINTER(i), ctypes.POINTER(ll),
                           ctypes.POINTER(p))
            lib.cris_decode.argtypes = [p, ll, i, pp, pi, pi, pi, p, i]
            lib.cris_jpeg_encode.argtypes = [p, i, i, i, i, pp, pll, p, i]
            lib.cris_zlib_inflate.argtypes = [p, ll, pp, pll, p, i]
            ptrs = ctypes.POINTER(ctypes.c_char_p)
            sz = ctypes.POINTER(ctypes.c_size_t)
            lib.cris_batch_preprocess.argtypes = [ptrs, sz, ptrs, sz, i, i, i,
                                                  p, p, p, p, p, i]
            lib.cris_fill_polygons.argtypes = [p, p, i, i, i, p, p, i]
            for fn in (lib.cris_decode, lib.cris_jpeg_encode,
                       lib.cris_zlib_inflate, lib.cris_batch_preprocess,
                       lib.cris_fill_polygons, lib.cris_data_abi_version):
                fn.restype = i
            lib.cris_data_abi_version.argtypes = []
            lib.cris_free.argtypes = [p]
            lib.cris_free.restype = None
            _library = lib
        return _library


def _call(fn, *args) -> None:
    err = ctypes.create_string_buffer(_ERRLEN)
    if fn(*args, err, _ERRLEN) != 0:
        raise ValueError(err.value.decode(errors="replace"))


def _take(lib, ptr: ctypes.c_void_p, out: np.ndarray) -> np.ndarray:
    """``out`` filled from the library's malloc'd output, which is freed."""
    try:
        ctypes.memmove(out.ctypes.data, ptr, out.nbytes)
    finally:
        lib.cris_free(ptr)
    return out


def _decode(buf, gray: bool) -> np.ndarray:
    buf = bytes(buf)
    lib = load_library()
    ptr = ctypes.c_void_p()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _call(lib.cris_decode, buf, len(buf), int(gray), ctypes.byref(ptr),
          ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    shape = (h.value, w.value) + ((3,) if c.value == 3 else ())
    return _take(lib, ptr, np.empty(shape, np.uint8))


def decode_image(buf) -> np.ndarray:
    """Image bytes (JPEG, PNG, WebP, BMP, PNM / PAM, TIFF, GIF, Sun raster,
    JPEG 2000, Radiance HDR, PFM) -> (H, W, 3) BGR uint8, as
    ``cv2.imdecode`` with ``IMREAD_COLOR`` gives it (a gray "Pf" PFM stays
    (H, W), as there)."""
    return _decode(buf, gray=False)


def decode_mask(buf) -> np.ndarray:
    """Image bytes (JPEG, PNG, WebP, BMP, PNM / PAM, TIFF, GIF, Sun raster,
    JPEG 2000, Radiance HDR, PFM) -> (H, W) uint8, as ``cv2.imdecode``
    with ``IMREAD_GRAYSCALE`` gives it (a colour "PF" PFM stays (H, W, 3),
    as there)."""
    return _decode(buf, gray=True)


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) BGR or (H, W) gray uint8 -> baseline JPEG bytes, as
    ``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])`` writes
    them (JFIF, IJG quality tables, 4:2:0 for color, standard Huffman
    tables); ``cv2.imwrite``'s default quality is 95."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or
                                     (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    lib = load_library()
    ptr, size = ctypes.c_void_p(), ctypes.c_longlong()
    _call(lib.cris_jpeg_encode, img.ctypes.data, img.shape[0], img.shape[1],
          1 if img.ndim == 2 else 3, int(quality), ctypes.byref(ptr),
          ctypes.byref(size))
    return _take(lib, ptr, np.empty(size.value, np.uint8)).tobytes()


def read_mask(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_GRAYSCALE)`` of a mask file."""
    with open(path, "rb") as f:
        return decode_mask(f.read())


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 -> PNG bytes (every row filter 0,
    ``zlib`` at ``level``)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or
                                     (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if img.ndim == 3 else 0, 0, 0, 0)
    return (_PNG_MAGIC + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _png_chunk(b"IEND", b""))
