"""Image decoding and encoding on the host, without OpenCV or PIL.

``decode_image`` and ``decode_mask`` are the port's ``cv2.imdecode`` with
``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE``: the format is sniffed from the
bytes, an EXIF orientation (a JPEG's APP1, a PNG's eXIf) is applied as
OpenCV applies it, and the output is BGR (gray replicated to 3 channels)
or gray uint8. ``csrc/image_codec.cc`` decodes along the libraries behind
OpenCV (libjpeg-turbo, libpng), so the pixels equal ``cv2.imdecode``'s
bit for bit.

- JPEG: Huffman-coded baseline, extended-sequential and progressive frames
  (SOF0, SOF1, SOF2), 8-bit, 1 or 3 components, 4:4:4, 4:2:2 and 4:2:0
  sampling, restart intervals. Refused with a ``ValueError`` naming the
  marker or the fault: arithmetic-coded, lossless, hierarchical and 12-bit
  frames, CMYK / YCCK and RGB-coded files, a progressive file whose scans
  leave low-frequency coefficients approximate (libjpeg would smooth
  them), corrupt or truncated data.
- PNG: colour types 0, 2, 3, 4 and 6 at every bit depth PNG allows (1, 2,
  4, 8, 16), with or without Adam7 interlace, with or without tRNS: the
  palette expanded, low depths scaled to 8 bits, 16 bits cut to their high
  byte, alpha dropped without compositing, colour turned to gray under
  ``IMREAD_GRAYSCALE`` by libpng's fixed-point weights (and its gamma
  tables when gAMA or sRGB gives a file gamma). The chunk walk drops an
  ancillary chunk with a bad CRC and refuses a critical one, or a critical
  chunk other than IHDR, PLTE, IDAT and IEND. Refused: 16-bit colour read
  as gray under a file gamma.
- Any other format (WebP, BMP, TIFF, JPEG 2000, AVIF, ...) is refused.

``encode_jpeg`` writes baseline JPEG as ``cv2.imencode(".jpg")`` does
with its defaults; ``encode_png`` (filter 0 + ``zlib``) is pure Python.

The C++ library (``csrc/image_codec.cc``, the batched data plane,
``csrc/batch_preprocess.cc``, see ``data/native.py``, and the polygon
fill, ``csrc/rasterize.cc``, see ``data/refer.py``) is built with the
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
SOURCES = (CSRC / "image_codec.cc", CSRC / "batch_preprocess.cc",
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
    """JPEG or PNG bytes -> (H, W, 3) BGR uint8, as ``cv2.imdecode`` with
    ``IMREAD_COLOR`` gives it."""
    return _decode(buf, gray=False)


def decode_mask(buf) -> np.ndarray:
    """JPEG or PNG bytes -> (H, W) uint8, as ``cv2.imdecode`` with
    ``IMREAD_GRAYSCALE`` gives it."""
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
