"""Image decoding and PNG encoding on the host, without OpenCV or PIL.

``decode_image`` and ``decode_mask`` are the port's ``cv2.imdecode`` with
``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE``: the format is sniffed from the
bytes, a JPEG's EXIF orientation is applied as OpenCV applies it, and the
output is BGR (gray replicated to 3 channels) or gray uint8.

- JPEG: baseline and extended-sequential Huffman frames (SOF0/SOF1), 1 or
  3 components, 4:4:4, 4:2:2 and 4:2:0 sampling, restart intervals.
  ``csrc/image_codec.cc`` decodes them along libjpeg-turbo's default path,
  so the pixels equal OpenCV's bit for bit. Anything else (progressive,
  arithmetic-coded, 12-bit, CMYK, corrupt data) raises ``ValueError``
  naming the marker or the fault.
- PNG: 8-bit gray and RGB, not interlaced. ``zlib`` inflates the data
  here, the C++ library undoes the five row filters.

The C++ library is built with the host's C++ compiler at first use (a few
seconds, no torch headers) under ``build/cris_tpu_torch/`` at the
repository root, named by a digest of its source and flags, and loaded
with ``ctypes``. It is written under a temporary name and renamed into
place, so processes that build it at once do not race. If it cannot be
built, decoding raises: there is no other decoder.

``encode_png`` (filter 0 + ``zlib``) is pure Python.
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
SOURCE = PACKAGE_DIR / "csrc" / "image_codec.cc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "cris_tpu_torch"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_JPEG_MAGIC = b"\xff\xd8\xff"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_ERRLEN = 256

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcris_codec_{digest.hexdigest()[:16]}.so"


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) to build the image codec")


def build() -> Path:
    """Compile the codec unless a library for this source exists."""
    target = library_path()
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=target.name + ".", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load_library() -> ctypes.CDLL:
    """The codec's shared library, built on first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            pi, pll = ctypes.POINTER(i), ctypes.POINTER(ll)
            lib.cris_jpeg_info.argtypes = [p, ll, pi, pi, pll, pll, p, i]
            lib.cris_jpeg_decode.argtypes = [p, ll, p, i, p, i]
            lib.cris_png_unfilter.argtypes = [p, ll, i, i, i, p, p, i]
            for fn in (lib.cris_jpeg_info, lib.cris_jpeg_decode,
                       lib.cris_png_unfilter):
                fn.restype = i
            _library = lib
        return _library


def _call(fn, *args) -> None:
    err = ctypes.create_string_buffer(_ERRLEN)
    if fn(*args, err, _ERRLEN) != 0:
        raise ValueError(err.value.decode(errors="replace"))


def exif_orientation(payload: bytes) -> int:
    """The orientation tag (0x0112) of an APP1 payload, read as OpenCV's
    EXIF reader reads it: a TIFF header 6 bytes in, IFD0's entries; 1 when
    there is none or the header is not TIFF."""
    tiff = payload[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack_from(end + "H", tiff, 2)[0] != 42:
        return 1
    ifd = struct.unpack_from(end + "I", tiff, 4)[0]
    if ifd + 2 > len(tiff):
        return 1
    for k in range(struct.unpack_from(end + "H", tiff, ifd)[0]):
        entry = ifd + 2 + 12 * k
        if entry + 12 > len(tiff):
            break
        if struct.unpack_from(end + "H", tiff, entry)[0] == 0x0112:
            return struct.unpack_from(end + "H", tiff, entry + 8)[0]
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ApplyExifOrientation: flips for 2-4, a transpose then flips
    for 5-8, nothing for 1 or an unknown value."""
    if 5 <= orientation <= 8:
        img = img.swapaxes(0, 1)
        orientation = {5: 1, 6: 2, 7: 3, 8: 4}[orientation]
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


def _decode_jpeg(buf: bytes, channels: int) -> np.ndarray:
    lib = load_library()
    h, w = ctypes.c_int(), ctypes.c_int()
    app1_off, app1_len = ctypes.c_longlong(), ctypes.c_longlong()
    _call(lib.cris_jpeg_info, buf, len(buf), ctypes.byref(h), ctypes.byref(w),
          ctypes.byref(app1_off), ctypes.byref(app1_len))
    shape = (h.value, w.value) + ((3,) if channels == 3 else ())
    out = np.empty(shape, np.uint8)
    _call(lib.cris_jpeg_decode, buf, len(buf), out.ctypes.data, channels)
    if app1_off.value >= 0:
        payload = buf[app1_off.value : app1_off.value + app1_len.value]
        out = apply_orientation(out, exif_orientation(payload))
    return out


def _decode_png(buf: bytes, gray: bool) -> np.ndarray:
    """8-bit gray or RGB PNG -> (H, W) gray or (H, W, 3) BGR."""
    pos, header, idat = len(_PNG_MAGIC), None, []
    while True:
        if pos + 12 > len(buf):
            raise ValueError("PNG: truncated data (no IEND chunk)")
        length, kind = struct.unpack_from(">I4s", buf, pos)
        data = buf[pos + 8 : pos + 8 + length]
        if len(data) != length or pos + 12 + length > len(buf):
            raise ValueError(f"PNG {kind!r}: truncated chunk")
        crc = struct.unpack_from(">I", buf, pos + 8 + length)[0]
        pos += 12 + length
        critical = not kind[0] & 0x20
        if zlib.crc32(kind + data) != crc:
            if critical:
                raise ValueError(f"PNG {kind.decode(errors='replace')}: "
                                 "CRC mismatch")
            continue  # libpng drops an ancillary chunk with a bad CRC
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        elif critical:
            raise ValueError(f"PNG {kind.decode(errors='replace')}: chunk "
                             "not supported (palette images are not)")
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, color, method, filt, interlace = header
    if depth != 8 or color not in (0, 2) or interlace or method or filt:
        raise ValueError(f"PNG IHDR: bit depth {depth}, color type {color}, "
                         f"interlace {interlace}: only 8-bit gray or RGB, not "
                         "interlaced, is supported")
    if gray and color == 2:
        raise ValueError("PNG: RGB to grayscale is not supported")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG IDAT: {e}") from None
    bpp = 1 if color == 0 else 3
    out = np.empty((height, width, bpp), np.uint8)
    _call(load_library().cris_png_unfilter, raw, len(raw), height, width, bpp,
          out.ctypes.data)
    if gray:
        return out[:, :, 0]
    if bpp == 1:
        return np.repeat(out, 3, axis=2)
    return np.ascontiguousarray(out[:, :, ::-1])


def _decode(buf, gray: bool) -> np.ndarray:
    buf = bytes(buf)
    if buf.startswith(_JPEG_MAGIC):
        return _decode_jpeg(buf, 1 if gray else 3)
    if buf.startswith(_PNG_MAGIC):
        return _decode_png(buf, gray)
    raise ValueError("not a JPEG or PNG image")


def decode_image(buf) -> np.ndarray:
    """JPEG or PNG bytes -> (H, W, 3) BGR uint8, as ``cv2.imdecode`` with
    ``IMREAD_COLOR`` gives it."""
    return _decode(buf, gray=False)


def decode_mask(buf) -> np.ndarray:
    """JPEG or gray PNG bytes -> (H, W) uint8, as ``cv2.imdecode`` with
    ``IMREAD_GRAYSCALE`` gives it."""
    return _decode(buf, gray=True)


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
