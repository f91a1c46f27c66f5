"""The port's decoder on the formats the JAX front reads through OpenCV
besides JPEG and PNG, held bit for bit against cv2.imdecode under
IMREAD_COLOR and IMREAD_GRAYSCALE, through ``decode_image`` /
``decode_mask`` and through the batch plane (``_assert_as_cv2``):

- WebP, lossy: cv2 at qualities 1, 50, 90 and 100 at odd sizes, 1 x 1 and
  640 x 480; PIL at methods 0 and 6, with alpha (ALPH, VP8L-coded);
  libwebp itself (the library PIL ships, through ctypes) for what neither
  writer exposes: the simple loop filter, sharpness, 2 to 8 token
  partitions, one or two segments, a raw alpha plane.
- WebP, lossless (VP8L): cv2 at quality 101; PIL at methods 0 and 6 and
  quality 0 and 100, with and without alpha, palette, gray and few-colour
  images (colour indexing with 1, 2 and 4 bits a pixel bundled).
- WebP's EXIF orientation (VP8X flag and EXIF chunk), every value.
- BMP: cv2 (colour and gray) and PIL (modes 1, P, L, RGB, RGBA); built
  byte by byte: 1, 4 and 8 bits through the palette, bottom-up and
  top-down, short palettes, OS/2 and V5 headers, RLE4 and RLE8 with
  runs, absolute runs, end of line, end of bitmap and delta escapes, 16
  bits (555 BI_RGB, 555 and 565 BI_BITFIELDS), 24 and 32 bits, 32-bit
  BI_BITFIELDS with V4 masks.
- PNM / PAM: cv2's PPM, PGM, PBM (binary and ASCII) and PAM; PIL's; built:
  P1 spaced and packed, P2 / P3 / P5 / P6 at maxval 7, 100, 255, 1000 and
  65535 with comments, P4, P7 GRAYSCALE / RGB / BLACKANDWHITE / none at 8
  and 16 bits and OpenCV's bit mode (maxval 1).
- JPEG: CMYK (PIL, Adobe transform 0), YCCK (the same bitstream with the
  Adobe transform set to 2, as no writer here makes one), CMYK with no
  Adobe marker, RGB-coded (PIL keep_rgb), baseline and progressive.

And the kinds that stay refused, each with a message that names it.
"""

import ctypes
import glob
import io
import os
import struct

import cv2
import numpy as np
import PIL
import pytest
from PIL import Image

from cris_tpu_torch.data import batch_preprocess, decode_image, decode_mask
from test_torch_codec_formats import SIZE, _assert_as_cv2, _photo


def _encode(ext, img, *params):
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok
    return buf.tobytes()


def _pil(arr, fmt, mode=None, **kw):
    im = Image.fromarray(np.ascontiguousarray(arr))
    if mode:
        im = im.convert(mode)
    out = io.BytesIO()
    im.save(out, fmt, **kw)
    return out.getvalue()


def _rgba(h, w, seed):
    rgb = _photo(h, w, seed)[:, :, ::-1]
    alpha = (np.arange(h * w).reshape(h, w) * 7 % 256).astype(np.uint8)
    return np.dstack([rgb, alpha])


def _few_colours(n, h=33, w=47):
    rng = np.random.RandomState(n)
    palette = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    return palette[rng.randint(0, n, (h, w))]


# ---------------------------------------------------------------- WebP

# libwebp's advanced encoder through ctypes, for the options that cv2 and
# PIL do not expose (WebPConfig and WebPPicture as encode.h declares them)
_CONFIG = ["lossless", "quality", "method", "image_hint", "target_size",
           "target_PSNR", "segments", "sns_strength", "filter_strength",
           "filter_sharpness", "filter_type", "autofilter",
           "alpha_compression", "alpha_filtering", "alpha_quality", "pass_",
           "show_compressed", "preprocessing", "partitions",
           "partition_limit", "emulate_jpeg_size", "thread_level",
           "low_memory", "near_lossless", "exact", "use_delta_palette",
           "use_sharp_yuv", "qmin", "qmax"]


class _Config(ctypes.Structure):
    _fields_ = [(f, ctypes.c_float if f in ("quality", "target_PSNR")
                 else ctypes.c_int) for f in _CONFIG] + [
                     ("pad", ctypes.c_uint32 * 8)]


class _Picture(ctypes.Structure):
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    _fields_ = [("use_argb", i), ("colorspace", i), ("width", i),
                ("height", i), ("y", p), ("u", p), ("v", p), ("y_stride", i),
                ("uv_stride", i), ("a", p), ("a_stride", i), ("pad1", u * 2),
                ("argb", p), ("argb_stride", i), ("pad2", u * 3),
                ("writer", p), ("custom_ptr", p), ("extra_info_type", i),
                ("extra_info", p), ("stats", p), ("error_code", i),
                ("progress_hook", p), ("user_data", p), ("pad3", u * 3),
                ("pad4", p), ("pad5", p), ("pad6", u * 8), ("memory_", p),
                ("memory_argb_", p), ("pad7", p * 2)]


_WRITER = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
                           ctypes.c_void_p)


def _libwebp():
    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    for dep in sorted(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(sorted(glob.glob(os.path.join(libs, "libwebp-*.so*")))[0])


def _libwebp_encode(pixels, quality=75.0, **options):
    """RGB or RGBA uint8 -> a WebP file written by libwebp's WebPEncode
    with the given WebPConfig fields."""
    lib = _libwebp()
    abi = 0x020F  # the encoder ABI's major byte is what libwebp checks
    cfg = _Config()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                      ctypes.c_float(quality), abi)
    for k, v in options.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), options
    pic = _Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), abi)
    h, w, c = pixels.shape
    pic.width, pic.height, pic.use_argb = w, h, cfg.lossless
    pixels = np.ascontiguousarray(pixels)
    load = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert load(ctypes.byref(pic), pixels.ctypes.data_as(ctypes.c_void_p), w * c)
    out = bytearray()

    @_WRITER
    def write(data, size, _):
        out.extend(ctypes.string_at(data, size))
        return 1

    pic.writer = ctypes.cast(write, ctypes.c_void_p)
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    lib.WebPPictureFree(ctypes.byref(pic))
    assert ok, pic.error_code
    return bytes(out)


@pytest.mark.parametrize("hw", [(1, 1), (17, 33), (37, 53)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("quality", [1, 50, 90, 100, 101])
def test_cv2_written_webp_equals_cv2(quality, hw):
    """cv2's WebP writer: lossy at quality 1-100, lossless at 101."""
    img = _photo(*hw, seed=hw[0] * 3 + quality)
    _assert_as_cv2(_encode(".webp", img, cv2.IMWRITE_WEBP_QUALITY, quality))


@pytest.mark.parametrize("quality", [90, 101], ids=["lossy", "lossless"])
def test_webp_640x480_equals_cv2(quality):
    img = _photo(480, 640, seed=5)
    _assert_as_cv2(_encode(".webp", img, cv2.IMWRITE_WEBP_QUALITY, quality))


PIL_WEBP = {
    "lossy m0": dict(quality=50, method=0),
    "lossy m6": dict(quality=90, method=6),
    "lossy q5": dict(quality=5, method=3),
    "lossless m0": dict(lossless=True, method=0),
    "lossless m6": dict(lossless=True, method=6),
    "lossless q0": dict(lossless=True, quality=0),
    "lossless q100 m6": dict(lossless=True, quality=100, method=6),
}


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L", "LA"])
@pytest.mark.parametrize("options", sorted(PIL_WEBP))
def test_pil_written_webp_equals_cv2(options, mode):
    """PIL's writer (libwebp): RGBA adds alpha (ALPH for lossy), P, L and
    LA go through PIL's conversions first."""
    pixels = _rgba(37, 53, seed=len(options))
    if mode in ("RGB", "P", "L"):
        pixels = pixels[:, :, :3]
    _assert_as_cv2(_pil(pixels, "WEBP", None if mode == "RGBA" else mode,
                        **PIL_WEBP[options]))


@pytest.mark.parametrize("method", [0, 6])
@pytest.mark.parametrize("colours", [2, 3, 5, 16, 17, 200])
def test_few_colour_lossless_webp_equals_cv2(colours, method):
    """Colour indexing: 8, 4, 2 and 1 bits a pixel (256 / 16 / 4 / 2
    colours), bundled into the green of the packed image."""
    _assert_as_cv2(_pil(_few_colours(colours), "WEBP", lossless=True,
                        method=method))


LIBWEBP = {
    "simple filter": dict(filter_type=0, filter_strength=60),
    "simple filter, sharpness 7": dict(filter_type=0, filter_strength=100,
                                       filter_sharpness=7),
    "normal filter, sharpness 3": dict(filter_type=1, filter_strength=100,
                                       filter_sharpness=3),
    "no filter": dict(filter_strength=0),
    "8 partitions": dict(partitions=3),
    "4 partitions, 1 segment": dict(partitions=2, segments=1),
    "2 segments": dict(segments=2, sns_strength=100),
    "q10 simple autofilter": dict(quality=10, filter_type=0, autofilter=1),
    "q100 m6": dict(quality=100, method=6, partitions=1),
    "raw alpha": dict(alpha_compression=0),
    "sharp yuv": dict(quality=70, use_sharp_yuv=1),
    "mixed": dict(quality=60, filter_type=1, filter_sharpness=5,
                  partitions=3, segments=3),
}


@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "rgba"])
@pytest.mark.parametrize("options", sorted(LIBWEBP))
def test_libwebp_options_equal_cv2(options, alpha):
    """Lossy files from libwebp's own encoder with the loop filter, token
    partitions, segments and alpha coding cv2 and PIL do not expose."""
    pixels = _rgba(67, 93, seed=len(options))
    if not alpha:
        pixels = pixels[:, :, :3]
    _assert_as_cv2(_libwebp_encode(pixels, **LIBWEBP[options]))


@pytest.mark.parametrize("lossless", [False, True], ids=["lossy", "lossless"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_webp_exif_orientation_equals_cv2(orientation, lossless):
    """OpenCV applies the EXIF chunk's orientation (VP8X EXIF flag)."""
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = _pil(_photo(20, 30, seed=3)[:, :, ::-1], "WEBP",
               exif=exif.tobytes(), lossless=lossless)
    _assert_as_cv2(buf)


# ----------------------------------------------------------------- BMP

def _bmp(width, height, bpp, pixels, palette=None, compression=0, hsize=40,
         extra=b"", clrused=None, top_down=False, os2=False):
    """A BMP file: BITMAPFILEHEADER, the info (or OS/2 core) header, extra
    header bytes (masks), the palette, the pixel data."""
    if os2:
        info = struct.pack("<IHHHH", 12, width, height, 1, bpp)
        pal = b"".join(bytes(c) for c in (palette or []))
    else:
        used = len(palette) if palette is not None and clrused is None else (clrused or 0)
        info = struct.pack("<IiiHHIIiiII", hsize, width,
                           -height if top_down else height, 1, bpp,
                           compression, len(pixels), 2835, 2835, used, 0)
        info += extra.ljust(hsize - 40, b"\0") if hsize > 40 else extra
        pal = b"".join(bytes(c) + b"\0" for c in (palette or []))
    offset = 14 + len(info) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
    return head + info + pal + pixels


def _rows(indices, bpp):
    """Palette indices, packed and padded to 4 bytes a row."""
    out = b""
    for r in indices:
        r = [int(v) for v in r]
        if bpp == 8:
            b = bytes(r)
        elif bpp == 4:
            b = bytes((r[i] << 4) | (r[i + 1] if i + 1 < len(r) else 0)
                      for i in range(0, len(r), 2))
        else:
            b = np.packbits(np.array(r, np.uint8)).tobytes()
        out += b + b"\0" * (-len(b) % 4)
    return out


def _padded(px, w, bytes_per_pixel):
    return b"".join(r.tobytes() + b"\0" * (-bytes_per_pixel * w % 4) for r in px)


def _rle8(indices):
    """RLE8 rows: encoded runs, absolute runs, an end of line each row,
    an end of bitmap."""
    out = bytearray()
    for r in indices:
        r = [int(v) for v in r]
        i = 0
        while i < len(r):
            j = i
            while j < len(r) and r[j] == r[i] and j - i < 255:
                j += 1
            if j - i >= 2 or len(r) - i < 3:
                out += bytes([j - i, r[i]])
                i = j
            else:
                seg = r[i:i + max(3, min(len(r) - i, 255))]
                out += bytes([0, len(seg)]) + bytes(seg) + b"\0" * (len(seg) % 2)
                i += len(seg)
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _rle4(indices):
    """RLE4 rows: two-colour encoded runs and absolute runs."""
    out = bytearray()
    for r in indices:
        r = [int(v) for v in r]
        i = 0
        while i < len(r):
            if len(r) - i >= 4 and i % 5 == 0:
                seg = r[i:i + 20]
                packed = bytes((seg[t] << 4) | (seg[t + 1] if t + 1 < len(seg) else 0)
                               for t in range(0, len(seg), 2))
                out += bytes([0, len(seg)]) + packed + b"\0" * (len(packed) % 2)
                i += len(seg)
            else:
                k = 2 if i + 1 < len(r) else 1
                out += bytes([k, (r[i] << 4) | (r[i + 1] if k == 2 else 0)])
                i += k
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _palette(n, seed=0):
    rng = np.random.RandomState(seed)
    return [tuple(int(v) for v in rng.randint(0, 256, 3)) for _ in range(n)]


def _bmp_cases():
    h, w = 17, 33
    rng = np.random.RandomState(0)
    pal = _palette(256)
    cases = {}
    for bpp in (1, 4, 8):
        idx = rng.randint(0, 1 << bpp, (h, w))
        p = pal[:1 << bpp]
        cases[f"{bpp}-bit"] = lambda idx=idx, p=p, bpp=bpp: _bmp(w, h, bpp, _rows(idx, bpp), p)
        cases[f"{bpp}-bit top-down"] = lambda idx=idx, p=p, bpp=bpp: _bmp(
            w, h, bpp, _rows(idx, bpp), p, top_down=True)
        cases[f"{bpp}-bit short palette"] = lambda idx=idx, bpp=bpp: _bmp(
            w, h, bpp, _rows(np.minimum(idx, 2), bpp), pal[:3])
        cases[f"{bpp}-bit OS/2"] = lambda idx=idx, p=p, bpp=bpp: _bmp(
            w, h, bpp, _rows(idx, bpp), p, os2=True)
        cases[f"{bpp}-bit V5"] = lambda idx=idx, p=p, bpp=bpp: _bmp(
            w, h, bpp, _rows(idx, bpp), p, hsize=124)
    gray = [(v, v, v) for v in range(256)]
    idx8 = rng.randint(0, 256, (h, w))
    cases["8-bit gray palette"] = lambda: _bmp(w, h, 8, _rows(idx8, 8), gray)
    runs = rng.randint(0, 256, (h, w))
    runs[:, : w // 2] = runs[:, :1]
    cases["rle8"] = lambda: _bmp(w, h, 8, _rle8(runs), pal, compression=1)
    idx4 = rng.randint(0, 16, (h, w))
    cases["rle4"] = lambda: _bmp(w, h, 4, _rle4(idx4), pal[:16], compression=2)
    # 10 x 6 streams with the escapes: OpenCV's RLE8 reads a delta as a run
    # of entry 0 in raster order and fills the rest at an end of bitmap;
    # its RLE4 ends the row at an end of bitmap and drops a delta's dy
    esc8 = bytes([3, 5, 0, 2, 2, 1, 4, 7, 0, 0, 0, 4, 1, 2, 3, 4, 6, 9, 0, 0,
                  10, 8, 0, 0, 0, 1])
    cases["rle8 escapes"] = lambda: _bmp(10, 6, 8, esc8, pal, compression=1)
    full8 = bytes([10, 5, 0, 0, 0, 10] + list(range(10)) + [0, 0, 2, 3, 0, 1])
    cases["rle8 full rows then eol"] = lambda: _bmp(10, 6, 8, full8, pal, compression=1)
    esc4 = bytes([2, 0x12, 0, 2, 3, 1, 2, 0x34, 0, 0, 10, 0x56, 0, 1,
                  0, 5, 0x12, 0x34, 0x50, 0, 0, 0, 10, 0x78, 0, 0,
                  4, 0x9a, 0, 0, 10, 0xbc, 0, 0])
    cases["rle4 escapes"] = lambda: _bmp(10, 6, 4, esc4, pal[:16], compression=2)
    px16 = rng.randint(0, 65536, (h, w)).astype("<u2")
    raw16 = _padded(px16, w, 2)
    cases["16-bit 555"] = lambda: _bmp(w, h, 16, raw16)
    cases["16-bit bitfields 555"] = lambda: _bmp(
        w, h, 16, raw16, compression=3, extra=struct.pack("<III", 0x7C00, 0x3E0, 0x1F))
    cases["16-bit bitfields 565"] = lambda: _bmp(
        w, h, 16, raw16, compression=3, extra=struct.pack("<III", 0xF800, 0x7E0, 0x1F))
    px24 = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    cases["24-bit top-down"] = lambda: _bmp(w, h, 24, _padded(px24, w, 3), top_down=True)
    cases["24-bit OS/2"] = lambda: _bmp(w, h, 24, _padded(px24, w, 3), os2=True)
    px32 = rng.randint(0, 256, (h, w, 4)).astype(np.uint8).tobytes()
    cases["32-bit"] = lambda: _bmp(w, h, 32, px32)
    cases["32-bit bitfields, no masks read"] = lambda: _bmp(w, h, 32, px32, compression=3)
    for name, masks in (("BGRA", (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
                        ("RGBA", (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
                        ("ARGB", (0xFF000000, 0xFF0000, 0xFF00, 0xFF))):
        cases[f"32-bit bitfields V4 {name}"] = lambda m=masks: _bmp(
            w, h, 32, px32, compression=3, hsize=108, extra=struct.pack("<IIII", *m))
    return cases


BMP_CASES = _bmp_cases()


@pytest.mark.parametrize("case", sorted(BMP_CASES))
def test_built_bmp_equals_cv2(case):
    _assert_as_cv2(BMP_CASES[case]())


@pytest.mark.parametrize("source", ["cv2 colour", "cv2 gray", "cv2 640x480",
                                    "PIL 1", "PIL P", "PIL L", "PIL RGB",
                                    "PIL RGBA"])
def test_written_bmp_equals_cv2(source):
    img = _photo(37, 53, seed=9)
    if source == "cv2 colour":
        buf = _encode(".bmp", img)
    elif source == "cv2 gray":
        buf = _encode(".bmp", img[:, :, 0])
    elif source == "cv2 640x480":
        buf = _encode(".bmp", _photo(480, 640, seed=4))
    elif source == "PIL RGBA":
        buf = _pil(_rgba(37, 53, seed=9), "BMP")
    else:
        buf = _pil(img[:, :, ::-1], "BMP", source.split()[1])
    _assert_as_cv2(buf)


# ------------------------------------------------------------ PNM / PAM

def _pnm(kind, samples, maxval, comment=True):
    h, w = samples.shape[:2]
    head = f"P{kind}\n" + ("# a comment\n" if comment else "") + f"{w} {h}\n"
    if kind not in (1, 4):
        head += f"{maxval}\n"
    if kind in (1, 2, 3):
        body = "\n".join(" ".join(map(str, r)) for r in samples.reshape(h, -1)) + "\n"
        return head.encode() + body.encode()
    if kind == 4:
        return head.encode() + np.packbits(samples.astype(np.uint8), axis=1).tobytes()
    return head.encode() + samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def _pam(samples, maxval, tupltype):
    h, w, depth = samples.shape
    head = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n"
            + (f"TUPLTYPE {tupltype}\n" if tupltype else "") + "ENDHDR\n")
    return head.encode() + samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()


@pytest.mark.parametrize("maxval", [7, 100, 255, 1000, 65535])
@pytest.mark.parametrize("kind", [2, 3, 5, 6])
def test_built_pnm_equals_cv2(kind, maxval):
    """ASCII samples scale by 255 / maxval, binary ones do not; 16-bit ones
    keep their high byte."""
    rng = np.random.RandomState(kind * maxval)
    samples = rng.randint(0, maxval + 1, (17, 33, 3 if kind in (3, 6) else 1))
    _assert_as_cv2(_pnm(kind, samples, maxval))


@pytest.mark.parametrize("case", ["P1 spaced", "P1 packed", "P4", "P2 clamped",
                                  "P6 1x1"])
def test_built_bilevel_and_edge_pnm_equals_cv2(case):
    bits = np.random.RandomState(1).randint(0, 2, (17, 33))
    if case == "P1 spaced":
        buf = _pnm(1, bits, 1)
    elif case == "P1 packed":
        buf = b"P1\n33 17\n" + "".join(map(str, bits.ravel())).encode()
    elif case == "P4":
        buf = _pnm(4, bits, 1)
    elif case == "P2 clamped":  # samples over maxval read as maxval
        buf = b"P2 3 1 10 15 3 10\n"
    else:
        buf = b"P6 1 1 255\n\x10\x80\xf0"
    _assert_as_cv2(buf)


PAM_CASES = {
    "GRAYSCALE": (1, 255, "GRAYSCALE"), "RGB": (3, 255, "RGB"),
    "depth 1, no tuple type": (1, 255, None), "depth 3, no tuple type": (3, 255, None),
    "BLACKANDWHITE, bit mode": (1, 1, "BLACKANDWHITE"),
    "BLACKANDWHITE, maxval 255": (1, 255, "BLACKANDWHITE"),
    "GRAYSCALE, bit mode": (1, 1, "GRAYSCALE"), "RGB, bit mode": (3, 1, "RGB"),
    "GRAYSCALE 16-bit": (1, 65535, "GRAYSCALE"), "RGB 16-bit": (3, 1000, "RGB"),
    "RGB maxval 100": (3, 100, "RGB"),
}


@pytest.mark.parametrize("case", sorted(PAM_CASES))
def test_built_pam_equals_cv2(case):
    """OpenCV reads a 3-channel PAM in file order, turns it to gray as RGB,
    and in bit mode (maxval 1) reads each row's first bytes as bits."""
    depth, maxval, tupl = PAM_CASES[case]
    samples = np.random.RandomState(depth + maxval).randint(0, maxval + 1, (17, 33, depth))
    _assert_as_cv2(_pam(samples, maxval, tupl))


@pytest.mark.parametrize("source", ["cv2 ppm", "cv2 pgm", "cv2 pbm",
                                    "cv2 pam colour", "cv2 pam gray",
                                    "cv2 ascii ppm", "cv2 ascii pgm",
                                    "cv2 ascii pbm", "cv2 ppm 640x480",
                                    "PIL RGB", "PIL L", "PIL 1"])
def test_written_pnm_equals_cv2(source):
    img = _photo(37, 53, seed=2)
    if source.startswith("PIL"):
        buf = _pil(img[:, :, ::-1], "PPM", source.split()[1])
    elif source == "cv2 ppm 640x480":
        buf = _encode(".ppm", _photo(480, 640, seed=6))
    else:
        words = source.split()
        ext = "." + words[-1] if words[-1] != "colour" and words[-1] != "gray" else ".pam"
        src = img if words[-1] in ("ppm", "colour") else img[:, :, 0]
        params = (cv2.IMWRITE_PXM_BINARY, 0) if "ascii" in words else ()
        buf = _encode(ext, src, *params)
    _assert_as_cv2(buf)


# -------------------------------------------------- CMYK / YCCK / RGB JPEG

def _adobe_transform(buf, transform):
    """buf with its APP14 Adobe transform byte set (None: the segment cut)."""
    at = buf.index(b"Adobe") - 4
    if transform is None:
        length = struct.unpack_from(">H", buf, at + 2)[0]
        return buf[:at] + buf[at + 2 + length:]
    b = bytearray(buf)
    b[at + 4 + 11] = transform
    return bytes(b)


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (37, 53)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("kind", ["cmyk", "ycck", "cmyk, no Adobe marker",
                                  "Adobe transform 1 (read as ycck)", "rgb"])
def test_cmyk_ycck_and_rgb_jpeg_equal_cv2(kind, progressive, hw):
    """libjpeg's CMYK / YCCK (-> CMYK) output and OpenCV's CMYK to BGR and
    to gray; an RGB-coded file with no colour transform."""
    img = _photo(*hw, seed=hw[0] + progressive)
    if kind == "rgb":
        buf = _pil(img[:, :, ::-1], "JPEG", quality=90, keep_rgb=True,
                   progressive=progressive)
    else:
        k = np.random.RandomState(hw[1]).randint(0, 256, hw).astype(np.uint8)
        cmyk = Image.fromarray(np.dstack([img, k]), "CMYK")
        out = io.BytesIO()
        cmyk.save(out, "JPEG", quality=90, progressive=progressive)
        buf = out.getvalue()
        transform = {"cmyk": 0, "ycck": 2, "cmyk, no Adobe marker": None,
                     "Adobe transform 1 (read as ycck)": 1}[kind]
        buf = _adobe_transform(buf, transform)
    _assert_as_cv2(buf)


def test_cmyk_jpeg_640x480_with_exif_orientation_equals_cv2():
    img = _photo(480, 640, seed=8)
    exif = Image.Exif()
    exif[0x0112] = 6
    k = np.full((480, 640), 40, np.uint8)
    out = io.BytesIO()
    Image.fromarray(np.dstack([img, k]), "CMYK").save(out, "JPEG", quality=90,
                                                      exif=exif.tobytes())
    _assert_as_cv2(out.getvalue())


# ------------------------------------------------------------- refusals

def _animated_webp():
    """An animated WebP whose ANIM chunk is cut out: animated files decode
    now, but WebPDemux (and so cv2) refuses frames that no ANIM precedes."""
    frames = [Image.fromarray(_photo(16, 16, seed=s)) for s in range(2)]
    out = io.BytesIO()
    frames[0].save(out, "WEBP", save_all=True, append_images=frames[1:],
                   duration=50, lossless=True)
    buf = out.getvalue()
    at = buf.index(b"ANIM")
    buf = bytearray(buf[:at] + buf[at + 14:])
    struct.pack_into("<I", buf, 4, len(buf) - 8)
    assert cv2.imdecode(np.frombuffer(bytes(buf), np.uint8), cv2.IMREAD_COLOR) is None
    return bytes(buf)


REFUSED = {
    "animated webp": (_animated_webp, "animated WebP"),
    # TIFF and GIF decode now; what stays refused of them keeps these names
    "tiff": (lambda: _encode(".tiff", _photo(16, 16, seed=1).astype(np.float32)),
             "TIFF: 32-bit samples"),
    "gif": (lambda: _pil(_photo(16, 16, seed=1), "GIF")[:-1], "GIF: unexpected end of data"),
    "pam RGB_ALPHA": (lambda: _pam(np.zeros((4, 4, 4), np.uint8), 255, "RGB_ALPHA"),
                      "TUPLTYPE RGB_ALPHA is not supported"),
    "pam GRAYSCALE_ALPHA": (lambda: _pam(np.zeros((4, 4, 2), np.uint8), 255,
                                         "GRAYSCALE_ALPHA"),
                            "TUPLTYPE GRAYSCALE_ALPHA is not supported"),
    "bmp BI_JPEG": (lambda: _bmp(4, 4, 24, b"\0" * 48, compression=4),
                    "compression 4 is not supported"),
    "bmp 16-bit 444 masks": (lambda: _bmp(4, 4, 16, b"\0" * 32, compression=3,
                                          extra=struct.pack("<III", 0xF00, 0xF0, 0xF)),
                             "masks other than 555 and 565"),
    "bmp rle8 run past the row": (lambda: _bmp(10, 2, 8, bytes([12, 1, 0, 1]),
                                               _palette(256), compression=1),
                                  "RLE run beyond the row"),
    "truncated ppm": (lambda: _encode(".ppm", _photo(8, 8, seed=1))[:-5],
                      "PNM: unexpected end of data"),
    "webp cut in the bitstream": (lambda: _encode(".webp", _photo(32, 32, seed=1),
                                                  cv2.IMWRITE_WEBP_QUALITY, 80)[:-40],
                                  "WebP: truncated RIFF data"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_formats_raise_naming_what_they_are(case):
    """Each raises ValueError naming it, under both flags and in the plane."""
    make, words = REFUSED[case]
    buf = make()
    with pytest.raises(ValueError, match=words):
        decode_image(buf)
    with pytest.raises(ValueError, match=words):
        decode_mask(buf)
    with pytest.raises(ValueError, match=f"sample 0: .*{words}"):
        batch_preprocess([buf], [buf], SIZE, nthreads=1)
