"""The port's decoder on what cv2.imdecode decodes for the HTTP front and
the data plane: progressive JPEG and every PNG colour type, bit depth and
interlace, held bit for bit against cv2.imdecode under IMREAD_COLOR and
IMREAD_GRAYSCALE, through ``decode_image`` / ``decode_mask`` and through
the batch plane (``batch_preprocess`` against the per-sample warps of
cv2's pixels); and the kinds that stay refused, each with a message that
names it.

- Progressive JPEG: gray, 4:4:4, 4:2:2 and 4:2:0; 1 x 1, 17 x 33, 37 x 53
  and 640 x 480; with and without a restart interval; written by cv2 and
  by PIL (libjpeg's default script: successive approximation, a DHT before
  every scan); PIL's optimised tables; every EXIF orientation.
- PNG: every legal (colour type, bit depth) pair, with and without Adam7,
  with and without tRNS, rows under all five filters, written by
  ``_png`` below; palettes with indices past PLTE's end; gAMA and sRGB
  (libpng's gamma tables for colour to gray); eXIf orientations.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from cris_tpu_torch.data import batch_preprocess, decode_image, decode_mask
from cris_tpu_torch.data.transforms import (get_transform_mats,
                                            normalize_image, warp_image,
                                            warp_mask)

SIZE = 48  # the plane's input size in these checks


def _photo(h, w, seed, channels=3):
    """A seeded photo-like uint8 image: smooth fields plus noise."""
    rng = np.random.RandomState(seed)
    small = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, channels))
    big = cv2.resize(small.astype(np.float32), (w, h),
                     interpolation=cv2.INTER_LINEAR).reshape(h, w, channels)
    img = np.clip(big + rng.randn(h, w, channels) * 10, 0, 255).astype(np.uint8)
    return img if channels == 3 else img[:, :, 0]


def _cv2(buf, flags):
    return cv2.imdecode(np.frombuffer(buf, np.uint8), flags)


def _assert_as_cv2(buf):
    """decode_image, decode_mask and the batch plane against cv2.imdecode;
    returns cv2's BGR pixels."""
    ref = _cv2(buf, cv2.IMREAD_COLOR)
    gray = _cv2(buf, cv2.IMREAD_GRAYSCALE)
    assert ref is not None and gray is not None
    np.testing.assert_array_equal(decode_image(buf), ref)
    np.testing.assert_array_equal(decode_mask(buf), gray)
    # the plane decodes the same bytes as image and as mask
    hw = (SIZE, SIZE)
    mat, inv = get_transform_mats(ref.shape[:2], hw)
    images, masks, inverse, ori = batch_preprocess([buf], [buf], SIZE,
                                                   nthreads=1)
    np.testing.assert_array_equal(
        images[0], normalize_image(warp_image(ref[:, :, ::-1], mat, hw)))
    np.testing.assert_array_equal(masks[0], warp_mask(gray, mat, hw))
    np.testing.assert_array_equal(inverse[0], inv)
    assert tuple(ori[0]) == ref.shape[:2]
    return ref


# ---------------------------------------------------------- progressive

SAMPLINGS = {"gray": None, "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
PIL_SUBSAMPLING = {"444": 0, "422": 1, "420": 2}
SIZES = [(1, 1), (17, 33), (37, 53), (480, 640)]


def _progressive(writer, sampling, h, w, restart=0, seed=None, **pil):
    gray = sampling == "gray"
    img = _photo(h, w, seed=h * 7 + w if seed is None else seed,
                 channels=1 if gray else 3)
    if writer == "cv2":
        params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        if not gray:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
        if restart:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        return cv2.imencode(".jpg", img, params)[1].tobytes()
    out = io.BytesIO()
    kw = dict(progressive=True, quality=90, **pil)
    if not gray:
        kw["subsampling"] = PIL_SUBSAMPLING[sampling]
        img = img[:, :, ::-1]
    if restart:
        kw["restart_marker_blocks"] = restart
    Image.fromarray(np.ascontiguousarray(img)).save(out, "JPEG", **kw)
    return out.getvalue()


def _scans(buf):
    """(Ss, Se, Ah, Al) of each SOS, and whether a DHT follows the first."""
    scans, pos, dht_between = [], 2, False
    while pos < len(buf) - 1:
        assert buf[pos] == 0xFF
        marker = buf[pos + 1]
        if marker == 0xD9:
            break
        length = struct.unpack_from(">H", buf, pos + 2)[0]
        if marker == 0xC4 and scans:
            dht_between = True
        if marker == 0xDA:
            ns = buf[pos + 4]
            ss, se, ahal = buf[pos + 5 + 2 * ns: pos + 8 + 2 * ns]
            scans.append((ss, se, ahal >> 4, ahal & 15))
            pos += 2 + length
            while not (buf[pos] == 0xFF and buf[pos + 1] not in
                       (0x00, *range(0xD0, 0xD8))):
                pos += 1
            continue
        pos += 2 + length
    return scans, dht_between


@pytest.mark.parametrize("restart", [0, 3], ids=["no rst", "rst 3"])
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("writer", ["cv2", "PIL"])
def test_progressive_jpeg_equals_cv2(writer, sampling, hw, restart):
    buf = _progressive(writer, sampling, *hw, restart=restart)
    assert buf[buf.index(b"\xff\xc2") + 9] == (1 if sampling == "gray" else 3)
    assert (b"\xff\xdd" in buf) == bool(restart)
    scans, dht_between = _scans(buf)
    # libjpeg's default script: all four scan kinds, a DHT before each scan
    kinds = {(ss == 0, ah > 0) for ss, se, ah, al in scans}
    assert kinds == {(True, False), (True, True), (False, False),
                     (False, True)}, scans
    assert dht_between
    _assert_as_cv2(buf)


@pytest.mark.parametrize("sampling", sorted(PIL_SUBSAMPLING))
def test_progressive_jpeg_with_optimized_tables_equals_cv2(sampling):
    _assert_as_cv2(_progressive("PIL", sampling, 37, 53, optimize=True))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_progressive_jpeg_exif_orientation_equals_cv2(orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = _progressive("PIL", "420", 20, 44, restart=2, exif=exif.tobytes())
    ref = _assert_as_cv2(buf)
    assert ref.shape[:2] == ((44, 20) if orientation >= 5 else (20, 44))


# ------------------------------------------------------------------ PNG

# (colour type, bit depth) pairs PNG allows, and samples a pixel
PAIRS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
         (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _packed(samples, depth):
    """(h, w, c) samples -> (h, row bytes) as PNG packs them."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = -(-flat.shape[1] // per)
    padded = np.zeros((h, n * per), np.int64)
    padded[:, :flat.shape[1]] = flat
    shifts = 8 - depth * (1 + np.arange(per))
    return (padded.reshape(h, n, per) << shifts).sum(-1).astype(np.uint8)


def _filtered(rows, bpp, first_filter=0):
    """Each row under filter (first_filter + y) % 5, as a PNG writer
    would emit it."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        f = (first_filter + y) % 5
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            # the average filter uses the reconstructed left byte, so it
            # is computed byte by byte
            enc = np.zeros_like(row)
            for i in range(len(row)):
                left = row[i - bpp] if i >= bpp else 0
                enc[i] = (row[i] - ((left + b[i]) >> 1)) % 256
            out.append(bytes([3]) + enc.astype(np.uint8).tobytes())
            prev = row
            continue
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _png(samples, color, depth, interlace=False, plte=None, trns=None,
         before_idat=b"", after_idat=b""):
    """A PNG of (h, w, c) samples (palette indices for colour type 3)."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    samples = samples.reshape(h, w, -1)
    bpp = max(1, SAMPLES[color] * depth // 8)
    raw = b""
    for k, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace
                                         else [(0, 0, 1, 1)]):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filtered(_packed(sub, depth), bpp, first_filter=k)
    out = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))) + before_idat)
    if plte is not None:
        out += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return (out + _chunk(b"IDAT", zlib.compress(raw, 6)) + after_idat
            + _chunk(b"IEND", b""))


def _png_case(color, depth, interlace, trns, h=37, w=53, **kw):
    rng = np.random.RandomState(color * 100 + depth * 10 + interlace)
    top = (1 << depth) - 1
    plte = None
    if color == 3:
        entries = min(1 << depth, 200)  # depth 8: indices past the end
        plte = rng.randint(0, 256, (entries, 3))
        samples = rng.randint(0, top + 1, (h, w))
    else:
        samples = rng.randint(0, top + 1, (h, w, SAMPLES[color]))
        if color in (2, 6):
            samples[0, :5, 1:3] = samples[0, :5, :1]  # gray pixels
    t = None
    if trns:
        t = {0: lambda: struct.pack(">H", int(samples[0, 0, 0])),
             2: lambda: struct.pack(">HHH", *map(int, samples[0, 0, :3])),
             3: lambda: bytes(range(0, 250, 50))}[color]()
    return _png(samples, color, depth, interlace, plte, t, **kw)


PNG_CASES = [(c, d, i, t) for c, d in PAIRS for i in (False, True)
             for t in ((False, True) if c in (0, 2, 3) else (False,))]


@pytest.mark.parametrize(
    "color,depth,interlace,trns", PNG_CASES,
    ids=[f"type{c}-{d}bit" + ("-adam7" if i else "") + ("-trns" if t else "")
         for c, d, i, t in PNG_CASES])
def test_png_equals_cv2(color, depth, interlace, trns):
    _assert_as_cv2(_png_case(color, depth, interlace, trns))


@pytest.mark.parametrize("hw", [(1, 1), (1, 9), (5, 3), (8, 8), (9, 17)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("color,depth", [(0, 1), (3, 2), (6, 16)])
def test_small_adam7_pngs_with_empty_passes_equal_cv2(color, depth, hw):
    _assert_as_cv2(_png_case(color, depth, True, False, *hw))


GAMMAS = {"gAMA 1/2.2": _chunk(b"gAMA", struct.pack(">I", 45455)),
          "gAMA 0.8": _chunk(b"gAMA", struct.pack(">I", 80000)),
          "gAMA 0.97 (insignificant)": _chunk(b"gAMA", struct.pack(">I", 97000)),
          "sRGB": _chunk(b"sRGB", b"\0"),
          "sRGB over gAMA 1.0": (_chunk(b"gAMA", struct.pack(">I", 100000))
                                 + _chunk(b"sRGB", b"\0"))}


@pytest.mark.parametrize("color,depth", [(2, 8), (3, 4), (6, 8), (0, 16)])
@pytest.mark.parametrize("gamma", sorted(GAMMAS))
def test_png_file_gamma_equals_cv2(gamma, color, depth):
    """A file gamma moves libpng's colour-to-gray conversion (its 8-bit
    gamma tables); gray images and IMREAD_COLOR are untouched."""
    _assert_as_cv2(_png_case(color, depth, False, False,
                             before_idat=GAMMAS[gamma]))


def _exif(orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    raw = exif.tobytes()
    return raw[6:] if raw.startswith(b"Exif\0\0") else raw


@pytest.mark.parametrize("where", ["before IDAT", "after IDAT"])
@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_png_exif_orientation_equals_cv2(orientation, where):
    chunk = _chunk(b"eXIf", _exif(orientation))
    kw = {"before_idat" if where == "before IDAT" else "after_idat": chunk}
    ref = _assert_as_cv2(_png_case(2, 8, False, False, 20, 30, **kw))
    assert ref.shape[:2] == ((30, 20) if orientation >= 5 else (20, 30))


@pytest.mark.parametrize("mode", ["P", "LA", "RGBA", "I;16", "1"])
def test_pil_written_pngs_equal_cv2(mode):
    img = Image.fromarray(_photo(33, 47, seed=9)[:, :, ::-1])
    img = {"P": lambda: img.quantize(100), "LA": lambda: img.convert("LA"),
           "RGBA": lambda: img.convert("RGBA"),
           "I;16": lambda: Image.fromarray(
               (np.asarray(img.convert("L")).astype(np.uint16) * 257)),
           "1": lambda: img.convert("1")}[mode]()
    out = io.BytesIO()
    img.save(out, "PNG")
    _assert_as_cv2(out.getvalue())


# ------------------------------------------------------------- refusals

def _patched(buf, marker, offset, value):
    b = bytearray(buf)
    b[buf.index(marker) + offset] = value
    return bytes(b)


def _bad_al(buf):
    """buf with its first scan's Al set to 14 (libjpeg allows up to 13)."""
    at = buf.index(b"\xff\xda")
    b = bytearray(buf)
    b[at + 7 + 2 * buf[at + 4]] = 0x0E
    return bytes(b)


def _with_ihdr(buf, depth, color):
    """buf with its IHDR's bit depth and colour type replaced."""
    w, h = struct.unpack_from(">II", buf, 16)
    return (buf[:8] + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                  color, 0, 0, 0)) + buf[33:])


def _sos_offsets(buf):
    return [i for i in range(len(buf) - 1) if buf[i:i + 2] == b"\xff\xda"]


def _refused():
    prog = _progressive("cv2", "420", 37, 53, restart=2)
    sos = _sos_offsets(prog)
    cases = {
        "progressive cut mid-scan": (prog[: (sos[3] + sos[4]) // 2],
                                     "SOF2: progressive JPEG: .*(premature "
                                     "end|truncated)"),
        "progressive cut between scans": (prog[: sos[5]], "SOF2: progressive "
                                          "JPEG: .*truncated"),
        # complete to EOI, but its scans leave coefficients approximate
        "progressive, early scans only": (prog[: sos[4]] + b"\xff\xd9",
                                          "approximate"),
        "progressive 12-bit": (_patched(prog, b"\xff\xc2", 4, 12),
                               "SOF2: 12-bit"),
        "progressive cmyk": (_patched(prog, b"\xff\xc2", 9, 4),
                             "4 components"),
        "progressive bad Al": (_bad_al(prog), "bad progression"),
        "progressive arithmetic (SOF10)": (_patched(prog, b"\xff\xc2", 1, 0xCA),
                                           "SOF10: arithmetic"),
        "lossless (SOF3)": (_patched(prog, b"\xff\xc2", 1, 0xC3), "SOF3: lossless"),
        "arithmetic (SOF9)": (_patched(prog, b"\xff\xc2", 1, 0xC9),
                              "SOF9: arithmetic"),
        "hierarchical (SOF5)": (_patched(prog, b"\xff\xc2", 1, 0xC5),
                                "SOF5: .*hierarchical"),
        "png 16-bit rgb as gray under gAMA": (
            _png_case(2, 16, False, False, before_idat=GAMMAS["gAMA 1/2.2"]),
            "RGB to grayscale"),
        "png depth 16 palette": (_with_ihdr(_png_case(3, 8, False, False),
                                            16, 3),
                                 "bit depth 16, color type 3.* not a valid"),
        "png depth 4 rgb": (_with_ihdr(_png_case(2, 8, False, False), 4, 2),
                            "bit depth 4, color type 2.* not a valid"),
        "png no PLTE": (_png(np.zeros((4, 4)), 3, 8), "PLTE: missing"),
        "png unknown critical chunk": (_png(np.zeros((4, 4)), 0, 8,
                                            before_idat=_chunk(b"ABCD", b"")),
                                       "ABCD: critical chunk"),
    }
    img = _photo(16, 16, seed=1)
    # WebP and BMP decode now; what stays refused of them keeps these names
    frames = [Image.fromarray(img), Image.fromarray(img[::-1])]
    webp = io.BytesIO()
    frames[0].save(webp, "WEBP", save_all=True, append_images=frames[1:],
                   lossless=True)
    # animated files decode now; one whose ANIM chunk is cut out stays
    # refused (by WebPDemux too: cv2 returns None)
    webp = webp.getvalue()
    at = webp.index(b"ANIM")
    webp = bytearray(webp[:at] + webp[at + 14:])
    struct.pack_into("<I", webp, 4, len(webp) - 8)
    cases["webp"] = (bytes(webp), "animated WebP: ANMF before ANIM")
    bmp = bytearray(cv2.imencode(".bmp", img)[1].tobytes())
    bmp[30] = 4  # BI_JPEG compression
    cases["bmp"] = (bytes(bmp), "compression 4 is not supported")
    # TIFF decodes now; what stays refused of it keeps this name
    cases["tiff"] = (cv2.imencode(".tiff", img.astype(np.float32))[1].tobytes(),
                     "TIFF: 32-bit samples")
    return cases


@pytest.mark.parametrize("case", sorted(_refused()))
def test_refused_kinds_raise_naming_what_they_are(case):
    """Each raises ValueError naming it, under both flags and in the plane
    (16-bit colour under a file gamma only when read as gray: the plane
    reads the same bytes as its mask)."""
    buf, words = _refused()[case]
    as_gray_only = "as gray" in case
    if as_gray_only:
        np.testing.assert_array_equal(decode_image(buf),
                                      _cv2(buf, cv2.IMREAD_COLOR))
    else:
        with pytest.raises(ValueError, match=words):
            decode_image(buf)
    with pytest.raises(ValueError, match=words):
        decode_mask(buf)
    with pytest.raises(ValueError, match=f"sample 0: .*{words}"):
        batch_preprocess([buf], [buf], SIZE, nthreads=1)


# ------------------------------------------------------------- fixtures

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_codec_fixtures")


def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return json.load(f)["files"]


@pytest.mark.parametrize("name", sorted(_digests()))
def test_committed_fixtures_match_their_digests(name):
    """The files chip_smoke.py decodes on the card: cv2.imdecode and the
    port give the committed digests under both flags."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        buf = f.read()
    color, gray = (_digests()[name][key]["shape"] for key in ("color", "gray"))
    if color[2:] == [3] and len(gray) == 2:
        ref = _assert_as_cv2(buf)
    else:  # a PFM keeps its 3 channels under IMREAD_GRAYSCALE: no plane
        ref = _cv2(buf, cv2.IMREAD_COLOR)
    for flag, key, got in ((cv2.IMREAD_COLOR, "color", decode_image(buf)),
                           (cv2.IMREAD_GRAYSCALE, "gray", decode_mask(buf))):
        want = _digests()[name][key]
        for img in (got, _cv2(buf, flag)):
            assert list(img.shape) == want["shape"]
            assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"]
    width, height = map(int, name.rsplit("_", 1)[1].split(".")[0].split("x"))
    assert ref.shape[:2] == (height, width)  # the size the name gives
