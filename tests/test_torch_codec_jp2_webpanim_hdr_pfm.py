"""The port's decoder on JPEG 2000, animated WebP, Radiance HDR and PFM,
held bit for bit against cv2.imdecode (OpenCV 5.0.0: OpenJPEG 2.5.3,
libwebp 1.6, its own HDR and PFM readers) under IMREAD_COLOR and
IMREAD_GRAYSCALE, through ``decode_image`` / ``decode_mask`` and, where
cv2 gives the plane's channels, through the batch plane
(``_assert_as_cv2``):

- JPEG 2000: JP2 files and raw J2K codestreams written by PIL's writer,
  by cv2's, and by PIL's bundled libopenjp2 through ``ctypes`` (``_opj``
  below) for what PIL's plugin does not pass: the 5/3 and 9/7 wavelets,
  every progression order, 0 to 7 decomposition levels, sizes from 1 x 1
  to odd ones, tiles and tile-parts, precincts, code-block sizes, quality
  layers, SOP / EPH markers, every code-block style (selective bypass,
  context reset, termination on every pass, vertically causal contexts,
  predictable termination, segmentation symbols), 8- to 16-bit
  components; JP2 boxes built here around codestreams (palettes with
  cmap, channel definitions, colour specifications: sRGB, greyscale,
  sYCC, ICC, unknown; boxes out of place); marker segments OpenJPEG skips
  (COM, TLM, PLM, CRG, unknown ones), COC and QCC, Psot 0, TNsot 0.
- Animated WebP: the first frame, lossless or lossy with ALPH, at an
  offset on a larger canvas whose background colour is not used, with
  transparent pixels that keep their colour, every blend and disposal
  bit, an EXIF orientation; PIL's animated writer.
- Radiance HDR: cv2's writer flat and RLE, scanlines RLE then flat, an
  old-style run read as a pixel, the header lines OpenCV takes, the
  orientations it refuses.
- PFM: cv2's writer, colour and gray, both byte orders, scales, samples
  past 8 bits, NaN and infinities, the header spellings OpenCV's atoi /
  atof take.

Each format is fuzzed: cut and byte-changed files are decoded as cv2
decodes them, or refused where cv2 returns None (or raises). And the
kinds that stay refused, each with a message that names it (and says that
OpenCV reads it where it does).
"""

import ctypes
import functools
import glob
import io
import os
import struct
import tempfile

import cv2
import numpy as np
import PIL
import pytest
from PIL import Image

from cris_tpu_torch.data import batch_preprocess, decode_image, decode_mask
from test_torch_codec_formats import SIZE, _assert_as_cv2, _photo


def _cv2(buf, flag):
    """cv2.imdecode, with None for what it raises on (a size it refuses)."""
    try:
        return cv2.imdecode(np.frombuffer(buf, np.uint8), flag)
    except cv2.error:
        return None


def _port(buf, gray):
    try:
        return (decode_mask if gray else decode_image)(buf)
    except ValueError as e:
        return e


def _assert_same(buf):
    """decode_image / decode_mask against cv2 (shapes and pixels), and
    through the plane when cv2 gives it 3 and 1 channels; returns cv2's
    IMREAD_COLOR result."""
    ref = _cv2(buf, cv2.IMREAD_COLOR)
    gray = _cv2(buf, cv2.IMREAD_GRAYSCALE)
    assert ref is not None and gray is not None
    if ref.ndim == 3 and gray.ndim == 2:
        return _assert_as_cv2(buf)
    np.testing.assert_array_equal(decode_image(buf), ref)
    np.testing.assert_array_equal(decode_mask(buf), gray)
    assert decode_image(buf).shape == ref.shape and decode_mask(buf).shape == gray.shape
    return ref


def _assert_as_cv2_or_refused(buf):
    """What cv2 decodes the port decodes to the same pixels; where cv2
    returns None the port raises ValueError."""
    for flag, gray in ((cv2.IMREAD_COLOR, False), (cv2.IMREAD_GRAYSCALE, True)):
        ref, got = _cv2(buf, flag), _port(buf, gray)
        if ref is None:
            assert isinstance(got, ValueError), "cv2 refuses, the port decodes"
        else:
            assert not isinstance(got, ValueError), f"cv2 decodes, the port refuses: {got}"
            assert got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)


def _mutations(base, seed, n):
    """n cut, bit-flipped or byte-changed copies of base."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        m = bytearray(base)
        kind = rng.randint(3)
        if kind == 0:
            m = m[:rng.randint(1, len(m))]
        elif kind == 1:
            m[rng.randint(len(m))] ^= 1 << rng.randint(8)
        else:
            m[rng.randint(len(m))] = rng.randint(256)
        yield bytes(m)


def _box(kind, payload):
    return struct.pack(">I", 8 + len(payload)) + kind + payload


# -------------------------------------------------------------- JPEG 2000

def _pil_j2k(arr, mode=None, **kw):
    im = Image.fromarray(np.ascontiguousarray(arr))
    if mode:
        im = im.convert(mode)
    out = io.BytesIO()
    im.save(out, "JPEG2000", **kw)
    return out.getvalue()


def _jp2(codestream, h, w, nc, enumcs=16, colr=None, extra=b""):
    """A JP2 file around a codestream: jP, ftyp, jp2h (ihdr, colr, extra),
    jp2c."""
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0))
    if colr is None:
        colr = _box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    return (_box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + _box(b"jp2h", ihdr + colr + extra) + _box(b"jp2c", codestream))


_OPJ = None
_NUMRES = 5600  # offsetof(opj_cparameters_t, numresolution)


def _libopenjp2():
    global _OPJ
    if _OPJ is None:
        path = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                      "libopenjp2*"))[0]
        lib = ctypes.CDLL(path)
        p, u32, i = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
        lib.opj_image_create.restype = p
        lib.opj_image_create.argtypes = [u32, p, i]
        lib.opj_create_compress.restype = p
        lib.opj_create_compress.argtypes = [i]
        lib.opj_setup_encoder.argtypes = [p, p, p]
        lib.opj_stream_create_default_file_stream.restype = p
        lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, i]
        lib.opj_start_compress.argtypes = [p, p, p]
        lib.opj_encode.argtypes = [p, p]
        lib.opj_end_compress.argtypes = [p, p]
        for fn in ("opj_stream_destroy", "opj_destroy_codec", "opj_image_destroy",
                   "opj_set_default_encoder_parameters"):
            getattr(lib, fn).argtypes = [p]
        _OPJ = lib
    return _OPJ


def _opj(planes, prec=8, sgnd=False, dx=1, x0=0, color_space=1, numres=None,
         cblk=(64, 64), mode=0, irreversible=False, prog=0, layers=None, tile=None,
         precincts=None, csty=0, tp_flag=None, roi=None):
    """planes (component sample arrays) encoded by PIL's libopenjp2 with
    opj_cparameters_t fields PIL's plugin does not set: the code-block style
    (mode), SOP / EPH (csty), tile-parts (tp_flag), an ROI shift, the
    precision, sign, subsampling and offset of the components."""
    lib = _libopenjp2()
    par = ctypes.create_string_buffer(32768)
    lib.opj_set_default_encoder_parameters(par)

    def put(off, v, fmt="<i"):
        struct.pack_into(fmt, par, off, v)

    # the layout of opj_cparameters_t in OpenJPEG 2.5 (x86-64)
    assert struct.unpack_from("<3i", par, _NUMRES) == (6, 64, 64)
    assert struct.unpack_from("<2i", par, 18204) == (-1, -1)  # decod / cod_format
    rates = layers or [0.0]
    put(4796, len(rates))  # tcp_numlayers
    for k, r in enumerate(rates):
        put(4800 + 4 * k, float(r), "<f")
    put(20, 1)  # cp_disto_alloc
    if numres is not None:
        put(_NUMRES, numres)
    put(_NUMRES + 4, cblk[0])
    put(_NUMRES + 8, cblk[1])
    put(_NUMRES + 12, mode)
    put(_NUMRES + 16, int(irreversible))
    put(52, prog)
    put(48, csty | (1 if precincts else 0))
    if precincts:
        put(_NUMRES + 28, len(precincts))
        for k, (pw, ph) in enumerate(precincts):
            put(_NUMRES + 32 + 4 * k, pw)
            put(_NUMRES + 164 + 4 * k, ph)
    if tile:
        put(0, 1)
        put(12, tile[0])
        put(16, tile[1])
    put(18188, x0)
    if tp_flag:
        struct.pack_into("<bb", par, 18696, 1, ord(tp_flag))
    if roi:
        put(_NUMRES + 20, roi[0])
        put(_NUMRES + 24, roi[1])
    h, w = planes[0].shape
    nc = len(planes)
    parm = (ctypes.c_uint32 * (9 * nc))()
    for c in range(nc):
        parm[9 * c: 9 * c + 9] = [dx, 1, w, h, x0, 0, prec, prec, int(sgnd)]
    img = lib.opj_image_create(nc, parm, color_space)
    struct.pack_into("<IIII", (ctypes.c_char * 16).from_address(img), 0, x0, 0,
                     x0 + (w - 1) * dx + 1, h)
    comps = ctypes.c_void_p.from_address(img + 24).value
    for c in range(nc):
        data = ctypes.c_void_p.from_address(comps + 64 * c + 48).value
        arr = np.ascontiguousarray(planes[c], dtype=np.int32)
        ctypes.memmove(data, arr.ctypes.data, arr.nbytes)
    codec = lib.opj_create_compress(2)  # OPJ_CODEC_JP2
    fd, name = tempfile.mkstemp(suffix=".jp2")
    os.close(fd)
    try:
        assert lib.opj_setup_encoder(codec, par, img)
        stream = lib.opj_stream_create_default_file_stream(name.encode(), 0)
        ok = (lib.opj_start_compress(codec, img, stream) and lib.opj_encode(codec, stream)
              and lib.opj_end_compress(codec, stream))
        lib.opj_stream_destroy(stream)
        assert ok
        with open(name, "rb") as f:
            return f.read()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
        os.unlink(name)


def _planes(img):
    return [img[:, :, c].astype(np.int64) for c in range(img.shape[2])]


@pytest.mark.parametrize("hw", [(1, 1), (1, 7), (5, 1), (2, 3), (17, 33), (64, 64), (119, 161)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
def test_jp2_sizes_equal_cv2(hw, channels, irreversible):
    """Every size down to 1 x 1, at one level and at as many as it holds."""
    h, w = hw
    img = _photo(h, w, seed=h * w, channels=channels)
    levels = max(1, min(6, int(np.log2(min(h, w))) + 1))
    for kw in ({"num_resolutions": 1}, {"num_resolutions": levels}):
        _assert_same(_pil_j2k(img, irreversible=irreversible, **kw))


@pytest.mark.parametrize("levels", range(0, 8))
@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
def test_jp2_decomposition_levels_equal_cv2(levels, irreversible):
    """0 to 7 decomposition levels of the 5/3 and 9/7 wavelets at an odd
    size."""
    img = _photo(133, 161, seed=levels)
    _assert_same(_pil_j2k(img, irreversible=irreversible, num_resolutions=levels + 1))


PROGRESSIONS = ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"]
LAYOUTS = {
    "plain": {},
    "tiles": {"tile_size": (48, 32)},
    "precincts": {"precinct_size": (32, 64)},
    "code-blocks 16x32": {"codeblock_size": (16, 32)},
    "layers": {"quality_layers": [40, 20, 5], "quality_mode": "rates"},
    "tiles, precincts, layers": {"tile_size": (48, 40), "precinct_size": (32, 16), "num_resolutions": 4,
                                 "quality_layers": [30, 8], "quality_mode": "rates"},
    "no mct": {"mct": 0},
    "j2k": {"no_jp2": True},
    "plt": {"plt": True},
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("progression", PROGRESSIONS)
@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
def test_jp2_progressions_and_layouts_equal_cv2(progression, layout, irreversible):
    """PIL's writer: every progression order with tiles, precincts,
    code-block sizes, quality layers, without the colour transform, as a
    raw codestream, with PLT markers."""
    img = _photo(61, 77, seed=5)
    _assert_same(_pil_j2k(img, irreversible=irreversible, progression=progression,
                          **LAYOUTS[layout]))


@pytest.mark.parametrize("x1000", [1, 10, 50, 200, 1000])
@pytest.mark.parametrize("channels", [1, 3])
def test_cv2_written_jp2_equals_cv2(x1000, channels):
    """cv2's writer (its 9/7 rate control) at several compressions."""
    img = _photo(119, 161, seed=7, channels=channels)
    _assert_same(cv2.imencode(".jp2", img, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000,
                                            x1000])[1].tobytes())


@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
def test_16_bit_jp2_equals_cv2(irreversible):
    """16-bit gray (PIL) and colour (cv2): OpenCV's shift to 8 bits, gray
    taken by cvtColor of the shifted colour."""
    rng = np.random.RandomState(9)
    g16 = (_photo(40, 50, seed=9, channels=1).astype(np.uint16) * 257
           + rng.randint(0, 257, (40, 50))).astype(np.uint16)
    _assert_same(_pil_j2k(g16, "I;16", irreversible=irreversible))
    c16 = rng.randint(0, 65536, (40, 50, 3)).astype(np.uint16)
    _assert_same(cv2.imencode(".jp2", c16)[1].tobytes())


STYLES = {"selective bypass": 1, "context reset": 2, "termination on every pass": 4,
          "vertically causal": 8, "predictable termination": 16,
          "segmentation symbols": 32, "bypass, termall, causal, segsym": 1 | 4 | 8 | 32,
          "all six": 63}


@pytest.mark.parametrize("style", sorted(STYLES))
@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
def test_jp2_code_block_styles_equal_cv2(style, irreversible):
    """Every code-block style, through libopenjp2's encoder, one and three
    quality layers."""
    planes = _planes(_photo(61, 77, seed=3))
    for layers in (None, [30, 10, 2]):
        _assert_same(_opj(planes, mode=STYLES[style], irreversible=irreversible,
                          layers=layers))


@pytest.mark.parametrize("prog", range(5), ids=PROGRESSIONS)
@pytest.mark.parametrize("case", ["tile-parts by resolution", "tile-parts by layer",
                                  "tile-parts by component", "sop eph", "precincts"])
def test_jp2_tile_parts_and_markers_equal_cv2(prog, case):
    """Tile-parts split by resolution, layer or component; SOP and EPH
    around every packet; precincts per level with small code-blocks; each
    with a code-block style on."""
    planes = _planes(_photo(61, 77, seed=4))
    kw = {"tile-parts by resolution": dict(tile=(32, 24), tp_flag="R", numres=4),
          "tile-parts by layer": dict(tile=(40, 40), tp_flag="L", layers=[20, 5], numres=5),
          "tile-parts by component": dict(tile=(32, 32), tp_flag="C", numres=5),
          "sop eph": dict(csty=6, layers=[30, 8]),
          "precincts": dict(precincts=[(64, 64), (32, 32), (16, 16)], cblk=(16, 16))}[case]
    _assert_same(_opj(planes, prog=prog, mode=1 | 8, irreversible=prog % 2 == 1, **kw))


@pytest.mark.parametrize("prec", [9, 10, 12, 15])
@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
def test_jp2_precisions_equal_cv2(prec, irreversible):
    """Components of 9 to 15 bits, colour and greyscale: shifted by the
    precision less 8."""
    img = _photo(37, 45, seed=prec).astype(np.int64) * ((1 << prec) - 1) // 255
    _assert_same(_opj(_planes(img), prec=prec, irreversible=irreversible))
    _assert_same(_opj([img[:, :, 0]], prec=prec, irreversible=irreversible, color_space=2))


def _pclr(entries, sizes):
    ne, nc = entries.shape
    payload = struct.pack(">HB", ne, nc) + bytes((s - 1) & 0x7F for s in sizes)
    for row in entries:
        for v, s in zip(row, sizes):
            payload += int(v).to_bytes((s + 7) // 8, "big")
    return _box(b"pclr", payload)


def _cmap(maps):
    return _box(b"cmap", b"".join(struct.pack(">HBB", *m) for m in maps))


def _cdef(defs):
    return _box(b"cdef", struct.pack(">H", len(defs))
                + b"".join(struct.pack(">HHH", *d) for d in defs))


@functools.lru_cache(maxsize=None)
def _box_cases():
    rng = np.random.RandomState(5)
    gray = _pil_j2k(_photo(23, 31, seed=1, channels=1), no_jp2=True)
    rgb = _pil_j2k(_photo(23, 31, seed=2), no_jp2=True, mct=0)
    rgba = _pil_j2k(np.dstack([_photo(23, 31, seed=2), _photo(23, 31, seed=3, channels=1)]),
                    "RGBA", no_jp2=True)
    pal = rng.randint(0, 256, (256, 3))
    three = _cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    sig, ftyp = _box(b"jP  ", b"\r\n\x87\n"), _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", 23, 31, 3, 7, 7, 0, 0))

    def colr(e):
        return _box(b"colr", struct.pack(">BBBI", 1, 0, 0, e))

    ycc = _pil_j2k(rng.randint(0, 256, (50, 60, 3)).astype(np.uint8), no_jp2=True, mct=0)
    return {
        "palette": _jp2(gray, 23, 31, 1, extra=_pclr(pal, [8, 8, 8]) + three),
        "palette of 16-bit entries": _jp2(gray, 23, 31, 1, extra=_pclr(
            rng.randint(0, 65536, (256, 3)), [16, 16, 16]) + three),
        "palette shorter than the indices": _jp2(gray, 23, 31, 1,
                                                 extra=_pclr(pal[:40], [8, 8, 8]) + three),
        "palette of 4 columns": _jp2(gray, 23, 31, 1, extra=_pclr(
            rng.randint(0, 256, (256, 4)), [8] * 4) + _cmap([(0, 1, k) for k in range(4)])),
        "palette under greyscale": _jp2(gray, 23, 31, 1, enumcs=17,
                                        extra=_pclr(pal, [8, 8, 8]) + three),
        "palette without cmap": _jp2(gray, 23, 31, 1, extra=_pclr(pal, [8, 8, 8])),
        "palette with direct channels": _jp2(rgb, 23, 31, 3, extra=_pclr(pal, [8, 8, 8])
                                             + _cmap([(0, 1, 0), (1, 0, 0), (2, 0, 0)])),
        "palette with a direct first channel": _jp2(gray, 23, 31, 1, extra=_pclr(
            pal, [8, 8, 8]) + _cmap([(0, 0, 0), (0, 1, 1), (0, 1, 2)])),
        "cdef alpha first": _jp2(rgba, 23, 31, 4, extra=_cdef(
            [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)])),
        "cdef reversed colours": _jp2(rgb, 23, 31, 3, extra=_cdef(
            [(0, 0, 3), (1, 0, 2), (2, 0, 1)])),
        "cdef rgba": _jp2(rgba, 23, 31, 4, extra=_cdef(
            [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)])),
        "cdef unspecified": _jp2(rgb, 23, 31, 3, extra=_cdef(
            [(0, 0, 65535), (1, 65535, 2), (2, 0, 1)])),
        "icc profile": _jp2(rgb, 23, 31, 3, colr=_box(b"colr", b"\x02\x00\x00" + bytes(100))),
        "colr method 3": _jp2(rgb, 23, 31, 3, colr=_box(b"colr", b"\x03\x00\x00" + bytes(4))),
        "two colr, sYCC first": _jp2(rgb, 23, 31, 3, enumcs=18, extra=colr(16)),
        "sycc": _jp2(ycc, 50, 60, 3, enumcs=18),
        "sycc with a fourth channel": _jp2(rgba, 23, 31, 4, enumcs=18),
        "greyscale colour over rgb": _jp2(rgb, 23, 31, 3, enumcs=17),
        "greyscale with alpha": _jp2(_pil_j2k(np.dstack([_photo(23, 31, seed=6, channels=1)] * 2),
                                              "LA", no_jp2=True), 23, 31, 2, enumcs=17),
        "unknown enumcs": _jp2(rgb, 23, 31, 3, enumcs=20),
        "no colr": _jp2(rgb, 23, 31, 3, colr=b""),
        "colr after jp2h": sig + ftyp + _box(b"jp2h", ihdr) + colr(18) + _box(b"jp2c", rgb),
        "colr before jp2h": sig + ftyp + colr(18) + _box(b"jp2h", ihdr) + _box(b"jp2c", rgb),
        "xml, uuid and trailing bytes": sig + ftyp + _box(b"xml ", b"<a/>")
        + _box(b"jp2h", ihdr + colr(16)) + _box(b"jp2c", rgb) + _box(b"uuid", bytes(20)) + b"tail",
        "jp2c of length 0": sig + ftyp + _box(b"jp2h", ihdr + colr(16)) + b"\0\0\0\0jp2c" + rgb,
        "jp2c of extended length": sig + ftyp + _box(b"jp2h", ihdr + colr(16))
        + struct.pack(">I4sQ", 1, b"jp2c", 16 + len(rgb)) + rgb,
        "ihdr after colr": sig + ftyp + _box(b"jp2h", colr(16) + ihdr) + _box(b"jp2c", rgb),
        "ihdr with other components and depth": sig + ftyp + _box(b"jp2h", _box(
            b"ihdr", struct.pack(">IIHBBBB", 23, 31, 1, 11, 7, 0, 0)) + colr(16))
        + _box(b"jp2c", rgb),
        "jpx brand": sig + _box(b"ftyp", b"jpx \0\0\0\0jpx jp2 ") + _box(b"jp2h", ihdr + colr(16))
        + _box(b"jp2c", rgb),
    }


@pytest.mark.parametrize("case", sorted(_box_cases()))
def test_jp2_boxes_equal_cv2(case):
    """Palettes, channel definitions and colour specifications applied as
    OpenJPEG applies them, then converted as OpenCV converts each colour
    space; boxes out of their place."""
    _assert_as_cv2_or_refused(_box_cases()[case])
    assert _cv2(_box_cases()[case], cv2.IMREAD_GRAYSCALE) is not None


def _marker(code, payload):
    return struct.pack(">HH", code, len(payload) + 2) + payload


def _in_main_header(cs, seg):
    at = 4 + struct.unpack(">H", cs[4:6])[0]  # after SIZ
    return cs[:at] + seg + cs[at:]


def _in_tile_part_header(cs, seg):
    at = cs.find(b"\xff\x90\x00\x0a")
    out = bytearray(cs[:at + 12] + seg + cs[at + 12:])
    psot = struct.unpack(">I", cs[at + 6:at + 10])[0]
    if psot:
        struct.pack_into(">I", out, at + 6, psot + len(seg))
    return bytes(out)


@functools.lru_cache(maxsize=None)
def _codestreams():
    img = _photo(29, 37, seed=4)
    return (_pil_j2k(img, no_jp2=True), _pil_j2k(img, no_jp2=True, irreversible=True))


@functools.lru_cache(maxsize=None)
def _marker_cases():
    cs, cs97 = _codestreams()
    sot, qcd = cs.find(b"\xff\x90"), cs97.find(b"\xff\x5c")
    return {
        "com in the main header": _in_main_header(cs, _marker(0xFF64, b"\x00\x01hello")),
        "com in a tile-part header": _in_tile_part_header(cs, _marker(0xFF64, b"\x00\x01hi")),
        "tlm": _in_main_header(cs, _marker(0xFF55, b"\x00\x00")),
        "tlm of a bad Stlm and size": _in_main_header(cs, _marker(0xFF55, b"\x00\x30\x00")),
        "plm": _in_main_header(cs, _marker(0xFF57, b"\x00")),
        "plm cut mid-length": _in_main_header(cs, _marker(0xFF57, b"\x00\x02\x81\x81")),
        "cpf": _in_main_header(cs, _marker(0xFF59, b"ab")),
        "crg": _in_main_header(cs, _marker(0xFF63, bytes(12))),
        "an unknown marker in the main header": _in_main_header(cs, _marker(0xFF30, b"abcd")),
        "an unknown marker of odd length": _in_main_header(cs, b"\xff\x30\x00\x05abc"),
        "an unknown marker in a tile-part header": _in_tile_part_header(cs, _marker(0xFF30, b"ab")),
        "coc": _in_main_header(cs, _marker(0xFF53, bytes([1, 0, 3, 3, 3, 0, 1]))),
        "coc 9/7": _in_main_header(cs97, _marker(0xFF53, bytes([2, 0, 2, 4, 4, 0, 0]))),
        "qcc": _in_main_header(cs97, _marker(0xFF5D, bytes([1, 0x22]) + struct.pack(">H", 0x4800))),
        # the 9/7 QCD rewritten as scalar derived from its first step size
        "qcd scalar derived": cs97[:qcd] + struct.pack(">HHB", 0xFF5C, 5, cs97[qcd + 4] & 0xE0 | 1)
        + cs97[qcd + 5:qcd + 7] + cs97[qcd + 2 + struct.unpack(">H", cs97[qcd + 2:qcd + 4])[0]:],
        "qcc scalar derived": _in_main_header(cs97, _marker(0xFF5D, bytes(
            [1, cs97[qcd + 4] & 0xE0 | 1]) + cs97[qcd + 5:qcd + 7])),
        "rsiz part 2": cs[:6] + b"\x80\x00" + cs[8:],
        "psot 0": cs[:sot + 6] + bytes(4) + cs[sot + 10:],
        "tnsot 0": cs[:sot + 11] + b"\x00" + cs[sot + 12:],
        "bytes after eoc": cs + b"\x12\x34\x56",
        "no eoc": cs[:-2],
    }


@pytest.mark.parametrize("case", sorted(_marker_cases()))
def test_jp2_marker_segments_equal_cv2(case):
    """Marker segments OpenJPEG skips or takes: COM, TLM, PLM, CRG, CPF,
    unknown markers (skipped two bytes at a time in the main header,
    refused in a tile-part header), COC, QCC, scalar derived quantisation,
    a Part 2 Rsiz, Psot 0, TNsot 0."""
    _assert_as_cv2_or_refused(_marker_cases()[case])


def test_jp2_tile_part_count_correction_equals_cv2():
    """TNsot too low by one (OpenJPEG's correction for TPsot == TNsot), and
    TNsot 1 over three tile-parts (the tile decodes from its first)."""
    base = _opj([_photo(40, 40, seed=3, channels=1).astype(np.int64)], tp_flag="R", numres=3,
                color_space=2)
    sots = [i for i in range(len(base) - 3) if base[i:i + 4] == b"\xff\x90\x00\x0a"]
    assert len(sots) == 3
    for tnsot in (1, 2):
        buf = bytearray(base)
        for at in sots:
            buf[at + 11] = tnsot
        _assert_same(bytes(buf))


@functools.lru_cache(maxsize=None)
def _refused_jp2():
    cs, cs97 = _codestreams()
    planes = _planes(_photo(29, 37, seed=4))
    cod = cs.find(b"\xff\x52")

    def cod_byte(off, value):
        b = bytearray(cs)
        b[cod + 4 + off] = value
        return bytes(b)

    poc = _marker(0xFF5F, struct.pack(">BBHBBB", 0, 0, 1, 6, 3, 0))
    part2 = "Part 2 extensions \\(MCT, MCC, MCO and CBD markers\\) are not supported \\(OpenCV reads it\\)"
    return {
        # feature: (file, message, whether cv2 decodes it)
        "poc": (_in_main_header(cs, poc), "POC .*not supported \\(OpenCV reads it\\)", True),
        "poc in a tile-part header": (_in_tile_part_header(cs, poc), "POC", True),
        "rgn": (_opj(planes, roi=(0, 3), numres=4), "RGN .*not supported \\(OpenCV reads it\\)", True),
        "htj2k cap marker": (_in_main_header(cs, _marker(0xFF50, struct.pack(">IH", 1 << 14, 0))),
                             "HTJ2K .*not supported \\(OpenCV reads it\\)", True),
        "htj2k code-blocks": (cod_byte(8, 0x40), "HTJ2K", False),
        "ppm": (_in_main_header(cs, _marker(0xFF60, b"\x00" + bytes(4))), "PPM / PPT", False),
        "ppt": (_in_tile_part_header(cs, _marker(0xFF61, b"\x00")), "PPM / PPT", False),
        "part 2 wavelet": (cod_byte(9, 2), "Part 2 .*wavelet", False),
        "part 2 multiple component transform": (cod_byte(4, 2), "Part 2 .*component transform",
                                                False),
        # Part 2's markers, each refused by name wherever it stands
        "part 2 mct": (_in_main_header(cs, _marker(0xFF74, b"\x00\x00\x00\x01\x00\x00" + bytes(36))),
                       part2, True),
        "part 2 mct in a tile-part header": (_in_tile_part_header(
            cs, _marker(0xFF74, b"\x00\x00\x00\x01\x00\x00" + bytes(36))), part2, True),
        "part 2 mcc": (_in_main_header(cs, _marker(0xFF75, b"\x00\x00\x01" + bytes(4))), part2, True),
        "part 2 mco": (_in_main_header(cs, _marker(0xFF77, b"\x00")), part2, True),
        "part 2 cbd": (_in_main_header(cs, _marker(0xFF78, b"\x00\x03\x09\x09\x09")), part2, True),
        "signed components": (_opj([p - 128 for p in planes], sgnd=True, numres=4), "signed components",
                              False),
        "components under 8 bits": (_opj([p // 2 for p in planes], prec=7, numres=4), "under 8 bits", False),
        "subsampled components": (_opj(planes, dx=2, numres=4), "subsampled components", False),
        "an image offset": (_opj(planes, x0=3, numres=4), "image offset", False),
        "cmyk": (_jp2(_pil_j2k(np.dstack([_photo(23, 31, seed=2)] * 2)[:, :, :4], "RGBA",
                               no_jp2=True), 23, 31, 4, enumcs=12), "CMYK", False),
        "e-sycc": (_jp2(cs, 29, 37, 3, enumcs=24), "e-sYCC", False),
        "cut to half": (cs97[:len(cs97) // 2], "runs past the end", False),
        "cut to 90%": (cs97[:len(cs97) * 9 // 10], "runs past the end", False),
        "a missing eph": (_eph_removed(_opj(planes, csty=4, numres=4)), "EPH marker is missing", False),
        "ihdr size differs": (_jp2(cs, 29, 36, 3), "ihdr box's size", False),
        "cdef incomplete": (_jp2(cs, 29, 37, 3, extra=_cdef([(0, 0, 1), (1, 0, 2)])),
                            "incomplete channel definitions", False),
        "cmap without pclr": (_jp2(cs, 29, 37, 3, extra=_cmap([(0, 1, 0)])), "cmap box before pclr",
                              False),
        "unknown scod bits": (cod_byte(0, 0x08), "unknown Scod", False),
        "sop in the main header": (_in_main_header(cs, _marker(0xFF91, b"\x00\x00")),
                                   "out of its place", False),
        "bad plt": (_plt_unended(_pil_j2k(_photo(29, 37, seed=4), no_jp2=True, plt=True)),
                    "bad PLT", False),
        "a tlm of one byte": (_in_main_header(cs, _marker(0xFF55, b"\x00")), "bad TLM", False),
        "bad crg": (_in_main_header(cs, _marker(0xFF63, bytes(8))), "bad CRG", False),
        "2 channels as rgb": (_jp2(_pil_j2k(
            np.dstack([_photo(23, 31, seed=6, channels=1)] * 2), "LA", no_jp2=True), 23, 31, 2),
            "RGB conversion of 2 channels", False),
    }


def _plt_unended(buf):
    """The first PLT's last length byte with its continuation bit set."""
    at = buf.find(b"\xff\x58")
    end = at + 2 + struct.unpack(">H", buf[at + 2:at + 4])[0]
    return buf[:end - 1] + bytes([buf[end - 1] | 0x80]) + buf[end:]


def _eph_removed(buf):
    at = buf.find(b"\xff\x92")
    return buf[:at] + buf[at + 2:]


@pytest.mark.parametrize("case", sorted(_refused_jp2()))
def test_refused_jp2_raise_naming_them(case):
    """Each raises ValueError naming it, under both flags and in the plane;
    where OpenCV decodes the file the message says so, and where cv2
    returns None the test checks that it does."""
    buf, words, cv2_reads = _refused_jp2()[case]
    if case == "2 channels as rgb":  # only IMREAD_COLOR refuses it
        assert _cv2(buf, cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match=words):
            decode_image(buf)
        return
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        assert (_cv2(buf, flag) is not None) == cv2_reads
    for fn in (decode_image, decode_mask):
        with pytest.raises(ValueError, match=f"JPEG 2000: .*{words}"):
            fn(buf)
    with pytest.raises(ValueError, match=f"sample 0: .*{words}"):
        batch_preprocess([buf], [buf], SIZE, nthreads=1)


def _siz(w, h, nc, tile=None, sgnd=False):
    """SOC, a SIZ of nc 8-bit components (tile x tile tiles, one tile by
    default), then the small codestream's COD and QCD."""
    cs = _codestreams()[0]
    cod = cs.find(b"\xff\x52")
    comp = bytes([0x87 if sgnd else 7, 1, 1])
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, tile or w, tile or h, 0, 0, nc) + comp * nc
    return b"\xff\x4f" + _marker(0xFF51, siz) + cs[cod:cs.find(b"\xff\x90")]


def _huge_headers():
    """Headers of files that would have the decoder size work by the
    header alone: 16384 components over 65535 tiles, and a 32768 x 32768
    image of one tile whose tile-part holds no data. Each with whether cv2
    is asked too. OpenJPEG sizes both by the header before it refuses them
    (a component table for every tile, the image's 2^30 pixels), so cv2
    is asked of twins: 16384 components in one tile, 64 x 64 pixels."""
    sot = struct.pack(">HHHIBB", 0xFF90, 10, 0, 14, 0, 1) + b"\xff\x93"
    return {
        "16384 components, 65535 tiles": (_siz(65535, 1, 16384, tile=1) + sot,
                                          "more than 4 components", False),
        "16384 signed components": (_siz(64, 64, 16384, sgnd=True), "more than 4 components",
                                    True),
        "32768 x 32768, no tile data": (_siz(32768, 32768, 3) + sot + b"\xff\xd9",
                                        "a tile with no data", False),
        "64 x 64, no tile data": (_siz(64, 64, 3) + sot + b"\xff\xd9", "a tile with no data",
                                  True),
        "32768 x 32768, header only": (_siz(32768, 32768, 3), "ends early", True),
        "32768 x 32769": (_siz(32768, 32769, 3) + sot, "image size 32768 x 32769", True),
    }


@pytest.mark.parametrize("case", sorted(_huge_headers()))
def test_huge_jp2_headers_are_refused_before_their_size_is_allocated(case):
    """A SIZ of many components or tiles, or of a large image with no tile
    data, refuses before the decoder allocates by the header's numbers (a
    hundred bytes must not cost gigabytes): OpenCV's checks on the header
    run as SIZ is read, tiles get their parameters as their SOT comes, and
    the image's planes are made when a tile has data. cv2 returns None for
    each (or for its small twin)."""
    buf, words, ask_cv2 = _huge_headers()[case]
    assert len(buf) < 100_000
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        assert not ask_cv2 or _cv2(buf, flag) is None
    for fn in (decode_image, decode_mask):
        with pytest.raises(ValueError, match=words):
            fn(buf)


@functools.lru_cache(maxsize=None)
def _fuzz_bases():
    img = _photo(29, 37, seed=1)
    small = _photo(21, 26, seed=4, channels=1).astype(np.int64)
    return {
        "5/3 rgb": _pil_j2k(img),
        "9/7 rgb, layers": _pil_j2k(_photo(29, 37, seed=2), irreversible=True,
                                    quality_layers=[30, 10], quality_mode="rates"),
        "5/3 gray tiles rpcl": _pil_j2k(_photo(40, 33, seed=3, channels=1),
                                        tile_size=(16, 16), progression="RPCL",
                                        num_resolutions=3, no_jp2=True),
        "9/7 sop eph bypass termall": _opj([small], csty=6, mode=1 | 4, irreversible=True,
                                           color_space=2, numres=4),
        "5/3 tile-parts": _opj(_planes(_photo(45, 50, seed=11)), tile=(24, 24), tp_flag="R",
                               numres=3, layers=[20, 5, 0]),
    }


@pytest.mark.parametrize("base", sorted(_fuzz_bases()))
@pytest.mark.parametrize("seed", range(2))
def test_mutated_jp2_match_cv2(base, seed):
    """Cut, bit-flipped and byte-changed files: the port decodes what cv2
    decodes to the same pixels (OpenJPEG decodes damaged code-block data
    without complaint) and refuses what cv2 returns None for."""
    for buf in _mutations(_fuzz_bases()[base], seed, 60):
        _assert_as_cv2_or_refused(buf)


# ----------------------------------------------------------- animated WebP

def _chunk(tag, payload):
    return tag + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) & 1 else b"")


def _u24(v):
    return struct.pack("<I", v)[:3]


def _webp_frame(img, **kw):
    """The ALPH / VP8 / VP8L chunks of a still WebP written by PIL."""
    out = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img)).save(out, "WEBP", **kw)
    buf, at, chunks = out.getvalue(), 12, b""
    while at + 8 <= len(buf):
        tag, n = buf[at:at + 4], struct.unpack("<I", buf[at + 4:at + 8])[0]
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            chunks += _chunk(tag, buf[at + 8:at + 8 + n])
        at += 8 + n + (n & 1)
    return chunks


def _anmf(frame, x, y, w, h, flags=0):
    return _chunk(b"ANMF", _u24(x // 2) + _u24(y // 2) + _u24(w - 1) + _u24(h - 1) + _u24(100)
                  + bytes([flags]) + frame)


def _animated(frames, canvas, vp8x_flags=0x12, background=b"\x11\x22\x33\x44", before=b"",
              after=b"", anim=True):
    w, h = canvas
    body = (b"WEBP" + _chunk(b"VP8X", struct.pack("<I", vp8x_flags) + _u24(w - 1) + _u24(h - 1))
            + before + (_chunk(b"ANIM", background + b"\0\0") if anim else b"")
            + b"".join(frames) + after)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _rgba(h, w, seed):
    rgba = np.dstack([_photo(h, w, seed)[:, :, ::-1], np.zeros((h, w), np.uint8)])
    rgba[:, :, 3] = np.random.RandomState(seed).choice([0, 1, 128, 254, 255], (h, w))
    return rgba


def _exif(orientation):
    return (b"II*\0" + struct.pack("<IH", 8, 1) + struct.pack("<HHII", 0x112, 3, 1, orientation)
            + b"\0\0\0\0")


@functools.lru_cache(maxsize=None)
def _anim_cases():
    rgba = _rgba(40, 50, 1)
    lossless = _webp_frame(rgba, lossless=True, exact=True)
    lossy_alpha = _webp_frame(rgba, quality=70, exact=True)
    lossy = _webp_frame(rgba[:, :, :3], quality=70)
    second = _webp_frame(_rgba(40, 50, 2)[:, :, :3], quality=50)
    cases = {
        "lossless at an offset": _animated([_anmf(lossless, 6, 4, 50, 40)], (64, 48)),
        "lossy with alpha at an offset": _animated([_anmf(lossy_alpha, 10, 8, 50, 40)], (64, 48)),
        "lossy filling the canvas": _animated([_anmf(lossy, 0, 0, 50, 40)], (50, 40)),
        "two frames": _animated([_anmf(lossless, 2, 2, 50, 40), _anmf(second, 0, 0, 50, 40)],
                                (52, 42)),
        "an ANMF size other than the bitstream's": _animated([_anmf(lossless, 6, 4, 30, 20)],
                                                             (64, 48)),
        "ANIM, ANMF and a still bitstream without the flag": _animated(
            [_anmf(lossless, 6, 4, 50, 40)], (50, 40), vp8x_flags=0x10, after=lossless),
    }
    for flags in range(4):
        cases[f"blend and dispose bits {flags}"] = _animated(
            [_anmf(lossy_alpha, 2, 2, 50, 40, flags)], (54, 44), background=b"\xff" * 4)
    for orientation in (3, 6, 8):
        cases[f"exif orientation {orientation}"] = _animated(
            [_anmf(lossy, 2, 2, 50, 40)], (54, 44), vp8x_flags=0x1A,
            after=_chunk(b"EXIF", _exif(orientation)))
    # an ANMF size 2 past its frame's chunks: the demuxer goes on from the
    # frame's end, so the EXIF chunk after it still counts
    longer = bytearray(cases["exif orientation 6"])
    at = longer.index(b"ANMF")
    struct.pack_into("<I", longer, at + 4, struct.unpack("<I", longer[at + 4:at + 8])[0] + 2)
    cases["an ANMF size past its frame, then EXIF"] = bytes(longer)
    frames = [Image.fromarray(_rgba(24, 30, s)) for s in range(3)]
    for kw in (dict(lossless=True), dict(lossless=True, exact=True), dict(quality=60)):
        out = io.BytesIO()
        frames[0].save(out, "WEBP", save_all=True, append_images=frames[1:], duration=50, **kw)
        cases[f"pil {sorted(kw.items())}"] = out.getvalue()
    return cases


@pytest.mark.parametrize("case", sorted(_anim_cases()))
def test_animated_webp_first_frame_equals_cv2(case):
    """The first frame on a transparent black canvas: its pixels as a still
    decode gives them (a transparent pixel keeps its colour: the first
    frame is not blended), nothing else; gray by cvtColor; the EXIF
    orientation applied."""
    _assert_same(_anim_cases()[case])


def test_animated_webp_keeps_colour_under_zero_alpha():
    """cv2 keeps the RGB of pixels whose alpha is 0, which PIL's animated
    writer clears: the frame here is a still written with exact=True."""
    rgba = _rgba(40, 50, 1)
    buf = _animated([_anmf(_webp_frame(rgba, lossless=True, exact=True), 0, 0, 50, 40)],
                    (50, 40))
    ref = _assert_same(buf)
    np.testing.assert_array_equal(ref, rgba[:, :, 2::-1])
    assert (ref[rgba[:, :, 3] == 0] != 0).any()


@functools.lru_cache(maxsize=None)
def _refused_anim():
    lossless = _webp_frame(_rgba(40, 50, 1), lossless=True)
    second = bytearray(_webp_frame(_rgba(40, 50, 2)[:, :, :3], quality=50))
    second[11] ^= 0xFF  # the VP8 start code
    return {
        "no ANIM": (_animated([_anmf(lossless, 0, 0, 50, 40)], (50, 40), anim=False),
                    "ANMF before ANIM"),
        "no frame": (_animated([], (50, 40)), "no frame"),
        "a frame outside the canvas": (_animated([_anmf(lossless, 16, 4, 50, 40)], (64, 48)),
                                       "does not lie inside the canvas"),
        "a bad second frame header": (_animated([_anmf(lossless, 0, 0, 50, 40),
                                                 _anmf(bytes(second), 0, 0, 50, 40)], (50, 40)),
                                      "bad VP8 frame header"),
        "a still bitstream outside the frames": (_animated([], (50, 40), after=lossless),
                                                 "'VP8L' chunk outside its frames"),
        "cut": (_animated([_anmf(lossless, 0, 0, 50, 40)], (50, 40))[:-10], "truncated"),
    }


@pytest.mark.parametrize("case", sorted(_refused_anim()))
def test_refused_animated_webp_raise_naming_them(case):
    """What WebPDemux refuses (cv2 returns None) the port refuses by name."""
    buf, words = _refused_anim()[case]
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        assert _cv2(buf, flag) is None
    for fn in (decode_image, decode_mask):
        with pytest.raises(ValueError, match=words):
            fn(buf)


@pytest.mark.parametrize("case", ["two frames", "lossy with alpha at an offset",
                                  "exif orientation 6", "pil [('lossless', True)]"])
@pytest.mark.parametrize("seed", range(2))
def test_mutated_animated_webp_match_cv2(case, seed):
    """Cut and damaged animated files, VP8 data included (libwebp's SSE2
    inverse DCT wraps at 16 bits on corrupt coefficients, as the port's
    does)."""
    for buf in _mutations(_anim_cases()[case], seed, 60):
        _assert_as_cv2_or_refused(buf)


def test_damaged_alpha_of_an_animated_webp_matches_cv2():
    """An ALPH stream damaged so that a simple prefix code names a symbol
    past its alphabet, which libwebp ignores (the frame decodes)."""
    buf = bytearray(_anim_cases()["pil [('quality', 60)]"])
    buf[103] = 63
    _assert_as_cv2_or_refused(bytes(buf))


def test_damaged_vp8_still_matches_cv2():
    """Every byte of a lossy still's VP8 data damaged in turn: the port
    gives cv2's pixels or refuses where cv2 returns None."""
    out = io.BytesIO()
    Image.fromarray(_photo(40, 50, 2)[:, :, ::-1].copy()).save(out, "WEBP", quality=70)
    base = out.getvalue()
    for at in range(30, len(base), 3):
        buf = bytearray(base)
        buf[at] ^= 0x41
        _assert_as_cv2_or_refused(bytes(buf))


# ------------------------------------------------------------ Radiance HDR

HDR_HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n"


def _rgbe(h, w, seed, exponents=(120, 140)):
    rng = np.random.RandomState(seed)
    px = rng.randint(0, 256, (h * w, 4)).astype(np.uint8)
    px[:, 3] = rng.randint(*exponents, h * w)
    px[px[:, 0] == 2, 0] = 3  # no pixel reads as an RLE scanline start
    return px


@functools.lru_cache(maxsize=None)
def _hdr_cases():
    rng = np.random.RandomState(3)
    img = (rng.rand(13, 37, 3) * 1.3).astype(np.float32)
    flat = _rgbe(6, 20, 1)
    rle = cv2.imencode(".hdr", img, [cv2.IMWRITE_HDR_COMPRESSION,
                                     cv2.IMWRITE_HDR_COMPRESSION_RLE])[1].tobytes()
    at = rle.index(b"+X 37\n") + 6
    for _ in range(2):  # past two RLE scanlines: then 11 flat ones
        at += 4
        for _channel in range(4):
            left = 37
            while left:
                count = rle[at] - 128 if rle[at] > 128 else rle[at]
                at += 2 if rle[at] > 128 else 1 + count
                left -= count
    mixed = rle[:at] + _rgbe(11, 37, 4).tobytes()
    return {
        "cv2 flat": cv2.imencode(".hdr", img, [cv2.IMWRITE_HDR_COMPRESSION,
                                               cv2.IMWRITE_HDR_COMPRESSION_NONE])[1].tobytes(),
        "cv2 rle": rle,
        "cv2 rle, narrow (flat)": cv2.imencode(".hdr", img[:, :7], [
            cv2.IMWRITE_HDR_COMPRESSION, cv2.IMWRITE_HDR_COMPRESSION_RLE])[1].tobytes(),
        "rle then flat": mixed,
        "flat, every exponent": HDR_HEADER % (6, 20) + _rgbe(6, 20, 2, (0, 256)).tobytes(),
        "old-style run read as a pixel": HDR_HEADER % (6, 20) + flat[:10].tobytes()
        + bytes([1, 1, 1, 5]) + flat[11:].tobytes(),
        "#?RGBE": b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 20\n" + flat.tobytes(),
        "other header lines": b"#?RADIANCE\n# made here\nGAMMA=2\nFORMAT=32-bit_rle_rgbe\n"
        b"EXPOSURE=3\n\n-Y 6 +X 20\n" + flat.tobytes(),
        "crlf signature line": b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 20\n"
        + flat.tobytes(),
        "sscanf spacing": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y   6 +X20 junk\n"
        + flat.tobytes(),
        "a header line of 127 bytes": b"#?RADIANCE\n" + b"x" * 126
        + b"\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 20\n" + flat.tobytes(),
        "values past 1 saturate": HDR_HEADER % (2, 20) + _rgbe(2, 20, 5, (137, 170)).tobytes(),
    }


@pytest.mark.parametrize("case", sorted(_hdr_cases()))
def test_hdr_equals_cv2(case):
    """rgbe2float, then x 255 in float, rounded half to even and saturated,
    into BGR; gray as cvtColor's 15-bit weights of that."""
    _assert_same(_hdr_cases()[case])


def test_hdr_gray_is_cvtcolor_of_the_8_bit_colour():
    """Pixels whose 8-bit colour tells cvtColor's 15-bit weights from the
    readers' 14-bit ones."""
    lut = {}
    for m in range(256):
        v = int(np.rint(np.float32(np.float32(m) * np.float32(2.0 ** -8)) * np.float32(255)))
        lut.setdefault(v, m)
    rng = np.random.RandomState(0)
    colours = rng.randint(0, 256, (20000, 3))
    g15 = (colours @ [3735, 19235, 9798] + (1 << 14)) >> 15
    g14 = (colours @ [1868, 9617, 4899] + (1 << 13)) >> 14
    pick = np.array([c for c in colours[g15 != g14] if all(int(v) in lut for v in c)][:40])
    px = np.array([[lut[int(c[2])], lut[int(c[1])], lut[int(c[0])], 128] for c in pick], np.uint8)
    buf = HDR_HEADER % (1, len(px)) + px.tobytes()
    _assert_same(buf)
    np.testing.assert_array_equal(decode_image(buf)[0], pick)
    np.testing.assert_array_equal(decode_mask(buf)[0], (pick @ [3735, 19235, 9798] + (1 << 14)) >> 15)


@functools.lru_cache(maxsize=None)
def _refused_hdr():
    flat = _rgbe(6, 20, 1).tobytes()
    rle = _hdr_cases()["cv2 rle"]
    at = rle.index(b"+X 37\n") + 6
    bad_run = bytearray(rle)
    bad_run[at + 4] = 0
    return {
        "+Y orientation": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 6 +X 20\n" + flat,
                           "resolution line"),
        "-X orientation": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 -X 20\n" + flat,
                           "resolution line"),
        "+X first": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+X 20 -Y 6\n" + flat,
                     "resolution line"),
        "no FORMAT line": (b"#?RADIANCE\n\n-Y 6 +X 20\n" + flat, "FORMAT"),
        "xyze": (b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 6 +X 20\n" + flat, "FORMAT"),
        "crlf FORMAT line": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\r\n\n-Y 6 +X 20\n" + flat,
                             "FORMAT"),
        "two blank lines": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n\n-Y 6 +X 20\n" + flat,
                            "resolution line"),
        "cut": (HDR_HEADER % (6, 20) + flat[:-7], "unexpected end of data"),
        "a run of 0": (bytes(bad_run), "bad scanline data"),
        "a wrong scanline width": (rle[:at + 3] + b"\x26" + rle[at + 4:], "wrong scanline width"),
    }


@pytest.mark.parametrize("case", sorted(_refused_hdr()))
def test_refused_hdr_raise_naming_them(case):
    """What OpenCV's reader refuses (cv2 returns None), by name."""
    buf, words = _refused_hdr()[case]
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        assert _cv2(buf, flag) is None
    for fn in (decode_image, decode_mask):
        with pytest.raises(ValueError, match=f"Radiance HDR: .*{words}"):
            fn(buf)


@pytest.mark.parametrize("case", ["cv2 rle", "cv2 flat", "rle then flat"])
@pytest.mark.parametrize("seed", range(2))
def test_mutated_hdr_match_cv2(case, seed):
    for buf in _mutations(_hdr_cases()[case], seed, 80):
        _assert_as_cv2_or_refused(buf)


# -------------------------------------------------------------------- PFM

def _pfm_samples():
    rng = np.random.RandomState(1)
    img = (rng.randn(13, 17, 3) * 120 + 100).astype(np.float32)
    img[0, :4] = [[0.5, 1.5, 2.5], [254.5, 255.5, -0.5], [300, -3, np.nan],
                  [np.inf, -np.inf, 3.5]]
    img[1, :2] = [[2.1e9, 2147483520.0, 3e9], [-3e9, 1e-40, -1e-40]]
    return img


def _pfm(img, scale=b"-1", big_endian=False):
    h, w = img.shape[:2]
    kind = b"PF" if img.ndim == 3 else b"Pf"
    rows = img[::-1][..., ::-1] if img.ndim == 3 else img[::-1]
    return (kind + b"\n%d %d\n" % (w, h) + scale + b"\n"
            + rows.astype(">f4" if big_endian else "<f4").tobytes())


@functools.lru_cache(maxsize=None)
def _pfm_cases():
    img = _pfm_samples()
    cases = {
        "cv2 colour": cv2.imencode(".pfm", img)[1].tobytes(),
        "cv2 gray": cv2.imencode(".pfm", img[:, :, 1].copy())[1].tobytes(),
        "cv2 [0, 1]": cv2.imencode(".pfm", np.random.RandomState(2).rand(9, 11, 3)
                                   .astype(np.float32))[1].tobytes(),
        "big-endian colour": _pfm(img, b"1", big_endian=True),
        "big-endian gray": _pfm(img[:, :, 0], b"1.0", big_endian=True),
        "little-endian gray": _pfm(img[:, :, 2], b"-1.0"),
    }
    for scale in (b"-3", b"-0.3", b"-2.5", b"-0.7", b"-1e-3", b"-13.37", b"-0x1.8p1", b"-1e400",
                  b"-inf"):
        cases[f"scale {scale.decode()}"] = _pfm(img, scale)
    for name, header in (("width and height on two lines", b"PF\n17\n13\n-1\n"),
                         ("a tab after the scale", b"PF\n17 13\n-1\t"),
                         ("a carriage return after the scale", b"PF\n17 13\n-1\r"),
                         ("numbers with a sign and letters", b"PF\n+17x 013\n-1.5e\n"),
                         ("a width past 32 bits", b"PF\n4294967313 13\n-1\n")):
        cases[name] = header + img[::-1][..., ::-1].astype("<f4").tobytes()
    cases["bytes after the samples"] = cases["cv2 colour"] + b"xyz"
    return cases


@pytest.mark.parametrize("case", sorted(_pfm_cases()))
def test_pfm_equals_cv2(case):
    """saturate_cast<uchar>(x / |scale|) with no x 255 (NaN, infinities and
    values past 2^31 give 0); rows bottom-up; RGB to BGR; the file's
    channels under either flag, as cv2.imdecode keeps them."""
    buf = _pfm_cases()[case]
    _assert_same(buf)
    gray = _cv2(buf, cv2.IMREAD_GRAYSCALE)
    assert gray.shape == _cv2(buf, cv2.IMREAD_COLOR).shape


def test_pfm_channels_stay_the_files_and_the_plane_refuses_them():
    """A "PF" file reads as 3 channels under IMREAD_GRAYSCALE and a "Pf"
    one as 1 under IMREAD_COLOR, as cv2 gives them; the batch plane, which
    needs a 3-channel image and a 1-channel mask, refuses both."""
    colour, gray = _pfm_cases()["cv2 colour"], _pfm_cases()["cv2 gray"]
    assert decode_mask(colour).shape == (13, 17, 3)
    assert decode_image(gray).shape == (13, 17)
    png = cv2.imencode(".png", _photo(13, 17, 1))[1].tobytes()
    with pytest.raises(ValueError, match="sample 0: the mask decodes to 3 channels"):
        batch_preprocess([png], [colour], SIZE, nthreads=1)
    with pytest.raises(ValueError, match="sample 0: the image decodes to 1 channel"):
        batch_preprocess([gray], [png], SIZE, nthreads=1)


@functools.lru_cache(maxsize=None)
def _refused_pfm():
    body = _pfm_samples()[::-1][..., ::-1].astype("<f4").tobytes()
    return {
        "scale 0": (b"PF\n17 13\n0\n" + body, "scale is 0"),
        "scale -0": (b"PF\n17 13\n-0\n" + body, "scale is 0"),
        "scale nan": (b"PF\n17 13\nnan\n" + body, "not a number"),
        "scale abc": (b"PF\n17 13\nabc\n" + body, "scale is 0"),
        "two blanks between numbers": (b"PF\n17  13\n-1\n" + body, "image size"),
        "a blank before the width": (b"PF\n 17 13\n-1\n" + body, "image size"),
        "a negative width": (b"PF\n-17 13\n-1\n" + body, "image size"),
        "no line break after PF": (b"PF 17 13 -1\n" + body, "no line break"),
        "crlf after PF": (b"PF\r\n17 13\n-1\n" + body, "no line break"),
        "a byte past 127 in the header": (b"PF\n17 13\n-1\xb0\n" + body, "byte 0xB0"),
        "cut": (b"PF\n17 13\n-1\n" + body[:-3], "unexpected end of data"),
    }


@pytest.mark.parametrize("case", sorted(_refused_pfm()))
def test_refused_pfm_raise_naming_them(case):
    """What OpenCV's reader refuses (cv2 returns None or raises), by name."""
    buf, words = _refused_pfm()[case]
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        assert _cv2(buf, flag) is None
    for fn in (decode_image, decode_mask):
        with pytest.raises(ValueError, match=f"PFM: .*{words}"):
            fn(buf)


@pytest.mark.parametrize("case", ["cv2 colour", "cv2 gray", "big-endian colour"])
@pytest.mark.parametrize("seed", range(2))
def test_mutated_pfm_match_cv2(case, seed):
    for buf in _mutations(_pfm_cases()[case], seed, 80):
        _assert_as_cv2_or_refused(buf)
