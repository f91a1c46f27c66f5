"""The port's decoder on TIFF, GIF and Sun raster, held bit for bit against
cv2.imdecode (OpenCV 5.0.0, libtiff 4.7.1) under IMREAD_COLOR and
IMREAD_GRAYSCALE, through ``decode_image`` / ``decode_mask`` and through
the batch plane (``_assert_as_cv2``):

- Sun raster: RT_OLD and RT_STANDARD at depths 1, 8, 24 and 32 and odd
  widths (16-bit row padding), with and without an RMT_EQUAL_RGB colormap,
  short colormaps; cv2's own writer.
- GIF: minimum code sizes 2-8, interlace, global and local colour tables
  and no table at all, Graphic Control Extension transparency against the
  background index, a first image smaller than the screen and offset in
  it, LZW streams with clear codes, a deferred clear, no end code, codes
  after the end code and past the image; PIL's writer (interlace,
  transparency, animation); a palette whose gray tells cvtColor's 15-bit
  weights from the readers' 14-bit ones.
- TIFF: built byte by byte in both byte orders: gray, RGB, RGB with
  associated and unassociated alpha, gray with alpha, palette, CMYK and
  YCbCr, at the depths OpenCV takes; strips (the last one ragged), tiles
  (edge tiles cut), planar configuration 2; no compression, LZW, Deflate,
  PackBits and JPEG (with JPEGTables); Predictor 2 at 8 and 16 bits;
  FillOrder 2; Orientation 1-8; YCbCr subsampling and coefficients; the
  first page of a multi-page file; PIL's and cv2's writers.

And the kinds that stay refused, each with a message that names it (and
says that OpenCV reads it where it does).
"""

import io
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from cris_tpu_torch.data import batch_preprocess, decode_image, decode_mask
from test_torch_codec_formats import SIZE, _assert_as_cv2, _cv2, _photo
from test_torch_codec_webp_bmp_pnm import _pil

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_codec_fixtures")


def _pack_bits(rows, bps):
    """(h, n) ints -> rows of bps-bit samples, MSB first, each row padded
    to a byte."""
    rows = np.asarray(rows).reshape(len(rows), -1)
    bits = ((rows[..., None] >> np.arange(bps - 1, -1, -1)) & 1).reshape(len(rows), -1)
    return np.packbits(bits.astype(np.uint8), axis=1).tobytes()


def _pack_codes(codes, sizes):
    """LSB-first codes of the given widths (GIF's order)."""
    acc = nb = 0
    out = bytearray()
    for c, s in zip(codes, sizes):
        acc |= c << nb
        nb += s
        while nb >= 8:
            out.append(acc & 255)
            acc >>= 8
            nb -= 8
    if nb:
        out.append(acc & 255)
    return bytes(out)


# ----------------------------------------------------------- Sun raster

def _ras(width, height, depth, data, kind=1, cmap=b""):
    return struct.pack(">8I", 0x59A66A95, width, height, depth, len(data), kind,
                       1 if cmap else 0, len(cmap)) + cmap + data


def _ras_rows(width, height, depth, seed):
    pitch = ((width * depth + 7) // 8 + 1) & ~1
    return np.random.RandomState(seed).randint(0, 256, pitch * height).astype(np.uint8).tobytes()


@pytest.mark.parametrize("width", [1, 7, 16])
@pytest.mark.parametrize("kind", [0, 1], ids=["RT_OLD", "RT_STANDARD"])
@pytest.mark.parametrize("depth", [1, 8, 24, 32])
def test_sun_raster_equals_cv2(depth, kind, width):
    """Rows padded to 16 bits; 32 bits are X, B, G, R. Without a colormap
    IMREAD_GRAYSCALE of 1 and 8 bits is all zero in OpenCV 5.0."""
    buf = _ras(width, 5, depth, _ras_rows(width, 5, depth, depth + width), kind)
    _assert_as_cv2(buf)
    if depth <= 8:
        assert not decode_mask(buf).any()


@pytest.mark.parametrize("entries", [1, 2, 3, "full"])
@pytest.mark.parametrize("depth", [1, 8])
def test_sun_raster_colormap_equals_cv2(depth, entries):
    """maplength / 3 entries (R plane, G plane, B plane); the rest black."""
    n = (1 << depth) if entries == "full" else min(entries, 1 << depth)
    cmap = np.random.RandomState(n).randint(0, 256, 3 * n).astype(np.uint8).tobytes()
    _assert_as_cv2(_ras(13, 6, depth, _ras_rows(13, 6, depth, n), 1, cmap))


@pytest.mark.parametrize("case", ["colour", "gray", "640x480"])
def test_written_sun_raster_equals_cv2(case):
    img = {"colour": _photo(37, 53, seed=3), "gray": _photo(37, 53, seed=4)[:, :, 0],
           "640x480": _photo(480, 640, seed=5)}[case]
    _assert_as_cv2(cv2.imencode(".ras", np.ascontiguousarray(img))[1].tobytes())


# ------------------------------------------------------------------ GIF

def _gif_lzw(indices, min_size, clear_every=0, no_eoi=False):
    """GIF LZW of the indices (a clear code first; optionally a clear
    every clear_every codes, else a deferred clear at 4096)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    size, nxt, table = min_size + 1, eoi + 1, {}
    codes, sizes = [clear], [size]
    prefix, count = None, 0
    for k in map(int, indices):
        if prefix is None:
            prefix = (k,)
            continue
        if prefix + (k,) in table:
            prefix += (k,)
            continue
        codes.append(table[prefix] if len(prefix) > 1 else prefix[0])
        sizes.append(size)
        count += 1
        if nxt < 4096:
            table[prefix + (k,)] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        prefix = (k,)
        if clear_every and count % clear_every == 0:
            codes.append(clear)
            sizes.append(size)
            size, nxt, table = min_size + 1, eoi + 1, {}
    codes.append(table[prefix] if len(prefix) > 1 else prefix[0])
    sizes.append(size)
    if not no_eoi:
        if nxt < 4096 and nxt + 1 > (1 << size) and size < 12:
            size += 1
        codes.append(eoi)
        sizes.append(size)
    return _pack_codes(codes, sizes)


def _sub_blocks(data):
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def _table_bits(n):
    return max(0, int(np.ceil(np.log2(n))) - 1)


def _gif(screen, frames, palette=None, background=0, version=b"GIF89a"):
    """frames: dicts of idx (h, w), left, top, local (n, 3), interlace,
    transparent, disposal, min_size, raw (LZW bytes in place of idx's)."""
    flags = 0x80 | 0x70 | _table_bits(len(palette)) if palette is not None else 0
    out = version + struct.pack("<HHBBB", screen[1], screen[0], flags, background, 0)
    if palette is not None:
        out += np.asarray(palette, np.uint8).tobytes()
    for f in frames:
        if f.get("transparent") is not None or f.get("disposal"):
            t = f.get("transparent")
            packed = f.get("disposal", 0) << 2 | (t is not None)
            out += b"\x21\xf9\x04" + struct.pack("<BHB", packed, 0, t or 0) + b"\0"
        idx = np.asarray(f["idx"])
        h, w = idx.shape
        local = f.get("local")
        flags = (0x80 | _table_bits(len(local)) if local is not None else 0) | (
            0x40 if f.get("interlace") else 0)
        out += b"\x2c" + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0), w, h, flags)
        if local is not None:
            out += np.asarray(local, np.uint8).tobytes()
        if f.get("interlace"):
            idx = idx[list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4))
                      + list(range(1, h, 2))]
        ms = f.get("min_size", 8)
        raw = f.get("raw")
        if raw is None:
            raw = _gif_lzw(idx.ravel(), ms, **f.get("lzw", {}))
        out += bytes([ms]) + _sub_blocks(raw)
    return out + b"\x3b"


def _palette(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 3))


@pytest.mark.parametrize("interlace", [False, True], ids=["sequential", "interlaced"])
@pytest.mark.parametrize("min_size", range(2, 9))
def test_gif_code_sizes_equal_cv2(min_size, interlace):
    n = 1 << min_size
    idx = np.random.RandomState(min_size).randint(0, n, (23, 29))
    _assert_as_cv2(_gif((23, 29), [dict(idx=idx, min_size=min_size, interlace=interlace)],
                        _palette(n, min_size)))


GIF_SCREENS = {
    # screen, left, top, background, transparent index
    "full, opaque": ((13, 17), 0, 0, 0, None),
    "full, transparent, background 0": ((13, 17), 0, 0, 0, 3),
    "full, transparent, background 5": ((13, 17), 0, 0, 5, 3),
    "offset, opaque, background 7": ((20, 25), 4, 3, 7, None),
    "offset, transparent, background 5": ((20, 25), 8, 7, 5, 9),
    "offset to the corner": ((20, 25), 8, 7, 0, None),
}


@pytest.mark.parametrize("case", sorted(GIF_SCREENS))
def test_gif_transparency_and_screen_equal_cv2(case):
    """Transparent pixels and the screen outside the image take the global
    table's colour at the background index."""
    screen, left, top, background, transparent = GIF_SCREENS[case]
    idx = np.random.RandomState(len(case)).randint(0, 16, (13, 17))
    idx[0, 0] = 3
    _assert_as_cv2(_gif(screen, [dict(idx=idx, left=left, top=top, min_size=4,
                                      transparent=transparent, disposal=2)],
                        _palette(16, 1), background))


GIF_TABLES = {
    "local over global": (_palette(16, 2), _palette(16, 3), None),
    "short local, then global": (_palette(4, 4), _palette(16, 5), None),
    "local only, transparent": (_palette(16, 6), None, 2),
    "no table (OpenCV's default)": (None, None, None),
    "no table, transparent": (None, None, 1),
}


@pytest.mark.parametrize("case", sorted(GIF_TABLES))
def test_gif_colour_tables_equal_cv2(case):
    local, palette, transparent = GIF_TABLES[case]
    idx = np.random.RandomState(7).randint(0, 16, (11, 14))
    _assert_as_cv2(_gif((11, 14), [dict(idx=idx, local=local, min_size=4,
                                        transparent=transparent)], palette))


# (image row, codes, code widths): hand-made streams at minimum code size 2
# (clear 4, end 5) and 4 (clear 16, end 17)
GIF_STREAMS = {
    "no clear code first": ([3, 4, 5], [3, 4, 5, 17], 5),
    "end code, then more pixels": ([3, 4, 5], [16, 3, 4, 17, 5, 17], 5),
    "end code, clear, more pixels": ([3, 4, 3, 4], [16, 3, 4, 17, 16, 3, 4, 17], 5),
    "clear mid-stream": ([3, 4, 3, 4], [16, 3, 4, 16, 3, 4, 17], 5),
    "KwKwK": ([3, 3, 3], [16, 3, 18], 5),
    "codes after the end code, same byte": ([3, 4, 5], [16, 3, 4, 5, 17, 3], 5),
    "end codes after the end code": ([3, 4, 5], [16, 3, 4, 5, 17, 17, 17, 17], 5),
    "pad bits past the image, no end code": ([1, 2], [4, 1, 2], 3),
    "a code past the image in the last byte": ([1, 2, 3], [4, 1, 2, 3, 1], [3, 3, 3, 3, 4]),
    "a string past the image in the last byte": ([1, 2, 3], [4, 1, 2, 3, 6], [3, 3, 3, 3, 4]),
    "two codes past the image, last bytes": ([1, 2, 3, 1], [4, 1, 2, 3, 1, 2, 2],
                                            [3, 3, 3, 3, 4, 4, 4]),
}


@pytest.mark.parametrize("case", sorted(GIF_STREAMS))
def test_gif_lzw_streams_equal_cv2(case):
    row, codes, widths = GIF_STREAMS[case]
    widths = [widths] * len(codes) if isinstance(widths, int) else widths
    min_size = 4 if widths[0] == 5 else 2
    raw = _pack_codes(codes, widths)
    _assert_as_cv2(_gif((1, len(row)), [dict(idx=np.array([row]), min_size=min_size, raw=raw)],
                        _palette(1 << min_size, 8)))


@pytest.mark.parametrize("lzw", [dict(clear_every=7), dict(), dict(no_eoi=True)],
                         ids=["clear every 7 codes", "deferred clear at 4096", "no end code"])
def test_gif_long_streams_equal_cv2(lzw):
    idx = np.random.RandomState(9).randint(0, 256, (64, 64))
    _assert_as_cv2(_gif((64, 64), [dict(idx=idx, lzw=lzw)], _palette(256, 9)))


def _pil_gif(case):
    img = _photo(37, 53, seed=10)[:, :, ::-1]
    if case == "animated":
        frames = [Image.fromarray(_photo(20, 24, seed=s)) for s in range(3)]
        out = io.BytesIO()
        frames[0].save(out, "GIF", save_all=True, append_images=frames[1:], duration=40, loop=0)
        return out.getvalue()
    if case == "gray":
        return _pil(img, "GIF", "L")
    if case == "interlaced, transparent":
        return _pil(img, "GIF", "P", interlace=True, transparency=5)
    if case == "640x480":
        return _pil(_photo(480, 640, seed=11)[:, :, ::-1], "GIF", "P")
    return _pil(img, "GIF", "P", interlace=False)


@pytest.mark.parametrize("case", ["palette", "gray", "interlaced, transparent", "animated",
                                  "640x480"])
def test_pil_written_gif_equals_cv2(case):
    _assert_as_cv2(_pil_gif(case))


@pytest.mark.parametrize("seed", range(4))
def test_mutated_gif_lzw_streams_match_cv2(seed):
    """Valid streams cut short, with bytes appended or a bit flipped: the
    port decodes exactly what cv2 decodes (the same pixels) and refuses
    what cv2 returns None for."""
    rng = np.random.RandomState(seed)
    for _ in range(40):
        min_size = int(rng.choice([2, 4, 8]))
        h, w = rng.randint(1, 12, 2)
        idx = rng.randint(0, min(1 << min_size, int(rng.choice([2, 4, 16, 256]))), (h, w))
        raw = bytearray(_gif_lzw(idx.ravel(), min_size, clear_every=int(rng.choice([0, 5]))))
        mutation = rng.randint(0, 4)
        if mutation == 0 and len(raw) > 1:
            raw = raw[:rng.randint(1, len(raw))]
        elif mutation == 1:
            raw += rng.randint(0, 256, rng.randint(1, 4)).astype(np.uint8).tobytes()
        elif mutation == 2:
            raw[rng.randint(len(raw))] ^= 1 << rng.randint(8)
        buf = _gif((h, w), [dict(idx=idx, min_size=min_size, raw=bytes(raw),
                                 interlace=bool(rng.rand() < 0.3))], _palette(1 << min_size, 2))
        if _cv2(buf, cv2.IMREAD_COLOR) is None:
            with pytest.raises(ValueError, match="GIF: "):
                decode_image(buf)
        else:
            _assert_as_cv2(buf)


def test_gif_gray_is_cvtcolor_not_the_readers_weights():
    """OpenCV 5's GIF reader turns its BGR to gray by cvtColor (15-bit
    weights), not by the 14-bit ones of its BMP / Sun raster readers: every
    colour of this palette tells the two apart."""
    r, g, b = np.meshgrid(np.arange(0, 256, 3), np.arange(0, 256, 5),
                          np.arange(0, 256, 7), indexing="ij")
    r, g, b = r.ravel(), g.ravel(), b.ravel()
    w14 = (b * 1868 + g * 9617 + r * 4899 + 8192) >> 14
    w15 = (b * 3735 + g * 19235 + r * 9798 + 16384) >> 15
    pick = np.random.RandomState(1).choice(np.nonzero(w14 != w15)[0], 256, replace=False)
    buf = _gif((16, 16), [dict(idx=np.arange(256).reshape(16, 16))],
               np.stack([r[pick], g[pick], b[pick]], 1))
    _assert_as_cv2(buf)
    np.testing.assert_array_equal(decode_mask(buf).ravel(), w15[pick])


# ----------------------------------------------------------------- TIFF

_TYPES = {1: "B", 3: "H", 4: "I", 7: "B"}


def _tiff(tags, chunks, order="<", tiles=False):
    """A TIFF of one IFD: tags {tag: (type, values)}, RATIONAL (5) as
    (numerator, denominator) pairs; the strip or tile offsets and byte
    counts are filled in."""
    tags = dict(tags)
    off_tag, count_tag = (324, 325) if tiles else (273, 279)
    tags[off_tag] = (4, [0] * len(chunks))
    tags[count_tag] = (4, [len(c) for c in chunks])

    def encode(kind, values):
        if kind == 5:
            return b"".join(struct.pack(order + "II", *v) for v in values)
        return b"".join(struct.pack(order + _TYPES[kind], v) for v in values)

    start = 8 + 2 + 12 * len(tags) + 4
    where, pos = {}, start
    for tag in sorted(tags):
        size = len(encode(*tags[tag]))
        if size > 4:
            where[tag] = pos
            pos += size + (size & 1)
    offsets = []
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    tags[off_tag] = (4, offsets)
    out = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, 8)
    out += struct.pack(order + "H", len(tags))
    values = b""
    for tag in sorted(tags):
        kind, vals = tags[tag]
        data = encode(kind, vals)
        if len(data) > 4:
            out += struct.pack(order + "HHII", tag, kind, len(vals), where[tag])
            values += data + b"\0" * (len(data) & 1)
        else:
            out += struct.pack(order + "HHI", tag, kind, len(vals)) + data.ljust(4, b"\0")
    return out + struct.pack(order + "I", 0) + values + b"".join(chunks)


def _tiff_lzw(data):
    """TIFF LZW as libtiff writes it: MSB-first codes, one code early."""
    acc = nb = 0
    out, size = bytearray(), 9

    def emit(code):
        nonlocal acc, nb
        acc, nb = acc << size | code, nb + size
        while nb >= 8:
            nb -= 8
            out.append(acc >> nb & 255)
        acc &= (1 << nb) - 1

    def added():
        nonlocal nxt, size, table
        nxt += 1
        if nxt == 4094:
            emit(256)
            table, nxt, size = {bytes([i]): i for i in range(256)}, 258, 9
        elif nxt > (1 << size) - 1:
            size += 1

    table, nxt = {bytes([i]): i for i in range(256)}, 258
    emit(256)
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = nxt
        added()
        w = bytes([ch])
    if w:
        emit(table[w])
        added()
    emit(257)
    if nb:
        out.append(acc << (8 - nb) & 255)
    return bytes(out)


def _packbits(data):
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j + 1] == data[j]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


COMPRESS = {1: lambda b: b, 5: _tiff_lzw, 8: zlib.compress, 32946: zlib.compress,
            32773: _packbits}


def _samples(px, bps, order):
    if bps == 16:
        return px.astype(order + "u2").tobytes()
    if bps == 8:
        return px.astype(np.uint8).tobytes()
    return _pack_bits(px.reshape(len(px), -1), bps)


def _differenced(px, spp, bps):
    rows = px.reshape(len(px), -1).astype(np.int64)
    out = rows.copy()
    out[:, spp:] = (rows[:, spp:] - rows[:, :-spp]) % (1 << bps)
    return out.reshape(px.shape)


def _tiff_image(px, photometric, bps, compression=1, order="<", rows=None, tile=None,
                planar=1, predictor=1, extra=None):
    """px (h, w) or (h, w, spp) samples as strips of `rows` rows or tiles
    of `tile` (w, h)."""
    h, w = px.shape[:2]
    spp = px.shape[2] if px.ndim == 3 else 1
    planes = [px[:, :, i] for i in range(spp)] if planar == 2 else [px]
    chunks = []
    for plane in planes:
        if tile:
            tw, th = tile
            parts = []
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw) + plane.shape[2:], np.int64)
                    cut = plane[y:y + th, x:x + tw]
                    t[:cut.shape[0], :cut.shape[1]] = cut
                    parts.append(t)
        else:
            rows = rows or h
            parts = [plane[y:y + rows] for y in range(0, h, rows)]
        for part in parts:
            if predictor == 2:
                part = _differenced(part, spp if planar == 1 else 1, bps)
            chunks.append(COMPRESS[compression](_samples(part, bps, order)))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if tile:
        tags[322], tags[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        tags[278] = (4, [rows or h])
    if predictor != 1:
        tags[317] = (3, [predictor])
    tags.update(extra or {})
    return _tiff(tags, chunks, order, tiles=bool(tile))


# (photometric, samples a pixel, bits, ExtraSamples): the layouts OpenCV
# reads through libtiff's RGBA interface
TIFF_KINDS = {
    "gray 1-bit": (1, 1, 1, None), "white-is-zero 1-bit": (0, 1, 1, None),
    "gray 8-bit": (1, 1, 8, None), "white-is-zero 8-bit": (0, 1, 8, None),
    "gray 16-bit": (1, 1, 16, None), "white-is-zero 16-bit": (0, 1, 16, None),
    "gray + alpha": (1, 2, 8, 2), "gray 16-bit + alpha": (1, 2, 16, 2),
    "rgb": (2, 3, 8, None), "rgb 16-bit": (2, 3, 16, None),
    "rgba unassociated": (2, 4, 8, 2), "rgba associated": (2, 4, 8, 1),
    "rgba 16-bit unassociated": (2, 4, 16, 2), "rgb + unspecified": (2, 4, 8, 0),
    "rgba, no ExtraSamples": (2, 4, 8, None),
    "palette 1-bit": (3, 1, 1, None), "palette 4-bit": (3, 1, 4, None),
    "palette 8-bit": (3, 1, 8, None), "cmyk": (5, 4, 8, None),
}


def _kind_image(kind, h, w, seed):
    photometric, spp, bps, extra_samples = TIFF_KINDS[kind]
    rng = np.random.RandomState(seed)
    shape = (h, w, spp) if spp > 1 else (h, w)
    px = rng.randint(0, 1 << bps, shape)
    if spp > 1 and extra_samples is not None and bps == 8:
        px[..., -1] = rng.choice([0, 1, 77, 128, 254, 255], (h, w))  # alpha below 255
    extra = {}
    if extra_samples is not None:
        extra[338] = (3, [extra_samples])
    if photometric == 3:
        extra[320] = (3, list(rng.randint(0, 65536, 3 << bps)))
    return px, photometric, bps, extra


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("kind", sorted(TIFF_KINDS))
def test_tiff_strips_equal_cv2(kind, compression, order):
    """Strips of 10 rows of a 37-row image (the last one ragged)."""
    px, photometric, bps, extra = _kind_image(kind, 37, 45, len(kind) + compression)
    _assert_as_cv2(_tiff_image(px, photometric, bps, compression, order, rows=10, extra=extra))


@pytest.mark.parametrize("compression", [5, 8, 1])
@pytest.mark.parametrize("kind", sorted(TIFF_KINDS))
def test_tiff_tiles_equal_cv2(kind, compression):
    """Tiles cut at the right and bottom edges (cv2.imdecode takes
    uncompressed tiles only in multiples of 1024 bytes: 32 wide and tall
    enough there). libtiff's gray putters read a right-edge tile's rows
    from skewed offsets at 16 bits or with alpha, and so does the port."""
    px, photometric, bps, extra = _kind_image(kind, 37, 45, len(kind))
    bits = bps * (px.shape[2] if px.ndim == 3 else 1)
    tile = (16, 32) if compression != 1 else (32, 32 if bits >= 8 else 256 // bits)
    _assert_as_cv2(_tiff_image(px, photometric, bps, compression, tile=tile, extra=extra))


@pytest.mark.parametrize("tile", [(12, 16), (20, 8), (6, 6)], ids=str)
@pytest.mark.parametrize("kind", ["gray 1-bit", "white-is-zero 1-bit", "palette 1-bit",
                                  "palette 4-bit"])
def test_sub_byte_tiff_tiles_off_whole_bytes_equal_cv2(kind, tile):
    """1- and 4-bit tiles whose rows are padded bits: each tile lands at
    its bit position, and libtiff's putters step over a right-edge tile's
    hidden columns by their whole bytes, short of the padded row."""
    px, photometric, bps, extra = _kind_image(kind, 37, 45, len(kind) + tile[0])
    _assert_as_cv2(_tiff_image(px, photometric, bps, 5, tile=tile, extra=extra))


@pytest.mark.parametrize("tiled", [False, True], ids=["strips", "tiles"])
@pytest.mark.parametrize("kind", ["rgb", "rgb 16-bit", "rgba unassociated",
                                  "rgba 16-bit unassociated", "gray + alpha", "cmyk"])
def test_planar_tiff_equals_cv2(kind, tiled):
    """PlanarConfiguration 2: libtiff's separate putters (gray planes as
    RGB, unassociated alpha premultiplied, 16 bits rounded)."""
    px, photometric, bps, extra = _kind_image(kind, 37, 45, 3 + len(kind))
    _assert_as_cv2(_tiff_image(px, photometric, bps, 5, rows=None if tiled else 10,
                               tile=(16, 16) if tiled else None, planar=2, extra=extra))


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("compression", [5, 8])
@pytest.mark.parametrize("layout", ["gray 8", "gray 16", "rgb 8", "rgb 16", "rgba 16 planar"])
def test_tiff_predictor_2_equals_cv2(layout, compression, order):
    spp = 1 if "gray" in layout else 4 if "rgba" in layout else 3
    bps = int(layout.split()[1])
    rng = np.random.RandomState(spp * bps)
    px = rng.randint(0, 1 << bps, (23, 37, spp) if spp > 1 else (23, 37))
    extra = {338: (3, [2])} if spp == 4 else None
    _assert_as_cv2(_tiff_image(px, 1 if spp == 1 else 2, bps, compression, order, rows=7,
                               planar=2 if "planar" in layout else 1, predictor=2,
                               extra=extra))


@pytest.mark.parametrize("tiled", [False, True], ids=["strips", "tiles"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_equals_cv2(orientation, tiled):
    """The Orientation tag: for strips as OpenCV's ApplyExifOrientation
    applies it to the stored image; for tiles libtiff mirrors each tile in
    place (orientations 2, 3, 6 and 7)."""
    px = _photo(30, 40, seed=orientation)[:, :, ::-1]
    buf = _tiff_image(px, 2, 8, 5, rows=None if tiled else 7, tile=(16, 16) if tiled else None,
                      extra={274: (3, [orientation])})
    ref = _assert_as_cv2(buf)
    assert ref.shape[:2] == ((40, 30) if orientation >= 5 else (30, 40))


def _ycbcr_blocks(y, cb, cr, hs, vs):
    out = bytearray()
    for by in range(cb.shape[0]):
        for bx in range(cb.shape[1]):
            out += y[by * vs:(by + 1) * vs, bx * hs:(bx + 1) * hs].astype(np.uint8).tobytes()
            out += bytes([cb[by, bx], cr[by, bx]])
    return bytes(out)


def _ycbcr_tiff(sub, layout, compression, predictor=1):
    """Random hs x vs YCbCr blocks, 37 rows, as strips or 16 x 16 tiles."""
    hs, vs = map(int, sub.split("x"))
    h, w = 37, 45 if hs < 4 else 40  # 4x4 needs an even number of blocks a row
    rng = np.random.RandomState(hs * 10 + vs)
    tiles = layout == "tiles"
    cw, ch = (16, 16) if tiles else (w, 6 if layout == "strips of 6" else h)
    chunks = []
    for y in range(0, h, ch):
        for _ in range(0, w, cw):
            rows = ch if tiles else min(ch, h - y)
            bh, bw = -(-rows // vs), -(-cw // hs)
            blocks = _ycbcr_blocks(rng.randint(0, 256, (bh * vs, bw * hs)),
                                   rng.randint(0, 256, (bh, bw)), rng.randint(0, 256, (bh, bw)),
                                   hs, vs)
            chunks.append(COMPRESS[compression](blocks))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * 3), 259: (3, [compression]),
            262: (3, [6]), 277: (3, [3]), 530: (3, [hs, vs])}
    if tiles:
        tags[322], tags[323] = (3, [16]), (3, [16])
    else:
        tags[278] = (4, [ch])
    if predictor != 1:
        tags[317] = (3, [predictor])
    return _tiff(tags, chunks, tiles=tiles)


YCBCR_SUBSAMPLING = ["1x1", "2x1", "2x2", "4x1", "4x2", "1x2", "4x4"]


@pytest.mark.parametrize("layout", ["strips of 6", "one strip", "tiles"])
@pytest.mark.parametrize("sub", YCBCR_SUBSAMPLING)
def test_uncompressed_ycbcr_tiff_equals_cv2(sub, layout):
    """libtiff's own YCbCr conversion, each chroma sample covering its
    block; LZW for the tiles."""
    _assert_as_cv2(_ycbcr_tiff(sub, layout, 5 if layout == "tiles" else 1))


@pytest.mark.parametrize("compression", [5, 8])
@pytest.mark.parametrize("layout", ["strips of 6", "tiles"])
@pytest.mark.parametrize("sub", YCBCR_SUBSAMPLING)
def test_ycbcr_tiff_predictor_2_equals_cv2(sub, layout, compression):
    """Predictor 2 on subsampled YCbCr: libtiff differences block rows
    over vs (strips) or rows of 3 x the tile's width (tiles) and leaves
    chunks that are not whole such rows undifferenced."""
    _assert_as_cv2(_ycbcr_tiff(sub, layout, compression, predictor=2))


def _rational(values):
    return (5, [(int(round(v * 1000)), 1000) for v in values])


@pytest.mark.parametrize("case", ["Rec. 709 luma", "studio range", "fractional range",
                                  "planar 1x1"])
def test_ycbcr_tiff_coefficients_equal_cv2(case):
    """YCbCrCoefficients and ReferenceBlackWhite as RATIONAL, through
    libtiff's float tables."""
    rng = np.random.RandomState(len(case))
    y, cb, cr = (rng.randint(0, 256, (8, 10)) for _ in range(3))
    tags = {256: (4, [10]), 257: (4, [8]), 258: (3, [8] * 3), 259: (3, [1]), 262: (3, [6]),
            277: (3, [3]), 278: (4, [8]), 530: (3, [1, 1])}
    chunks = [_ycbcr_blocks(y, cb, cr, 1, 1)]
    if case == "Rec. 709 luma":
        tags[529] = _rational([0.2125, 0.7154, 0.0721])
    elif case == "studio range":
        tags[532] = _rational([16, 235, 128, 240, 128, 240])
    elif case == "fractional range":
        tags[532] = _rational([15.5, 235.25, 127.5, 240, 128, 239.5])
    else:
        tags[284] = (3, [2])
        chunks = [p.astype(np.uint8).tobytes() for p in (y, cb, cr)]
    _assert_as_cv2(_tiff(tags, chunks))


def _jpeg_parts(jpeg):
    """A JPEG file -> (a tables-only stream of its DQT / DHT, the stream
    without them), as a TIFF writer splits it."""
    pos, tables, rest = 2, b"\xff\xd8", b"\xff\xd8"
    while jpeg[pos + 1] != 0xDA:
        size = struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        segment = jpeg[pos:pos + 2 + size]
        if jpeg[pos + 1] in (0xDB, 0xC4):
            tables += segment
        elif jpeg[pos + 1] in (0xC0, 0xC1, 0xC2, 0xDD):
            rest += segment
        pos += 2 + size
    return tables + b"\xff\xd9", rest + jpeg[pos:]


JPEG_TIFFS = {
    # photometric, PIL subsampling, tiles, RGB-coded
    "ycbcr 4:2:0 strips": (6, 2, False, False), "ycbcr 4:2:0 tiles": (6, 2, True, False),
    "ycbcr 4:4:4 strips": (6, 0, False, False), "ycbcr 4:2:2 tiles": (6, 1, True, False),
    "rgb strips": (2, 0, False, True), "rgb tiles": (2, 0, True, True),
    "gray strips": (1, 0, False, False),
}


@pytest.mark.parametrize("case", sorted(JPEG_TIFFS))
def test_jpeg_tiff_equals_cv2(case):
    """Compression 7: the JPEGTables stream, then a JPEG stream a strip or
    tile; YCbCr through libjpeg's conversion, RGB and gray as coded."""
    photometric, sub, tiled, keep_rgb = JPEG_TIFFS[case]
    h, w = 37, 45
    img = _photo(h, w, seed=len(case))[:, :, ::-1]
    img = img[:, :, 0] if photometric == 1 else img
    tw, th = (16, 16) if tiled else (w, 8)
    chunks = []
    for y in range(0, h, th):
        for x in range(0, w if tiled else 1, tw):
            part = img[y:y + th, x:x + tw] if tiled else img[y:y + th]
            if tiled:
                full = np.zeros((th, tw) + img.shape[2:], np.uint8)
                full[:part.shape[0], :part.shape[1]] = part
                part = full
            kw = dict(subsampling=sub, keep_rgb=keep_rgb) if photometric != 1 else {}
            tables, stream = _jpeg_parts(_pil(part, "JPEG", quality=80, **kw))
            chunks.append(stream)
    spp = 1 if photometric == 1 else 3
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [7]),
            262: (3, [photometric]), 277: (3, [spp]), 347: (7, list(tables))}
    if photometric == 6:
        tags[530] = (3, {2: [2, 2], 1: [2, 1], 0: [1, 1]}[sub])
    if tiled:
        tags[322], tags[323] = (3, [tw]), (3, [th])
    else:
        tags[278] = (4, [th])
    _assert_as_cv2(_tiff(tags, chunks, tiles=tiled))


PIL_TIFFS = [(c, m) for c in ("raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
                              "packbits")
             for m in ("RGB", "L", "P", "RGBA", "1", "CMYK", "LA", "I;16", "YCbCr")] + [
    ("jpeg", m) for m in ("RGB", "L", "YCbCr", "CMYK")]


@pytest.mark.parametrize("compression, mode", PIL_TIFFS)
def test_pil_written_tiff_equals_cv2(compression, mode):
    img = _photo(37, 53, seed=12)[:, :, ::-1]
    if mode == "I;16":
        im = Image.fromarray(img[:, :, 0].astype(np.uint16) * 257)
    else:
        im = Image.fromarray(img).convert(mode)
    if mode == "RGBA":
        im.putalpha(Image.fromarray((np.arange(37 * 53).reshape(37, 53) * 7 % 256)
                                    .astype(np.uint8)))
    out = io.BytesIO()
    im.save(out, "TIFF", compression=compression)
    _assert_as_cv2(out.getvalue())


@pytest.mark.parametrize("params", [[], [cv2.IMWRITE_TIFF_COMPRESSION, 1],
                                    [cv2.IMWRITE_TIFF_COMPRESSION, 8],
                                    [cv2.IMWRITE_TIFF_COMPRESSION, 32773],
                                    [cv2.IMWRITE_TIFF_PREDICTOR, 2]],
                         ids=["default", "none", "deflate", "packbits", "predictor"])
@pytest.mark.parametrize("image", ["bgr", "gray", "16-bit", "bgra"])
def test_cv2_written_tiff_equals_cv2(image, params):
    img = _photo(37, 53, seed=13)
    img = {"bgr": img, "gray": img[:, :, 0], "16-bit": img.astype(np.uint16) * 200,
           "bgra": np.dstack([img, img[:, :, :1]])}[image]
    _assert_as_cv2(cv2.imencode(".tiff", np.ascontiguousarray(img), params)[1].tobytes())


def _reverse_bits(data):
    return bytes(int(f"{b:08b}"[::-1], 2) for b in data)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("bps", [1, 8])
def test_fill_order_2_tiff_equals_cv2(bps, compression):
    """FillOrder 2: the stored bytes' bits reversed (libtiff undoes it
    before decoding)."""
    px = np.random.RandomState(bps + compression).randint(0, 1 << bps, (9, 21))
    tags = {256: (4, [21]), 257: (4, [9]), 258: (3, [bps]), 259: (3, [compression]),
            262: (3, [1]), 277: (3, [1]), 278: (4, [9]), 266: (3, [2])}
    _assert_as_cv2(_tiff(tags, [_reverse_bits(COMPRESS[compression](_samples(px, bps, "<")))]))


@pytest.mark.parametrize("case", ["multi-page, first page", "signed 8-bit", "signed 16-bit rgb",
                                  "rgba 640x480, LZW, predictor 2"])
def test_other_tiffs_equal_cv2(case):
    rng = np.random.RandomState(len(case))
    if case.startswith("multi-page"):
        frames = [Image.fromarray(_photo(20, 30, seed=s)) for s in range(3)]
        out = io.BytesIO()
        frames[0].save(out, "TIFF", save_all=True, append_images=frames[1:],
                       compression="tiff_lzw")
        buf = out.getvalue()
    elif case.startswith("signed"):
        bps, spp = (8, 1) if "8" in case else (16, 3)
        px = rng.randint(0, 1 << bps, (6, 10, spp) if spp > 1 else (6, 10))
        buf = _tiff_image(px, 1 if spp == 1 else 2, bps, extra={339: (3, [2] * spp)})
    else:
        px = np.dstack([_photo(480, 640, seed=14)[:, :, ::-1],
                        rng.randint(0, 256, (480, 640))])
        buf = _tiff_image(px, 2, 8, 5, rows=16, predictor=2, extra={338: (3, [2])})
    _assert_as_cv2(buf)


# ------------------------------------------------------------- refusals

def _one_strip(compression=1, photometric=1, bps=8, spp=1, extra=None, data=None):
    tags = {256: (4, [10]), 257: (4, [6]), 258: (3, [bps] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 278: (4, [6])}
    tags.update(extra or {})
    n = ((10 * bps * spp + 7) // 8) * 6
    data = data if data is not None else np.random.RandomState(n).randint(
        0, 256, n).astype(np.uint8).tobytes()
    return _tiff(tags, [data])


def _group4():
    return _pil(_photo(16, 16, seed=1), "TIFF", "1", compression="group4")


def _lzw_without_clear():
    bits = "".join(f"{b:08b}" for b in _tiff_lzw(bytes(range(60))))[9:]
    bits += "0" * (-len(bits) % 8)
    return _one_strip(5, data=bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)))


# each case: the bytes, the words of the message, and whether cv2 decodes it
REFUSED = {
    "tiff CCITT Group 4": (_group4, r"CCITT Group 4 fax .*\(OpenCV reads it\)", True),
    "tiff CCITT Group 3": (lambda: _pil(_photo(16, 16, seed=1), "TIFF", "1",
                                        compression="group3"),
                           r"CCITT Group 3 fax .*\(OpenCV reads it\)", True),
    "tiff CCITT RLE": (lambda: _one_strip(2, bps=1),
                       r"CCITT modified Huffman RLE .*\(OpenCV reads it\)", True),
    "tiff old-style JPEG": (lambda: _one_strip(6), "old-style JPEG", False),
    "tiff LogLuv": (lambda: _one_strip(34676, 32845, 8, 3), r"SGILog .*\(OpenCV reads it\)",
                    True),
    "tiff JBIG": (lambda: _one_strip(34661), "JBIG", False),
    "tiff LZMA": (lambda: _one_strip(34925), "LZMA", False),
    "tiff ZSTD": (lambda: _one_strip(50000), "ZSTD", False),
    "tiff WebP": (lambda: _one_strip(50001), "WebP", False),
    "tiff unknown compression": (lambda: _one_strip(99), "compression 99 .*all-zero", True),
    "tiff BigTIFF": (lambda: b"II+\x00\x08\x00\x00\x00" + bytes(40),
                     r"BigTIFF .*\(OpenCV reads it\)", False),
    "tiff 32-bit float": (lambda: _one_strip(bps=32, extra={339: (3, [3])}), "32-bit samples",
                          False),
    "tiff 32-bit unsigned": (lambda: _one_strip(bps=32), "32-bit samples", False),
    "tiff 16-bit float": (lambda: _one_strip(bps=16, extra={339: (3, [3])}), "floating-point",
                          False),
    "tiff 12-bit": (lambda: _one_strip(bps=12), "12-bit samples", False),
    "tiff 2-bit gray": (lambda: _one_strip(bps=2), "2 bits per sample", False),
    "tiff 4-bit gray": (lambda: _one_strip(bps=4), "4 bits per sample without a palette", False),
    "tiff 2-bit palette": (lambda: _one_strip(photometric=3, bps=2,
                                              extra={320: (3, list(range(12)))}),
                           "2 bits per sample", False),
    "tiff 16-bit palette": (lambda: _one_strip(photometric=3, bps=16,
                                               extra={320: (3, [7] * (3 << 16))}),
                            r"16-bit palette .*OpenCV 5.0 refuses it too", False),
    "tiff 5 samples": (lambda: _one_strip(photometric=2, spp=5, extra={338: (3, [2, 0])}),
                       "5 samples per pixel", False),
    "tiff CIELab": (lambda: _one_strip(photometric=8, spp=3), r"CIELab .*\(OpenCV reads it\)",
                    True),
    "tiff InkSet 2": (lambda: _one_strip(photometric=5, spp=4, extra={332: (3, [2])}),
                      "InkSet 2", False),
    "tiff uncompressed 16 x 16 tiles": (
        lambda: _tiff_image(np.zeros((20, 20)), 1, 8, tile=(16, 16)),
        "not a multiple of 1024 bytes", False),
    "tiff YCbCr 4x4, odd blocks a row": (
        lambda: _tiff({256: (4, [4]), 257: (4, [4]), 258: (3, [8] * 3), 259: (3, [1]),
                       262: (3, [6]), 277: (3, [3]), 278: (4, [4]), 530: (3, [4, 4])},
                      [bytes(18)]), "YCbCr subsampling 4x4", True),
    "tiff LZW without a clear code": (_lzw_without_clear, "do not start with a clear code",
                                      True),
    "tiff LZW cut short": (lambda: _one_strip(5, data=_tiff_lzw(bytes(range(60)))[:30]),
                           r"LZW data end .*part-filled", True),
    "gif truncated LZW": (lambda: _gif((20, 30), [dict(
        idx=np.zeros((20, 30), int), min_size=4, raw=_gif_lzw(np.zeros(100, int), 4))],
        _palette(16, 1)), "LZW data end before the image", False),
    "gif cut": (lambda: _pil_gif("palette")[:-40], "unexpected end of data", False),
    "gif without a trailer": (lambda: _pil_gif("palette")[:-1], "unexpected end of data", False),
    "gif a string past the image": (lambda: _gif((1, 3), [dict(
        idx=np.zeros((1, 3), int), min_size=4, raw=_pack_codes([16, 3, 4, 18, 17], [5] * 5))],
        _palette(16, 1)), "more LZW data than the image holds", False),
    "gif bytes past the end code": (lambda: _gif((1, 3), [dict(
        idx=np.zeros((1, 3), int), min_size=4,
        raw=_pack_codes([16, 3, 4, 5, 17], [5] * 5) + b"\0")], _palette(16, 1)),
        "more LZW data than the image holds", False),
    "gif colour index outside the tables": (lambda: _gif((9, 11), [dict(
        idx=np.full((9, 11), 9), min_size=4, local=_palette(4, 1))], None),
        "colour index 9 is outside", False),
    "gif background index outside the table": (lambda: _gif((4, 4), [dict(
        idx=np.zeros((4, 4), int), min_size=2)], _palette(4, 1), background=7),
        "background index 7", False),
    "gif image outside the screen": (lambda: _gif((4, 4), [dict(
        idx=np.zeros((4, 4), int), min_size=2, left=1)], _palette(4, 1)),
        "does not lie inside the logical screen", False),
    "gif disposal 4": (lambda: _gif((4, 4), [dict(idx=np.zeros((4, 4), int), min_size=2,
                                                  disposal=4)], _palette(4, 1)),
                       "disposal method 4", False),
    "gif minimum code size 1": (lambda: _gif((1, 2), [dict(
        idx=np.zeros((1, 2), int), min_size=1, raw=_pack_codes([2, 0, 1, 3], [2] * 4))],
        _palette(4, 1)), "LZW minimum code size 1", False),
    "sun raster RLE": (lambda: _ras(4, 3, 8, bytes(range(1, 13)), kind=2),
                       "RT_BYTE_ENCODED", False),
    "sun raster RT_FORMAT_RGB": (lambda: _ras(4, 3, 24, bytes(36), kind=3), "RT_FORMAT_RGB",
                                False),
    "sun raster depth 4": (lambda: _ras(4, 3, 4, bytes(12)), "depth 4", False),
    "sun raster colormap at 24 bits": (lambda: _ras(4, 3, 24, bytes(24), cmap=bytes(6)),
                                       "colormap type 1", False),
    "sun raster truncated": (lambda: _ras(5, 3, 8, bytes(13)), "unexpected end of data", False),
    # the values TIFFReadDirectory refuses as it reads the directory
    "tiff PlanarConfiguration 3": (
        lambda: _one_strip(photometric=2, spp=3, extra={284: (3, [3])}),
        "PlanarConfiguration 3 .*libtiff refuses", False),
    "tiff RowsPerStrip 0": (lambda: _one_strip(extra={278: (4, [0])}),
                            "RowsPerStrip 0 .*libtiff refuses", False),
    "tiff ExtraSamples value 3": (
        lambda: _one_strip(photometric=2, spp=4, extra={338: (3, [3])}),
        "ExtraSamples value 3 .*libtiff refuses", False),
    "tiff TileDepth 0": (
        lambda: _tiff({256: (4, [16]), 257: (4, [16]), 258: (3, [8]), 259: (3, [1]),
                       262: (3, [1]), 277: (3, [1]), 322: (3, [16]), 323: (3, [16]),
                       32998: (3, [0])}, [bytes(256)], tiles=True),
        "TileDepth 0 .*libtiff refuses", False),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_tiff_gif_ras_raise_naming_them(case):
    """Each raises ValueError naming it, under both flags and in the plane;
    where OpenCV decodes the file the message says so, and where cv2
    returns None the test checks that it does."""
    make, words, cv2_reads = REFUSED[case]
    buf = make()
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        assert (_cv2(buf, flag) is not None) == cv2_reads
    with pytest.raises(ValueError, match=words):
        decode_image(buf)
    with pytest.raises(ValueError, match=words):
        decode_mask(buf)
    with pytest.raises(ValueError, match=f"sample 0: .*{words}"):
        batch_preprocess([buf], [buf], SIZE, nthreads=1)


def _single_valued_tags(buf):
    """(entry offset, tag, type, byte order) of each SHORT or LONG tag of
    the first IFD with one value."""
    order = "<" if buf[:2] == b"II" else ">"
    ifd = struct.unpack(order + "I", buf[4:8])[0]
    for k in range(struct.unpack(order + "H", buf[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * k
        tag, kind, count = struct.unpack(order + "HHI", buf[at:at + 8])
        if count == 1 and kind in (3, 4):
            yield at, tag, kind, order


SWEPT_TIFFS = ["palette_deflate_160x120.tif", "rgba_unassoc_160x120.tif",
               "tiled_planar_160x120.tif"]


@pytest.mark.parametrize("name", SWEPT_TIFFS)
def test_single_valued_tags_swept_against_cv2(name):
    """Every single-valued tag of the 160 x 120 TIFF fixtures set to each
    of 0..11: the port reads no file that cv2 refuses, and decodes none to
    other pixels (it may refuse, by name, a file that cv2 reads)."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        buf = f.read()
    bad = []
    for at, tag, kind, order in _single_valued_tags(buf):
        for value in range(12):
            b = bytearray(buf)
            if kind == 3:
                b[at + 8:at + 10] = struct.pack(order + "H", value)
            else:
                b[at + 8:at + 12] = struct.pack(order + "I", value)
            b = bytes(b)
            for flag, decode in ((cv2.IMREAD_COLOR, decode_image),
                                 (cv2.IMREAD_GRAYSCALE, decode_mask)):
                ref = _cv2(b, flag)
                try:
                    got = decode(b)
                except ValueError:
                    continue
                if ref is None or got.shape != ref.shape or (got != ref).any():
                    bad.append((tag, value, flag, ref is None))
    assert not bad, bad
