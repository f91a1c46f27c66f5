"""Damaged JPEG and PNG uploads decode as cv2.imdecode (OpenCV 5.0.0:
libjpeg-turbo 3.1.2 with its SIMD inverse DCT, libpng 1.6, libtiff 4.7)
decodes them, with no tolerance: the port's JPEG decoder takes the
warning-level recovery of libjpeg-turbo (a run past the last coefficient,
a bad Huffman code, data that runs into a marker, RSTn missing or out of
order, bytes before a marker, a one-pass file's faults after its scan),
and refuses where cv2 gives None; a PNG whose Adler-32 fails after every
row is in is read as libpng reads it. Each copy goes through
``decode_image`` and ``decode_mask`` against both flags of cv2; the
committed cases of ``torch_codec_fixtures/damaged.json`` (which
``chip_smoke.py`` decodes on the card's host) also through the batch
plane, and JPEG-in-TIFF through the TIFF reader.
"""

import hashlib
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from cris_tpu_torch.data import batch_preprocess, decode_image, decode_mask
from cris_tpu_torch.data.transforms import (get_transform_mats,
                                            normalize_image, warp_image,
                                            warp_mask)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_codec_tiff_gif_ras import _jpeg_parts, _pil, _tiff  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_codec_fixtures")
COPIES = 300
# the fixture swept and the numpy seed of its copies
SEEDS = {"baseline_420_640x480.jpg": 0, "progressive_420_640x480.jpg": 1,
         "cmyk_160x120.jpg": 2, "rgba_160x120.png": 3}
# the progressive copies that cv2 reads and the port refuses, each for a
# cause still queued (ROADMAP §1 item 3.2: libjpeg's block smoothing of
# coefficients that the damaged scans left approximate); none in this
# sweep, about 1 in 1500 copies under other seeds
PROGRESSIVE_REFUSED_AT_MOST = 0
QUEUED = "which libjpeg would smooth"
PLANE_SIZE = 48  # the batch plane's input size in the committed cases
FLAGS = {"color": (cv2.IMREAD_COLOR, decode_image),
         "gray": (cv2.IMREAD_GRAYSCALE, decode_mask)}


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def damaged_copies(buf, seed, n=COPIES, start=700):
    """n copies of buf, each with 1, 2 or 4 bytes at or past ``start``
    XORed with a nonzero byte: [(edits [(offset, xor)], bytes)]."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rs.choice([1, 2, 4])
        offsets = rs.randint(start, len(buf), k)
        xors = rs.randint(1, 256, k)
        out.append((list(zip(offsets.tolist(), xors.tolist())),
                    apply_edits(buf, zip(offsets, xors))))
    return out


def idat_flips(buf, seed, n=COPIES):
    """n copies of a PNG, each with 1, 2 or 4 bytes of its IDAT payloads
    XORed with a nonzero byte and every IDAT CRC repaired."""
    idats, pos = [], 8
    while pos < len(buf):
        length = struct.unpack(">I", buf[pos:pos + 4])[0]
        if buf[pos + 4:pos + 8] == b"IDAT":
            idats.append((pos, length))
        pos += 12 + length
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        edits = []
        for _ in range(rs.choice([1, 2, 4])):
            at, length = idats[rs.randint(len(idats))]
            edits.append((at + 8 + int(rs.randint(0, length)),
                          int(rs.randint(1, 256))))
        out.append((edits, repair_idat_crcs(apply_edits(buf, edits))))
    return out


def apply_edits(buf, edits):
    b = bytearray(buf)
    for offset, xor in edits:
        b[int(offset)] ^= int(xor)
    return bytes(b)


def repair_idat_crcs(buf):
    b, pos = bytearray(buf), 8
    while pos < len(b):
        length = struct.unpack(">I", b[pos:pos + 4])[0]
        if b[pos + 4:pos + 8] == b"IDAT":
            b[pos + 8 + length:pos + 12 + length] = struct.pack(
                ">I", zlib.crc32(bytes(b[pos + 4:pos + 8 + length])))
        pos += 12 + length
    return bytes(b)


def case_bytes(case):
    """A committed case's bytes: its fixture with its edits (and, for a
    PNG, its IDAT CRCs repaired)."""
    buf = apply_edits(_read(case["fixture"]), case["edits"])
    return repair_idat_crcs(buf) if case["fixture"].endswith(".png") else buf


def plane_digest(buf):
    """The sha256 of the batch plane's image and mask of buf, as the card
    reproduces it."""
    images, masks, _, _ = batch_preprocess([buf], [buf], PLANE_SIZE,
                                           nthreads=1)
    return hashlib.sha256(images[0].tobytes() + masks[0].tobytes()).hexdigest()


def _cv2(buf, flag):
    return cv2.imdecode(np.frombuffer(buf, np.uint8), flag)


def _outcome(buf, flag, decode):
    """'same' (both decode to the same pixels, or both refuse), or what
    differs."""
    ref = _cv2(buf, flag)
    try:
        got, err = decode(buf), None
    except ValueError as e:
        got, err = None, str(e)
    if ref is None:
        return "same" if got is None else "the port reads what cv2 refuses"
    if got is None:
        return "refused: " + err
    if got.shape != ref.shape or (got != ref).any():
        return "different pixels"
    return "same"


@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("name", sorted(SEEDS))
def test_damaged_copies_decode_as_cv2(name, flag):
    """300 seeded copies: none decodes to other pixels than cv2's, none is
    read where cv2 gives None, and none is refused where cv2 reads it, but
    for the progressive copies left to block smoothing."""
    buf = _read(name)
    copies = (idat_flips(buf, SEEDS[name]) if name.endswith(".png")
              else damaged_copies(buf, SEEDS[name]))
    bad, refused = [], []
    for edits, data in copies:
        outcome = _outcome(data, *FLAGS[flag])
        if outcome.startswith("refused"):
            refused.append((edits, outcome))
        elif outcome != "same":
            bad.append((edits, outcome))
    assert not bad, bad[:5]
    if name.startswith("progressive"):
        assert all(QUEUED in why for _, why in refused), refused
        assert len(refused) <= PROGRESSIVE_REFUSED_AT_MOST, refused
    else:
        assert not refused, refused[:5]


def _restart_jpeg():
    img = np.random.RandomState(5).randint(0, 256, (48, 64, 3)).astype(np.uint8)
    img = cv2.GaussianBlur(img, (5, 5), 2)
    return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                      cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1].tobytes()


def _rst_at(buf, n):
    """The offset of the n-th RSTm marker."""
    at = [i for i in range(len(buf) - 1)
          if buf[i] == 0xFF and 0xD0 <= buf[i + 1] <= 0xD7]
    return at[n]


def _dqt_precision_2(buf):
    """buf with its first DQT table rewritten as 16-bit values under a
    precision nibble of 2."""
    at = buf.index(b"\xff\xdb")
    length = struct.unpack(">H", buf[at + 2:at + 4])[0]
    values = buf[at + 5:at + 5 + 64]
    seg = (b"\xff\xdb" + struct.pack(">H", 2 + 1 + 128) + bytes([0x20 | buf[at + 4] & 15])
           + b"".join(struct.pack(">H", v) for v in values))
    return buf[:at] + seg + buf[at + 2 + length:]


def _named():
    base = _read("baseline_420_640x480.jpg")
    prog = _read("progressive_420_640x480.jpg")
    rst = _restart_jpeg()
    stuffed = base.index(b"\xff\x00", 1000)
    sos = base.index(b"\xff\xda")
    mid = len(base) // 2
    r3 = _rst_at(rst, 3)
    dht = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xc4"][3]
    return {
        # the islow IDCT's 16-bit lanes: libjpeg-turbo's SIMD saturates
        # an output that jidctint.c's range-limit table would wrap
        "fault 4: the SIMD IDCT's saturation": apply_edits(base, [(32080, 0x37 ^ 0x0D)]),
        "data runs into EOI mid-scan, the rest decodes from zeros":
            base[:mid] + b"\xff\xd9",
        "data runs into a marker, the file goes on": base[:mid] + b"\xff\x02" + base[mid:],
        "0xFF 0xFF 0x00 is one 0xFF byte": base[:stuffed] + b"\xff" + base[stuffed:],
        "the EOI replaced by another marker": base[:-2] + b"\xff\x02",
        "the EOI replaced by an RST marker": base[:-2] + b"\xff\xd0",
        "no EOI, 7 bytes after the scan: no fill reaches the end":
            base[:-2] + bytes(range(1, 8)),
        "no EOI, 6 bytes after the scan: a fill reaches the end, cv2 refuses":
            base[:-2] + bytes(range(1, 7)),
        "a sequential scan's Ss of 5 (libjpeg warns)":
            apply_edits(base, [(sos + 2 + 2 + 1 + 6, 5)]),
        "an RST marker missing": rst[:r3] + rst[r3 + 2:],
        "an RST marker one ahead": apply_edits(rst, [(r3 + 1, (rst[r3 + 1] ^ (
            0xD0 + ((rst[r3 + 1] - 0xD0 + 1) & 7))))]),
        "an RST marker two behind": apply_edits(rst, [(r3 + 1, (rst[r3 + 1] ^ (
            0xD0 + ((rst[r3 + 1] - 0xD0 - 2) & 7))))]),
        "an RST marker replaced by EOI": apply_edits(rst, [(r3 + 1, rst[r3 + 1] ^ 0xD9)]),
        "junk bytes before an RST marker": rst[:r3] + b"\x12\x34\x56" + rst[r3:],
        "a DNL segment between progressive scans":
            prog[:dht] + b"\xff\xdc\x00\x04\x01\xe0" + prog[dht:],
        "a JPGn marker before the frame, cv2 refuses":
            base[:20] + b"\xff\xf0\x00\x04\x00\x00" + base[20:],
        "a JPGn marker between progressive scans, cv2 refuses":
            prog[:dht] + b"\xff\xfd\x00\x04\x00\x00" + prog[dht:],
        "an RST marker turned into a JPGn marker, cv2 refuses":
            apply_edits(rst, [(r3 + 1, rst[r3 + 1] ^ 0xF9)]),
        "a DQT precision of 2 (16-bit values, as get_dqt reads any but 0)":
            _dqt_precision_2(base),
        "a bad Huffman code (a copy the reader used to refuse)":
            apply_edits(base, [(17063, 210)]),
        "a run past the last coefficient (a copy the reader used to refuse)":
            apply_edits(base, [(32621, 244)]),
    }


NAMED = _named()


@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("case", sorted(NAMED))
def test_named_damaged_jpegs_decode_as_cv2(case, flag):
    assert _outcome(NAMED[case], *FLAGS[flag]) == "same"


def _png_bad_adler(w, h, split):
    """A gray PNG of h rows of w, zlib level 0 (stored blocks) with its
    Adler-32 broken, in one IDAT chunk or two split before the Adler."""
    raw = b"".join(b"\0" + ((np.arange(w) * (y + 1)) % 256).astype(np.uint8)
                   .tobytes() for y in range(h))
    z = zlib.compress(raw, 0)
    z = z[:-1] + bytes([z[-1] ^ 1])
    parts = [z[:-4], z[-4:]] if split else [z]

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            b"".join(chunk(b"IDAT", p) for p in parts) + chunk(b"IEND", b""))


PNG_CASES = {
    # libpng hands zlib 8192 bytes of IDAT at a time: when the rows end
    # at a piece's end, the Adler-32 is read after the last row's call
    # and its failure is a warning; inside the piece it is fatal
    "adler in the next 8192-byte piece (read)": (1636, 5, False),
    "adler in the same piece, past its end (refused)": (1637, 5, False),
    "adler in the same piece, before its end (refused)": (1635, 5, False),
    "adler in the next IDAT chunk (read)": (1637, 5, True),
}


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_png_bad_adler_as_libpng(case):
    buf = _png_bad_adler(*PNG_CASES[case])
    assert _outcome(buf, *FLAGS["gray"]) == "same"
    assert (_cv2(buf, cv2.IMREAD_GRAYSCALE) is None) == ("refused" in case)


def _damaged():
    """damaged.json (no cases while make_fixtures.py first writes it)."""
    path = os.path.join(FIXTURES, "damaged.json")
    if not os.path.isfile(path):
        return {"cases": []}
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("index", range(len(_damaged()["cases"])))
def test_committed_damaged_cases_match_cv2(index):
    """The damaged cases chip_smoke.py decodes on the card's host: cv2 and
    the port give the committed digests under both flags (None where cv2
    refuses), and the batch plane gives the committed digest of the warps
    of cv2's pixels."""
    case = _damaged()["cases"][index]
    buf = case_bytes(case)
    refs = {}
    for key, (flag, decode) in FLAGS.items():
        want, ref = case[key], _cv2(buf, flag)
        refs[key] = ref
        if want is None:
            assert ref is None
            with pytest.raises(ValueError):
                decode(buf)
            continue
        for img in (ref, decode(buf)):
            assert list(img.shape) == want["shape"]
            assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"]
    if case["plane"] is None:
        assert refs["color"] is None or refs["gray"] is None
        return
    ref, gray = refs["color"], refs["gray"]
    mat, _ = get_transform_mats(ref.shape[:2], (PLANE_SIZE, PLANE_SIZE))
    images, masks, _, _ = batch_preprocess([buf], [buf], PLANE_SIZE,
                                           nthreads=1)
    np.testing.assert_array_equal(images[0], normalize_image(
        warp_image(ref[:, :, ::-1], mat, (PLANE_SIZE, PLANE_SIZE))))
    np.testing.assert_array_equal(masks[0], warp_mask(
        gray, mat, (PLANE_SIZE, PLANE_SIZE)))
    assert plane_digest(buf) == case["plane"]


def test_committed_damaged_cases_cover_every_fixture_and_outcome():
    with open(os.path.join(FIXTURES, "damaged.json")) as f:
        cases = json.load(f)["cases"]
    assert len(cases) >= 24
    assert {c["fixture"] for c in cases} == set(SEEDS)
    assert any(c["color"] is None for c in cases)
    assert sum(c["plane"] is not None for c in cases) >= 20


def _jpeg_tiff(h=64, w=96, rows=64):
    """A YCbCr 4:2:0 JPEG-compressed TIFF in strips of ``rows``: (the
    file, the first strip's entropy-coded data as (start, end))."""
    img = np.random.RandomState(3).randint(0, 256, (h, w, 3)).astype(np.uint8)
    img = cv2.GaussianBlur(img, (5, 5), 1.5)
    chunks = []
    for y in range(0, h, rows):
        tables, stream = _jpeg_parts(_pil(img[y:y + rows], "JPEG", quality=85,
                                          subsampling=2))
        chunks.append(stream)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * 3), 259: (3, [7]),
            262: (3, [6]), 277: (3, [3]), 278: (4, [rows]),
            347: (7, list(tables)), 530: (3, [2, 2])}
    buf = _tiff(tags, chunks)
    start = buf.index(chunks[0])
    return buf, (start + chunks[0].index(b"\xff\xda") + 14,
                 start + len(chunks[0]))


def test_damaged_jpeg_in_tiff_decodes_as_cv2():
    """JPEG-in-TIFF strips through the same decoder: 60 seeded copies of
    a one-strip file, 40 with bytes of its scan XORed and 20 with its byte
    count cut (where libtiff's source inserts an EOI), all as cv2."""
    buf, (lo, hi) = _jpeg_tiff()
    rs = np.random.RandomState(6)
    copies = []
    for _ in range(40):
        k = rs.choice([1, 2, 4])
        copies.append(apply_edits(buf, zip(rs.randint(lo, hi, k),
                                           rs.randint(1, 256, k))))
    count_at = buf.index(struct.pack("<HHI", 279, 4, 1)) + 8
    count = struct.unpack("<I", buf[count_at:count_at + 4])[0]
    for cut in rs.randint(1, hi - lo, 20):
        b = bytearray(buf)
        b[count_at:count_at + 4] = struct.pack("<I", count - int(cut))
        copies.append(bytes(b))
    outcomes = [_outcome(c, *FLAGS[f]) for c in copies for f in FLAGS]
    assert outcomes == ["same"] * len(outcomes)


def _deflate_tiff(rows, bad):
    """An RGB Deflate TIFF of 24 x 40 in strips of ``rows``; the strip
    ``bad`` (an index) with its Adler-32 broken."""
    px = (np.arange(24 * 40 * 3) % 251).astype(np.uint8).reshape(24, 40, 3)
    chunks = [zlib.compress(px[y:y + rows].tobytes()) for y in range(0, 24, rows)]
    chunks[bad] = chunks[bad][:-1] + bytes([chunks[bad][-1] ^ 1])
    tags = {256: (4, [40]), 257: (4, [24]), 258: (3, [8] * 3), 259: (3, [8]),
            262: (3, [2]), 277: (3, [3]), 278: (4, [rows])}
    return _tiff(tags, chunks)


@pytest.mark.parametrize("rows,bad", [(24, 0), (8, 0), (8, -1)])
def test_tiff_deflate_bad_adler_as_cv2(rows, bad):
    """PNG's warning does not reach TIFF: libtiff inflates a strip into a
    buffer of its size, reports the bad Adler-32 after it is full, and
    OpenCV reads the whole strip; so does the port."""
    buf = _deflate_tiff(rows, bad)
    assert _cv2(buf, cv2.IMREAD_COLOR) is not None
    for flag in FLAGS:
        assert _outcome(buf, *FLAGS[flag]) == "same"
