"""The port's data layer on the CPU, against OpenCV and the JAX package:
the JPEG/PNG decoder against cv2.imdecode, warp_mask against the JAX
package's (OpenCV's) warp, RefPack files across the two packages, the
synthetic records, RefDataset in its three modes and on prewarped records,
the loader, and the config and command-line plumbing of the entry points."""

import base64
import hashlib
import importlib.util
import logging
import os
import struct
import threading
import time
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cris_tpu.data import RefDataset as JaxDataset
from cris_tpu.data import RefPackReader as JaxReader
from cris_tpu.data import make_record as jax_make_record
from cris_tpu.data import transforms as jax_tf
from cris_tpu.data import write_refpack as jax_write_refpack

from cris_tpu_torch import cli
from cris_tpu_torch.data import (RefDataLoader, RefDataset, RefPackReader,
                                 SyntheticBackend, codec, decode_image,
                                 decode_mask, encode_png, make_record,
                                 open_backend, warp_mask, write_refpack)
from cris_tpu_torch.data.loader import _collate
from cris_tpu_torch.utils import (cris_r50_refcoco, load_cfg_from_cfg_file,
                                  merge_cfg_from_list, setup_logger)
from cris_tpu_torch.utils.logging import logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "synthetic", "cris_tiny.yaml")

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
SIZES = [(1, 1), (1, 2), (2, 1), (2, 3), (3, 3), (5, 7), (8, 8), (9, 17),
         (16, 16), (17, 33), (31, 47), (48, 64), (101, 77), (240, 320),
         (333, 500), (480, 640)]
QUALITIES = (30, 50, 75, 90, 95, 100)


def _photo(h, w, seed, channels=3):
    """A seeded photo-like uint8 image: smooth color fields plus noise."""
    rng = np.random.RandomState(seed)
    small = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, channels))
    big = cv2.resize(small.astype(np.float32), (w, h),
                     interpolation=cv2.INTER_LINEAR).reshape(h, w, channels)
    img = np.clip(big + rng.randn(h, w, channels) * 20, 0, 255).astype(np.uint8)
    return img[:, :, 0] if channels == 1 else img


def _jpeg(img, quality=90, sampling="420", rst=0, **extra):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
              cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    for key, value in extra.items():
        params += [getattr(cv2, key), value]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _cv2_decode(buf, flags=cv2.IMREAD_COLOR):
    return cv2.imdecode(np.frombuffer(buf, np.uint8), flags)


def _assert_decodes_as_cv2(buf):
    ref, got = _cv2_decode(buf), decode_image(buf)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(decode_mask(buf),
                                  _cv2_decode(buf, cv2.IMREAD_GRAYSCALE))


# ------------------------------------------------------------------ JPEG

@pytest.mark.parametrize("rst", [0, 3])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_equals_cv2_bitwise_over_the_encode_grid(sampling, rst):
    """Every size from 1 x 1 to 480 x 640 (odd and even, partial MCUs) at
    qualities 30-100: the same bits as cv2.imdecode, color and gray."""
    for h, w in SIZES:
        img = _photo(h, w, seed=h * 1000 + w)
        for q in QUALITIES:
            _assert_decodes_as_cv2(_jpeg(img, q, sampling, rst))


@pytest.mark.parametrize("quality", [30, 75, 100])
def test_gray_jpeg_replicates_to_bgr_as_cv2(quality):
    for h, w in SIZES:
        _assert_decodes_as_cv2(_jpeg(_photo(h, w, seed=w, channels=1), quality))


def test_optimized_huffman_tables_decode_as_cv2():
    for h, w in SIZES[::3]:
        _assert_decodes_as_cv2(_jpeg(_photo(h, w, seed=3), 85, "420",
                                     IMWRITE_JPEG_OPTIMIZE=1))


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 200), w=st.integers(1, 200),
       quality=st.integers(30, 100), sampling=st.sampled_from(sorted(SAMPLING)),
       rst=st.integers(0, 5), seed=st.integers(0, 2**16))
def test_jpeg_equals_cv2_on_drawn_encodes(h, w, quality, sampling, rst, seed):
    _assert_decodes_as_cv2(_jpeg(_photo(h, w, seed), quality, sampling, rst))


def _with_exif(jpeg, orientation, order):
    end = "<" if order == b"II" else ">"
    tiff = (order + struct.pack(end + "HI", 42, 8) + struct.pack(end + "H", 1)
            + struct.pack(end + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(end + "I", 0))
    payload = b"Exif\0\0" + tiff
    app1 = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
    return jpeg[:2] + app1 + jpeg[2:]


@pytest.mark.parametrize("order", [b"II", b"MM"])
@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation_applied_as_cv2(orientation, order):
    """cv2.imdecode applies the APP1 orientation tag: an orientation-6
    20 x 40 JPEG decodes to 40 x 20."""
    buf = _with_exif(_jpeg(_photo(20, 40, seed=1), 90, "420"), orientation,
                     order)
    _assert_decodes_as_cv2(buf)
    if orientation in (5, 6, 7, 8):
        assert decode_image(buf).shape == (40, 20, 3)


def _patched(buf, marker_at, offset, value):
    b = bytearray(buf)
    b[marker_at + offset] = value
    return bytes(b)


def _truncated_progressive():
    buf = _jpeg(_photo(16, 24, seed=2), 90, "420", IMWRITE_JPEG_PROGRESSIVE=1)
    sos = [i for i in range(len(buf) - 1) if buf[i:i + 2] == b"\xff\xda"]
    return buf[: (sos[2] + sos[3]) // 2]


def _unsupported():
    base = _jpeg(_photo(16, 24, seed=2), 90, "420")
    sof = base.index(b"\xff\xc0")
    sos = base.index(b"\xff\xda")
    scan = sos + 2 + struct.unpack_from(">H", base, sos + 2)[0]
    return {
        # a progressive JPEG cut in the middle of a scan
        "progressive": (_truncated_progressive(),
                        "SOF2: progressive JPEG: .*(premature end|truncated)"),
        "lossless": (_patched(base, sof, 1, 0xC3), "SOF3"),
        "arithmetic": (_patched(base, sof, 1, 0xC9), "SOF9"),
        "12-bit": (_patched(base, sof, 4, 12), "12-bit"),
        "cmyk": (_patched(base, sof, 9, 4), "4 components"),
        "truncated": (base[: scan + 10], "premature end"),
        "no eoi": (base[:-2], "EOI"),
        "bad huffman table": (base.replace(b"\xff\xc4", b"\xff\xfe", 1), "Huffman table"),
        "not an image": (b"NOTIMG" + base, "not a JPEG or PNG"),
    }


@pytest.mark.parametrize("case", sorted(_unsupported()))
def test_unsupported_or_corrupt_jpeg_raises_naming_it(case):
    buf, words = _unsupported()[case]
    with pytest.raises(ValueError, match=words):
        decode_image(buf)


def test_chip_smoke_embedded_jpeg_matches_cv2():
    """The JPEG that chip_smoke.py decodes on the card and the sha256 it
    must reproduce are cv2.imdecode's, and the port's decoder gives them
    here."""
    import chip_smoke

    buf = base64.b64decode(chip_smoke.CODEC_JPEG_B64)
    assert 2000 <= len(buf) <= 4096
    info = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    assert info.shape == chip_smoke.CODEC_JPEG_SHAPE
    assert info.shape[0] % 2 and info.shape[1] % 2  # odd, partial MCUs
    assert hashlib.sha256(info.tobytes()).hexdigest() == chip_smoke.CODEC_JPEG_SHA256
    assert hashlib.sha256(decode_image(buf).tobytes()).hexdigest() == \
        chip_smoke.CODEC_JPEG_SHA256


def test_codec_builds_once_under_a_digest_name(tmp_path, monkeypatch):
    """The library's name carries the source's digest, and a build from
    scratch leaves only that file in the build directory (written under a
    temporary name and renamed into place)."""
    monkeypatch.setattr(codec, "BUILD_DIR", tmp_path / "build")
    path = codec.build()
    assert path.parent == tmp_path / "build"
    assert path.name == codec.library_path().name
    assert os.listdir(tmp_path / "build") == [path.name]
    assert codec.build() == path


# ------------------------------------------------------------------- PNG

def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _png(img, filters, color_type=None, interlace=0, depth=8):
    """A PNG whose row y uses filter filters[y % len(filters)]."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    rows = img.reshape(h, -1).astype(np.int64)
    prev = np.zeros_like(rows[0])
    out = []
    for y in range(h):
        f, x = filters[y % len(filters)], rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prev = x
    ctype = color_type if color_type is not None else (0 if bpp == 1 else 2)
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(b"".join(out)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_filters_equal_cv2(filters, channels):
    for h, w in [(1, 1), (5, 7), (33, 17), (64, 48)]:
        img = _photo(h, w, seed=h + w, channels=channels)
        buf = _png(img, filters)
        np.testing.assert_array_equal(decode_image(buf), _cv2_decode(buf))
        if channels == 1:
            np.testing.assert_array_equal(
                decode_mask(buf), _cv2_decode(buf, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("channels", [1, 3])
def test_cv2_png_encodes_decode_and_encode_png_round_trips(channels):
    img = _photo(37, 53, seed=5, channels=channels)
    for level in (0, 1, 9):
        ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        np.testing.assert_array_equal(decode_image(buf.tobytes()), _cv2_decode(buf))
    ours = encode_png(img if channels == 1 else img[:, :, ::-1])
    np.testing.assert_array_equal(_cv2_decode(ours, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(decode_image(ours), _cv2_decode(ours))


def _png16_rgb_with_gama(h, w, seed):
    """A 16-bit RGB PNG with a gAMA of 1/2.2, random samples, filter 0."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 65536, (h, w * 3)).astype(">u2").view(np.uint8)
    header = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"gAMA", struct.pack(">I", 45455))
            + _chunk(b"IDAT", zlib.compress(b"".join(b"\0" + r.tobytes()
                                                     for r in rows)))
            + _chunk(b"IEND", b""))


def _bad_pngs():
    img = _photo(8, 8, seed=1, channels=1)
    good = _png(img, (0,))
    return {
        "palette": (_png(img, (0,), color_type=3), "color type 3"),
        "interlaced": (_png(img, (0,), interlace=1), "interlace 1"),
        "16-bit": (_png(img, (0,), depth=16), "bit depth 16"),
        "crc": (good[:-5] + bytes([good[-5] ^ 1]) + good[-4:], "CRC"),
        "filter": (_png(img, (5,)), "filter type 5"),
        "truncated": (good[:40], "truncated"),
        # 16-bit colour read as gray under a file gamma (libpng's 16-bit
        # gamma tables are not reproduced)
        "rgb as gray": (_png16_rgb_with_gama(4, 4, seed=1), "RGB to grayscale"),
    }


@pytest.mark.parametrize("case", sorted(_bad_pngs()))
def test_unsupported_or_corrupt_png_raises(case):
    buf, words = _bad_pngs()[case]
    decode = decode_mask if case == "rgb as gray" else decode_image
    with pytest.raises(ValueError, match=words):
        decode(buf)


# ------------------------------------------------------ warps, records

@pytest.mark.parametrize("hw", [(333, 500), (480, 640), (427, 640), (640, 480),
                                (50, 37)])
def test_warp_mask_matches_opencv(hw):
    rec = jax_make_record(hw[0] % 7, seed=hw[1])
    mask = cv2.resize(jax_tf.decode_mask(rec["mask"]), hw[::-1],
                      interpolation=cv2.INTER_NEAREST)
    for size in (416, 64):
        mat, _ = jax_tf.get_transform_mats(hw, (size, size))
        ref = jax_tf.warp_mask(mask, mat, (size, size))
        got = warp_mask(mask, mat, (size, size))
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1.0 / 255


def test_refpack_round_trip_across_packages(tmp_path):
    records = [jax_make_record(i, seed=7) for i in range(5)]
    ours, theirs = str(tmp_path / "port.refpack"), str(tmp_path / "jax.refpack")
    assert write_refpack(ours, records) == 5
    jax_write_refpack(theirs, records)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for path in (ours, theirs):
        for reader in (RefPackReader(path), JaxReader(path)):
            assert len(reader) == 5
            assert [reader[i] for i in range(5)] == records
            with pytest.raises(IndexError):
                reader[5]
            reader.close()
    with open(tmp_path / "bad.refpack", "wb") as f:
        f.write(b"NOPE" + bytes(20))
    with pytest.raises(ValueError, match="not a RefPack"):
        RefPackReader(str(tmp_path / "bad.refpack"))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_records_equal_jax_but_for_the_image_codec(seed):
    """The same draws in the same order: sentences, ids, image size and
    the GT mask pixel for pixel; the image is the drawn one stored as PNG,
    where the JAX package's went through a JPEG encode."""
    for i in range(12):
        ours, theirs = make_record(i, seed), jax_make_record(i, seed)
        assert set(ours) == set(theirs)
        for key in ("cat", "seg_id", "num_sents", "sents"):
            assert ours[key] == theirs[key], key
        assert ours["num_sents"] == len(ours["sents"]) >= 1
        np.testing.assert_array_equal(decode_mask(ours["mask"]),
                                      jax_tf.decode_mask(theirs["mask"]))
        img, ref = decode_image(ours["img"]), jax_tf.decode_image(theirs["img"])
        assert img.shape == ref.shape
        assert np.abs(img.astype(int) - ref.astype(int)).mean() < 3
    assert make_record(3, seed=1)["img"] == make_record(3, seed=1)["img"]
    assert make_record(3, seed=2)["img"] != make_record(3, seed=1)["img"]


def test_materialized_masks_are_the_record_masks(tmp_path):
    backend = SyntheticBackend(4, seed=3)
    root = backend.materialize_masks(str(tmp_path / "masks"))
    for i in range(4):
        with open(os.path.join(root, f"{i}.png"), "rb") as f:
            assert f.read() == backend[i]["mask"]
    assert not [n for n in os.listdir(root) if ".tmp." in n]


def test_open_backend_refuses_lmdb_and_unknown():
    assert len(open_backend("synthetic://5?seed=2")) == 5
    with pytest.raises(ValueError, match="LMDB"):
        open_backend("datasets/lmdb/refcoco/val.lmdb")
    with pytest.raises(ValueError, match="cannot resolve"):
        open_backend("data.tar")


# ---------------------------------------------------------------- dataset

@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """A refpack of the JAX make_record's records, its prewarped form
    (tools/prewarp.py, with the original images) and a mask directory."""
    root = tmp_path_factory.mktemp("packs")
    src = str(root / "src.refpack")
    jax_write_refpack(src, [jax_make_record(i, seed=21) for i in range(5)])
    masks = str(root / "masks")
    SyntheticBackend(5, seed=21).materialize_masks(masks)
    spec = importlib.util.spec_from_file_location(
        "prewarp", os.path.join(REPO, "tools", "prewarp.py"))
    prewarp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prewarp)
    warped = str(root / "warped.refpack")
    prewarp.prewarp(src, warped, 416, keep_ori=True)
    return {"src": src, "warped": warped, "masks": masks}


def _unnormalized(image):
    return (image * jax_tf.CLIP_STD + jax_tf.CLIP_MEAN) * 255


def _assert_samples_match(ours, theirs, mode, exact_image=False):
    assert set(ours) == set(theirs)
    for key in theirs:
        a, b = ours[key], theirs[key]
        if key == "image":
            assert a.dtype == np.float32 and a.shape == b.shape == (416, 416, 3)
            if exact_image:
                np.testing.assert_array_equal(a, b)
            else:
                assert np.abs(_unnormalized(a) - _unnormalized(b)).max() <= 1.001
        elif key == "mask":
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert np.abs(a - b).max() <= (0 if exact_image else 1.0 / 255)
        elif key == "ori_img":
            np.testing.assert_array_equal(a, b)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_dataset_matches_jax_on_a_refpack(packs, mode):
    """Word ids, inverse, ori_size, seg_id, mask paths and sentences
    exactly; images (before normalising) and train masks within one uint8
    level; the decoded original image bit for bit."""
    ours = RefDataset(packs["src"], packs["masks"], "synthetic", "val", mode,
                      416, 17)
    theirs = JaxDataset(packs["src"], packs["masks"], "synthetic", "val", mode,
                        416, 17)
    assert len(ours) == len(theirs) == 5
    for i in range(5):
        _assert_samples_match(ours.__getitem__(i, rng=np.random.RandomState(i)),
                              theirs.__getitem__(i, rng=np.random.RandomState(i)),
                              mode)


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_prewarped_records_match_jax_and_the_live_path(packs, mode):
    """On tools/prewarp.py's records both packages give the same samples
    bit for bit, and the port's equal its own on-the-fly path within the
    warps' bar."""
    ours = RefDataset(packs["warped"], packs["masks"], "synthetic", "val",
                      mode, 416, 17)
    theirs = JaxDataset(packs["warped"], packs["masks"], "synthetic", "val",
                        mode, 416, 17)
    live = RefDataset(packs["src"], packs["masks"], "synthetic", "val", mode,
                      416, 17)
    for i in range(3):
        a = ours.__getitem__(i, rng=np.random.RandomState(i))
        _assert_samples_match(a, theirs.__getitem__(
            i, rng=np.random.RandomState(i)), mode, exact_image=True)
        _assert_samples_match(a, live.__getitem__(
            i, rng=np.random.RandomState(i)), mode)


def test_synthetic_dataset_writes_its_masks_and_uses_them():
    ds = RefDataset("synthetic://4?seed=31", None, "synthetic", "val", "val",
                    64, 17)
    assert "cris_tpu_torch_masks_synthetic_val_4_31" in ds.mask_root
    for i in range(4):
        sample = ds[i]
        assert sample["image"].shape == (64, 64, 3)
        mask = decode_mask(open(sample["mask_path"], "rb").read())
        np.testing.assert_array_equal(mask, decode_mask(ds.backend[i]["mask"]))


# ----------------------------------------------------------------- loader

def test_loader_batching_and_padding():
    ds = RefDataset("synthetic://10?seed=4", None, "synthetic", "val", "val",
                    64, 17)
    batches = list(RefDataLoader(ds, batch_size=4, num_workers=2))
    assert len(batches) == 3
    assert batches[0]["image"].shape == (4, 64, 64, 3)
    assert batches[0]["word"].shape == (4, 17)
    assert batches[0]["valid"].all()
    assert batches[2]["valid"].tolist() == [True, True, False, False]
    assert batches[2]["seg_id"].tolist() == [8, 9, 9, 9]
    assert list(RefDataLoader(ds, batch_size=4, drop_last=True,
                              num_workers=1).__iter__()).__len__() == 2


def test_loader_epoch_shuffle_is_seeded():
    ds = RefDataset("synthetic://16?seed=5", None, "synthetic", "train",
                    "train", 64, 17)
    loader = RefDataLoader(ds, batch_size=4, shuffle=True, seed=1,
                           drop_last=True, num_workers=2)

    def epoch(e):
        loader.set_epoch(e)
        return [(b["word"].copy(), b["mask"].copy()) for b in loader]

    a, b, c = epoch(1), epoch(1), epoch(2)
    assert all((x[0] == y[0]).all() and (x[1] == y[1]).all()
               for x, y in zip(a, b))
    assert any((x[0] != y[0]).any() for x, y in zip(a, c))
    # the JAX loader's order for the same seed and epoch
    from cris_tpu.data import RefDataLoader as JaxLoader

    theirs = JaxLoader(ds, batch_size=4, shuffle=True, seed=1, drop_last=True)
    theirs.set_epoch(2)
    loader.set_epoch(2)
    np.testing.assert_array_equal(loader._indices(), theirs._indices())


def test_loader_process_sharding():
    ds = RefDataset("synthetic://10?seed=6", None, "synthetic", "val", "val",
                    64, 17)
    seen = []
    for rank in range(4):
        loader = RefDataLoader(ds, batch_size=3, num_workers=1,
                               process_index=rank, process_count=4)
        assert len(loader) == 1
        for batch in loader:
            seen.extend(np.asarray(batch["seg_id"])[batch["valid"]].tolist())
    # wrap-around padding: every sample, some twice, ceil(10 / 4) * 4 in all
    assert len(seen) == 12 and set(seen) == set(range(10))


def test_loader_abandoned_iteration_does_not_leak_threads():
    ds = RefDataset("synthetic://24?seed=50", None, "synthetic", "train",
                    "train", 64, 17)
    loader = RefDataLoader(ds, batch_size=2, num_workers=3, prefetch=1)
    before = threading.active_count()
    for i, _ in enumerate(loader):
        if i == 1:
            break
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= before, threading.active_count()


def test_loader_surfaces_a_worker_error():
    class Broken:
        def __len__(self):
            return 8

        def get_batch(self, idxs, rngs):
            raise ValueError("SOF2: progressive JPEG is not supported")

    with pytest.raises(ValueError, match="SOF2"):
        list(RefDataLoader(Broken(), batch_size=2, num_workers=2))


def test_collate_stacks_arrays_and_keeps_ragged_values():
    samples = [{"a": np.zeros(3), "n": 1, "s": ["x"], "r": np.zeros(i + 1)}
               for i in range(2)]
    batch = _collate(samples)
    assert batch["a"].shape == (2, 3) and batch["n"].tolist() == [1, 1]
    assert batch["s"] == [["x"], ["x"]] and len(batch["r"]) == 2


# ------------------------------------------------------ config, logging

def test_merge_cfg_from_list_matches_jax():
    from cris_tpu.utils import config as jax_config

    opts = ["TEST.test_lmdb", "synthetic://64?seed=0", "TRAIN.batch_size_val",
            "8", "TRAIN.milestones", "(10, 20)", "TRAIN.base_lr", "1",
            "TEST.visualize", "True", "TRAIN.weight", "a/b.pth"]
    ours = merge_cfg_from_list(cris_r50_refcoco(), opts)
    theirs = jax_config.merge_cfg_from_list(
        jax_config.load_cfg_from_cfg_file(
            os.path.join(REPO, "config", "refcoco", "cris_r50.yaml")), opts)
    assert dict(ours) == dict(theirs)
    assert ours.milestones == [10, 20] and ours.base_lr == 1.0
    for bad in (["TRAIN.nope", "1"], ["TRAIN.batch_size_val", "'x'"],
                ["TRAIN.epochs"]):
        with pytest.raises((AssertionError, ValueError)):
            merge_cfg_from_list(cris_r50_refcoco(), bad)


def test_get_parser_reads_the_yaml_device_and_opts(monkeypatch):
    cfg = cli.get_parser(argv=["--config", TINY, "--device", "cpu", "--opts",
                               "TEST.test_lmdb", "synthetic://3?seed=1"])
    want = load_cfg_from_cfg_file(TINY)
    assert cfg.device == "cpu" and cfg.test_lmdb == "synthetic://3?seed=1"
    assert {k: v for k, v in cfg.items() if k not in ("device", "test_lmdb")} \
        == {k: v for k, v in want.items() if k != "test_lmdb"}
    assert cli.get_parser(argv=["--config", TINY]).device == "cuda"
    # without PyYAML (the card's machine) the RefCOCO presets serve
    import builtins

    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    r50 = os.path.join(REPO, "config", "refcoco", "cris_r50.yaml")
    assert dict(cli.load_config(r50)) == dict(cris_r50_refcoco())


def test_setup_logger_writes_the_file_and_log_exceptions_reraises(tmp_path):
    from cris_tpu_torch.utils import log_exceptions

    setup_logger(str(tmp_path), filename="t.log", mode="o")
    try:
        logger.info("hello")

        @log_exceptions
        def boom():
            raise KeyError("x")

        with pytest.raises(KeyError):
            boom()
        for handler in logger.handlers:
            handler.flush()
        text = (tmp_path / "t.log").read_text()
        assert "hello" in text and "uncaught exception in boom" in text
        setup_logger(str(tmp_path), process_index=1)
        assert all(isinstance(h, logging.NullHandler) for h in logger.handlers)
    finally:
        for handler in logger.handlers:
            handler.close()
        logger.handlers.clear()
        logger.propagate = True
        logger.setLevel(logging.NOTSET)
