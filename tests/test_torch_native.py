"""The port's batched data plane (data/native.py, csrc/batch_preprocess.cc)
on the CPU: RefDataset.get_batch against the per-sample __getitem__ bit for
bit, and against the JAX package's per-sample samples at the warps' bars;
its failures, CRIS_NATIVE=0, the library's build; the C++ container code
under it (the inflate against zlib) and the JPEG encoder against OpenCV;
the host pipeline's measurement (data/host_bench.py)."""

import ctypes
import importlib.util
import os
import threading
import zlib

import cv2
import numpy as np
import pytest

from cris_tpu.data import RefDataset as JaxDataset
from cris_tpu.data import make_record as jax_make_record
from cris_tpu.data import write_refpack as jax_write_refpack
from cris_tpu.data.host_bench import make_test_jpegs as jax_make_test_jpegs

from cris_tpu_torch.data import (RefDataset, batch_preprocess, codec,
                                 decode_image, decode_mask, encode_jpeg,
                                 encode_png, host_bench, make_test_jpegs,
                                 native, write_refpack)
from test_torch_data import (_assert_samples_match, _jpeg, _photo, _png,
                             _with_exif)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 416
MODES = ("train", "val")
SIZES = [(480, 640), (640, 480), (37, 100), (416, 416), (300, 1000)]


def _record(i, img, mask):
    return {"img": img, "mask": mask, "cat": 0, "seg_id": i,
            "img_name": f"{i}.jpg", "num_sents": 3,
            "sents": ["the left one", f"thing {i}", "a red thing"]}


def _mask_png(h, w, seed):
    mask = np.zeros((h, w), np.uint8)
    rng = np.random.RandomState(seed)
    y, x = rng.randint(0, h), rng.randint(0, w)
    mask[max(0, y - h // 3):y + h // 3, max(0, x - w // 3):x + w // 3] = 255
    return mask


def _jpeg_records(case):
    """Records of one case: cv2 JPEG images (and PNG masks unless said)."""
    if case in ("444", "422", "420"):
        return [_record(i, _jpeg(_photo(97 + 31 * i, 130 - 17 * i, i), 90,
                                 case), encode_png(_mask_png(97 + 31 * i,
                                                             130 - 17 * i, i)))
                for i in range(3)]
    if case == "gray":  # a gray image, and a gray JPEG as the mask
        return [_record(i, _jpeg(_photo(120, 90 + i, i, channels=1), 85),
                        _jpeg(_mask_png(120, 90 + i, i), 95))
                for i in range(2)]
    if case == "restart":
        return [_record(i, _jpeg(_photo(150, 200, i), 75, "420", rst=2 + i),
                        encode_png(_mask_png(150, 200, i))) for i in range(2)]
    if case == "exif":  # orientations 1-8; 5-8 swap H and W
        base = _jpeg(_photo(60, 140, 7), 90, "420")
        mask = encode_png(_mask_png(60, 140, 7))
        masks = {o: encode_png(_mask_png(140, 60, 7)) for o in (5, 6, 7, 8)}
        return [_record(o, _with_exif(base, o, b"II" if o % 2 else b"MM"),
                        masks.get(o, mask)) for o in range(1, 9)]
    if case == "sizes":  # shrinks and enlargements
        return [_record(i, _jpeg(_photo(h, w, i), 90, "420"),
                        encode_png(_mask_png(h, w, i)))
                for i, (h, w) in enumerate(SIZES)]
    raise ValueError(case)


def _prewarp(src, dst):
    spec = importlib.util.spec_from_file_location(
        "prewarp", os.path.join(REPO, "tools", "prewarp.py"))
    prewarp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prewarp)
    prewarp.prewarp(src, dst, SIZE, keep_ori=True)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """case -> a data URI: the port's synthetic:// records (PNG), a
    refpack of the JAX make_record's cv2 JPEGs, its prewarped form, and
    refpacks of the cv2 JPEG cases."""
    root = tmp_path_factory.mktemp("native")
    out = {"synthetic": "synthetic://4?seed=12"}
    jax_pack = str(root / "jax.refpack")
    jax_write_refpack(jax_pack, [jax_make_record(i, seed=13) for i in range(4)])
    out["jax refpack"] = jax_pack
    out["prewarped"] = str(root / "warped.refpack")
    _prewarp(jax_pack, out["prewarped"])
    for case in ("444", "422", "420", "gray", "restart", "exif", "sizes"):
        out[case] = str(root / f"{case}.refpack")
        write_refpack(out[case], _jpeg_records(case))
    return out


def _rngs(indices):
    return [np.random.RandomState(1000 + int(i)) for i in indices]


def _assert_equal_samples(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key, value in b.items():
            if isinstance(value, np.ndarray):
                assert a[key].dtype == value.dtype, key
                assert a[key].shape == value.shape, key
                np.testing.assert_array_equal(a[key], value, err_msg=key)
            else:
                assert a[key] == value, key


CASES = ["synthetic", "jax refpack", "444", "422", "420", "gray", "restart",
         "exif", "sizes", "prewarped"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_get_batch_equals_getitem_bitwise(sources, case, mode, monkeypatch):
    """image, mask, word, inverse and ori_size of the plane's batch equal
    the per-sample path's bit for bit; train draws the same sentences."""
    ds = RefDataset(sources[case], None, "synthetic", "train", mode, SIZE, 17)
    indices = np.arange(len(ds))[::-1]
    calls = []
    plane = native.batch_preprocess
    monkeypatch.setattr(native, "batch_preprocess",
                        lambda *a, **k: calls.append(len(a[0])) or plane(*a, **k))
    got = ds.get_batch(indices, _rngs(indices))
    monkeypatch.undo()
    # one call for the batch, none for prewarped records
    assert calls == ([] if case == "prewarped" else [len(ds)])
    want = [ds.__getitem__(int(i), rng=r)
            for i, r in zip(indices, _rngs(indices))]
    _assert_equal_samples(got, want)
    if case == "exif":
        shapes = {tuple(s["ori_size"]) for s in got} if mode == "val" else None
        assert shapes in (None, {(60, 140), (140, 60)})


@pytest.mark.parametrize("mode", MODES)
def test_get_batch_passes_the_jax_per_sample_bars(sources, mode):
    """Against the JAX package's per-sample samples (OpenCV's decode and
    warps): the bars of tests/test_torch_data.py."""
    ours = RefDataset(sources["jax refpack"], None, "synthetic", "val", mode,
                      SIZE, 17)
    theirs = JaxDataset(sources["jax refpack"], None, "synthetic", "val",
                        mode, SIZE, 17)
    indices = list(range(len(ours)))
    for i, sample in zip(indices, ours.get_batch(indices, _rngs(indices))):
        _assert_samples_match(sample, theirs.__getitem__(
            i, rng=np.random.RandomState(1000 + i)), mode)


def test_thread_counts_give_the_same_bytes():
    imgs, masks = make_test_jpegs(6, (200, 150), seed=3)
    one = batch_preprocess(imgs, masks, 96, nthreads=1)
    many = batch_preprocess(imgs, masks, 96, nthreads=8)
    for a, b in zip(one, many):
        assert a.tobytes() == b.tobytes()
    images, masks_out, inverse, ori = one
    assert images.shape == (6, 96, 96, 3) and masks_out.shape == (6, 96, 96)
    assert inverse.shape == (6, 2, 3) and ori.tolist() == [[150, 200]] * 6
    images, no_masks, no_inverse, _ = batch_preprocess(imgs, None, 96,
                                                       want_inverse=False)
    assert no_masks is None and no_inverse is None
    np.testing.assert_array_equal(images, one[0])


def test_host_bench_paths_agree():
    """The two paths host_bench times compute the same images."""
    imgs, masks = make_test_jpegs(3, seed=4)
    np.testing.assert_array_equal(
        host_bench.python_preprocess(imgs, masks, SIZE),
        batch_preprocess(imgs, masks, SIZE)[0])


def _progressive():
    """A progressive JPEG cut in the middle of its third scan."""
    buf = _jpeg(_photo(16, 24, seed=2), 90, "420", IMWRITE_JPEG_PROGRESSIVE=1)
    sos = [i for i in range(len(buf) - 1) if buf[i:i + 2] == b"\xff\xda"]
    return buf[: (sos[2] + sos[3]) // 2]


def _corrupt_png():
    good = _png(_photo(8, 8, seed=1, channels=1), (0,))
    at = good.index(b"IDAT") + 8  # a byte of the IDAT payload
    return good[:at] + bytes([good[at] ^ 0x40]) + good[at + 1:]


@pytest.mark.parametrize("case", ["bad bytes", "progressive", "corrupt png"])
def test_failures_raise_naming_the_sample(case, tmp_path):
    """A sample that fails raises ValueError with its index in the batch
    and the decoder's message, the same message as the per-sample path."""
    good = _jpeg(_photo(20, 30, seed=1), 90)
    mask = encode_png(_mask_png(20, 30, 1))
    bad = {"bad bytes": (b"NOTIMAGE..", "not a JPEG or PNG"),
           "progressive": (_progressive(), "SOF2: progressive"),
           "corrupt png": (_corrupt_png(), "PNG IDAT: CRC mismatch")}[case]
    # the image of sample 2, or for a mask format the mask of sample 1
    records = [_record(i, good, mask) for i in range(4)]
    at = 1 if case == "corrupt png" else 2
    key = "mask" if case == "corrupt png" else "img"
    records[at][key] = bad[0]
    records[3][key] = bad[0]  # the lowest failing index is reported
    path = str(tmp_path / "bad.refpack")
    write_refpack(path, records)
    ds = RefDataset(path, None, "synthetic", "train", "train", 64, 17)
    with pytest.raises(ValueError, match=f"sample {at}: {bad[1]}"):
        ds.get_batch(list(range(4)), _rngs(range(4)))
    with pytest.raises(ValueError, match=bad[1]):
        ds[at]


def test_cris_native_0_takes_the_per_sample_path(sources, monkeypatch):
    ds = RefDataset(sources["420"], None, "synthetic", "train", "train", 64, 17)
    want = ds.get_batch([0, 1], _rngs([0, 1]))

    def refuse(*args, **kwargs):
        raise AssertionError("the plane ran")

    monkeypatch.setattr(native, "batch_preprocess", refuse)
    for value in ("0", "false"):
        monkeypatch.setenv("CRIS_NATIVE", value)
        assert not native.available()
        _assert_equal_samples(ds.get_batch([0, 1], _rngs([0, 1])), want)
    monkeypatch.setenv("CRIS_NATIVE", "1")
    assert native.available()
    with pytest.raises(AssertionError, match="the plane ran"):
        ds.get_batch([0, 1], _rngs([0, 1]))
    # test mode stays per sample
    test_ds = RefDataset(sources["420"], None, "synthetic", "val", "test", 64,
                         17)
    assert "ori_img" in test_ds.get_batch([0])[0]


def test_a_library_that_does_not_build_raises(tmp_path, monkeypatch):
    """No fallback: the plane raises when its library cannot be built."""
    imgs, masks = make_test_jpegs(1, (200, 150))
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(codec, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(codec, "SOURCES", (bad,))
    monkeypatch.setattr(codec, "_library", None)
    with pytest.raises(RuntimeError, match="broken.cc failed"):
        batch_preprocess(imgs, masks, 32)


def test_concurrent_builds_leave_one_library(tmp_path, monkeypatch):
    monkeypatch.setattr(codec, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(codec.build())
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    assert len(set(paths)) == 1 and len(paths) == 4
    assert os.listdir(tmp_path / "build") == [paths[0].name]
    assert paths[0].name.startswith("libcris_data_")


# -------------------------------------------------------------- inflate

def _inflate(data):
    lib = codec.load_library()
    ptr, n = ctypes.c_void_p(), ctypes.c_longlong()
    codec._call(lib.cris_zlib_inflate, data, len(data), ctypes.byref(ptr),
                ctypes.byref(n))
    return codec._take(lib, ptr, np.empty(n.value, np.uint8)).tobytes()


def _stream(payload, level=6, strategy=zlib.Z_DEFAULT_STRATEGY):
    c = zlib.compressobj(level, zlib.DEFLATED, 15, 8, strategy)
    return c.compress(payload) + c.flush()


def _payloads():
    rng = np.random.RandomState(0)
    text = b" ".join(b"the %d red things on the left" % (i % 97)
                     for i in range(9000))
    return {"empty": b"", "one byte": b"x", "text": text,
            "noise": rng.randint(0, 256, 150_000).astype(np.uint8).tobytes(),
            "runs": bytes(70_000) + b"\xff" * 70_000 + text[:1000]}


@pytest.mark.parametrize("kind,level,strategy,btype", [
    ("stored", 0, zlib.Z_DEFAULT_STRATEGY, 0),
    ("fixed", 6, zlib.Z_FIXED, 1),
    ("dynamic", 9, zlib.Z_DEFAULT_STRATEGY, 2),
    ("huffman only", 6, zlib.Z_HUFFMAN_ONLY, 2),
    ("rle", 6, zlib.Z_RLE, 2)])
def test_inflate_equals_zlib(kind, level, strategy, btype):
    for name, payload in _payloads().items():
        stream = _stream(payload, level, strategy)
        if name == "text":  # the first block's type
            assert (stream[2] >> 1) & 3 == btype
        assert _inflate(stream) == zlib.decompress(stream) == payload, name


def test_inflate_rejects_corrupt_streams():
    stream = _stream(_payloads()["text"])
    bad_adler = stream[:-1] + bytes([stream[-1] ^ 1])
    with pytest.raises(zlib.error):
        zlib.decompress(bad_adler)
    with pytest.raises(ValueError, match="incorrect data check"):
        _inflate(bad_adler)
    with pytest.raises(ValueError, match="truncated"):
        _inflate(stream[: len(stream) // 2])
    with pytest.raises(ValueError, match="header check"):
        _inflate(b"\x78\x9d" + stream[2:])
    assert _inflate(stream + b"trailing") == zlib.decompress(stream + b"x")


# --------------------------------------------------------------- encoder

@pytest.mark.parametrize("channels", [1, 3])
def test_encoder_output_decodes_the_same_in_cv2_and_the_port(channels):
    for h, w in [(1, 1), (7, 5), (16, 16), (17, 33), (101, 77), (480, 640)]:
        img = _photo(h, w, seed=h + w, channels=channels)
        for quality in (10, 50, 90, 95, 100):
            buf = encode_jpeg(img, quality)
            assert buf[:4] == b"\xff\xd8\xff\xe0" and buf[6:11] == b"JFIF\0"
            assert buf[-2:] == b"\xff\xd9"
            arr = np.frombuffer(buf, np.uint8)
            np.testing.assert_array_equal(
                cv2.imdecode(arr, cv2.IMREAD_COLOR), decode_image(buf))
            np.testing.assert_array_equal(
                cv2.imdecode(arr, cv2.IMREAD_GRAYSCALE), decode_mask(buf))
            if channels == 1:
                assert buf.count(b"\xff\xc0") == 1 and buf[
                    buf.index(b"\xff\xc0") + 9] == 1  # one component


def _psnr(a, b):
    err = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255.0 ** 2 / err)


def test_encoder_quality_and_size_near_cv2_on_the_bench_images():
    """Quality 90 on the bench's 640 x 480 images: PSNR against the
    source within 0.5 dB of cv2.imencode's, the size within 15%."""
    for img, _ in host_bench.draw_test_images(4, seed=5):
        ours = encode_jpeg(img, 90)
        ok, theirs = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        assert ok
        psnr_ours = _psnr(decode_image(ours), img)
        psnr_cv2 = _psnr(cv2.imdecode(theirs, cv2.IMREAD_COLOR), img)
        assert abs(psnr_ours - psnr_cv2) <= 0.5, (psnr_ours, psnr_cv2)
        assert abs(len(ours) / len(theirs) - 1) <= 0.15, (len(ours),
                                                          len(theirs))


@pytest.mark.parametrize("img,quality,words", [
    (np.zeros((4, 4, 3), np.float32), 90, "uint8"),
    (np.zeros((4, 4, 4), np.uint8), 90, "uint8"),
    (np.zeros((4, 4, 3), np.uint8), 0, "quality 0"),
    (np.zeros((4, 4, 3), np.uint8), 101, "quality 101"),
    (np.zeros((0, 4), np.uint8), 90, "not a JPEG size")])
def test_encoder_refuses(img, quality, words):
    with pytest.raises(ValueError, match=words):
        encode_jpeg(img, quality)


def test_bench_images_draw_the_jax_packages_images():
    """make_test_jpegs' draws are the JAX package's: the masks equal its
    cv2.circle masks, the images differ by its JPEG encode's loss."""
    imgs, masks = make_test_jpegs(3, seed=6)
    jax_imgs, jax_masks = jax_make_test_jpegs(3, seed=6)
    for ours, mask, theirs, their_mask in zip(imgs, masks, jax_imgs,
                                              jax_masks):
        np.testing.assert_array_equal(
            decode_mask(mask),
            cv2.imdecode(np.frombuffer(their_mask, np.uint8),
                         cv2.IMREAD_GRAYSCALE))
        a = decode_image(ours).astype(np.float64)
        b = cv2.imdecode(np.frombuffer(theirs, np.uint8), cv2.IMREAD_COLOR)
        assert a.shape == b.shape == (480, 640, 3)
        assert np.abs(a - b).mean() < 8


def test_measure_host_pipeline_reports_both_paths():
    r = host_bench.measure_host_pipeline(n_images=4, repeats=1,
                                         python_images=2, nthreads=2)
    assert r["native_threads"] == 2 and r["host_cores"] == os.cpu_count()
    for key in ("python_img_s", "native_1thread_img_s", "native_img_s",
                "prewarped_img_s"):
        assert r[key] > 0, key
    assert r["native_speedup_vs_python"] == (r["native_img_s"]
                                             / r["python_img_s"])
    assert host_bench.cores_to_feed(200.0, 50.0) == 4.0
