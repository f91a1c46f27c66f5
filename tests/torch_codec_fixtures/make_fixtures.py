"""Write the decoder fixtures that ``chip_smoke.py`` phase 17 decodes on
the card's machine (which has no OpenCV), and the digests OpenCV gives.

    python3 tests/torch_codec_fixtures/make_fixtures.py [--tables]

(``--tables`` rewrites only ``damaged.json`` and the configs'
``expected.json``, from the files as committed.)

Needs cv2, PIL and pytest (the Adam7 writer of
``tests/test_torch_codec_formats.py``, the BMP writers of
``tests/test_torch_codec_webp_bmp_pnm.py`` and the TIFF and Sun raster
writers of ``tests/test_torch_codec_tiff_gif_ras.py``). Writes beside this
script:

- ``progressive_420_640x480.jpg``: a 640 x 480 progressive 4:2:0 JPEG
  (libjpeg's default script, quality 90) of the bench's first test image
  (``data/host_bench.draw_test_images(1, seed=0)``), and
  ``baseline_420_640x480.jpg``, the same image as baseline JPEG;
- ``lossy_640x480.webp``: the same image as lossy WebP (cv2, quality 90),
  the baseline JPEG's timing twin;
- ``rgba_160x120.png`` (8-bit RGBA), ``palette_160x120.png`` (4-bit
  palette with a tRNS), ``gray16_160x120.png`` (16-bit gray) and
  ``adam7_rgb_160x120.png`` (8-bit RGB, Adam7), from the same image at
  a quarter size;
- ``lossless_rgba_160x120.webp`` (VP8L with alpha, PIL),
  ``rle8_160x120.bmp`` (64-colour palette, RLE8, written by the BMP writer
  of ``tests/test_torch_codec_webp_bmp_pnm.py``), ``rgb_160x120.ppm``
  (binary P6, cv2) and ``cmyk_160x120.jpg`` (Adobe CMYK, PIL), from the
  same small image;
- ``lzw_pred2_640x480.tif``: the 640 x 480 image as RGB TIFF, LZW with
  Predictor 2 (cv2), the baseline JPEG's timing twin;
  ``tiled_planar_160x120.tif`` (RGB in 16 x 16 LZW tiles, planar
  configuration 2, written by the TIFF writer of
  ``tests/test_torch_codec_tiff_gif_ras.py``), ``palette_deflate_160x120.tif``
  (8-bit palette, Deflate, PIL), ``rgba_unassoc_160x120.tif`` (RGBA with
  unassociated alpha below 255, LZW, PIL),
  ``interlaced_transparent_160x120.gif`` (interlaced, a transparent
  index, PIL) and ``colormap_160x120.ras`` (8-bit Sun raster with an
  RMT_EQUAL_RGB colormap; OpenCV 5.0 refuses RLE-coded Sun rasters), from
  the same small image;
- ``lossy97_640x480.jp2``: the 640 x 480 image as JPEG 2000 (9/7
  wavelet, the irreversible colour transform, one layer at 20:1, PIL),
  the baseline JPEG's timing twin; ``lossless53_tiled_160x120.j2k`` (a
  raw codestream: 5/3, the reversible colour transform, 64 x 64 tiles,
  RPCL, 32 x 32 precincts, PIL) and ``gray_layers_160x120.jp2`` (gray,
  three quality layers, LRCP, PIL), from the same small image;
- ``anim_offset_160x120.webp``: an animated WebP whose first frame (a
  lossless 128 x 96 still with alpha, written with exact=True so that its
  transparent pixels keep their colour) lies at (16, 12) on the 160 x 120
  canvas, then a second, lossy frame; ``rle_160x120.hdr`` (Radiance HDR,
  RLE, cv2) and ``color_80x60.pfm`` (a colour PFM, cv2, samples in
  [0, 300]), from the same small image;
- ``digests.json``: for each file, the shape and the sha256 of the pixel
  bytes of ``cv2.imdecode`` under IMREAD_COLOR ("color") and
  IMREAD_GRAYSCALE ("gray"), with the OpenCV version;
- ``damaged.json``: damaged copies of the baseline, progressive and CMYK
  JPEGs and the RGBA PNG, each as its fixture and its edits ((offset,
  xor) pairs; a PNG's IDAT CRCs are repaired after them), picked from the
  seeded sweeps of ``tests/test_torch_codec_damaged.py`` (copies that cv2
  reads to pixels other than the undamaged file's, and a few that it
  refuses), with cv2's digests under both flags (null where it gives
  None) and the batch plane's digest (``plane_digest``);
- ``../torch_config_fixtures/expected.json``: every config under
  ``config/``, flattened from ``yaml.safe_load`` as the loaders flatten it,
  with the PyYAML version.

``tests/test_torch_codec_formats.py::test_committed_fixtures_match_their_digests``
holds the committed files to the digests and to cv2.imdecode.
"""

import hashlib
import io
import json
import os
import sys

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

sys.path.insert(0, os.path.dirname(HERE))

from cris_tpu_torch.data.host_bench import draw_test_images  # noqa: E402
from test_torch_codec_formats import _png  # noqa: E402  (writes Adam7)
from test_torch_codec_webp_bmp_pnm import _bmp, _rle8  # noqa: E402
from test_torch_codec_tiff_gif_ras import _ras, _tiff_image  # noqa: E402
from test_torch_codec_jp2_webpanim_hdr_pfm import (  # noqa: E402
    _anmf, _animated, _webp_frame)
from test_torch_codec_damaged import (  # noqa: E402
    SEEDS, case_bytes, damaged_copies, idat_flips, plane_digest)

REPO = os.path.dirname(os.path.dirname(HERE))
# damaged cases picked a fixture: (read by cv2 to other pixels, refused)
DAMAGED_PICKS = {"baseline_420_640x480.jpg": (7, 1),
                 "progressive_420_640x480.jpg": (6, 1),
                 "cmyk_160x120.jpg": (5, 0), "rgba_160x120.png": (3, 1)}


def digest(img: np.ndarray) -> dict:
    return {"shape": list(img.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest()}


def files() -> dict:
    bgr, _ = next(draw_test_images(1, seed=0))
    out = {}
    for name, progressive in (("progressive_420_640x480.jpg", 1),
                              ("baseline_420_640x480.jpg", 0)):
        out[name] = cv2.imencode(".jpg", bgr, [
            cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE,
            progressive, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])[1].tobytes()
    out["lossy_640x480.webp"] = cv2.imencode(
        ".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, 90])[1].tobytes()
    small = cv2.resize(bgr, (160, 120), interpolation=cv2.INTER_AREA)
    yy, xx = np.mgrid[0:120, 0:160]
    alpha = ((xx + yy) % 256).astype(np.uint8)
    out["rgba_160x120.png"] = cv2.imencode(
        ".png", np.dstack([small, alpha]))[1].tobytes()
    rgb = Image.fromarray(small[:, :, ::-1].copy())
    buf = io.BytesIO()
    palette = rgb.quantize(16)
    palette.info["transparency"] = bytes(range(0, 256, 32))
    palette.save(buf, "PNG", bits=4, transparency=bytes(range(0, 256, 32)))
    out["palette_160x120.png"] = buf.getvalue()
    gray16 = cv2.cvtColor(small, cv2.COLOR_BGR2GRAY).astype(np.uint16) * 257
    gray16 += (xx * 300).astype(np.uint16)
    out["gray16_160x120.png"] = cv2.imencode(".png", gray16)[1].tobytes()
    out["adam7_rgb_160x120.png"] = _png(small[:, :, ::-1], 2, 8,
                                        interlace=True)
    buf = io.BytesIO()
    Image.fromarray(np.dstack([small[:, :, ::-1], alpha])).save(
        buf, "WEBP", lossless=True)
    out["lossless_rgba_160x120.webp"] = buf.getvalue()
    quant = rgb.quantize(64)
    colours = np.array(quant.getpalette()[:3 * 64]).reshape(64, 3)
    indices = np.array(quant)[::-1]  # bottom-up rows
    out["rle8_160x120.bmp"] = _bmp(160, 120, 8, _rle8(indices),
                                   [tuple(int(v) for v in c[::-1]) for c in colours],
                                   compression=1)
    out["rgb_160x120.ppm"] = cv2.imencode(".ppm", small)[1].tobytes()
    k = (255 - cv2.cvtColor(small, cv2.COLOR_BGR2GRAY)) // 2
    buf = io.BytesIO()
    Image.fromarray(np.dstack([255 - small[:, :, ::-1], k]), "CMYK").save(
        buf, "JPEG", quality=90)
    out["cmyk_160x120.jpg"] = buf.getvalue()
    out["lzw_pred2_640x480.tif"] = cv2.imencode(".tiff", bgr, [
        cv2.IMWRITE_TIFF_COMPRESSION, 5, cv2.IMWRITE_TIFF_PREDICTOR, 2])[1].tobytes()
    out["tiled_planar_160x120.tif"] = _tiff_image(small[:, :, ::-1], 2, 8, 5,
                                                  tile=(16, 16), planar=2)
    buf = io.BytesIO()
    rgb.quantize(200).save(buf, "TIFF", compression="tiff_deflate")
    out["palette_deflate_160x120.tif"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(np.dstack([small[:, :, ::-1], alpha])).save(
        buf, "TIFF", compression="tiff_lzw")
    out["rgba_unassoc_160x120.tif"] = buf.getvalue()
    buf = io.BytesIO()
    rgb.quantize(128).save(buf, "GIF", interlace=True, transparency=3)
    out["interlaced_transparent_160x120.gif"] = buf.getvalue()
    colours = np.array(quant.getpalette()[:3 * 64]).reshape(64, 3).astype(np.uint8)
    rows = np.zeros((120, 160), np.uint8)  # 160 is even: no row padding
    rows[:] = np.array(quant)
    out["colormap_160x120.ras"] = _ras(160, 120, 8, rows.tobytes(),
                                       cmap=colours.T.tobytes())
    buf = io.BytesIO()
    Image.fromarray(bgr[:, :, ::-1].copy()).save(
        buf, "JPEG2000", irreversible=True, quality_mode="rates",
        quality_layers=[20])
    out["lossy97_640x480.jp2"] = buf.getvalue()
    buf = io.BytesIO()
    rgb.save(buf, "JPEG2000", no_jp2=True, tile_size=(64, 64),
             progression="RPCL", precinct_size=(32, 32))
    out["lossless53_tiled_160x120.j2k"] = buf.getvalue()
    buf = io.BytesIO()
    rgb.convert("L").save(buf, "JPEG2000", quality_mode="rates",
                          quality_layers=[40, 20, 10], progression="LRCP")
    out["gray_layers_160x120.jp2"] = buf.getvalue()
    frame = np.dstack([small[12:108, 16:144, ::-1], alpha[12:108, 16:144]])
    frame[:, :, 3] = np.where(frame[:, :, 3] < 64, 0, frame[:, :, 3])
    second = small[:96, :128, ::-1].copy()
    out["anim_offset_160x120.webp"] = _animated(
        [_anmf(_webp_frame(frame, lossless=True, exact=True), 16, 12, 128, 96),
         _anmf(_webp_frame(second, quality=80), 0, 0, 128, 96)], (160, 120))
    linear = (small.astype(np.float32) / 255) ** 2.2 * 1.5
    out["rle_160x120.hdr"] = cv2.imencode(".hdr", linear, [
        cv2.IMWRITE_HDR_COMPRESSION, cv2.IMWRITE_HDR_COMPRESSION_RLE])[1].tobytes()
    tiny = cv2.resize(small, (80, 60), interpolation=cv2.INTER_AREA)
    out["color_80x60.pfm"] = cv2.imencode(
        ".pfm", tiny.astype(np.float32) * np.float32(300 / 255))[1].tobytes()
    return out


def _decoded(buf, flag):
    img = cv2.imdecode(np.frombuffer(buf, np.uint8), flag)
    return None if img is None else digest(img)


def damaged_table() -> dict:
    """The committed damaged cases: fault 4's example, then each fixture's
    first copies in its seeded sweep that cv2 reads (under both flags) to
    pixels other than the undamaged file's, and its first that cv2
    refuses."""
    cases = [{"fixture": "baseline_420_640x480.jpg", "edits": [[32080, 0x37 ^ 0x0D]]}]
    for name, (n_read, n_refused) in DAMAGED_PICKS.items():
        with open(os.path.join(HERE, name), "rb") as f:
            buf = f.read()
        clean = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        copies = (idat_flips(buf, SEEDS[name]) if name.endswith(".png")
                  else damaged_copies(buf, SEEDS[name]))
        read, refused = [], []
        for edits, data in copies:
            color = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            gray = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
            if color is None and gray is None and len(refused) < n_refused:
                refused.append(edits)
            elif (color is not None and gray is not None and len(read) < n_read
                  and (color.shape != clean.shape or (color != clean).any())):
                read.append(edits)
        cases += [{"fixture": name, "edits": [list(e) for e in edits]}
                  for edits in read + refused]
    for case in cases:
        data = case_bytes(case)
        case["color"] = _decoded(data, cv2.IMREAD_COLOR)
        case["gray"] = _decoded(data, cv2.IMREAD_GRAYSCALE)
        case["plane"] = (plane_digest(data) if case["color"] and case["gray"]
                         else None)
    return {"opencv": cv2.__version__, "plane_size": 48, "cases": cases}


def config_table() -> dict:
    """Every config file's flattened config, as yaml.safe_load reads it."""
    import yaml

    configs = {}
    folder = os.path.join(REPO, "config")
    for dataset in sorted(os.listdir(folder)):
        for name in sorted(os.listdir(os.path.join(folder, dataset))):
            with open(os.path.join(folder, dataset, name)) as f:
                raw = yaml.safe_load(f)
            flat = {}
            for section in raw:
                flat.update(raw[section])
            configs[f"config/{dataset}/{name}"] = flat
    return {"pyyaml": yaml.__version__, "configs": configs}


def write_tables():
    """damaged.json and the configs' expected.json, from the committed
    fixtures and config files."""
    with open(os.path.join(HERE, "damaged.json"), "w") as f:
        json.dump(damaged_table(), f, indent=1, sort_keys=True)
        f.write("\n")
    os.makedirs(os.path.join(REPO, "tests", "torch_config_fixtures"), exist_ok=True)
    with open(os.path.join(REPO, "tests", "torch_config_fixtures",
                           "expected.json"), "w") as f:
        json.dump(config_table(), f, indent=1, sort_keys=True)
        f.write("\n")


def main():
    table = {"opencv": cv2.__version__, "files": {}}
    for name, data in files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        arr = np.frombuffer(data, np.uint8)
        table["files"][name] = {
            "color": digest(cv2.imdecode(arr, cv2.IMREAD_COLOR)),
            "gray": digest(cv2.imdecode(arr, cv2.IMREAD_GRAYSCALE))}
        print(f"{name}: {len(data)} bytes")
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    write_tables()


if __name__ == "__main__":
    write_tables() if sys.argv[1:] == ["--tables"] else main()
