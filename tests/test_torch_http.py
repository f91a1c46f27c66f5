"""The port's HTTP front and its two command lines on the CPU, against the
JAX package's.

- ``encode_rle`` equals ``cris_tpu.serving.encode_rle``.
- ``tests/test_serving.py::test_http_endpoints``'s requests against the
  port's server, and the formats the port's decoder added for it: a
  progressive JPEG, RGBA / palette / Adam7 PNGs, lossy and lossless WebP,
  BMP, PPM and a CMYK JPEG answered with 200 (and decoded as the JAX
  package's record decode decodes them),
  undecodable bytes with 400 (as the JAX server answers them), a gray PFM
  (one channel) with 400, an unknown route with 404.
- The port's server and the JAX server on the same tiny f32 weights (one
  ``best_model.pth``) answer the same request with the same keys,
  ``height``, ``width`` and RLE ``size``, and masks that agree on at least
  0.999 of the pixels (the bar of
  ``test_torch_serving.py::test_predict_service_matches_jax_chain``).
- ``python3 -m cris_tpu_torch.predict --device cpu`` against
  ``tools/predict.py`` on that checkpoint: the same files and shapes,
  masks to the same bar, and the overlay arithmetic bit for bit on the
  JAX tool's own mask.
- ``python3 -m cris_tpu_torch.serve``'s options.
"""

import base64
import io
import json
import os
import runpy
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from cris_tpu.data.refer import decode_uncompressed_rle
from cris_tpu.data.synthetic import make_record

from test_torch_codec_formats import _png

from cris_tpu_torch import predict as port_predict
from cris_tpu_torch import serve as port_serve
from cris_tpu_torch.checkpoint import from_jax
from cris_tpu_torch.data import decode_image
from cris_tpu_torch.data import decode_mask as port_decode_mask
from cris_tpu_torch.serving import PredictService, encode_rle, make_server
from cris_tpu_torch.utils import load_cfg_from_cfg_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "synthetic", "cris_tiny.yaml")
AGREE = 0.999


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the suite runs several pytest workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _masks():
    rng = np.random.RandomState(0)
    first = np.zeros((6, 9), bool)
    first[0, 0] = True
    return {"random": rng.rand(13, 7) > 0.6, "zeros": np.zeros((4, 5), bool),
            "ones": np.ones((4, 5), bool), "first pixel": first,
            "uint8 0/255": (rng.rand(31, 17) > 0.5).astype(np.uint8) * 255}


@pytest.mark.parametrize("kind", sorted(_masks()))
def test_encode_rle_equals_jax(kind):
    from cris_tpu.serving import encode_rle as jax_encode_rle

    mask = _masks()[kind]
    got = encode_rle(mask)
    assert got == jax_encode_rle(mask)
    back = decode_uncompressed_rle(got["counts"], *got["size"])
    np.testing.assert_array_equal(back.astype(bool), mask.astype(bool))


# ------------------------------------------------------------ the servers

def _cfg():
    cfg = load_cfg_from_cfg_file(TINY)
    cfg.precision = "fp32"
    return cfg


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """One best_model.pth of tiny JAX-init weights (f32), in the port's
    names, as both packages read it."""
    from cris_tpu.models import build_segmenter as jax_build

    cfg = _cfg()
    variables = jax_build(cfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 3)),
                                    jnp.zeros((1, 17), jnp.int32))
    sd = from_jax(jax.tree_util.tree_map(np.asarray, variables))
    folder = tmp_path_factory.mktemp("model")
    torch.save({"state_dict": {k: torch.tensor(np.asarray(v))
                               for k, v in sd.items()}},
               folder / "best_model.pth")
    return str(folder)


def _serving(service):
    server = make_server(service, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def port(checkpoint):
    service = PredictService(_cfg(), model_dir=checkpoint, device="cpu",
                             max_batch=2)
    server, url = _serving(service)
    yield service, url
    server.shutdown()
    server.server_close()


@pytest.fixture(scope="module")
def jax_url(checkpoint):
    from cris_tpu.serving import PredictService as JaxService
    from cris_tpu.serving import make_server as jax_make_server

    server = jax_make_server(JaxService(_cfg(), model_dir=checkpoint,
                                        max_batch=2), "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def _post(url, payload, path="/predict"):
    """(status, reply JSON) of a POST; payload is a dict or raw bytes."""
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _b64(buf):
    return base64.b64encode(buf).decode()


def _photo(h, w, seed, channels=3):
    rng = np.random.RandomState(seed)
    small = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, channels))
    big = cv2.resize(small.astype(np.float32), (w, h),
                     interpolation=cv2.INTER_LINEAR).reshape(h, w, channels)
    return np.clip(big + rng.randn(h, w, channels) * 8, 0, 255).astype(np.uint8)


def _images():
    """Uploads in the formats the port's decoder took up for the front."""
    bgr = _photo(70, 90, seed=1)
    bgra = np.dstack([bgr, _photo(70, 90, seed=2, channels=1)])
    progressive = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
    palette = io.BytesIO()
    Image.fromarray(bgr[:, :, ::-1]).quantize(64).save(palette, "PNG")
    lossless = io.BytesIO()
    Image.fromarray(bgra[:, :, [2, 1, 0, 3]]).save(lossless, "WEBP",
                                                  lossless=True)
    cmyk = io.BytesIO()
    Image.fromarray(np.dstack([bgr, bgr[:, :, 1] // 3]), "CMYK").save(
        cmyk, "JPEG", quality=90)
    return {"baseline jpeg": make_record(1, seed=3)["img"],
            "progressive jpeg": progressive.tobytes(),
            "rgba png": cv2.imencode(".png", bgra)[1].tobytes(),
            "palette png": palette.getvalue(),
            "adam7 png": _png(bgr[:, :, ::-1], 2, 8, interlace=True),
            "lossy webp": cv2.imencode(".webp", bgr,
                                       [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes(),
            "lossless webp": lossless.getvalue(),
            "bmp": cv2.imencode(".bmp", bgr)[1].tobytes(),
            "ppm": cv2.imencode(".ppm", bgr)[1].tobytes(),
            "cmyk jpeg": cmyk.getvalue()}


def test_http_endpoints(port):
    """tests/test_serving.py::test_http_endpoints against the port."""
    service, url = port
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health == {"status": "ok", "input_size": 64}
    with urllib.request.urlopen(url + "/health", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"

    rec = make_record(1, seed=3)
    status, out = _post(url, {"image_b64": _b64(rec["img"]),
                              "sentences": [rec["sents"][0], "something else"],
                              "format": "rle"})
    assert status == 200 and len(out["results"]) == 2
    m = decode_uncompressed_rle(out["results"][0]["rle"]["counts"],
                                *out["results"][0]["rle"]["size"])
    assert m.shape == (out["height"], out["width"])
    assert int(m.sum()) == out["results"][0]["foreground_px"]

    # png format (the default): cv2 decodes the reply to exactly mask * 255
    status, out = _post(url, {"image_b64": _b64(rec["img"]),
                              "sentence": rec["sents"][0]})
    assert status == 200
    png = base64.b64decode(out["results"][0]["mask_png_b64"])
    mask = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_GRAYSCALE)
    want = service.predict(decode_image(rec["img"]), [rec["sents"][0]])[0]
    np.testing.assert_array_equal(mask, want["mask"].astype(np.uint8) * 255)
    assert out["results"][0]["foreground_px"] == want["foreground_px"]

    # bad request -> 400, not a dead server
    assert _post(url, b"{}")[0] == 400


@pytest.mark.parametrize("kind", sorted(_images()))
def test_the_front_answers_each_format(port, kind):
    """Each upload is answered with 200, the decoded size and masks equal
    to PredictService.predict on decode_image's pixels (which equal
    cv2.imdecode's)."""
    service, url = port
    buf = _images()[kind]
    ref = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(decode_image(buf), ref)
    status, out = _post(url, {"image_b64": _b64(buf), "format": "rle",
                              "sentences": ["the left one", "a thing"]})
    assert status == 200, out
    assert (out["height"], out["width"]) == ref.shape[:2]
    want = service.predict(ref, ["the left one", "a thing"])
    for r, w in zip(out["results"], want):
        got = decode_uncompressed_rle(r["rle"]["counts"], *r["rle"]["size"])
        np.testing.assert_array_equal(got.astype(bool), w["mask"])


@pytest.mark.parametrize("kind", sorted(_images()))
def test_decode_equals_the_jax_records_decode(kind):
    """decode_image / decode_mask against cris_tpu.data.transforms' decode
    of the same record bytes (cv2.imdecode under both flags)."""
    from cris_tpu.data.transforms import decode_image as jax_decode_image
    from cris_tpu.data.transforms import decode_mask as jax_decode_mask

    buf = _images()[kind]
    np.testing.assert_array_equal(decode_image(buf), jax_decode_image(buf))
    np.testing.assert_array_equal(port_decode_mask(buf), jax_decode_mask(buf))


def test_image_path_requests(port, jax_url, tmp_path):
    """image_path reads the file; a path that cannot be read is a 400 in
    both fronts."""
    _, url = port
    path = tmp_path / "in.png"
    path.write_bytes(_images()["rgba png"])
    status, out = _post(url, {"image_path": str(path), "sentence": "x",
                              "format": "rle"})
    assert status == 200 and (out["height"], out["width"]) == (70, 90)
    missing = {"image_path": str(tmp_path / "nope.jpg"), "sentence": "x"}
    assert _post(url, missing)[0] == _post(jax_url, missing)[0] == 400


@pytest.mark.parametrize("payload", ["undecodable", "empty", "no sentence"])
def test_bad_requests_answer_400_as_jax_does(port, jax_url, payload):
    _, url = port
    req = {"undecodable": {"image_b64": _b64(b"not an image at all"),
                           "sentence": "x"},
           "empty": {},
           "no sentence": {"image_b64": _b64(_images()["baseline jpeg"])},
           }[payload]
    status, out = _post(url, req)
    assert status == 400 == _post(jax_url, req)[0]
    if payload == "undecodable":  # the decoder's message
        assert "not a JPEG or PNG" in out["error"]


def test_a_gray_pfm_answers_400(port):
    """A gray PFM decodes to one channel (as cv2.imdecode gives it under
    IMREAD_COLOR): the front answers 400 naming that, and
    PredictService.predict raises ValueError, where indexing its channels
    would fail."""
    service, url = port
    h, w = 12, 10
    pfm = (b"Pf\n%d %d\n-1.0\n" % (w, h)
           + np.linspace(0, 255, h * w, dtype="<f4").tobytes())
    assert decode_image(pfm).shape == (h, w)
    status, out = _post(url, {"image_b64": _b64(pfm), "sentence": "x"})
    assert status == 400
    assert "1 channel(s)" in out["error"] and "3-channel" in out["error"]
    with pytest.raises(ValueError, match="1 channel"):
        service.predict(decode_image(pfm), ["x"])


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_unknown_route_is_404(port, method):
    _, url = port
    req = urllib.request.Request(url + "/nope", method=method,
                                 data=b"{}" if method == "POST" else None)
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(req, timeout=30)
    assert info.value.code == 404
    assert json.loads(info.value.read()) == {"error": "no route /nope"}


def test_concurrent_requests_share_one_device_thread(port, monkeypatch):
    """8 requests at once, each on its own handler thread: every reply
    equals the one a lone request gets, and every device batch ran on the
    service's one device thread (not a handler's, whose fresh cuDNN plans
    would cost a rebuild each request)."""
    import concurrent.futures
    import sys as _sys

    service, url = port
    req = {"image_b64": _b64(_images()["progressive jpeg"]), "format": "rle",
           "sentences": ["the left one", "a thing"]}
    alone = _post(url, req)
    threads = []
    inner = service.evaluator.predict_probs

    def recorded(image, word):
        threads.append(threading.get_ident())
        return inner(image, word)

    monkeypatch.setattr(service.evaluator, "predict_probs", recorded)
    switch = _sys.getswitchinterval()
    _sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            replies = list(pool.map(lambda _: _post(url, req), range(8),
                                    timeout=300))
    finally:
        _sys.setswitchinterval(switch)
    assert replies == [alone] * 8
    assert len(threads) == 8 and len(set(threads)) == 1
    assert threads[0] != threading.get_ident()


@pytest.mark.parametrize("kind", ["baseline jpeg", "progressive jpeg",
                                  "rgba png", "lossy webp", "lossless webp",
                                  "bmp", "ppm", "cmyk jpeg"])
@pytest.mark.parametrize("fmt", ["rle", "png_b64"])
def test_port_server_matches_the_jax_server(port, jax_url, kind, fmt):
    """One request to both servers on the same weights: the same reply
    keys, height, width and RLE size, masks agreeing on >= 0.999."""
    _, url = port
    sents = ["the left one", "something red", "a thing 2"]
    req = {"image_b64": _b64(_images()[kind]), "sentences": sents,
           "format": fmt}
    (status, ours), (jstatus, theirs) = _post(url, req), _post(jax_url, req)
    assert status == jstatus == 200
    assert set(ours) == set(theirs) == {"height", "width", "results"}
    assert (ours["height"], ours["width"]) == (theirs["height"],
                                               theirs["width"])
    for a, b in zip(ours["results"], theirs["results"]):
        assert set(a) == set(b) and a["sentence"] == b["sentence"]
        if fmt == "rle":
            assert a["rle"]["size"] == b["rle"]["size"]
            ma, mb = (decode_uncompressed_rle(r["rle"]["counts"],
                                              *r["rle"]["size"])
                      for r in (a, b))
        else:
            ma, mb = (cv2.imdecode(np.frombuffer(base64.b64decode(
                r["mask_png_b64"]), np.uint8), cv2.IMREAD_GRAYSCALE)
                for r in (a, b))
        assert ma.shape == mb.shape == (ours["height"], ours["width"])
        assert (ma == mb).mean() >= AGREE
        assert abs(a["foreground_px"] - b["foreground_px"]) <= (
            (1 - AGREE) * ma.size)


# ------------------------------------------------------ the command lines

@pytest.fixture(scope="module")
def predicted(checkpoint, tmp_path_factory):
    """tools/predict.py run in this process on the checkpoint, its
    cv2.imwrite calls captured (the arrays it writes), beside
    ``python3 -m cris_tpu_torch.predict --device cpu`` on the same
    arguments."""
    folder = tmp_path_factory.mktemp("predict")
    image = folder / "in.jpg"
    image.write_bytes(cv2.imencode(".jpg", _photo(75, 110, seed=4),
                                   [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1])
    sents = ["the left one", "something red"]

    def args(tool):
        out = folder / tool
        out.mkdir()
        return ["--config", TINY, "--image", str(image), "--sent", sents[0],
                "--sent", sents[1], "--out", str(out / "mask.png"),
                "--overlay", str(out / "overlay.jpg"), "--checkpoint",
                checkpoint]

    written = {}
    real_imwrite = cv2.imwrite

    def imwrite(path, img):
        written[os.path.basename(path)] = img.copy()
        return real_imwrite(path, img)

    argv, sys.argv = sys.argv, ["predict.py", *args("jax"),
                                "--opts", "precision", "fp32"]
    cv2.imwrite = imwrite
    try:
        runpy.run_path(os.path.join(REPO, "tools", "predict.py"),
                       run_name="__main__")
    finally:
        cv2.imwrite, sys.argv = real_imwrite, argv
    proc = subprocess.run(
        [sys.executable, "-m", "cris_tpu_torch.predict", *args("port"),
         "--device", "cpu", "--opts", "precision", "fp32"], cwd=REPO,
        capture_output=True, text=True,
        timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    return folder, written, cv2.imread(str(image))


def test_predict_entry_writes_what_the_jax_tool_writes(predicted):
    folder, written, bgr = predicted
    names = sorted(written)
    assert names == ["mask_0.png", "mask_1.png", "overlay_0.jpg",
                     "overlay_1.jpg"]
    assert sorted(os.listdir(folder / "port")) == names
    for i in range(2):
        ours = cv2.imread(str(folder / "port" / f"mask_{i}.png"),
                          cv2.IMREAD_UNCHANGED)
        theirs = written[f"mask_{i}.png"]
        assert ours.shape == theirs.shape == bgr.shape[:2]
        assert ours.dtype == np.uint8 and set(np.unique(ours)) <= {0, 255}
        assert (ours == theirs).mean() >= AGREE
        overlay = cv2.imread(str(folder / "port" / f"overlay_{i}.jpg"))
        assert overlay.shape == written[f"overlay_{i}.jpg"].shape == bgr.shape


def test_overlay_equals_the_jax_tools_on_its_mask(predicted):
    """The port's overlay of the JAX tool's own mask is the array the JAX
    tool wrote, bit for bit."""
    _, written, bgr = predicted
    for i in range(2):
        mask = written[f"mask_{i}.png"]
        assert mask.any()
        np.testing.assert_array_equal(port_predict.overlay(bgr, mask),
                                      written[f"overlay_{i}.jpg"])


def test_predict_entry_refuses_an_unreadable_image(tmp_path):
    bad = tmp_path / "in.gif"
    bad.write_bytes(b"GIF89a not an image")
    for path in (bad, tmp_path / "missing.jpg"):
        with pytest.raises(SystemExit, match=f"cannot read image {path}"):
            port_predict.main(["--config", TINY, "--image", str(path),
                               "--sent", "x", "--device", "cpu"])


def test_serve_entry_builds_the_service_it_is_asked_for(monkeypatch,
                                                        checkpoint):
    """The daemon's options reach PredictService and serve; with no card
    and no --device cpu it refuses."""
    calls = []
    monkeypatch.setattr(port_serve, "serve",
                        lambda service, host, port: calls.append(
                            (service, host, port)))
    port_serve.main(["--config", TINY, "--checkpoint", checkpoint,
                     "--port", "0", "--max-batch", "2", "--no-fold-bn",
                     "--device", "cpu", "--opts", "precision", "fp32"])
    (service, host, port), = calls
    assert (host, port, service.max_batch) == ("127.0.0.1", 0, 2)
    assert service.device.type == "cpu"
    assert any(k.endswith("running_mean") for k in service.model.state_dict())
    port_serve.main(["--config", TINY, "--checkpoint", checkpoint,
                     "--device", "cpu"])
    service = calls[-1][0]
    assert service.max_batch == 16 and calls[-1][1:] == ("127.0.0.1", 8080)
    assert not any(k.endswith("running_mean") and "norm_layer" not in k
                   for k in service.model.state_dict())  # folded
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            port_serve.main(["--config", TINY])
