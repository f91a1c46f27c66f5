"""Warm predictor and its HTTP front: the model and tokenizer stay
resident across requests (counterpart of cris_tpu/serving.py).

- ``PredictService``: request flow per (image, N sentences): one letterbox
  warp, one tokenize, device batches padded to the next bucket >= N (the
  JAX package's static shapes; here they bound the shapes the card sees),
  one inverse warp per sentence. By default the service folds BatchNorm
  into the convs once at construction and pre-resizes the attnpool
  embedding to the input grid, as the JAX package serves;
  ``fused_bottleneck`` and ``fused_stem`` turn on K5 and K7 on that
  folded model.
- ``make_server`` / ``serve``: a stdlib ThreadingHTTPServer with the JAX
  front's routes, request keys and reply JSON (``python3 -m
  cris_tpu_torch.serve``):

      GET  /healthz, /health -> {"status": "ok", "input_size": ...}
      POST /predict  <- {"image_b64" | "image_path", "sentence" |
                         "sentences": [...], "format": "png_b64" | "rle"}
                     -> {"height", "width", "results": [{"sentence",
                         "foreground_px", "mask_png_b64" | "rle"}]}

  Uploads are decoded by ``data.codec.decode_image`` (``cv2.imdecode``'s
  bits for every format it takes). A request without an image or a sentence, an
  unreadable ``image_path``, bytes the decoder refuses, or an image that
  does not decode to 3 channels (a gray PFM) get 400 (the message in
  ``error``); any other failure 500; another route
  404. Requests are handled on threads of their own; their device
  batches run one at a time on the service's one device thread.
"""

from __future__ import annotations

import base64
import json
import os
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .checkpoint import (BEST_NAME, SCALES_NAME, attach_act_scales,
                         fold_batchnorm, load_cris_checkpoint)
from .data.codec import decode_image, encode_png
from .data.transforms import (get_transform_mats, inverse_warp_prediction,
                              normalize_image, warp_image)
from .engine import EVAL_THRESHOLD, Evaluator
from .models import build_segmenter, is_int8, resolve_dtype
from .utils.logging import logger
from .utils.tokenizer import tokenize


def _buckets(max_batch: int) -> List[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    return out + [max_batch]


def encode_rle(mask: np.ndarray) -> Dict[str, Any]:
    """Binary (h, w) mask -> COCO uncompressed RLE (column-major runs
    starting with zeros), as cris_tpu/serving.py:51-63 writes it."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)  # column-major
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate(([0], change, [flat.size]))
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0]:  # runs must start with a zero-run
        counts = [0] + counts
    return {"counts": counts, "size": [int(h), int(w)]}


class PredictService:
    """Single-model predictor with bucketed batch shapes.

    ``state_dict``: unfolded weights under the port's names (e.g. from
    ``checkpoint.from_jax``). Without it, the weights come from
    ``best_model.pth`` under ``model_dir`` (default
    ``cfg.output_folder/cfg.exp_name``, as ``cris_tpu.serving``), a
    trained CRIS checkpoint read by ``checkpoint.load_cris_checkpoint``;
    when there is none, a warning says so and the random init of seed 0
    is served. (The JAX package's orbax directories are JAX-only.) With
    ``fold_bn`` (the default, as ``cris_tpu.serving``) they are folded
    once (``checkpoint.fold_batchnorm`` with the input resolution) and
    served by the folded model with ``pos_grid = input_size // 32``; the
    kernel switches ``fused_bottleneck`` (K5, on the tails its tail gate
    takes; see ``models.build_segmenter``) and ``fused_stem`` (K7) need it
    and stay off by default: the bench's A/B
    (``python3 -m cris_tpu_torch.bench --ab``) found neither's gain
    larger than the spread of its turns. The forward runs under bf16 autocast
    when ``cfg.precision`` is bf16.

    ``precision: int8`` (folded only, as ``cris_tpu.serving``): the bf16
    forward with the graph rewrites and the int8 sites on K8, with the
    calibrated scales of ``quant_scales.npz`` under ``model_dir``
    (``python3 -m cris_tpu_torch.quantize`` writes it; its gates set the
    site set); without the file a warning says so and the plain-conv
    sites quantise with dynamic scales, the others run bf16."""

    def __init__(self, cfg, model_dir: Optional[str] = None,
                 device="cuda", max_batch: int = 16,
                 fold_bn: bool = True, state_dict=None,
                 fused_bottleneck: Union[bool, str] = False,
                 fused_stem: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.input_size = int(cfg.input_size)
        self.word_len = int(cfg.word_len)
        self.max_batch = int(max_batch)
        # One device batch at a time, always on this one thread: PyTorch
        # keeps cuDNN's execution plans per thread, so a batch on a thread
        # that never ran one (each request's thread, under the HTTP
        # front's ThreadingHTTPServer) builds them all again
        # (chip_smoke.py phase 17(b) times both).
        self._device_thread = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="predict-device")
        model_dir = model_dir or os.path.join(cfg.output_folder, cfg.exp_name)
        if state_dict is None:
            path = os.path.join(model_dir, BEST_NAME)
            if os.path.isfile(path):
                state_dict = load_cris_checkpoint(path)
            else:
                logger.warning(f"no checkpoint under '{model_dir}' -- "
                               "serving random weights")
                state_dict = build_segmenter(cfg, device="cpu",
                                             seed=0).state_dict()
        pos_grid = None
        if fold_bn:
            pos_grid = self.input_size // 32
            state_dict = fold_batchnorm(state_dict, self.input_size)
        model = build_segmenter(cfg, device="meta", fold_bn=fold_bn,
                                pos_grid=pos_grid,
                                fused_bottleneck=fused_bottleneck,
                                fused_stem=fused_stem)
        model.load_state_dict({k: torch.as_tensor(v).float()
                               for k, v in state_dict.items()}, assign=True)
        self.model = model.to(self.device)
        self.act_scales = 0  # int8 sites served with a calibrated scale
        scales = os.path.join(model_dir, SCALES_NAME)
        if is_int8(cfg) and fold_bn:
            if os.path.isfile(scales):
                self.act_scales = attach_act_scales(self.model, scales)
                logger.info(f"=> static int8 activation scales '{scales}' "
                            f"({self.act_scales} sites)")
            else:
                logger.warning(f"precision int8 without '{scales}': dynamic "
                               "scales (run python3 -m "
                               "cris_tpu_torch.quantize first)")
        self.evaluator = Evaluator(self.model, self.input_size,
                                   resolve_dtype(cfg.get("precision", "bf16")))
        self.warmup()

    def warmup(self) -> None:
        """Run every batch bucket once before the first request."""
        size = self.input_size
        for b in _buckets(self.max_batch):
            img = np.zeros((b, 3, size, size), np.float32)
            word = np.zeros((b, self.word_len), np.int64)
            self._device_batch(img, word)

    def _device_batch(self, image: np.ndarray, word: np.ndarray) -> np.ndarray:
        """``Evaluator.predict_probs`` on the service's device thread."""
        return self._device_thread.submit(self.evaluator.predict_probs,
                                          image, word).result()

    def predict(self, image_bgr: np.ndarray, sentences: Sequence[str],
                threshold: float = EVAL_THRESHOLD) -> List[Dict[str, Any]]:
        """BGR uint8 image + N referring expressions -> N binary masks at
        the original resolution, with their foreground pixel counts."""
        _need_bgr(image_bgr)
        if not sentences:
            return []
        rgb = image_bgr[:, :, ::-1]
        hw = (self.input_size, self.input_size)
        mat, inv = get_transform_mats(rgb.shape[:2], hw)
        net_in = normalize_image(warp_image(rgb, mat, hw)).transpose(2, 0, 1)
        words = tokenize(list(sentences), self.word_len, True)

        results: List[Dict[str, Any]] = []
        for start in range(0, len(sentences), self.max_batch):
            chunk = words[start : start + self.max_batch]
            n = chunk.shape[0]
            b = next(x for x in _buckets(self.max_batch) if x >= n)
            images = np.repeat(net_in[None], b, axis=0)
            word_batch = np.zeros((b, self.word_len), chunk.dtype)
            word_batch[:n] = chunk
            probs = self._device_batch(images, word_batch)
            for i in range(n):
                warped = inverse_warp_prediction(probs[i], inv, rgb.shape[:2])
                mask = warped > threshold
                results.append({"sentence": sentences[start + i],
                                "mask": mask,
                                "foreground_px": int(mask.sum())})
        return results


def _need_bgr(image: np.ndarray) -> None:
    """Refuse an image that is not H x W x 3: ``decode_image`` keeps a gray
    PFM's one channel, as ``cv2.imdecode`` does."""
    if image.ndim != 3 or image.shape[2] != 3:
        channels = 1 if image.ndim == 2 else image.shape[2]
        raise ValueError(f"the image decodes to {channels} channel(s); "
                         "predict needs a 3-channel colour image")


class _Handler(BaseHTTPRequestHandler):
    service: PredictService = None  # class attribute, set by make_server

    def log_message(self, fmt, *args):  # to the package logger, not stderr
        logger.info("serve: " + fmt % args)

    def _reply(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/healthz", "/health"):
            self._reply(200, {"status": "ok",
                              "input_size": self.service.input_size})
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/predict":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            buf = self._image_bytes(req)
            image = None
            if buf is not None:
                try:
                    image = decode_image(buf)
                    _need_bgr(image)
                except ValueError as e:  # refused, or not a colour image
                    self._reply(400, {"error": str(e)})
                    return
            sents = req.get("sentences") or (
                [req["sentence"]] if req.get("sentence") else [])
            if image is None or not sents:
                self._reply(400, {"error": "need image_b64|image_path and "
                                           "sentence|sentences"})
                return
            fmt = req.get("format", "png_b64")
            out = []
            for r in self.service.predict(image, sents):
                entry = {"sentence": r["sentence"],
                         "foreground_px": r["foreground_px"]}
                if fmt == "rle":
                    entry["rle"] = encode_rle(r["mask"])
                else:
                    png = encode_png(r["mask"].astype(np.uint8) * 255)
                    entry["mask_png_b64"] = base64.b64encode(png).decode()
                out.append(entry)
            self._reply(200, {"height": int(image.shape[0]),
                              "width": int(image.shape[1]),
                              "results": out})
        except Exception as e:  # noqa: BLE001 -- serving must not die
            logger.warning(f"serve: request failed: {e!r}")
            self._reply(500, {"error": repr(e)})

    @staticmethod
    def _image_bytes(req) -> Optional[bytes]:
        """The request's image bytes; None without an image or when
        ``image_path`` cannot be read (``cv2.imread`` gives None there)."""
        if req.get("image_b64"):
            return base64.b64decode(req["image_b64"])
        if req.get("image_path"):
            try:
                with open(req["image_path"], "rb") as f:
                    return f.read()
            except OSError:
                return None
        return None


def make_server(service: PredictService, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    """The HTTP server, built but not started (the caller owns
    ``serve_forever``; port 0 takes a free port)."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def serve(service: PredictService, host: str = "127.0.0.1",
          port: int = 8080) -> None:
    server = make_server(service, host, port)
    logger.info(f"serving on http://{host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
