"""Warm predictor: the model and tokenizer stay resident across requests
(counterpart of cris_tpu/serving.py:43-48,65-186).

Request flow per (image, N sentences): one letterbox warp, one tokenize,
device batches padded to the next bucket >= N (the JAX package's static
shapes; here they bound the shapes the card sees), one inverse warp per
sentence. By default the service folds BatchNorm into the convs once at
construction and pre-resizes the attnpool embedding to the input grid,
as the JAX package serves; ``fused_bottleneck`` and ``fused_stem`` turn
on K5 and K7 on that folded model. The HTTP front comes later.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .checkpoint import BEST_NAME, fold_batchnorm, load_cris_checkpoint
from .data.transforms import (get_transform_mats, inverse_warp_prediction,
                              normalize_image, warp_image)
from .engine import EVAL_THRESHOLD, Evaluator
from .models import build_segmenter, resolve_dtype
from .utils.logging import logger
from .utils.tokenizer import tokenize


def _buckets(max_batch: int) -> List[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    return out + [max_batch]


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
    when ``cfg.precision`` is bf16."""

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
        self._lock = threading.Lock()  # one device batch at a time
        if state_dict is None:
            model_dir = model_dir or os.path.join(cfg.output_folder,
                                                  cfg.exp_name)
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
        self.evaluator = Evaluator(self.model, self.input_size,
                                   resolve_dtype(cfg.get("precision", "bf16")))
        self.warmup()

    def warmup(self) -> None:
        """Run every batch bucket once before the first request."""
        size = self.input_size
        for b in _buckets(self.max_batch):
            img = np.zeros((b, 3, size, size), np.float32)
            word = np.zeros((b, self.word_len), np.int64)
            self.evaluator.predict_probs(img, word)

    def predict(self, image_bgr: np.ndarray, sentences: Sequence[str],
                threshold: float = EVAL_THRESHOLD) -> List[Dict[str, Any]]:
        """BGR uint8 image + N referring expressions -> N binary masks at
        the original resolution, with their foreground pixel counts."""
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
            with self._lock:
                probs = self.evaluator.predict_probs(images, word_batch)
            for i in range(n):
                warped = inverse_warp_prediction(probs[i], inv, rgb.shape[:2])
                mask = warped > threshold
                results.append({"sentence": sentences[start + i],
                                "mask": mask,
                                "foreground_px": int(mask.sum())})
        return results
