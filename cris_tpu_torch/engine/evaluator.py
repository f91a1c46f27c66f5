"""Test-time inference on the device (counterpart of
cris_tpu/engine/evaluator.py:65-72,101-109): eval forward -> sigmoid in
f32 -> bicubic align_corners=True resize to the network input size.

The dataset-level ``validate``/``inference`` loops come with a later part
of the port; this module carries the device step that serving runs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.resize import resize2d

EVAL_THRESHOLD = 0.35


class Evaluator:
    """``predict_probs`` for one model; ``dtype`` = torch.bfloat16 runs the
    forward under CUDA/CPU autocast (f32 parameters), None in f32."""

    def __init__(self, model: torch.nn.Module, input_size: int,
                 dtype: Optional[torch.dtype] = None):
        self.model = model
        self.input_size = int(input_size)
        self.dtype = dtype
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def predict_probs(self, image: np.ndarray, word: np.ndarray) -> np.ndarray:
        """(B, 3, S, S) float32 image, (B, L) ids -> (B, S, S) float32
        probabilities at network input size, on the host."""
        image_t = torch.from_numpy(np.ascontiguousarray(image, np.float32))
        word_t = torch.from_numpy(np.asarray(word, np.int64))
        image_t, word_t = image_t.to(self.device), word_t.to(self.device)
        with torch.autocast(self.device.type, dtype=self.dtype or torch.bfloat16,
                            enabled=self.dtype is not None):
            pred = self.model(image_t, word_t)
        probs = torch.sigmoid(pred.float())
        size = (self.input_size, self.input_size)
        probs = resize2d(probs, size, "bicubic", align_corners=True)[:, 0]
        return probs.cpu().numpy()
