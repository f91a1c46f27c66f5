"""Test-time inference on the device (counterpart of
cris_tpu/engine/evaluator.py:65-72,101-109): eval forward -> sigmoid in
f32 -> bicubic align_corners=True resize to the network input size.

The dataset-level ``validate``/``inference`` loops come with a later part
of the port; this module carries the device step that serving and the
bench run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.resize import resize2d

EVAL_THRESHOLD = 0.35


class Evaluator:
    """``device_probs`` and ``predict_probs`` for one model; ``dtype`` =
    torch.bfloat16 runs the forward under CUDA/CPU autocast (f32
    parameters), None in f32."""

    def __init__(self, model: torch.nn.Module, input_size: int,
                 dtype: Optional[torch.dtype] = None):
        self.model = model
        self.input_size = int(input_size)
        self.dtype = dtype
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def device_probs(self, image: torch.Tensor, word: torch.Tensor
                     ) -> torch.Tensor:
        """The device step on the model's device: (B, 3, S, S) float32
        image, (B, L) ids -> (B, S, S) float32 probabilities at network
        input size, left on the device."""
        with torch.autocast(self.device.type, dtype=self.dtype or torch.bfloat16,
                            enabled=self.dtype is not None):
            pred = self.model(image, word)
        probs = torch.sigmoid(pred.float())
        size = (self.input_size, self.input_size)
        return resize2d(probs, size, "bicubic", align_corners=True)[:, 0]

    def predict_probs(self, image: np.ndarray, word: np.ndarray) -> np.ndarray:
        """``device_probs`` from and to the host: (B, 3, S, S) float32
        image, (B, L) ids -> (B, S, S) float32 probabilities."""
        image_t = torch.from_numpy(np.ascontiguousarray(image, np.float32))
        word_t = torch.from_numpy(np.asarray(word, np.int64))
        probs = self.device_probs(image_t.to(self.device),
                                  word_t.to(self.device))
        return probs.cpu().numpy()
