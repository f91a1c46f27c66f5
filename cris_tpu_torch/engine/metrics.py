"""Train-time segmentation metrics on the device (counterpart of
cris_tpu/engine/metrics.py:22-39): sigmoid in f32, binarised at 0.35,
any nonzero target is foreground, IoU with union + 1e-6."""

from __future__ import annotations

from typing import Tuple

import torch

EVAL_THRESHOLD = 0.35
UNION_EPS = 1e-6


def train_metrics(pred_logits: torch.Tensor, target: torch.Tensor,
                  threshold: float = EVAL_THRESHOLD, pr_iou: float = 0.5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(batch mean IoU x 100, Pr@pr_iou x 100) as 0-dim f32 tensors on the
    logits' device; nothing is copied to the host."""
    b = pred_logits.shape[0]
    probs = torch.sigmoid(pred_logits.detach().float().reshape(b, -1))
    pred = probs >= threshold
    tgt = target.detach().reshape(b, -1) > 0
    inter = (pred & tgt).sum(dim=1).float()
    union = (pred | tgt).sum(dim=1).float()
    ious = inter / (union + UNION_EPS)
    return 100.0 * ious.mean(), 100.0 * (ious > pr_iou).float().mean()
