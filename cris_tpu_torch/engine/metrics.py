"""Segmentation metrics (counterpart of cris_tpu/engine/metrics.py).

On the device, in torch: the train IoU / Pr@50 and the per-sample IoUs at
prediction resolution (sigmoid in f32, binarised at the threshold, any
nonzero target is foreground, union + 1e-6), and the foreground
intersection and union areas. On the host, in numpy: the eval IoU at the
original resolution after the inverse warp, its intersection and union
counts (summed over a dataset they give the overall IoU, oIoU) and
Pr@{50..90}.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

EVAL_THRESHOLD = 0.35
UNION_EPS = 1e-6


def _sample_ious(pred_logits: torch.Tensor, target: torch.Tensor,
                 threshold: float) -> torch.Tensor:
    b = pred_logits.shape[0]
    probs = torch.sigmoid(pred_logits.detach().float().reshape(b, -1))
    pred = probs >= threshold
    tgt = target.detach().reshape(b, -1) > 0
    inter = (pred & tgt).sum(dim=1).float()
    union = (pred | tgt).sum(dim=1).float()
    return inter / (union + UNION_EPS)


def train_metrics(pred_logits: torch.Tensor, target: torch.Tensor,
                  threshold: float = EVAL_THRESHOLD, pr_iou: float = 0.5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(batch mean IoU x 100, Pr@pr_iou x 100) as 0-dim f32 tensors on the
    logits' device; nothing is copied to the host."""
    ious = _sample_ious(pred_logits, target, threshold)
    return 100.0 * ious.mean(), 100.0 * (ious > pr_iou).float().mean()


def val_metric(pred_logits: torch.Tensor, target: torch.Tensor,
               threshold: float = EVAL_THRESHOLD) -> torch.Tensor:
    """(B,) IoUs at prediction resolution (the reference's ValMetricGPU)."""
    return _sample_ious(pred_logits, target, threshold)


def intersection_and_union(pred_logits: torch.Tensor, target: torch.Tensor,
                           threshold: float = 0.5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Foreground intersection and union areas over the whole input, as
    f32 scalars (the reference's intersectionAndUnionGPU, binary)."""
    pred = (torch.sigmoid(pred_logits.detach().float()) >= threshold).reshape(-1)
    tgt = (target.detach().float() > 0).reshape(-1)
    inter = (pred & tgt).sum().float()
    return inter, pred.sum().float() + tgt.sum().float() - inter


def mask_iou(pred_bool: np.ndarray, mask: np.ndarray) -> float:
    """IoU of a binarised prediction and a {0, 1} GT mask on the host."""
    inter = np.logical_and(pred_bool, mask)
    union = np.logical_or(pred_bool, mask)
    return float(np.sum(inter) / (np.sum(union) + UNION_EPS))


def mask_inter_union(pred_bool: np.ndarray, mask: np.ndarray):
    """(intersection, union) pixel counts."""
    inter = int(np.logical_and(pred_bool, mask).sum())
    union = int(np.logical_or(pred_bool, mask).sum())
    return inter, union


def summarize_ious(iou_list: Sequence[float]) -> Tuple[float, Dict[str, float]]:
    """(mean IoU, {Pr@50..Pr@90}) over per-sample IoUs."""
    ious = np.asarray(iou_list, np.float64)
    prec = {}
    for i, thres in enumerate(np.arange(0.5, 1.0, 0.1)):
        prec[f"Pr@{(i + 5) * 10}"] = float((ious > thres).mean())
    return float(ious.mean()), prec
