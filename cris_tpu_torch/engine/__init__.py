"""Inference and training engine of the port."""

from .evaluator import EVAL_THRESHOLD, Evaluator
from .metrics import (intersection_and_union, mask_inter_union, mask_iou,
                      summarize_ious, train_metrics, val_metric)
from .trainer import (apply_gradients, lr_at_epoch, make_optimizer,
                      multistep_schedule, step_seed, train_epoch, train_step)

__all__ = ["EVAL_THRESHOLD", "Evaluator", "apply_gradients",
           "intersection_and_union", "lr_at_epoch", "make_optimizer",
           "mask_inter_union", "mask_iou", "multistep_schedule", "step_seed",
           "summarize_ious", "train_epoch", "train_metrics", "train_step",
           "val_metric"]
