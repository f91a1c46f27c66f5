"""Inference and training engine of the port."""

from .evaluator import EVAL_THRESHOLD, Evaluator
from .metrics import train_metrics
from .trainer import (apply_gradients, lr_at_epoch, make_optimizer, multistep_schedule,
                      step_seed, train_epoch, train_step)

__all__ = ["EVAL_THRESHOLD", "Evaluator", "apply_gradients", "lr_at_epoch", "make_optimizer",
           "multistep_schedule", "step_seed", "train_epoch", "train_metrics",
           "train_step"]
