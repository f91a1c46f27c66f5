"""Inference engine of the port."""

from .evaluator import EVAL_THRESHOLD, Evaluator

__all__ = ["EVAL_THRESHOLD", "Evaluator"]
