"""Host utilities of the port: config, tokenizer and training meters (no
JAX, no YAML, no ``regex`` at import)."""

from .config import CfgNode, cris_r50_refcoco, load_cfg_from_cfg_file
from .logging import AverageMeter, ProgressMeter
from .tokenizer import get_tokenizer, tokenize

__all__ = ["AverageMeter", "CfgNode", "ProgressMeter", "cris_r50_refcoco",
           "get_tokenizer", "load_cfg_from_cfg_file", "tokenize"]
