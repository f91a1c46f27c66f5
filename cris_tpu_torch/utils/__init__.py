"""Host utilities of the port: config, tokenizer, logging and training
meters (no JAX, no YAML, no ``regex`` at import)."""

from .config import (CfgNode, config_for, cris_r50_refcoco, cris_r101_refcoco,
                     load_cfg_from_cfg_file, merge_cfg_from_list)
from .logging import (AverageMeter, ProgressMeter, log_exceptions,
                      setup_logger)
from .tokenizer import get_tokenizer, tokenize

__all__ = ["AverageMeter", "CfgNode", "ProgressMeter", "config_for",
           "cris_r50_refcoco", "cris_r101_refcoco",
           "get_tokenizer", "load_cfg_from_cfg_file", "log_exceptions",
           "merge_cfg_from_list", "setup_logger", "tokenize"]
