"""Host utilities of the port: config, tokenizer, logging, training
meters, the run's seed, the experiment tracker and the profiler window
(no JAX, no YAML, no ``regex``, no wandb at import)."""

from .config import (CfgNode, config_for, cris_r50_refcoco, cris_r101_refcoco,
                     load_cfg_from_cfg_file, merge_cfg_from_list)
from .logging import (AverageMeter, ExperimentTracker, ProgressMeter,
                      log_exceptions, setup_logger)
from .profiling import StepTimer
from .seed import init_random_seed
from .tokenizer import get_tokenizer, tokenize

__all__ = ["AverageMeter", "CfgNode", "ExperimentTracker", "ProgressMeter",
           "StepTimer", "config_for", "cris_r50_refcoco", "cris_r101_refcoco",
           "get_tokenizer", "init_random_seed", "load_cfg_from_cfg_file",
           "log_exceptions", "merge_cfg_from_list", "setup_logger",
           "tokenize"]
