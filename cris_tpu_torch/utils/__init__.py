"""Host utilities of the port: config and tokenizer (no JAX, no YAML,
no ``regex`` at import)."""

from .config import CfgNode, cris_r50_refcoco, load_cfg_from_cfg_file
from .tokenizer import get_tokenizer, tokenize

__all__ = ["CfgNode", "cris_r50_refcoco", "get_tokenizer",
           "load_cfg_from_cfg_file", "tokenize"]
