"""Command-line bootstrap of the port's entry points (counterpart of
cris_tpu/cli.py:89-103): ``--config path.yaml [--device cpu] --opts KEY
VALUE ...``.

The YAML file is read with PyYAML where it is installed; without it (the
card's machine) the RefCOCO presets of ``utils.config.config_for`` serve
their two files. ``--opts`` takes the rest of the command line, so
``--device`` comes before it.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .utils.config import (CfgNode, config_for, load_cfg_from_cfg_file,
                           merge_cfg_from_list)


def load_config(path: str) -> CfgNode:
    """The flat config of a YAML file: parsed when PyYAML is installed,
    else ``config_for``'s preset."""
    try:
        import yaml  # noqa: F401
    except ImportError:
        return config_for(path)
    return load_cfg_from_cfg_file(path)


def get_parser(description: str = "CRIS referring expression segmentation",
               argv: Optional[Sequence[str]] = None) -> CfgNode:
    """The config of ``--config`` with ``--opts`` applied, and ``device``
    ("cuda" unless ``--device`` names another; never picked for the
    caller)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", required=True, type=str,
                        help="config file")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; comes before --opts")
    parser.add_argument("--opts", default=None, nargs=argparse.REMAINDER,
                        help="override some settings in the config.")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    if args.opts is not None:
        cfg = merge_cfg_from_list(cfg, args.opts)
    cfg.device = args.device
    return cfg
