"""Command-line bootstrap of the port's entry points (counterpart of
cris_tpu/cli.py:89-161): ``--config path.yaml [--device cpu] --opts KEY
VALUE ...``, and the training model with its initial weights.

The YAML file is read by ``utils.yaml_subset`` (no PyYAML), the same
on every machine. ``--opts`` takes the rest of the command line, so
``--device`` comes before it. Under ``torchrun`` each rank joins the
process group, takes its own card and its place in the (data, model)
rank grid of ``dp_size`` x ``tp_size`` (``init_device``); with
``tp_size`` > 1 the model is built full and split over its model group
(``build_model``), and weights load full and are split likewise
(``load_initial_weight``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from .checkpoint import load_clip_torchscript, load_cris_checkpoint
from .models import CRIS, build_segmenter, shard_model
from .parallel import grid, init_distributed, init_grid
from .parallel.tensor import load_full_state_dict
from .utils.config import CfgNode, load_cfg_from_cfg_file, merge_cfg_from_list
from .utils.logging import logger


load_config = load_cfg_from_cfg_file  # the flat config of a YAML file


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


def init_device(cfg, what: str) -> torch.device:
    """This rank's device for an entry point that would ``what`` ("train",
    "evaluate") on ``cfg.device``: with torchrun's environment the process
    group is joined (NCCL on the card, gloo on the CPU) and a "cuda"
    device becomes ``cuda:{LOCAL_RANK}`` (``parallel.init_distributed``);
    then ``dp_size`` and ``tp_size`` are checked against the world and
    the ranks laid out on their grid (``parallel.init_grid``, the JAX
    ``make_mesh_from_cfg``). No card and no ``--device cpu`` is an error,
    never a fallback."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: pass --device cpu to {what} on "
                           "the CPU")
    device = init_distributed(device)
    init_grid(cfg.get("dp_size", -1), cfg.get("tp_size", 1))
    return device


def build_model(cfg, device, train: bool = True) -> CRIS:
    """CRIS for training on ``device`` (counterpart of
    ``build_model_and_variables``, cris_tpu/cli.py:105-144): when
    ``cfg.clip_pretrain`` is an existing TorchScript archive, the
    architecture is inferred from it and ``backbone.*`` holds its weights
    while the neck, decoder and projector keep their init from
    ``cfg.manual_seed``; otherwise everything is initialised from the
    seed on the preset that ``cfg.clip_pretrain`` names.

    Every backbone tensor must come from the archive but the attnpool's
    ``connect`` conv and BN, which CRIS adds to CLIP and a released
    archive lacks: they keep their init, as the reference's non-strict
    load leaves them (a JAX package load needs them in the archive). A
    ViT archive is refused with ``build_segmenter``'s ValueError. Under
    tensor parallel the full model so made is then split over this
    rank's model group (``models.shard_model``)."""
    path = cfg.get("clip_pretrain")
    clip_sd, clip_config = None, None
    if path and os.path.isfile(path):
        logger.info(f"=> loading CLIP weights from '{path}'")
        clip_sd, clip_config = load_clip_torchscript(path)
    model = build_segmenter(cfg, device="cpu",
                            seed=int(cfg.get("manual_seed", 0)), train=train,
                            clip_config=clip_config)
    if clip_sd is not None:
        missing, unexpected = model.backbone.load_state_dict(clip_sd,
                                                             strict=False)
        missing = [k for k in missing
                   if not k.startswith("visual.attnpool.connect.")]
        if missing or unexpected:
            raise ValueError(f"'{path}' does not fit the CLIP it describes: "
                             f"missing {missing[:5]}, unexpected "
                             f"{unexpected[:5]}")
    return shard_model(model, grid()).to(device)


def load_initial_weight(cfg, model: torch.nn.Module) -> torch.nn.Module:
    """``cfg.weight``, a trained CRIS ``.pth`` file, loaded into ``model``
    with every key matched, each sharded parameter taking its slice
    (counterpart of cris_tpu/cli.py:147-161). The JAX package's orbax
    directories are not read."""
    path = cfg.get("weight")
    if not path:
        return model
    if os.path.isdir(path):
        raise ValueError(f"'{path}' is a directory: the port reads initial "
                         "weights only from .pth files, not orbax "
                         "checkpoints")
    logger.info(f"=> loading initial weight (torch) '{path}'")
    load_full_state_dict(model, load_cris_checkpoint(path), strict=True)
    return model
