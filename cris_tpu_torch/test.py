"""Standalone evaluation entry point of the port (counterpart of the
repository's test.py):

    python3 -m cris_tpu_torch.test --config config/refcoco/cris_r50.yaml \\
        [--device cpu] --opts TEST.test_split val-test TEST.test_lmdb <uri>
    torchrun --nproc_per_node=N -m cris_tpu_torch.test --config ... \\
        [--device cpu] --opts ...

Evaluates every sentence of every ref of ``test_lmdb`` (a ``.refpack``
file or a ``synthetic://COUNT?seed=S`` URI) with the weights of
``{output_folder}/{exp_name}/best_model.pth``, a trained CRIS checkpoint;
without that file it raises. BN is folded into the convs when
``fold_bn_eval`` is set, and the forward runs at the config's precision,
on the card unless ``--device cpu`` is given (no card and no
``--device cpu`` is an error). Under torchrun each rank takes
``cuda:{LOCAL_RANK}``, scores the refs ``rank, rank + N, ...`` and the
IoUs are gathered at the end (``Evaluator.inference``); rank 0 logs.
Logs to stderr and ``test.log`` in the output directory: IoU, Pr@50..90
and oIoU as the JAX package's test.py does, then a line ``=> run:
{...}`` with the pairs scored (summed over the ranks), the device batches,
the seconds on the host clock, the pairs per second, on the card the
seconds its batches took between CUDA events (those three rank 0's), the
card's name and power limit, and ``world_size``.
"""

from __future__ import annotations

import json
import os

import torch

from . import cli
from .bench import card, eval_model
from .checkpoint import (BEST_NAME, SCALES_NAME, attach_act_scales,
                         fold_batchnorm, load_cris_checkpoint)
from .data import RefDataset
from .engine import Evaluator
from .models import build_segmenter, is_int8, resolve_dtype
from .parallel import (allgather_floats, close_distributed, process_count,
                       process_index)
from .utils.logging import log_exceptions, logger, setup_logger


def load_model(cfg, path: str, device: torch.device) -> torch.nn.Module:
    """The eval model with the weights of a CRIS ``.pth`` file on
    ``device``: BN folded (and the attnpool embedding resized to the input
    grid) when ``cfg.fold_bn_eval`` is set, as serving folds it. At
    ``precision: int8`` the folded model takes the int8 sites' scales from
    ``quant_scales.npz`` beside the checkpoint when it is there
    (test.py:84-90)."""
    sd = load_cris_checkpoint(path)
    if cfg.get("fold_bn_eval", True):
        logger.info("=> folding BatchNorm into conv weights for inference")
        model = eval_model(cfg, device, fold_batchnorm(sd, cfg.input_size))
        scales = os.path.join(os.path.dirname(path), SCALES_NAME)
        if is_int8(cfg) and os.path.isfile(scales):
            n = attach_act_scales(model, scales)
            logger.info(f"=> static int8 activation scales '{scales}' "
                        f"({n} sites)")
        return model
    model = build_segmenter(cfg, device="meta")
    model.load_state_dict({k: torch.as_tensor(v).float() for k, v in sd.items()},
                          assign=True)
    return model.to(device)


@log_exceptions
def main(argv=None):
    """Run the evaluation; returns (mean IoU, {Pr@50..Pr@90, oIoU})."""
    cfg = cli.get_parser("CRIS evaluation (PyTorch port)", argv)
    device = cli.init_device(cfg, "evaluate")
    cfg.output_dir = os.path.join(cfg.output_folder, cfg.exp_name)
    if cfg.get("visualize"):
        cfg.vis_dir = os.path.join(cfg.output_dir, "vis")
        os.makedirs(cfg.vis_dir, exist_ok=True)
    setup_logger(cfg.output_dir, process_index=process_index(),
                 filename="test.log", mode="a")
    logger.info(cfg)
    dtype = resolve_dtype(cfg.get("precision", "bf16"))

    test_data = RefDataset(cfg.test_lmdb, cfg.mask_root, cfg.dataset,
                           cfg.test_split, "test", cfg.input_size, cfg.word_len)
    path = os.path.join(cfg.output_dir, BEST_NAME)
    if not os.path.isfile(path):
        raise ValueError(f"=> no checkpoint found at '{path}'")
    logger.info(f"=> loading checkpoint '{path}'")
    model = load_model(cfg, path, device)

    evaluator = Evaluator(model, cfg.input_size, dtype,
                          batch_size=cfg.get("batch_size_val", 32))
    iou, prec = evaluator.inference(test_data, word_len=cfg.word_len,
                                    visualize=bool(cfg.get("visualize")),
                                    vis_dir=cfg.get("vis_dir"))
    run = dict(evaluator.last_run)
    run["pairs"] = int(sum(r[0] for r in allgather_floats([run["pairs"]])))
    run["world_size"] = process_count()
    run["pairs_per_s"] = run["pairs"] / run["seconds"]
    run["card"] = card(device)
    logger.info(f"=> run: {json.dumps(run)}")
    return iou, prec


if __name__ == "__main__":
    try:
        main()
    finally:
        close_distributed()
