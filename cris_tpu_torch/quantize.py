"""Calibrate the int8 sites' activation scales (counterpart of the
repository's tools/quantize.py):

    python3 -m cris_tpu_torch.quantize --config config/refcoco/cris_r50.yaml \\
        [--device cpu] [--batches 8] [--batch-size 16] [--min-ch 64] \\
        [--pooled-min-ch 256] [--upfold-min-ch 256] [--pct 99.9] \\
        [--opts TRAIN.val_lmdb <uri> ...]

Loads ``{output_folder}/{exp_name}/best_model.pth`` as the test entry
does, folds BN, runs calibration forwards over ``--batches`` batches of
the val split (``val_lmdb``: a ``.refpack`` file or ``synthetic://``),
or of N(0, 1) images with random token ids when the split cannot be
read, and writes ``{output_dir}/quant_scales.npz`` in the JAX package's
format, with the gates it ran at. ``python3 -m cris_tpu_torch.test`` and
``PredictService`` read it under ``precision: int8``. The forwards run
at the config's compute dtype (bf16 for bf16 and int8) with the graph
rewrites on, on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np
import torch

from . import cli
from .bench import WORD_HIGH
from .checkpoint import (BEST_NAME, SCALES_NAME, calibrate_act_scales,
                         fold_batchnorm, load_cris_checkpoint,
                         save_act_scales)
from .data import RefDataset
from .models import QuantConfig, build_segmenter, resolve_dtype
from .utils.config import merge_cfg_from_list
from .utils.logging import logger


def val_batches(cfg, n: int, b: int, device) -> List[Tuple[torch.Tensor,
                                                           torch.Tensor]]:
    """n batches of b val samples (image NCHW, word ids), cycling over the
    split."""
    ds = RefDataset(cfg.val_lmdb, cfg.mask_root, cfg.dataset, cfg.val_split,
                    "val", cfg.input_size, cfg.word_len)
    out, idx = [], 0
    for _ in range(n):
        items = ds.get_batch([(idx + j) % len(ds) for j in range(b)])
        idx += b
        img = np.stack([it["image"] for it in items]).transpose(0, 3, 1, 2)
        word = np.stack([it["word"] for it in items])
        out.append((torch.from_numpy(np.ascontiguousarray(img)).to(device),
                    torch.from_numpy(word).long().to(device)))
    return out


def noise_batches(cfg, n: int, b: int, device, seed: int = 500):
    """n batches of N(0, 1) images and token ids in [1, WORD_HIGH)."""
    gen = torch.Generator().manual_seed(seed)
    size = cfg.input_size
    return [(torch.randn(b, 3, size, size, generator=gen).to(device),
             torch.randint(1, WORD_HIGH, (b, cfg.word_len),
                           generator=gen).to(device)) for _ in range(n)]


def main(argv=None) -> str:
    """Calibrate and write the scales; returns the file's path."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; comes before --opts")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--min-ch", type=int, default=64,
                    help="plain-conv sites (and the s2d stem's embedded "
                         "widths) quantise at min(cin, cout) >= this")
    ap.add_argument("--pooled-min-ch", type=int, default=256,
                    help="pooled and s2d-pooled sites at min(cin, cout) >= "
                         "this")
    ap.add_argument("--upfold-min-ch", type=int, default=256,
                    help="the upsample folds' cores at min(cin, cout) >= "
                         "this")
    ap.add_argument("--pct", type=float, default=0.0,
                    help="calibrate to this percentile of |x| instead of "
                         "its maximum (e.g. 99.9; saturates the tail)")
    ap.add_argument("--opts", nargs=argparse.REMAINDER, default=None)
    args = ap.parse_args(argv)
    cfg = cli.load_config(args.config)
    if args.opts:
        cfg = merge_cfg_from_list(cfg, args.opts)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to calibrate "
                           "on the CPU")
    cfg.output_dir = os.path.join(cfg.output_folder, cfg.exp_name)
    path = os.path.join(cfg.output_dir, BEST_NAME)
    if not os.path.isfile(path):
        raise ValueError(f"=> no checkpoint found at '{path}'")
    logger.info(f"=> loading checkpoint '{path}'")
    sd = fold_batchnorm(load_cris_checkpoint(path), cfg.input_size)
    dtype = resolve_dtype(cfg.get("precision", "bf16"))
    gates = dict(min_ch=args.min_ch, pooled_min_ch=args.pooled_min_ch,
                 upfold_min_ch=args.upfold_min_ch)
    # the JAX tool's model: quant_int8 on the folded eval model, the
    # rewrites on at a sub-f32 compute dtype
    model = build_segmenter(cfg, device="meta", fold_bn=True,
                            pos_grid=cfg.input_size // 32,
                            rewrites=dtype is not None,
                            quant=QuantConfig(**gates))
    model.load_state_dict(sd, assign=True)
    model = model.to(device).eval()
    try:
        batches = val_batches(cfg, args.batches, args.batch_size, device)
        logger.info(f"=> calibrating on {args.batches} x {args.batch_size} "
                    f"val images")
    except Exception as e:  # noqa: BLE001 -- the JAX tool falls back too
        logger.info(f"=> val split unavailable ({e!r}); calibrating on "
                    "synthetic inputs")
        batches = noise_batches(cfg, args.batches, args.batch_size, device)
    scales = calibrate_act_scales(model, batches, pct=args.pct, dtype=dtype)
    out = os.path.join(cfg.output_dir, SCALES_NAME)
    os.makedirs(cfg.output_dir, exist_ok=True)
    save_act_scales(out, scales, **gates)
    logger.info(f"=> wrote {len(scales)} activation scales to {out}")
    return out


if __name__ == "__main__":
    main()
