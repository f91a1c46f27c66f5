"""Single-image inference of the port (counterpart of tools/predict.py):
image + referring expressions -> masks, and overlays.

    python3 -m cris_tpu_torch.predict --config config/refcoco/cris_r50.yaml \\
        --image photo.jpg --sent "the man in the red shirt" [--sent ...] \\
        [--out mask.png] [--overlay overlay.jpg] [--checkpoint DIR] \\
        [--device cpu] [--opts KEY VALUE ...]

Loads ``best_model.pth`` under ``--checkpoint`` (default
``{output_folder}/{exp_name}``) into the unfolded eval model, as the JAX
tool does; without it, it warns and uses the random init of the config's
``manual_seed``. The image is read by ``data.codec.decode_image`` (JPEG,
PNG, WebP, BMP, PNM / PAM, ``cv2.imread``'s bits); one that cannot be read
exits non-zero with the decoder's message. All ``--sent`` run as one device batch at the
config's precision. Each mask (0 / 255) is written as a PNG to ``--out``,
or with several sentences to ``{base}_{i}{ext}``; with ``--overlay`` the
mask's pixels are blended halfway to red, as the JAX tool blends them, and
written as a JPEG of quality 95 (``cv2.imwrite``'s default), named the same
way. It runs on the card unless ``--device cpu`` is given; with no card
that is an error, never a fallback.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch

from .checkpoint import BEST_NAME, load_cris_checkpoint
from .cli import load_config
from .data.codec import decode_image, encode_jpeg, encode_png
from .data.transforms import (get_transform_mats, inverse_warp_prediction,
                              normalize_image, warp_image)
from .engine import EVAL_THRESHOLD, Evaluator
from .models import build_segmenter, resolve_dtype
from .utils.config import merge_cfg_from_list
from .utils.logging import logger, setup_logger
from .utils.tokenizer import tokenize


def load_model(cfg, model_dir: str, device) -> torch.nn.Module:
    """The unfolded eval model with ``best_model.pth`` under ``model_dir``,
    or, with a warning, the random init of ``cfg.manual_seed``."""
    path = os.path.join(model_dir, BEST_NAME)
    if not os.path.isfile(path):
        logger.warning(f"no checkpoint under '{model_dir}' -- using random "
                       "weights")
        model = build_segmenter(cfg, device="cpu",
                                seed=int(cfg.get("manual_seed", 0)))
        return model.to(device)
    model = build_segmenter(cfg, device="meta")
    model.load_state_dict({k: torch.as_tensor(v).float()
                           for k, v in load_cris_checkpoint(path).items()},
                          assign=True)
    return model.to(device)


def overlay(bgr: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``bgr`` with the pixels where ``mask`` > 0 blended halfway to red
    (tools/predict.py:104-107's arithmetic)."""
    out = bgr.copy()
    on = mask > 0
    out[on] = (0.5 * out[on] + 0.5 * np.array([0, 0, 255])).astype(np.uint8)
    return out


def main(argv=None) -> List[str]:
    """Segment; returns the paths written."""
    parser = argparse.ArgumentParser(description="CRIS single-image predict "
                                                 "(PyTorch port)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--image", required=True)
    parser.add_argument("--sent", action="append", required=True,
                        help="referring expression (repeatable)")
    parser.add_argument("--out", default="mask.png")
    parser.add_argument("--overlay", default="")
    parser.add_argument("--checkpoint", default="",
                        help="checkpoint dir (default {output_dir})")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; comes before --opts")
    parser.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    if args.opts:
        cfg = merge_cfg_from_list(cfg, args.opts)
    setup_logger(None)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to predict on "
                         "the CPU")
    try:
        with open(args.image, "rb") as f:
            bgr = decode_image(f.read())
    except (OSError, ValueError) as e:
        raise SystemExit(f"cannot read image {args.image}: {e}") from e

    model_dir = args.checkpoint or os.path.join(cfg.output_folder,
                                                cfg.exp_name)
    model = load_model(cfg, model_dir, device)
    rgb = bgr[:, :, ::-1]
    hw = (cfg.input_size, cfg.input_size)
    mat, inv = get_transform_mats(rgb.shape[:2], hw)
    net_in = normalize_image(warp_image(rgb, mat, hw)).transpose(2, 0, 1)
    sents = args.sent
    words = tokenize(sents, cfg.word_len, True)
    images = np.repeat(net_in[None], len(sents), axis=0)
    evaluator = Evaluator(model, cfg.input_size,
                          resolve_dtype(cfg.get("precision", "bf16")),
                          batch_size=len(sents))
    probs = evaluator.predict_probs(images, words)

    written = []
    base, ext = os.path.splitext(args.out)
    ov_base, ov_ext = os.path.splitext(args.overlay)
    for i, sent in enumerate(sents):
        warped = inverse_warp_prediction(probs[i], inv, rgb.shape[:2])
        mask = (warped > EVAL_THRESHOLD).astype(np.uint8) * 255
        out = args.out if len(sents) == 1 else f"{base}_{i}{ext}"
        with open(out, "wb") as f:
            f.write(encode_png(mask))
        written.append(out)
        logger.info(f"[{sent!r}] mask -> {out} "
                    f"({int(mask.sum() / 255)} px foreground)")
        if args.overlay:
            ov = args.overlay if len(sents) == 1 else f"{ov_base}_{i}{ov_ext}"
            with open(ov, "wb") as f:
                f.write(encode_jpeg(overlay(bgr, mask), 95))
            written.append(ov)
            logger.info(f"[{sent!r}] overlay -> {ov}")
    return written


if __name__ == "__main__":
    main()
