"""The port's serving daemon (counterpart of tools/serve.py): the model
and tokenizer stay warm behind ``serving``'s HTTP front.

    python3 -m cris_tpu_torch.serve --config config/refcoco/cris_r50.yaml \\
        [--checkpoint exp/refcoco/CRIS_R50] [--host 0.0.0.0] [--port 8080] \\
        [--max-batch 16] [--no-fold-bn] [--device cpu] [--opts KEY VALUE ...]

Endpoints (``serving.make_server``):
  GET  /healthz   -> {"status": "ok", "input_size": ...}
  POST /predict   <- {"image_b64" | "image_path", "sentence" |
                      "sentences": [...], "format": "png_b64" | "rle"}
                  -> {"height", "width", "results": [{"sentence",
                      "foreground_px", "mask_png_b64" | "rle"}]}

Example:
  curl -s localhost:8080/predict -d '{"image_path": "photo.jpg",
      "sentences": ["the man in red"], "format": "rle"}'

The weights are ``best_model.pth`` under ``--checkpoint`` (default
``{output_folder}/{exp_name}``); without it the service warns and serves
the random init of seed 0. BN is folded unless ``--no-fold-bn``. It runs
on the card unless ``--device cpu`` is given; with no card that is an
error, never a fallback. ``--opts`` takes the rest of the command line.
"""

from __future__ import annotations

import argparse

import torch

from .cli import load_config
from .serving import PredictService, serve
from .utils.config import merge_cfg_from_list
from .utils.logging import setup_logger


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="CRIS serving daemon "
                                                 "(PyTorch port)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default="",
                        help="checkpoint dir (default {output_dir})")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max-batch", type=int, default=16,
                        help="the largest device batch (buckets 1, 2, 4, ...)")
    parser.add_argument("--no-fold-bn", action="store_true")
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
        raise SystemExit("no CUDA device: pass --device cpu to serve on the "
                         "CPU")
    service = PredictService(cfg, model_dir=args.checkpoint or None,
                             device=device, max_batch=args.max_batch,
                             fold_bn=not args.no_fold_bn)
    serve(service, args.host, args.port)


if __name__ == "__main__":
    main()
