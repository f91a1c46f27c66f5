"""Forward latency of CRIS on one card: the port's ``tools/latency.py``.

    python3 -m cris_tpu_torch.latency [--config PATH ...] [--device cpu]

For each configuration (by default the R50 and R101 RefCOCO ones) it
builds the eval model of random weights from seed 0, as
``tools/latency.py`` does through ``cli.build_model_and_variables`` when
no CLIP archive is present, and runs 500 forwards of a batch-1 image at
the input size with random token ids, under the configuration's autocast
precision; the first 100 warm up. Each iteration is timed by the host
clock around a call that ends in a synchronise. It prints the parameters
(M), the FPS and the peak device memory in GB
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
ahead of the timed run, in units of 2^30 bytes as the reference's),
then the same as one JSON line with the card's name and power limit.

``CRIS_LATENCY_TRAIN=1`` times ``engine.train_step`` instead (30 steps,
the first 5 warm up; the configuration's optimizer), and
``CRIS_LATENCY_BATCH`` sets the batch (default 1). The mean is over the
iterations after the warm-up; the reference also adds the last warm-up
iteration to its sum (``(i + 1) >= warmup``). It runs on the card unless
``--device cpu`` is given, and exits non-zero when there is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import engine
from .bench import R50, R101, card
from .models import build_segmenter, resolve_dtype
from .utils import config_for


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def latency(cfg, device: torch.device, train: bool, batch: int,
            iters: int, warmup: int) -> dict:
    """Parameters (M), FPS and peak device memory (GB, None off the card)
    of ``iters`` forwards or train steps, the first ``warmup`` untimed."""
    dtype = resolve_dtype(cfg.get("precision", "bf16"))
    model = build_segmenter(cfg, device=device, seed=0, train=train)
    params_m = sum(p.numel() for p in model.parameters()) * 1e-6
    rng = np.random.RandomState(0)
    size = cfg.input_size
    image = torch.from_numpy(
        rng.randn(batch, 3, size, size).astype(np.float32)).to(device)
    word = torch.from_numpy(
        rng.randint(0, 4096, (batch, cfg.word_len))).long().to(device)
    if train:
        mask = torch.from_numpy(
            (rng.rand(batch, 1, size, size) > 0.5).astype(np.float32))
        opt, sched = engine.make_optimizer(model, cfg, 100)
        batch_in = {"image": image, "word": word, "mask": mask.to(device)}

        def step(i):
            out = engine.train_step(model, opt, sched, batch_in,
                                    engine.step_seed(0, i), dtype)
            float(out["loss"])
    else:
        @torch.no_grad()
        def step(i):
            with torch.autocast(device.type, dtype=dtype or torch.bfloat16,
                                enabled=dtype is not None):
                model(image, word)
            sync(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    total = 0.0
    for i in range(iters):
        t0 = time.perf_counter()
        step(i)
        if i >= warmup:
            total += time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    return {"params_m": params_m, "fps": (iters - warmup) / total,
            "peak_gb": peak}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", nargs="+", default=[R50, R101])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; never chosen for you")
    parser.add_argument("--iters", type=int, default=None,
                        help="iterations (default 500, or 30 with "
                             "CRIS_LATENCY_TRAIN=1)")
    parser.add_argument("--warmup", type=int, default=None,
                        help="untimed first iterations (default 100, or 5)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("latency: no CUDA device (pass --device cpu for the CPU)",
              file=sys.stderr)
        return 1
    train = os.environ.get("CRIS_LATENCY_TRAIN") == "1"
    batch = int(os.environ.get("CRIS_LATENCY_BATCH", "1"))
    iters = args.iters or (30 if train else 500)
    warmup = args.warmup if args.warmup is not None else (5 if train else 100)
    if not 0 <= warmup < iters:
        raise SystemExit(f"latency: need 0 <= warmup < iters, got {warmup}, "
                         f"{iters}")
    where = card(device)
    for path in args.config:
        r = latency(config_for(path), device, train, batch, iters, warmup)
        peak = "not measured" if r["peak_gb"] is None else \
            "{:.2f} GB".format(r["peak_gb"])
        print("#########################################")
        print(f"{path}: {'train step' if train else 'forward'}, batch "
              f"{batch}, {iters - warmup} timed of {iters}, on {where}")
        print("Average Parameters : {:.2f} M".format(r["params_m"]))
        print("Average FPS: {:.2f}".format(r["fps"]))
        print(f"Average Device Memory: {peak}")
        print("#########################################")
        print(json.dumps({"config": path,
                          "mode": "train" if train else "forward",
                          "batch": batch, "iters": iters, "warmup": warmup,
                          **r, "card": where}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
