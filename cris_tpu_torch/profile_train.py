"""Where a train step's time goes, on one CUDA card.

    python3 -m cris_tpu_torch.profile_train [--out FILE]

CRIS-R50 at 416 px and batch 32 (random weights from seed 0), bf16
autocast, dropout 0.1, as ``chip_smoke.py`` trains it, on seeded batches
made on the card. After three warm-up steps it times ten steps back to back with CUDA
events, and profiles three steps with ``torch.profiler``: device time by
kernel, the share of the wall time in which the card ran anything, and
the share of the device time in the port's own kernels (K1, K2 forward
and backward). It prints the card's name and power limit, and ``--out``
writes everything as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from . import engine
from .models import build_segmenter
from .profile_serving import NVSMI, profile
from .utils import cris_r50_refcoco

BATCH = 32
# name fragments of the port's kernels in a profile: K1's two bodies, and
# K2's scalar and tensor-core kernels
OWN_KERNELS = {"K1": ("attention_tc_kernel", "attention_bse_kernel"),
               "K2 forward": ("dropout_fwd_kernel", "dropout_tc_fwd_kernel"),
               "K2 backward": ("dropout_bwd_", "dropout_tc_bwd_")}


def make_batches(n, b, size, word_len, device, seed=0):
    """n seeded batches of b random images, token ids and masks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n):
        word = torch.randint(1, 49407, (b, word_len), device=device, generator=gen)
        length = torch.randint(3, word_len + 1, (b, 1), device=device, generator=gen)
        out.append({
            "image": torch.randn(b, 3, size, size, device=device, generator=gen),
            "word": torch.where(torch.arange(word_len, device=device) < length,
                                word, 0),
            "mask": (torch.rand(b, 1, size, size, device=device,
                                generator=gen) > 0.7).float()})
    return out


def own_shares(kernels, device_ms):
    """{kernel: (device ms, share of device_ms)} over profile rows."""
    out = {}
    for label, fragments in OWN_KERNELS.items():
        ms = sum(r["device_ms"] for r in kernels
                 if any(f in r["name"] for f in fragments))
        out[label] = (ms, ms / device_ms if device_ms else 0.0)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the results here as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    card = subprocess.run(NVSMI, capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    cfg = cris_r50_refcoco()
    model = build_segmenter(cfg, device="cuda", seed=0, train=True)
    opt, sched = engine.make_optimizer(model, cfg, steps_per_epoch=1000)
    batches = make_batches(16, BATCH, cfg.input_size, cfg.word_len, "cuda")
    step = iter(range(len(batches)))

    def train(n):
        for _ in range(n):
            i = next(step)
            engine.train_step(model, opt, sched, batches[i],
                              engine.step_seed(0, i), torch.bfloat16)

    train(3)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    train(10)
    end.record()
    torch.cuda.synchronize()
    out = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "batch": BATCH, "step_ms": start.elapsed_time(end) / 10}
    print(f"b{BATCH} train step: {out['step_ms']:.3f} ms (CUDA events, "
          f"mean of 10 back to back)", flush=True)

    prof = out["profile_steps_x3"] = profile(lambda: train(3), top=10_000)
    shares = own_shares(prof["kernels"], prof["device_busy_ms"])
    out["own_kernels"] = {k: {"device_ms": ms, "share_of_busy": sh}
                          for k, (ms, sh) in shares.items()}
    print(f"3 steps under the profiler: wall {prof['wall_ms']:.2f} ms, device "
          f"busy {prof['device_busy_ms']:.2f} ms, busy share "
          f"{prof['device_busy_share']:.4f}", flush=True)
    for label, (ms, share) in shares.items():
        print(f"  {label}: {ms:.3f} ms device, {share:.4f} of busy", flush=True)
    for row in prof["kernels"][:20]:
        print(f"  {row['device_ms']:9.3f} ms {row['launches']:5d}x  {row['name']}",
              flush=True)
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
