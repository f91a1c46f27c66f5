"""How far rounding alone moves CRIS-R50's f32 train-step gradients, and
the bars that phase 7 of ``chip_smoke.py`` holds the card to.

    python3 -m cris_tpu_torch.grad_spread [--out FILE]

At random weights train-mode BN makes the backward ill-conditioned:
forward rounding moves some ReLU inputs across zero, and each such unit
passes or blocks its whole gradient. So the card's gradients are held
against the CPU's own spread, the same step on the CPU with oneDNN off
(other convolution kernels), and not to a fixed tolerance alone.

This module takes the readings that set those bars. For three (weight
seed, batch seed) pairs at batch 2 and batch 8 it runs one f32 train step
at dropout 0 on the CPU (the reference), on the card, on the CPU with
oneDNN off, on the CPU with 3 threads (other GEMM blocking, which also
reaches the text encoder), and on the card with cuDNN off. For each run
it prints the loss's relative error and the gradients' global relative
L2 against the reference (all tensors, the head, the text encoder). For
the card it also prints the own-spread multiples the bars compare, and
txt_proj's smallest BN batch variance. It needs a CUDA card, and ``--out``
writes the readings as JSON.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import time

import torch

# Readings on one H100 at batch 8, three seeds (``main``): the card's
# global gradient error was at most 1.06 times the CPU's own spread, over
# all tensors and over the head, and no tensor needed more than 1.33 of
# its own spreads beyond 1e-3 of its norm. Each bar is its reading times
# about 1.5.
GLOBAL_SPREADS = 1.6
TENSOR_SPREADS = 2.0

SEEDS = ((0, 7), (0, 11), (1, 7))  # (weight seed, batch seed)
BATCHES = (2, 8)
# (label, device, oneDNN, cuDNN, CPU threads)
RUNS = (("cpu", "cpu", True, True, 8), ("card", "cuda", True, True, None),
        ("cpu oneDNN off", "cpu", False, True, 8),
        ("cpu 3 threads", "cpu", True, True, 3),
        ("card cuDNN off", "cuda", True, False, None))


def grad_rel(got, ref, names) -> float:
    """Global relative L2 of ``got`` against ``ref`` over ``names``."""
    num = sum(float((got[n].double() - ref[n].double()).square().sum())
              for n in names)
    den = sum(float(ref[n].double().square().sum()) for n in names)
    return math.sqrt(num / den)


def _slack(got, ref, n) -> float:
    """A tensor's error beyond its fixed allowance: 1e-3 of its norm,
    plus 1e-6 RMS for gradients that are zero in exact arithmetic."""
    r = ref[n].double()
    return (float((got[n].double() - r).norm()) - 1e-3 * float(r.norm())
            - 1e-6 * r.numel() ** 0.5)


def tensor_need(got, ref, alt, names) -> float:
    """The most own spreads (|alt - ref|) any tensor's error needs beyond
    its fixed allowance."""
    return max(_slack(got, ref, n)
               / max(float((alt[n].double() - ref[n].double()).norm()), 1e-30)
               for n in names)


def grad_faults(got, ref, alt, names, head):
    """Where ``got`` leaves the bars around ``ref``, given the own spread
    ``alt``: [] when it passes. Global relative L2 (all, head) within
    1e-3 + GLOBAL_SPREADS x the spread; each tensor within 1e-3 of its
    norm + TENSOR_SPREADS x its spread + 1e-6 RMS."""
    faults = []
    for what, group in (("all", names), ("head", head)):
        rel, spread = grad_rel(got, ref, group), grad_rel(alt, ref, group)
        if rel > 1e-3 + GLOBAL_SPREADS * spread:
            faults.append((what, rel, spread))
    for n in names:
        own = float((alt[n].double() - ref[n].double()).norm())
        if _slack(got, ref, n) > TENSOR_SPREADS * own:
            norm = max(float(ref[n].double().norm()), 1e-30)
            faults.append((n, float((got[n] - ref[n]).double().norm()) / norm,
                           own / norm))
    return faults


def step_grads(base, cfg, batch, device, onednn=True, cudnn=True,
               threads=None):
    """One f32 train step of a copy of ``base`` on ``device``: (loss,
    {name: gradient on the CPU}, seconds, txt_proj's BN input)."""
    from . import engine

    saved = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    model = copy.deepcopy(base).to(device)
    seen = []
    hook = model.neck.txt_proj[1].register_forward_hook(
        lambda mod, args, out: seen.append(args[0].detach().cpu()))
    opt, sched = engine.make_optimizer(model, cfg, steps_per_epoch=100)
    t0 = time.perf_counter()
    try:
        with torch.backends.mkldnn.flags(enabled=onednn), \
                torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            metrics = engine.train_step(model, opt, sched, batch, step_seed=0)
        loss = metrics["loss"].item()
    finally:
        hook.remove()
        torch.set_num_threads(saved)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return loss, grads, time.perf_counter() - t0, seen[0]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the readings here as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("grad_spread: no CUDA device")
    from .models import build_segmenter
    from .profile_train import make_batches
    from .utils import cris_r50_refcoco

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cris_r50_refcoco()
    cfg.dropout = 0.0
    readings = []
    for wseed, bseed in SEEDS:
        base = build_segmenter(cfg, device="cpu", seed=wseed, train=True)
        for b in BATCHES:
            batch = make_batches(1, b, cfg.input_size, cfg.word_len, "cpu",
                                 seed=bseed)[0]
            runs = {label: step_grads(base, cfg, batch, dev, dnn, cudnn, thr)
                    for label, dev, dnn, cudnn, thr in RUNS}
            ref_loss, ref, _, bn_in = runs["cpu"]
            names = list(ref)
            groups = {
                "all": names,
                "head": [n for n in names if not n.startswith("backbone.")],
                "text": [n for n in names if n.startswith("backbone.")
                         and not n.startswith("backbone.visual.")]}
            var = bn_in.double().var(0, unbiased=False)
            rec = {"weight_seed": wseed, "batch_seed": bseed, "batch": b,
                   "txt_proj_min_var": float(var.min()), "runs": {}}
            for label, (loss, grads, secs, _) in runs.items():
                if label == "cpu":
                    continue
                rec["runs"][label] = dict(
                    loss_rel=abs(loss - ref_loss) / abs(ref_loss),
                    seconds=secs,
                    **{g: grad_rel(grads, ref, ns) for g, ns in groups.items()})
            card, alt = runs["card"][1], runs["cpu oneDNN off"][1]
            own = rec["runs"]["cpu oneDNN off"]
            rec["card_over_own"] = {g: rec["runs"]["card"][g] / own[g]
                                    for g in ("all", "head")}
            rec["card_tensor_need"] = tensor_need(card, ref, alt, names)
            rec["card_faults"] = len(grad_faults(card, ref, alt, names,
                                                 groups["head"]))
            readings.append(rec)
            print(f"weights {wseed} batch seed {bseed} batch {b}: txt_proj "
                  f"min BN var {rec['txt_proj_min_var']:.3e}; card/own "
                  f"all {rec['card_over_own']['all']:.3f} head "
                  f"{rec['card_over_own']['head']:.3f}, tensor need "
                  f"{rec['card_tensor_need']:.3f}, "
                  f"{rec['card_faults']} out of the bars", flush=True)
            for label, r in rec["runs"].items():
                print(f"  {label:15s} loss {r['loss_rel']:.3e}  all "
                      f"{r['all']:.3e}  head {r['head']:.3e}  text "
                      f"{r['text']:.3e}  ({r['seconds']:.1f} s)", flush=True)
            del runs
    if args.out:
        with open(args.out, "w") as f:
            json.dump(readings, f, indent=1)


if __name__ == "__main__":
    main()
