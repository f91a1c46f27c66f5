"""Per-site error audit of int8 serving (counterpart of the repository's
tools/int8_error_audit.py):

    python3 -m cris_tpu_torch.int8_error_audit [--preset RN50] [--batch 8]
        [--size 416] [--static] [--pct 99.9] [--mode local|compound]
        [--min-ch 128] [--n-batches 2] [--device cpu]

Builds the BN-folded eval model of seed-0 weights at ``precision: int8``
(the graph rewrites on, the plain-conv sites at ``--min-ch``, the pooled
and upsample-fold ones at 256; ``bench.folded_state`` /
``bench.eval_model``); with ``--static`` it calibrates the sites' scales
as ``bench.int8_model`` does (with ``--pct`` at that percentile), else
each plain-conv site quantises with a dynamic scale. Then it runs the
forward in bf16 autocast over ``--n-batches`` batches of N(0, 1) images
and random token ids from a numpy seed under ``models.auditing``: every
site that runs int8 (K8 on the card) also runs its plain conv and records
(max |err|, rms(err), max |ref|, rms(ref)), the worst over the batches.
In ``local`` mode each site passes the plain result on, so a row is that
site's own error; in ``compound`` the int8 result, as serving does, and
the masks' agreement with the bf16 model (sigmoid > 0.35) is printed.

Prints the JAX tool's table, sorted by worst rms first (site under the
JAX module path, ``[i]`` a stage tail's block), and its summary line;
exits non-zero when no site engaged. ``--preset TINY`` takes the tiny
synthetic config (for the CPU). On the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import bench
from .checkpoint.from_jax import site_path
from .models import QuantConfig, auditing, int8_sites
from .utils import CfgNode, config_for

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config")
PRESETS = {"RN50": os.path.join(CONFIG_DIR, "refcoco", "cris_r50.yaml"),
           "RN101": os.path.join(CONFIG_DIR, "refcoco", "cris_r101.yaml"),
           "TINY": os.path.join(CONFIG_DIR, "synthetic", "cris_tiny.yaml")}
THRESHOLD = 0.35  # the masks' threshold, as the evaluator's
BATCH_SEED = 500  # batch i is drawn from numpy seed 500 + i, as the JAX tool


def audit_batches(n: int, b: int, size: int, word_len: int, device
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """n batches of b N(0, 1) images (NCHW) and token ids in [1,
    bench.WORD_HIGH), batch i from numpy seed 500 + i."""
    out = []
    for i in range(n):
        rng = np.random.RandomState(BATCH_SEED + i)
        img = rng.standard_normal((b, 3, size, size)).astype(np.float32)
        word = rng.randint(1, bench.WORD_HIGH, (b, word_len))
        out.append((torch.from_numpy(img).to(device),
                    torch.from_numpy(word).long().to(device)))
    return out


@torch.no_grad()
def audit(model: torch.nn.Module, batches: Sequence, mode: str = "local",
          plain_model: Optional[torch.nn.Module] = None):
    """({site name: (4,) f32 numpy stats, the worst over the batches},
    the mean mask agreement with ``plain_model`` or None) of ``model``'s
    int8 sites under ``auditing(mode)``, in bf16 autocast. Raises when no
    site engaged."""
    names = {mod: name for name, mod in int8_sites(model).items()}
    agree = []
    with auditing(mode) as record:
        for img, word in batches:
            with torch.autocast(img.device.type, dtype=torch.bfloat16):
                pred = model(img, word)
                if plain_model is not None:
                    ref = plain_model(img, word)
            if plain_model is not None:
                agree.append(((pred[:, 0].float().sigmoid() > THRESHOLD)
                              == (ref[:, 0].float().sigmoid() > THRESHOLD)
                              ).float().mean().item())
    if not record.stats:
        raise SystemExit("no int8 site engaged the audit: is the model "
                         "BN-folded, in eval mode, at precision int8, and "
                         "--min-ch low enough?")
    stats = {names[mod]: s.cpu().numpy() for mod, s in record.stats.items()}
    return stats, (float(np.mean(agree)) if agree else None)


def rows(stats: Dict[str, np.ndarray]
         ) -> List[Tuple[str, float, float, str]]:
    """(site, max_err / max_ref, rms_err / rms_ref, the port's site name)
    a site, worst rms first; a site is named by its JAX module path, with
    ``[i]`` for block i of a stage tail whose path holds more than one
    site, as the JAX tool names its stacked rows."""
    paths = {name: site_path(name) for name in stats}
    count: Dict[str, int] = {}
    for path, _ in paths.values():
        count[path] = count.get(path, 0) + 1
    out = []
    for name, (max_err, rms_err, max_ref, rms_ref) in stats.items():
        path, index = paths[name]
        label = path if count[path] == 1 else f"{path}[{index}]"
        out.append((label, float(max_err / (max_ref + 1e-12)),
                    float(rms_err / (rms_ref + 1e-12)), name))
    out.sort(key=lambda r: -r[2])
    return out


def main(argv=None) -> dict:
    """Run the audit and print its table; returns {"rows", "stats",
    "agreement", "sites", "model"} (the audited int8 model, for checks
    that plant a fault in it)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="RN50", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--static", action="store_true",
                    help="calibrated static scales (else dynamic)")
    ap.add_argument("--pct", type=float, default=0.0,
                    help="with --static: percentile calibration (e.g. "
                         "99.9) instead of maxabs")
    ap.add_argument("--mode", choices=("local", "compound"), default="local")
    ap.add_argument("--min-ch", type=int, default=128)
    ap.add_argument("--n-batches", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to audit on "
                           "the CPU")
    cfg = CfgNode({**config_for(PRESETS[args.preset]),
                   "input_size": args.size})
    folded = bench.folded_state(cfg)
    cfg8 = CfgNode({**cfg, "precision": "int8"})
    model = bench.eval_model(cfg8, device, folded,
                             quant=QuantConfig(min_ch=args.min_ch))
    if args.static:
        bench.calibrate(model, cfg8, device, pct=args.pct)
    plain = None
    if args.mode == "compound":
        plain = bench.eval_model(CfgNode({**cfg, "precision": "bf16"}),
                                 device, folded)
    stats, agreement = audit(
        model, audit_batches(args.n_batches, args.batch, args.size,
                             cfg.word_len, device),
        args.mode, plain)

    tag = ("static" + (f"-p{args.pct}" if args.pct else "-maxabs")
           if args.static else "dynamic")
    print(f"\n== per-site int8 error ({args.preset} {args.size}px "
          f"b{args.batch}, {tag} scales, mode={args.mode}; worst over "
          f"{args.n_batches} batches) ==", flush=True)
    table = rows(stats)
    print(f"{'site':64s} {'max_err/max_ref':>15} {'rms_err/rms_ref':>15}",
          flush=True)
    for site, rel_max, rel_rms, _ in table:
        print(f"{site:64s} {rel_max:15.4f} {rel_rms:15.4f}", flush=True)
    median = sorted(r[2] for r in table)[len(table) // 2]
    print(f"\n{len(table)} quantized sites; worst rms {table[0][2]:.4f} "
          f"({table[0][0]}); median rms {median:.4f}", flush=True)
    if agreement is not None:
        print(f"mask agreement vs bf16 at threshold {THRESHOLD} (compound): "
              f"{agreement:.4f}", flush=True)
    return {"rows": table, "stats": stats, "agreement": agreement,
            "sites": len(table), "model": model}


if __name__ == "__main__":
    main()
