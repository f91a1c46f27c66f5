"""The released-checkpoint parity report (counterpart of the repository's
tools/parity_report.py):

    python3 -m cris_tpu_torch.parity_report --config config/refcoco/cris_r50.yaml \\
        --ckpt exp/refcoco/CRIS_R50/best_model.pth \\
        [--splits val testA testB] [--lmdb-root datasets/lmdb/refcoco] \\
        [--mask-root datasets/masks/refcoco] [--tolerance 0.1] \\
        [--json report.json] [--device cpu] [--opts KEY VALUE ...]
    torchrun --nproc_per_node=N -m cris_tpu_torch.parity_report ... \\
        --opts Distributed.tp_size T

Evaluates every requested split of a trained CRIS ``.pth`` through the
test entry's path (``test.load_model``: BN folded, the int8 scales beside
the checkpoint at ``precision: int8``, the tensor-parallel split; then
``Evaluator.inference``, every sentence of every ref) and prints the
published table (CRIS.pytorch's README, IoU x 100) with each split's
diff and a PASS/FAIL verdict at ``--tolerance`` (0.1 mIoU). The exit code
is 0 only when every split with a published number is within it.

A split's records are ``<lmdb-root>/<split>.lmdb``, else
``<split>.refpack`` (``--lmdb-root`` defaults to the directory of the
config's ``val_lmdb``; a ``synthetic://`` root serves every split); test
mode's ``val`` reads the published val-test length table. ``--opts``
overrides the config as in the other entries (``--device`` and the
others before it). The port reads ``.pth`` files only: an orbax
directory is refused. On the card unless ``--device cpu``; under
torchrun rank 0 prints and writes the report.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import cli
from .data import RefDataset
from .engine import Evaluator
from .models import resolve_dtype
from .parallel import close_distributed, process_index
from .test import load_model
from .utils.config import merge_cfg_from_list
from .utils.logging import logger, setup_logger

# README "Main Results" (CRIS.pytorch), IoU x 100, as tools/parity_report.py
# lists them.
EXPECTED = {
    ("refcoco", "val", "RN50"): 69.52,
    ("refcoco", "testA", "RN50"): 72.72,
    ("refcoco", "testB", "RN50"): 64.70,
    ("refcoco", "val", "RN101"): 70.47,
    ("refcoco", "testA", "RN101"): 73.18,
    ("refcoco", "testB", "RN101"): 66.10,
    ("refcoco+", "val", "RN50"): 61.39,
    ("refcoco+", "testA", "RN50"): 67.10,
    ("refcoco+", "testB", "RN50"): 52.48,
    ("refcoco+", "val", "RN101"): 62.27,
    ("refcoco+", "testA", "RN101"): 68.08,
    ("refcoco+", "testB", "RN101"): 53.68,
    # G-Ref rows are the UMD split (the google partition has no test set)
    ("refcocog_u", "val", "RN50"): 59.35,
    ("refcocog_u", "test", "RN50"): 59.39,
    ("refcocog_u", "val", "RN101"): 59.87,
    ("refcocog_u", "test", "RN101"): 60.36,
}

DEFAULT_SPLITS = {
    "refcoco": ["val", "testA", "testB"],
    "refcoco+": ["val", "testA", "testB"],
    "refcocog_u": ["val", "test"],
    "refcocog_g": ["val"],
}


def backbone_name(cfg) -> str:
    """R50 and R101 CLIP differ in text width: word_dim 1024 vs 512."""
    return "RN50" if int(cfg.word_dim) == 1024 else "RN101"


def split_uri(lmdb_root: str, split: str) -> str:
    """A split's records: a ``scheme://`` root as it is, else
    ``<split>.lmdb`` or ``<split>.refpack`` under the root, whichever
    exists (``.lmdb`` when neither does)."""
    if "://" in lmdb_root:
        return lmdb_root
    for ext in (".lmdb", ".refpack"):
        path = os.path.join(lmdb_root, split + ext)
        if os.path.exists(path):
            return path
    return os.path.join(lmdb_root, split + ".lmdb")


def main(argv=None) -> int:
    """Evaluate, print the table (rank 0), write ``--json``; returns the
    exit code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True,
                    help="a trained CRIS .pth (CRIS.pytorch's format)")
    ap.add_argument("--splits", nargs="*", default=None)
    ap.add_argument("--lmdb-root", default=None,
                    help="directory holding <split>.lmdb / <split>.refpack")
    ap.add_argument("--mask-root", default=None)
    ap.add_argument("--tolerance", type=float, default=0.1)
    ap.add_argument("--json", dest="json_out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; comes before --opts")
    ap.add_argument("--opts", nargs=argparse.REMAINDER, default=None)
    args = ap.parse_args(argv)
    if os.path.isdir(args.ckpt):
        raise ValueError(f"'{args.ckpt}' is a directory: the port reads "
                         "trained weights only from .pth files, not orbax "
                         "checkpoints")
    cfg = cli.load_config(args.config)
    if args.opts:
        cfg = merge_cfg_from_list(cfg, args.opts)
    cfg.device = args.device
    device = cli.init_device(cfg, "evaluate")
    rank0 = process_index() == 0
    setup_logger(None, process_index=process_index())
    backbone = backbone_name(cfg)
    splits = args.splits or DEFAULT_SPLITS.get(cfg.dataset, ["val"])
    lmdb_root = args.lmdb_root or os.path.dirname(cfg.val_lmdb)
    mask_root = args.mask_root or cfg.mask_root

    model = load_model(cfg, args.ckpt, device)
    evaluator = Evaluator(model, cfg.input_size,
                          resolve_dtype(cfg.get("precision", "bf16")),
                          batch_size=cfg.get("batch_size_val", 32))
    rows = []
    for split in splits:
        # test-mode 'val' uses the published val-test length table entry
        ds_split = "val-test" if split == "val" else split
        dataset = RefDataset(split_uri(lmdb_root, split), mask_root,
                             cfg.dataset, ds_split, "test", cfg.input_size,
                             cfg.word_len)
        logger.info(f"=> evaluating {cfg.dataset}/{split} "
                    f"({len(dataset)} refs, all sentences)")
        iou, prec = evaluator.inference(dataset, word_len=cfg.word_len)
        expected = EXPECTED.get((cfg.dataset, split, backbone))
        rows.append({
            "dataset": cfg.dataset, "split": split, "backbone": backbone,
            "expected_iou": expected, "iou": 100.0 * iou,
            "diff": None if expected is None else 100.0 * iou - expected,
            **{k: 100.0 * v for k, v in prec.items()},
        })

    all_ok = True
    lines = [f"\n{'split':8s} {'expected':>9s} {'got':>8s} {'diff':>7s}  "
             "verdict"]
    for r in rows:
        if r["expected_iou"] is None:
            lines.append(f"{r['split']:8s} {'-':>9s} {r['iou']:8.2f} "
                         f"{'-':>7s}  (no published number)")
            continue
        ok = abs(r["diff"]) <= args.tolerance
        all_ok &= ok
        lines.append(f"{r['split']:8s} {r['expected_iou']:9.2f} "
                     f"{r['iou']:8.2f} {r['diff']:+7.2f}  "
                     f"{'PASS' if ok else 'FAIL'}")
    if rank0:
        print("\n".join(lines), flush=True)
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump({"rows": rows, "tolerance": args.tolerance,
                           "all_ok": all_ok}, f, indent=2)
    return 0 if all_ok else 1


if __name__ == "__main__":
    try:
        code = main()
    finally:
        close_distributed()
    sys.exit(code)
