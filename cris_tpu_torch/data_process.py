"""Offline dataset preparation (counterpart of tools/data_process.py):
the released refs pickle + COCO instances -> per-split annotation JSON and
GT mask PNGs, without OpenCV.

    python3 -m cris_tpu_torch.data_process --data_root <dir> \\
        --output_dir <dir> --dataset refcoco --split unc --generate_mask

Writes ``{output_dir}/anns/{dataset}/{split}.json`` (a list of {bbox, cat,
segment_id, img_name, sentences[], sentences_num}, the same bytes as the
JAX tool writes) and, with ``--generate_mask``,
``{output_dir}/masks/{dataset}/{segment_id}.png``: 8-bit gray 0 / 255 PNGs
(``data.codec.encode_png``) of ``REFER.getMask``, which decode to the
JAX tool's pixels. ``folder2pack`` packs them, and the eval loops read the
masks as ``DATA.mask_root``.
"""

from __future__ import annotations

import argparse
import json
import os

from .data.codec import encode_png
from .data.refer import REFER
from .utils.logging import progress

# images of refclef that the reference leaves out
REFCLEF_SKIP = ("19579.jpg", "17975.jpg", "19575.jpg")


def cat_process(cat: int) -> int:
    """COCO category id -> contiguous 0..79 (the reference's table)."""
    if 1 <= cat <= 11:
        return cat - 1
    if 13 <= cat <= 25:
        return cat - 2
    if 27 <= cat <= 28:
        return cat - 3
    if 31 <= cat <= 44:
        return cat - 5
    if 46 <= cat <= 65:
        return cat - 6
    if cat == 67:
        return cat - 7
    if cat == 70:
        return cat - 9
    if 72 <= cat <= 82:
        return cat - 10
    if 84 <= cat <= 90:
        return cat - 11
    return cat


def bbox_process(bbox):
    x_min, y_min = int(bbox[0]), int(bbox[1])
    return [x_min, y_min, x_min + int(bbox[2]), y_min + int(bbox[3])]


def dataset_splits(dataset: str, split_by: str):
    """The splits the reference prepares for a dataset and its split."""
    if dataset == "refclef":
        return (["train", "val", "testA", "testB", "testC"]
                if split_by == "unc" else ["train", "val", "test"])
    if dataset in ("refcoco", "refcoco+"):
        return ["train", "val", "testA", "testB"]
    return ["train", "val", "test"]  # refcocog


def prepare_dataset(refer, dataset, splits, output_dir, generate_mask=False):
    ann_path = os.path.join(output_dir, "anns", dataset)
    mask_path = os.path.join(output_dir, "masks", dataset)
    os.makedirs(ann_path, exist_ok=True)
    os.makedirs(mask_path, exist_ok=True)

    for split in splits:
        dataset_array = []
        ref_ids = refer.getRefIds(split=split)
        print(f"Processing split:{split} - Len: {len(ref_ids)}")
        for ref_id in progress(ref_ids, split):
            ref = refer.Refs[ref_id]
            img = refer.loadImgs(image_ids=ref["image_id"])[0]
            img_name = img["file_name"]
            if dataset == "refclef" and img_name in REFCLEF_SKIP:
                continue

            if generate_mask:
                with open(os.path.join(mask_path, f"{ref_id}.png"), "wb") as f:
                    f.write(encode_png(refer.getMask(ref)["mask"] * 255))

            sentences = [
                {"idx": i, "sent_id": s["sent_id"], "sent": s["sent"].strip()}
                for i, s in enumerate(ref["sentences"])
            ]
            dataset_array.append(
                {
                    "bbox": bbox_process(refer.getRefBox(ref_id)),
                    "cat": cat_process(ref["category_id"]),
                    "segment_id": ref_id,
                    "img_name": img_name,
                    "sentences": sentences,
                    "sentences_num": len(sentences),
                }
            )
        print("Dumping json file...")
        with open(os.path.join(ann_path, f"{split}.json"), "w") as f:
            json.dump(dataset_array, f)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Data preparation")
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument(
        "--dataset",
        type=str,
        choices=["refcoco", "refcoco+", "refcocog", "refclef"],
        default="refcoco",
    )
    parser.add_argument("--split", type=str, default="umd")
    parser.add_argument("--generate_mask", action="store_true")
    args = parser.parse_args(argv)

    refer = REFER(args.data_root, args.dataset, args.split)
    print(f"dataset [{args.dataset}_{args.split}] contains: ")
    print(
        f"{len(refer.Sents)} expressions for {len(refer.getRefIds())} refs "
        f"in {len(refer.getImgIds())} images."
    )
    splits = dataset_splits(args.dataset, args.split)
    for split in splits:
        print(f"{len(refer.getRefIds(split=split))} refs are in split [{split}].")

    prepare_dataset(refer, args.dataset, splits, args.output_dir, args.generate_mask)


if __name__ == "__main__":
    main()
