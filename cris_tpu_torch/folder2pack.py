"""Pack annotation JSON + image and mask folders into a RefPack shard
(counterpart of tools/folder2pack.py), or convert the reference's LMDB
shards (``--from-lmdb``, needs the ``lmdb`` module).

    python3 -m cris_tpu_torch.folder2pack -j anns/refcoco/train.json \\
        -i images/train2014 -m masks/refcoco -o datasets/pack/refcoco
    python3 -m cris_tpu_torch.folder2pack \\
        --from-lmdb datasets/lmdb/refcoco/train.lmdb -o datasets/pack/refcoco

Writes ``{output_dir}/{split}.refpack``, ``split`` the JSON's (or the LMDB
directory's) base name, through ``data.records.RefPackWriter``: the JAX
package's file format, so the same folders give the same bytes as the JAX
tool.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

from .data.lmdb_backend import LmdbBackend
from .data.records import RefPackWriter
from .utils.logging import progress


def raw_reader(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def folder2pack(json_data, img_dir, mask_dir, output_dir, split):
    path = osp.join(output_dir, f"{split}.refpack")
    print(f"Generate RefPack to {path}")
    with RefPackWriter(path) as writer:
        for item in progress(json_data, split):
            writer.write(
                {
                    "img": raw_reader(osp.join(img_dir, item["img_name"])),
                    "mask": raw_reader(
                        osp.join(mask_dir, f"{item['segment_id']}.png")
                    ),
                    "cat": item["cat"],
                    "seg_id": item["segment_id"],
                    "img_name": item["img_name"],
                    "num_sents": item["sentences_num"],
                    "sents": [s["sent"] for s in item["sentences"]],
                }
            )
    print("Done.")


def lmdb2pack(lmdb_path, output_dir):
    split = osp.basename(lmdb_path).split(".")[0]
    backend = LmdbBackend(lmdb_path)
    path = osp.join(output_dir, f"{split}.refpack")
    print(f"Convert {lmdb_path} ({len(backend)} records) -> {path}")
    with RefPackWriter(path) as writer:
        for i in progress(range(len(backend)), split):
            writer.write(backend[i])
    print("Done.")


def main(argv=None):
    parser = argparse.ArgumentParser(description="COCO folder to RefPack.")
    parser.add_argument("-j", "--json-dir", type=str, default="")
    parser.add_argument("-i", "--img-dir", type=str, default="")
    parser.add_argument("-m", "--mask-dir", type=str, default="")
    parser.add_argument("-o", "--output-dir", type=str, required=True)
    parser.add_argument("--from-lmdb", type=str, default="")
    args = parser.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    if args.from_lmdb:
        lmdb2pack(args.from_lmdb, args.output_dir)
        return

    split = osp.basename(args.json_dir).split(".")[0]
    with open(args.json_dir, "r") as f:
        json_data = json.load(f)
    folder2pack(json_data, args.img_dir, args.mask_dir, args.output_dir, split)


if __name__ == "__main__":
    main()
