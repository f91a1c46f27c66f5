"""Pre-warp a dataset shard: bake the deterministic letterbox transform in
(counterpart of tools/prewarp.py).

Every sample gets the same aspect-preserving affine warp on every epoch
(there is no random spatial augmentation), so the warp can be done once
offline. This tool reads any backend URI (.refpack, .lmdb with the
``lmdb`` module, synthetic://) and writes a .refpack whose records carry:

  warped      : uint8 input_size x input_size x 3 RGB (before normalising)
  warped_mask : float32 warped GT mask in [0, 1] (the same linear warp as
                the live path, stored exactly)
  inverse     : float64 2 x 3 inverse affine  |  ori_size : int32 {h, w}
  seg_id / sents / num_sents / cat / img_name  (unchanged)
  img         : the original JPEG bytes (only with --keep-ori, for test
                mode's original images)

``RefDataset._getitem_prewarped`` then only normalises and tokenises: its
samples equal the live path's on the source shard bit for bit.

    python3 -m cris_tpu_torch.prewarp -i datasets/pack/refcoco/train.refpack \\
        -o datasets/prewarped/refcoco/train.refpack --input-size 416
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from .data.codec import decode_image, decode_mask
from .data.dataset import open_backend
from .data.records import RefPackWriter
from .data.transforms import get_transform_mats, warp_image, warp_mask
from .utils.logging import progress


def prewarp(src_uri: str, out_path: str, input_size: int, keep_ori: bool):
    backend = open_backend(src_uri)
    os.makedirs(osp.dirname(osp.abspath(out_path)), exist_ok=True)
    hw = (input_size, input_size)
    with RefPackWriter(out_path) as writer:
        for i in progress(range(len(backend)), "prewarp"):
            rec = backend[i]
            img = decode_image(rec["img"])[:, :, ::-1]  # RGB
            mat, inv = get_transform_mats(img.shape[:2], hw)
            warped = warp_image(img, mat, hw)
            mask = warp_mask(decode_mask(rec["mask"]), mat, hw)
            out = {
                "warped": np.ascontiguousarray(warped).tobytes(),
                "warped_mask": mask.astype(np.float32)[..., None].tobytes(),
                "inverse": inv.astype(np.float64).tobytes(),
                "ori_size": np.array(img.shape[:2], np.int32).tobytes(),
                "seg_id": rec["seg_id"],
                "img_name": rec["img_name"],
                "cat": rec["cat"],
                "num_sents": rec["num_sents"],
                "sents": rec["sents"],
            }
            if keep_ori:
                out["img"] = rec["img"]
            writer.write(out)
    print(f"wrote {out_path}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Pre-warp a dataset shard.")
    parser.add_argument("-i", "--input", required=True, help="source URI")
    parser.add_argument("-o", "--output", required=True, help=".refpack out")
    parser.add_argument("--input-size", type=int, default=416)
    parser.add_argument(
        "--keep-ori", action="store_true",
        help="keep the original JPEG bytes (test mode's original images)",
    )
    args = parser.parse_args(argv)
    prewarp(args.input, args.output, args.input_size, args.keep_ori)


if __name__ == "__main__":
    main()
