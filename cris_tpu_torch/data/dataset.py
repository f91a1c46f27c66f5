"""RefDataset: record backend + preprocessing, mode-dependent outputs
(counterpart of cris_tpu/data/dataset.py, with the port's decoder, warps
and tokenizer):

- train: (image, word, mask) with a sentence drawn from the sample's rng;
- val:   (image, word, seg_id, mask_path, inverse, ori_size) for the
  first sentence;
- test:  (image, ori_img, seg_id, mask_path, inverse, ori_size, sents):
  the inference loop evaluates every sentence.

Images stay NHWC float32, as the JAX package's samples are; the device
step puts them in NCHW on the card. Backends come from the config's
``*_lmdb`` entry: RefPack files or ``synthetic://COUNT?seed=S`` URIs.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils.tokenizer import tokenize
from .records import RefPackReader
from .synthetic import SyntheticBackend
from .transforms import (decode_image, decode_mask, get_transform_mats,
                         normalize_image, warp_image, warp_mask)

# Published split sizes (the reference's fallback before it reads the LMDB
# metadata)
SPLIT_SIZES = {
    "refcoco": {"train": 42404, "val": 3811, "val-test": 3811,
                "testA": 1975, "testB": 1810},
    "refcoco+": {"train": 42278, "val": 3805, "val-test": 3805,
                 "testA": 1975, "testB": 1798},
    "refcocog_u": {"train": 42226, "val": 2573, "val-test": 2573,
                   "test": 5023},
    "refcocog_g": {"train": 44822, "val": 5000, "val-test": 5000},
}


def open_backend(uri: str):
    """A data source URI or path -> its record backend."""
    if uri.startswith("synthetic://"):
        parsed = urlparse(uri)
        count = int(parsed.netloc or parsed.path.strip("/"))
        seed = int(parse_qs(parsed.query).get("seed", ["0"])[0])
        return SyntheticBackend(count, seed)
    if uri.endswith(".refpack"):
        return RefPackReader(uri)
    if uri.endswith(".lmdb"):
        raise ValueError(f"{uri!r}: the port reads no LMDB shards (the lmdb "
                         "module is not installed); convert them to a "
                         ".refpack file")
    raise ValueError(f"cannot resolve data backend for {uri!r}")


class RefDataset:
    def __init__(self, data_uri: str, mask_root: Optional[str], dataset: str,
                 split: str, mode: str, input_size: int, word_length: int):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode must be train, val or test, not {mode!r}")
        self.mode = mode
        self.dataset = dataset
        self.split = split
        self.input_size = (input_size, input_size)
        self.word_length = word_length
        self.backend = open_backend(data_uri)
        self.mask_root = mask_root
        if not mask_root and hasattr(self.backend, "materialize_masks"):
            # synthetic data without a mask_root (None, or "" as --opts
            # gives it): GT masks in a directory unique to the backend
            tag = f"{len(self.backend)}_{self.backend.seed}"
            self.mask_root = self.backend.materialize_masks(os.path.join(
                tempfile.gettempdir(),
                f"cris_tpu_torch_masks_{dataset}_{split}_{tag}"))

    def __len__(self) -> int:
        return len(self.backend)

    def _mask_path(self, seg_id) -> str:
        return os.path.join(self.mask_root or "", f"{seg_id}.png")

    def _getitem_prewarped(self, rec, rng=None):
        """Records of tools/prewarp.py: the letterbox warp is baked in, so a
        sample is a normalize + tokenize (the same outputs as the
        on-the-fly path)."""
        size = self.input_size[0]
        img = np.frombuffer(rec["warped"], np.uint8).reshape(size, size, 3)
        sents = rec["sents"]
        if self.mode == "train":
            mask = np.frombuffer(rec["warped_mask"], np.float32).reshape(
                size, size, 1)
            rng = rng or np.random
            sent = sents[int(rng.choice(rec["num_sents"]))]
            return {"image": normalize_image(img),
                    "word": tokenize(sent, self.word_length, True)[0],
                    "mask": mask.copy()}
        base = {
            "image": normalize_image(img),
            "seg_id": rec["seg_id"],
            "mask_path": self._mask_path(rec["seg_id"]),
            "inverse": np.frombuffer(rec["inverse"], np.float64).reshape(2, 3),
            "ori_size": np.frombuffer(rec["ori_size"], np.int32).copy(),
        }
        if self.mode == "val":
            base["word"] = tokenize(sents[0], self.word_length, True)[0]
            return base
        base["sents"] = list(sents)
        # the original image only when packed with --keep-ori
        if "img" in rec:
            base["ori_img"] = decode_image(rec["img"])
        return base

    def get_batch(self, indices, rngs=None):
        """The samples of ``indices``, one by one (the port has no batched
        native data plane)."""
        rngs = rngs or [None] * len(indices)
        return [self.__getitem__(int(i), rng=r) for i, r in zip(indices, rngs)]

    def __getitem__(self, index: int,
                    rng: Optional[np.random.RandomState] = None):
        rec = self.backend[index]
        if "warped" in rec:
            return self._getitem_prewarped(rec, rng)
        ori_img = decode_image(rec["img"])  # BGR
        img = ori_img[:, :, ::-1]  # RGB
        img_size = img.shape[:2]
        sents = rec["sents"]

        mat, inv = get_transform_mats(img_size, self.input_size)
        img = warp_image(img, mat, self.input_size)

        if self.mode == "train":
            mask = warp_mask(decode_mask(rec["mask"]), mat, self.input_size)
            rng = rng or np.random
            sent = sents[int(rng.choice(rec["num_sents"]))]
            return {"image": normalize_image(img),
                    "word": tokenize(sent, self.word_length, True)[0],
                    "mask": mask[..., None]}
        base = {
            "image": normalize_image(img),
            "seg_id": rec["seg_id"],
            "mask_path": self._mask_path(rec["seg_id"]),
            "inverse": inv.astype(np.float64),
            "ori_size": np.array(img_size, np.int32),
        }
        if self.mode == "val":
            base["word"] = tokenize(sents[0], self.word_length, True)[0]
            return base
        base["ori_img"] = ori_img
        base["sents"] = list(sents)
        return base
