"""RefDataset: record backend + preprocessing, mode-dependent outputs
(counterpart of cris_tpu/data/dataset.py, with the port's decoder, warps
and tokenizer):

- train: (image, word, mask) with a sentence drawn from the sample's rng;
- val:   (image, word, seg_id, mask_path, inverse, ori_size) for the
  first sentence;
- test:  (image, ori_img, seg_id, mask_path, inverse, ori_size, sents):
  the inference loop evaluates every sentence.

Images stay NHWC float32, as the JAX package's samples are; the device
step puts them in NCHW on the card. The loader takes batches from
``get_batch``, which preprocesses train and val records in one call of the
native data plane (``data/native.py``). Backends come from the config's
``*_lmdb`` entry: RefPack files, the reference's LMDB shards (with the
``lmdb`` module) or ``synthetic://COUNT?seed=S`` URIs.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils.tokenizer import tokenize
from . import native
from .lmdb_backend import LmdbBackend
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
        try:
            return LmdbBackend(uri)
        except ImportError:
            raise ValueError(
                f"{uri!r}: reading LMDB shards needs the lmdb module, which "
                "is not installed; convert them to a .refpack file (python3 "
                "-m cris_tpu_torch.folder2pack --from-lmdb where lmdb is)"
            ) from None
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

    def _sample(self, rec, image, mask, inverse, ori_size, rng):
        """This mode's sample from a record's preprocessed image (and train
        mask, or val/test inverse affine and original size): train draws
        its sentence from ``rng``."""
        sents = rec["sents"]
        if self.mode == "train":
            rng = rng or np.random
            sent = sents[int(rng.choice(rec["num_sents"]))]
            return {"image": image,
                    "word": tokenize(sent, self.word_length, True)[0],
                    "mask": mask}
        base = {"image": image, "seg_id": rec["seg_id"],
                "mask_path": self._mask_path(rec["seg_id"]),
                "inverse": inverse, "ori_size": ori_size}
        if self.mode == "val":
            base["word"] = tokenize(sents[0], self.word_length, True)[0]
        else:
            base["sents"] = list(sents)
        return base

    def _getitem_prewarped(self, rec, rng=None):
        """Records of tools/prewarp.py: the letterbox warp is baked in, so a
        sample is a normalize + tokenize (the same outputs as the
        on-the-fly path)."""
        size = self.input_size[0]
        img = np.frombuffer(rec["warped"], np.uint8).reshape(size, size, 3)
        if self.mode == "train":
            mask = np.frombuffer(rec["warped_mask"], np.float32).reshape(
                size, size, 1)
            return self._sample(rec, normalize_image(img), mask.copy(), None,
                                None, rng)
        sample = self._sample(
            rec, normalize_image(img), None,
            np.frombuffer(rec["inverse"], np.float64).reshape(2, 3),
            np.frombuffer(rec["ori_size"], np.int32).copy(), rng)
        # the original image only when packed with --keep-ori
        if self.mode == "test" and "img" in rec:
            sample["ori_img"] = decode_image(rec["img"])
        return sample

    def get_batch(self, indices, rngs=None):
        """The samples of ``indices``, sentences drawn from ``rngs``, as
        ``cris_tpu/data/dataset.py``'s ``get_batch``: train and val records
        through the native data plane (``data/native.py``: one C++ call
        decodes, warps and normalises the batch, with the per-sample
        path's values bit for bit), prewarped records through
        ``_getitem_prewarped``; test mode, and ``CRIS_NATIVE=0``, sample by
        sample."""
        rngs = rngs or [None] * len(indices)
        if self.mode == "test" or not native.available():
            return [self.__getitem__(int(i), rng=r)
                    for i, r in zip(indices, rngs)]
        records = [self.backend[int(i)] for i in indices]
        if records and "warped" in records[0]:
            return [self._getitem_prewarped(rec, r)
                    for rec, r in zip(records, rngs)]
        train = self.mode == "train"
        images, masks, inverse, ori = native.batch_preprocess(
            [rec["img"] for rec in records],
            [rec["mask"] for rec in records] if train else None,
            self.input_size[0], want_inverse=not train)
        return [self._sample(rec, images[j],
                             masks[j][..., None] if train else None,
                             None if train else inverse[j],
                             None if train else ori[j], rng)
                for j, (rec, rng) in enumerate(zip(records, rngs))]

    def __getitem__(self, index: int,
                    rng: Optional[np.random.RandomState] = None):
        rec = self.backend[index]
        if "warped" in rec:
            return self._getitem_prewarped(rec, rng)
        ori_img = decode_image(rec["img"])  # BGR
        img = ori_img[:, :, ::-1]  # RGB
        img_size = img.shape[:2]

        mat, inv = get_transform_mats(img_size, self.input_size)
        img = normalize_image(warp_image(img, mat, self.input_size))
        if self.mode == "train":
            mask = warp_mask(decode_mask(rec["mask"]), mat, self.input_size)
            return self._sample(rec, img, mask[..., None], None, None, rng)
        sample = self._sample(rec, img, None, inv.astype(np.float64),
                              np.array(img_size, np.int32), rng)
        if self.mode == "test":
            sample["ori_img"] = ori_img
        return sample
