"""REFER: the referring-expression dataset API of offline preparation (the
port's copy of cris_tpu/data/refer.py, without OpenCV or pycocotools).

Loads ``refs(unc|umd|google).p`` and COCO's ``instances.json``, indexes
refs, annotations, images and categories, filters refs by split, and
rasterises a ref's mask:

- polygon segmentations -> ``rasterize_polygons``: ``cv2.fillPoly``'s
  mask bit for bit, each part filled on its own (so parts union), by
  ``csrc/rasterize.cc``, a C++ port of OpenCV's integer polygon fill
  (8-connected edge lines, 16.16 fixed-point edges, scanline spans,
  clipping) built with the codec library (``data/codec.py``). OpenCV's
  fill walks an active edge list row by row and clips each edge before it
  rounds, so a line-by-line port is the sure way to its bits; numpy would
  need one Python step per row or per edge to follow it.
- uncompressed COCO RLE -> ``decode_uncompressed_rle`` (column-major runs);
- compressed COCO RLE strings -> ``decode_compressed_counts``
  (pycocotools' ``rleFrString``).

The JAX package's plotting helpers (``showRef``, ``showMask``) need
matplotlib and OpenCV, which the card's machine lacks, and are not
ported.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import pickle
import time
from typing import Any, Dict, List

import numpy as np

from . import codec


def decode_uncompressed_rle(counts: List[int], h: int, w: int) -> np.ndarray:
    """COCO uncompressed RLE -> (h, w) uint8 mask (column-major runs,
    starting with zeros)."""
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in counts:
        flat[pos : pos + run] = val
        pos += run
        val = 1 - val
    return flat.reshape((w, h)).T  # column-major


def decode_compressed_counts(data) -> List[int]:
    """COCO compressed RLE counts string -> run lengths.

    Each run length is a varint of base-48 chars carrying 5 payload bits
    (bit 0x20 = continuation); the final chunk sign-extends when bit 0x10
    is set; every run after the second is delta-coded against the run two
    positions back.
    """
    if isinstance(data, str):
        data = data.encode("ascii")
    counts: List[int] = []
    pos = 0
    n = len(data)
    while pos < n:
        x = 0
        k = 0
        while True:
            c = data[pos] - 48
            x |= (c & 0x1F) << (5 * k)
            pos += 1
            k += 1
            if not c & 0x20:
                if c & 0x10:
                    x |= -1 << (5 * k)
                break
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rasterize_polygons(polygons: List[List[float]], h: int, w: int) -> np.ndarray:
    """COCO polygon list -> (h, w) uint8 0/1 mask, as ``cv2.fillPoly(mask,
    [np.round(part).astype(np.int32)], 1)`` over the parts gives it. A part
    without vertices raises ``ValueError``, as OpenCV refuses it."""
    if h < 1 or w < 1:
        raise ValueError(f"cannot rasterize into a {h} x {w} image")
    parts = [np.round(np.asarray(poly, np.float64).reshape(-1, 2))
             .astype(np.int32) for poly in polygons]
    mask = np.zeros((h, w), np.uint8)
    if not parts:
        return mask
    points = np.ascontiguousarray(np.concatenate(parts))
    counts = np.array([len(p) for p in parts], np.int64)
    codec._call(codec.load_library().cris_fill_polygons,
                points.ctypes.data_as(ctypes.c_void_p),
                counts.ctypes.data_as(ctypes.c_void_p), len(parts), h, w,
                mask.ctypes.data_as(ctypes.c_void_p))
    return mask


class REFER:
    def __init__(self, data_root: str, dataset: str = "refcoco", splitBy: str = "unc"):
        print(f"loading dataset {dataset} into memory...")
        self.DATA_DIR = os.path.join(data_root, dataset)
        if dataset in ("refcoco", "refcoco+", "refcocog"):
            self.IMAGE_DIR = os.path.join(data_root, "images/mscoco/images/train2014")
        elif dataset == "refclef":
            self.IMAGE_DIR = os.path.join(data_root, "images/saiapr_tc-12")
        else:
            raise KeyError(f"No refer dataset is called [{dataset}]")

        tic = time.time()
        ref_file = os.path.join(self.DATA_DIR, f"refs({splitBy}).p")
        with open(ref_file, "rb") as f:
            self.data = {"dataset": dataset, "refs": pickle.load(f)}
        with open(os.path.join(self.DATA_DIR, "instances.json"), "r") as f:
            instances = json.load(f)
        self.data["images"] = instances["images"]
        self.data["annotations"] = instances["annotations"]
        self.data["categories"] = instances["categories"]

        self._create_index()
        print(f"DONE (t={time.time() - tic:.2f}s)")

    def _create_index(self):
        self.Anns = {a["id"]: a for a in self.data["annotations"]}
        self.Imgs = {i["id"]: i for i in self.data["images"]}
        self.Cats = {c["id"]: c["name"] for c in self.data["categories"]}
        self.imgToAnns: Dict[Any, list] = {}
        for a in self.data["annotations"]:
            self.imgToAnns.setdefault(a["image_id"], []).append(a)

        self.Refs = {}
        self.imgToRefs: Dict[Any, list] = {}
        self.catToRefs: Dict[Any, list] = {}
        self.annToRef = {}
        self.Sents = {}
        self.sentToRef = {}
        self.sentToTokens = {}
        for ref in self.data["refs"]:
            self.Refs[ref["ref_id"]] = ref
            self.imgToRefs.setdefault(ref["image_id"], []).append(ref)
            self.catToRefs.setdefault(ref["category_id"], []).append(ref)
            self.annToRef[ref["ann_id"]] = ref
            for sent in ref["sentences"]:
                self.Sents[sent["sent_id"]] = sent
                self.sentToRef[sent["sent_id"]] = ref
                self.sentToTokens[sent["sent_id"]] = sent["tokens"]

    # ----------------------------------------------------------- getters

    def getRefIds(self, image_ids=None, cat_ids=None, ref_ids=None, split=""):
        refs = self.data["refs"]
        if image_ids:
            image_ids = set(np.atleast_1d(image_ids).tolist())
            refs = [r for r in refs if r["image_id"] in image_ids]
        if cat_ids:
            cat_ids = set(np.atleast_1d(cat_ids).tolist())
            refs = [r for r in refs if r["category_id"] in cat_ids]
        if ref_ids:
            ref_ids_set = set(np.atleast_1d(ref_ids).tolist())
            refs = [r for r in refs if r["ref_id"] in ref_ids_set]
        if split:
            if split in ("testA", "testB", "testC"):
                refs = [r for r in refs if split[-1] in r["split"]]
            elif split in ("testAB", "testBC", "testAC"):
                refs = [r for r in refs if r["split"] == split]
            elif split == "test":
                refs = [r for r in refs if "test" in r["split"]]
            elif split in ("train", "val"):
                refs = [r for r in refs if r["split"] == split]
            else:
                raise KeyError(f"No such split [{split}]")
        return [r["ref_id"] for r in refs]

    def getAnnIds(self, image_ids=None, ref_ids=None):
        if image_ids:
            image_ids = np.atleast_1d(image_ids).tolist()
            anns = itertools.chain.from_iterable(
                self.imgToAnns.get(i, []) for i in image_ids
            )
            ids = [a["id"] for a in anns]
        else:
            ids = [a["id"] for a in self.data["annotations"]]
        if ref_ids:
            ref_ids = np.atleast_1d(ref_ids).tolist()
            ids = list(set(ids) & {self.Refs[r]["ann_id"] for r in ref_ids})
        return ids

    def getImgIds(self, ref_ids=None):
        if ref_ids:
            ref_ids = np.atleast_1d(ref_ids).tolist()
            return list({self.Refs[r]["image_id"] for r in ref_ids})
        return list(self.Imgs.keys())

    def getCatIds(self):
        return list(self.Cats.keys())

    def loadRefs(self, ref_ids):
        return [self.Refs[r] for r in np.atleast_1d(ref_ids).tolist()]

    def loadAnns(self, ann_ids):
        return [self.Anns[a] for a in np.atleast_1d(ann_ids).tolist()]

    def loadImgs(self, image_ids):
        return [self.Imgs[i] for i in np.atleast_1d(image_ids).tolist()]

    def loadCats(self, cat_ids):
        return [self.Cats[c] for c in np.atleast_1d(cat_ids).tolist()]

    def getRefBox(self, ref_id):
        return self.Anns[self.Refs[ref_id]["ann_id"]]["bbox"]  # [x, y, w, h]

    # -------------------------------------------------------------- masks

    def getMask(self, ref) -> Dict[str, Any]:
        """Binary mask for a ref (the reference's tools/refer.py:295-314)."""
        ann = self.Anns[ref["ann_id"]]
        image = self.Imgs[ref["image_id"]]
        h, w = image["height"], image["width"]
        seg = ann["segmentation"]
        if isinstance(seg, list):  # polygons
            mask = rasterize_polygons(seg, h, w)
        else:  # RLE dict
            counts = seg["counts"]
            if not isinstance(counts, (list, tuple)):  # compressed string
                counts = decode_compressed_counts(counts)
            mask = decode_uncompressed_rle(counts, *seg["size"])
        return {"mask": mask.astype(np.uint8), "area": int(mask.sum())}
