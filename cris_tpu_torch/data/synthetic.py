"""Deterministic synthetic referring-segmentation data, without OpenCV
(counterpart of cris_tpu/data/synthetic.py).

Images of colored shapes, the ground-truth mask of one referred shape and
template referring expressions, in the reference LMDB record schema. The
``RandomState`` draws are the JAX package's, in its order, so the size,
the shapes, the target and the sentences of a record equal its record of
the same (index, seed). The shapes are drawn in numpy with OpenCV's
filled rasterization for these shapes (a filled circle is the disc
(x - cx)^2 + (y - cy)^2 <= r^2; the triangle's row at t below its apex
spans [cx - ceil(t / 2), cx + floor(t / 2)]), so the masks equal the JAX
package's pixel for pixel. The image is stored as PNG (the decoder
sniffs the format, as ``cv2.imdecode`` does), so its pixels are the drawn
ones, where the JAX package's went through a JPEG encode.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .codec import encode_png

_COLORS = {
    "red": (220, 40, 40),
    "green": (40, 190, 60),
    "blue": (40, 80, 220),
    "yellow": (230, 210, 40),
}
_SHAPES = ("circle", "square", "triangle")
_POSITIONS = ("left", "right", "top", "bottom")


def _shape_mask(shape: str, hw, center, size: int) -> np.ndarray:
    """Boolean (H, W) pixels of a filled shape."""
    h, w = hw
    cx, cy = center
    yy, xx = np.ogrid[:h, :w]
    if shape == "circle":
        return (xx - cx) ** 2 + (yy - cy) ** 2 <= size * size
    if shape == "square":
        return (abs(xx - cx) <= size) & (abs(yy - cy) <= size)
    t = yy - (cy - size)  # rows below the apex
    return (t >= 0) & (t <= 2 * size) & (xx >= cx - (t + 1) // 2) & (xx <= cx + t // 2)


def make_record(index: int, seed: int = 0) -> Dict:
    """One synthetic record in the reference LMDB schema."""
    rng = np.random.RandomState(seed * 1_000_003 + index)
    h = int(rng.randint(240, 640))
    w = int(rng.randint(240, 640))
    img = np.full((h, w, 3), rng.randint(100, 180, 3), np.uint8)
    mask = np.zeros((h, w), np.uint8)

    n_shapes = int(rng.randint(2, 5))
    target = int(rng.randint(n_shapes))
    sents = []
    for s in range(n_shapes):
        shape = _SHAPES[rng.randint(len(_SHAPES))]
        color_name = list(_COLORS)[rng.randint(len(_COLORS))]
        size = int(rng.randint(min(h, w) // 10, min(h, w) // 5))
        cx = int(rng.randint(size, w - size))
        cy = int(rng.randint(size, h - size))
        pixels = _shape_mask(shape, (h, w), (cx, cy), size)
        img[pixels] = _COLORS[color_name]
        if s == target:
            mask[pixels] = 255
            pos = _POSITIONS[rng.randint(len(_POSITIONS))]
            sents = [
                f"the {color_name} {shape}",
                f"{color_name} {shape} on the {pos}",
                f"a {shape} that is {color_name}",
            ][: int(rng.randint(1, 4))]

    return {
        "img": encode_png(img),  # decodes to BGR = img[..., ::-1], as COCO's
        "mask": encode_png(mask),
        "cat": 0,
        "seg_id": index,
        "img_name": f"synthetic_{index}.png",
        "num_sents": len(sents),
        "sents": sents,
    }


class SyntheticBackend:
    """Record backend generating data on the fly (no files needed)."""

    def __init__(self, count: int, seed: int = 0):
        self.count = count
        self.seed = seed

    def __len__(self):
        return self.count

    def __getitem__(self, index: int) -> Dict:
        return make_record(index, self.seed)

    def materialize_masks(self, mask_root: str):
        """Write {seg_id}.png GT masks so the eval path reads them from
        disk, as the reference does."""
        os.makedirs(mask_root, exist_ok=True)
        for i in range(self.count):
            rec = self[i]
            path = os.path.join(mask_root, f"{rec['seg_id']}.png")
            if not os.path.exists(path):
                # atomic rename: concurrent processes must never observe a
                # partially written PNG
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(rec["mask"])
                os.replace(tmp, path)
        return mask_root
