"""The host input pipeline's throughput, ``bench.py``'s fourth metric
``host_input_pipeline_640x480`` (counterpart of
cris_tpu/data/host_bench.py).

The work of one training sample on 640 x 480 JPEGs (the COCO images'
median shape): decode the JPEG image and the PNG mask, warp the image to
416^2 (cubic, CLIP-mean border) and the mask (linear), normalise. Two
paths run on the same inputs:

- native: the batched data plane (``data/native.py``), on all threads and
  on one;
- per-sample: the port's numpy path (``data/transforms.py``), one sample
  after another, as ``RefDataset.__getitem__`` and ``CRIS_NATIVE=0`` run
  it.

The inputs are distinct images made from a seed; each repeat runs the
same batch again (the decoder keeps no cache).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from . import native
from .codec import decode_image, decode_mask, encode_jpeg, encode_png
from .transforms import (get_transform_mats, normalize_image, warp_image,
                         warp_mask)


def draw_test_images(n: int, wh: Tuple[int, int] = (640, 480),
                     seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """n (BGR image, mask) uint8 pairs of one size: smooth gradients,
    filled discs and mild noise (noise alone is the worst case for a JPEG
    decoder; photos are mostly smooth with local detail). The JAX
    package's draws in its order, discs rasterised as (x - cx)^2 +
    (y - cy)^2 <= r^2 where it calls cv2.circle."""
    w, h = wh
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n):
        base = (
            120 + 60 * np.sin(xx / (20 + 10 * rng.rand()) + rng.rand() * 6)
            + 40 * np.cos(yy / (25 + 10 * rng.rand()))
        )
        img = np.stack([base + rng.randint(-20, 20) for _ in range(3)], -1)
        img = np.clip(img + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        for _ in range(rng.randint(2, 5)):
            cx, cy = int(rng.randint(60, w - 60)), int(rng.randint(60, h - 60))
            r = int(rng.randint(30, 90))
            color = rng.randint(0, 255, 3).astype(np.uint8)
            box = (slice(max(cy - r, 0), cy + r + 1),
                   slice(max(cx - r, 0), cx + r + 1))
            disc = (xx[box] - cx) ** 2 + (yy[box] - cy) ** 2 <= r * r
            img[box][disc] = color
            mask[box][disc] = 255
        yield img, mask


def make_test_jpegs(n: int, wh: Tuple[int, int] = (640, 480), seed: int = 0,
                    quality: int = 90) -> Tuple[List[bytes], List[bytes]]:
    """``draw_test_images``' pairs as (JPEG image, PNG mask) bytes, the
    port's encoders in place of ``cv2.imencode``."""
    imgs, masks = [], []
    for img, mask in draw_test_images(n, wh, seed):
        imgs.append(encode_jpeg(img, quality))
        masks.append(encode_png(mask))
    return imgs, masks


def python_preprocess(img_bytes: List[bytes], mask_bytes: List[bytes],
                      input_size: int) -> np.ndarray:
    """The per-sample path: decode, warp and normalise each image and
    decode and warp its mask, as ``RefDataset.__getitem__`` does."""
    size = (input_size, input_size)
    out = np.empty((len(img_bytes), input_size, input_size, 3), np.float32)
    for i, (jb, pb) in enumerate(zip(img_bytes, mask_bytes)):
        img = decode_image(jb)[:, :, ::-1]
        mat, _ = get_transform_mats(img.shape[:2], size)
        warp_mask(decode_mask(pb), mat, size)
        out[i] = normalize_image(warp_image(img, mat, size))
    return out


def cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo, with its vendor,
    family and model numbers where the name is missing or "unknown" (as
    in some virtual machines); "unknown" without the file."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        return "unknown"
    name = fields.get("model name", "unknown")
    if name != "unknown":
        return name
    ids = " ".join(f"{key} {fields[key]}" for key in
                   ("vendor_id", "cpu family", "model", "stepping")
                   if key in fields)
    return f"unknown ({ids})" if ids else name


def measure_host_pipeline(n_images: int = 64, wh: Tuple[int, int] = (640, 480),
                          input_size: int = 416, repeats: int = 3,
                          nthreads: Optional[int] = None,
                          python_images: int = 24) -> Dict:
    """Images per second of each path on the host clock, the best of
    ``repeats`` runs of one batch (the per-sample path on its first
    ``python_images``), after a warm-up: ``native_img_s`` on ``nthreads``
    threads (default ``min(os.cpu_count(), n_images)``),
    ``native_1thread_img_s``, ``python_img_s`` (per sample), their ratio,
    and ``prewarped_img_s`` (``tools/prewarp.py``'s records: a normalise a
    sample), with the host's cores and CPU model."""
    img_bytes, mask_bytes = make_test_jpegs(n_images, wh)
    if nthreads is None:
        nthreads = min(os.cpu_count() or 1, n_images)
    result: Dict = {"n_images": n_images, "shape": f"{wh[0]}x{wh[1]}",
                    "input_size": input_size,
                    "host_cores": os.cpu_count() or 1,
                    "cpu_model": cpu_model(), "native_threads": nthreads}

    pi, pm = img_bytes[:python_images], mask_bytes[:python_images]
    python_preprocess(pi[:2], pm[:2], input_size)
    t = min(_timed(lambda: python_preprocess(pi, pm, input_size))
            for _ in range(repeats))
    result["python_img_s"] = len(pi) / t

    for label, nt in (("native_1thread_img_s", 1), ("native_img_s", nthreads)):
        native.batch_preprocess(img_bytes[:2], mask_bytes[:2], input_size,
                                nthreads=nt)
        t = min(_timed(lambda: native.batch_preprocess(
            img_bytes, mask_bytes, input_size, nthreads=nt))
            for _ in range(repeats))
        result[label] = n_images / t
    result["native_speedup_vs_python"] = (result["native_img_s"]
                                          / result["python_img_s"])

    rng = np.random.RandomState(1)
    warped = [rng.randint(0, 255, (input_size, input_size, 3), dtype=np.uint8)
              for _ in range(n_images)]
    t = min(_timed(lambda: [normalize_image(w) for w in warped])
            for _ in range(repeats))
    result["prewarped_img_s"] = n_images / t
    return result


def cores_to_feed(card_img_s: float, per_core_img_s: float) -> float:
    """Host cores of the native plane that keep up with a card consuming
    ``card_img_s``, at ``per_core_img_s`` a core."""
    return card_img_s / per_core_img_s


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
