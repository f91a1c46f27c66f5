"""Validation and test-time inference (counterpart of
cris_tpu/engine/evaluator.py).

Device step (``device_probs``, also what serving and the bench run): the
eval forward -> sigmoid in f32 -> bicubic align_corners=True resize to the
network input size. Host tail, per sample: the cubic inverse warp to the
original resolution, the 0.35 threshold, and IoU against the GT mask PNG
read from disk.

``validate`` scores the first sentence of every ref from a loader;
``inference`` scores every sentence of every ref: the (image, sentence)
pairs are packed into fixed-size device batches, the last padded with its
last row. The host keeps the card fed as the JAX package does:

- two device batches stay in flight: each is copied to the card from
  pinned memory without blocking (NHWC, put in NCHW on the card) and its
  probabilities are fetched with ``.cpu()`` only when it is drained,
  while the host prepares the next batch;
- the per-sample host tail runs on a thread pool.

The model runs in eval mode (running BN statistics, no dropout), as the
JAX Evaluator's ``train=False``, whatever mode it is in: ``device_probs``,
``validate`` and ``inference`` give it back in the mode they found it in.

One process: ``_allgather`` returns its inputs (data parallel comes later).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..data.codec import encode_jpeg, encode_png, read_mask
from ..data.transforms import inverse_warp_prediction
from ..ops.resize import resize2d
from ..utils.logging import logger
from ..utils.tokenizer import tokenize
from .metrics import EVAL_THRESHOLD, mask_inter_union, mask_iou, summarize_ious

# device batches allowed in flight before the host blocks on a fetch
_PIPELINE_DEPTH = 2


def host_tensor(x, dtype: Optional[torch.dtype] = None,
                pin: bool = False) -> torch.Tensor:
    """A host array (or a tensor) as a tensor of ``dtype`` (its own when
    None), in pinned memory when ``pin`` and it is on the host."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x
    if dtype is not None:
        t = t.to(dtype)
    return t.pin_memory() if pin and t.device.type == "cpu" else t


def to_device(x, device, dtype: Optional[torch.dtype] = None,
              nchw: bool = False) -> torch.Tensor:
    """A host array or a tensor on ``device`` as ``dtype`` (its own when
    None); an (N, H, W, C) one is put in (N, C, H, W) on the device when
    ``nchw``. A host array bound for the card is copied from pinned memory
    without blocking the host (PyTorch's pinned-memory cache keeps the
    block until the copy is done); a pinned tensor is not copied again."""
    device = torch.device(device)
    t = host_tensor(x, dtype, pin=device.type == "cuda")
    t = t.to(device, non_blocking=True)
    return t.permute(0, 3, 1, 2).contiguous() if nchw else t


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """``model`` in eval mode for the block, then back in train mode if it
    was in train mode."""
    if not model.training:
        yield
        return
    model.eval()
    try:
        yield
    finally:
        model.train()


class Evaluator:
    """The eval steps of one model; ``dtype`` = torch.bfloat16 runs the
    forward under CUDA/CPU autocast (f32 parameters), None in f32.

    After ``validate`` or ``inference``, ``last_run`` holds what the run
    counted: pairs scored, device batches, host seconds, and on the card
    the seconds its batches took between CUDA events (None on the CPU)."""

    def __init__(self, model: torch.nn.Module, input_size: int,
                 dtype: Optional[torch.dtype] = None, batch_size: int = 32,
                 host_workers: Optional[int] = None):
        self.model = model
        self.input_size = int(input_size)
        self.dtype = dtype
        self.batch_size = int(batch_size)
        self.host_workers = host_workers or min(8, os.cpu_count() or 1)
        self.device = next(model.parameters()).device
        self.last_run: dict = {}
        self._device_s = 0.0  # card seconds of the batches fetched so far

    @torch.no_grad()
    def device_probs(self, image: torch.Tensor, word: torch.Tensor
                     ) -> torch.Tensor:
        """The device step on the model's device: (B, 3, S, S) float32
        image, (B, L) ids -> (B, S, S) float32 probabilities at network
        input size, left on the device."""
        with eval_mode(self.model), torch.autocast(
                self.device.type, dtype=self.dtype or torch.bfloat16,
                enabled=self.dtype is not None):
            pred = self.model(image, word)
        probs = torch.sigmoid(pred.float())
        size = (self.input_size, self.input_size)
        return resize2d(probs, size, "bicubic", align_corners=True)[:, 0]

    def predict_probs(self, image: np.ndarray, word: np.ndarray) -> np.ndarray:
        """``device_probs`` from and to the host: (B, 3, S, S) float32
        image, (B, L) ids -> (B, S, S) float32 probabilities."""
        image_t = torch.from_numpy(np.ascontiguousarray(image, np.float32))
        word_t = torch.from_numpy(np.asarray(word, np.int64))
        probs = self.device_probs(image_t.to(self.device),
                                  word_t.to(self.device))
        return probs.cpu().numpy()

    # ------------------------------------------------------ the pipeline

    def _dispatch(self, image: np.ndarray, word: np.ndarray):
        """Enqueue one device batch of (B, S, S, 3) float32 images and
        (B, L) ids; returns what ``_fetch`` takes. On the card the copies
        do not block the host (``to_device``), and CUDA events bracket the
        batch."""
        on_card = self.device.type == "cuda"
        image_t = host_tensor(image, torch.float32, pin=on_card)
        word_t = host_tensor(word, torch.long, pin=on_card)
        events = None
        if on_card:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        probs = self.device_probs(
            to_device(image_t, self.device, nchw=True),
            to_device(word_t, self.device))
        if events is not None:
            events[1].record()
        # the pinned host tensors stay referenced until the fetch
        return probs, events, (image_t, word_t)

    def _fetch(self, out, n: int) -> np.ndarray:
        """The first ``n`` rows of a dispatched batch on the host (blocks
        until the card is done)."""
        probs, events, _ = out
        rows = probs[:n].cpu().numpy()
        if events is not None:
            self._device_s += events[0].elapsed_time(events[1]) / 1e3
        return rows

    def _start_run(self) -> float:
        self._device_s = 0.0
        return time.perf_counter()

    def _end_run(self, t0: float, pairs: int, batches: int) -> None:
        self.last_run = {
            "pairs": pairs, "batches": batches,
            "seconds": time.perf_counter() - t0,
            "device_seconds": (self._device_s if self.device.type == "cuda"
                               else None)}

    # ---------------------------------------------------------------- val

    def validate(self, loader, epoch: int = 0, epochs: int = 0):
        """Validation over a loader's batches: IoU, Pr@50..90 and oIoU of
        the first sentence of every ref, padding rows dropped."""
        iou_list: List[float] = []
        sums = [0.0, 0.0]  # cumulative intersection / union
        t0 = self._start_run()
        batches = 0
        with eval_mode(self.model), \
                ThreadPoolExecutor(self.host_workers) as pool:
            inflight: deque = deque()

            def drain_one():
                out, batch = inflight.popleft()
                probs = self._fetch(out, batch["image"].shape[0])
                valid = batch.get("valid")
                tasks = [pool.submit(self._finish_sample, probs[i],
                                     np.asarray(batch["inverse"][i]),
                                     np.asarray(batch["ori_size"][i]),
                                     batch["mask_path"][i])
                         for i in range(probs.shape[0])
                         if valid is None or valid[i]]
                for t in tasks:
                    iou, inter, union = t.result()
                    iou_list.append(iou)
                    sums[0] += inter
                    sums[1] += union

            for batch in loader:
                inflight.append(
                    (self._dispatch(batch["image"], batch["word"]), batch))
                batches += 1
                if len(inflight) >= _PIPELINE_DEPTH:
                    drain_one()
            while inflight:
                drain_one()
        self._end_run(t0, len(iou_list), batches)

        iou_list, inter_sum, union_sum = self._allgather(iou_list, *sums)
        iou, prec = summarize_ious(iou_list)
        prec["oIoU"] = inter_sum / (union_sum + 1e-6)
        header = f"Evaluation: Epoch=[{epoch}/{epochs}]  IoU={100.0 * iou:.2f}"
        parts = "  ".join(f"{k}: {100.0 * v:.2f}" for k, v in prec.items())
        logger.info(f"{header}  {parts}")
        return iou, prec

    @staticmethod
    def _allgather(iou_list: List[float], inter_sum: float, union_sum: float):
        """Per-sample IoUs and summed counts of every process; one process
        holds them all."""
        return iou_list, inter_sum, union_sum

    def _finish_sample(self, probs, inv_mat, ori_size, mask_path):
        """(IoU, intersection, union) of one sample's probabilities at
        network input size against its GT mask file."""
        h, w = int(ori_size[0]), int(ori_size[1])
        pred = inverse_warp_prediction(probs, inv_mat, (h, w)) > EVAL_THRESHOLD
        mask = read_mask(mask_path) / 255.0
        inter, union = mask_inter_union(pred, mask)
        return mask_iou(pred, mask), inter, union

    # --------------------------------------------------------------- test

    def inference(self, dataset, word_len: int, visualize: bool = False,
                  vis_dir: Optional[str] = None, progress: bool = True):
        """All-sentences test evaluation: IoU, Pr@50..90 and oIoU over every
        (ref, sentence) pair. ``visualize`` writes each pair's binarised
        prediction ``{seg_id}-iou=...-{sentence}.png`` and each ref's GT
        ``{seg_id}-mask.png`` and original image ``{seg_id}-img.jpg``
        (quality 95, as ``cv2.imwrite`` writes it; records prewarped without
        ``--keep-ori`` have none, which one warning says) under
        ``vis_dir``. ``progress`` logs every tenth of the refs."""
        iou_list: List[float] = []
        sums = [0.0, 0.0]  # cumulative intersection / union (oIoU)
        total = len(dataset)
        step = max(1, total // 10)

        def write_png(name: str, img: np.ndarray) -> None:
            with open(os.path.join(vis_dir, name), "wb") as f:
                f.write(encode_png(img))

        def finish_pair(probs_i, meta):
            h, w = meta["ori_size"]
            warped = inverse_warp_prediction(probs_i, meta["inverse"],
                                             (int(h), int(w)))
            pred = warped > EVAL_THRESHOLD
            iou = mask_iou(pred, meta["mask"])
            inter, union = mask_inter_union(pred, meta["mask"])
            if visualize and vis_dir:
                sent_tag = "_".join(meta["sent"].split(" "))
                write_png(f"{meta['seg_id']}-iou={iou * 100:.2f}-{sent_tag}.png",
                          (pred * 255).astype(np.uint8))
            return iou, inter, union

        def pair_stream():
            warned_no_ori = False
            for idx in range(total):
                if progress and idx % step == 0:
                    logger.info(f"Inference: {idx}/{total} refs")
                sample = dataset[idx]
                mask = read_mask(sample["mask_path"]) / 255.0
                if visualize and vis_dir:
                    seg_id = sample["seg_id"]
                    if "ori_img" in sample:
                        with open(os.path.join(vis_dir, f"{seg_id}-img.jpg"),
                                  "wb") as f:
                            f.write(encode_jpeg(sample["ori_img"], 95))
                    elif not warned_no_ori:
                        warned_no_ori = True
                        logger.warning("visualize: records lack original "
                                       "images (prewarped without "
                                       "--keep-ori); skipping -img.jpg dumps")
                    write_png(f"{seg_id}-mask.png",
                              (mask * 255).astype(np.uint8))
                for sent in sample["sents"]:
                    yield (sample["image"], tokenize(sent, word_len, True)[0],
                           {"mask": mask,
                            "inverse": np.asarray(sample["inverse"]),
                            "ori_size": np.asarray(sample["ori_size"]),
                            "seg_id": sample["seg_id"], "sent": sent})

        def next_batch(stream):
            imgs, words, metas = [], [], []
            for img, word, meta in stream:
                imgs.append(img)
                words.append(word)
                metas.append(meta)
                if len(imgs) == self.batch_size:
                    break
            n = len(imgs)
            if n == 0:
                return None, None, [], 0
            pad = self.batch_size - n
            return (np.stack(imgs + [imgs[-1]] * pad),
                    np.stack(words + [words[-1]] * pad), metas, n)

        t0 = self._start_run()
        batches = 0
        with eval_mode(self.model), \
                ThreadPoolExecutor(self.host_workers) as pool:
            inflight: deque = deque()

            def drain_one():
                out, metas, n = inflight.popleft()
                probs = self._fetch(out, n)
                tasks = [pool.submit(finish_pair, probs[i], metas[i])
                         for i in range(n)]
                for t in tasks:
                    iou, inter, union = t.result()
                    iou_list.append(iou)
                    sums[0] += inter
                    sums[1] += union

            stream = pair_stream()
            while True:
                images, words, metas, n = next_batch(stream)
                if n == 0:
                    break
                inflight.append((self._dispatch(images, words), metas, n))
                batches += 1
                if len(inflight) >= _PIPELINE_DEPTH:
                    drain_one()
            while inflight:
                drain_one()
        self._end_run(t0, len(iou_list), batches)

        iou_list, inter_sum, union_sum = self._allgather(iou_list, *sums)
        logger.info("=> Metric Calculation <=")
        iou, prec = summarize_ious(iou_list)
        prec["oIoU"] = inter_sum / (union_sum + 1e-6)
        logger.info(f"IoU={100.0 * iou:.2f}")
        for k, v in prec.items():
            logger.info(f"{k}: {100.0 * v:.2f}.")
        return iou, prec
