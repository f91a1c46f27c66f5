"""Batched, prefetching host data loader (counterpart of
cris_tpu/data/loader.py):

- a deterministic per-epoch shuffle (seed + epoch, the ``set_epoch``
  contract of torch's DistributedSampler);
- per-process sharding by index with even-split padding: the index list
  wraps around so every process sees the same number of samples;
- fixed batch shapes: the last partial batch repeats its last sample, and
  a ``valid`` mask marks the padding so eval can drop it;
- a thread pool that decodes and warps the next batches while the device
  computes (the codec releases the interpreter lock; the numpy warps
  mostly do), at most ``num_workers + prefetch`` batches ahead.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List

import numpy as np


def _collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    batch: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray) and all(
                v.shape == first.shape for v in vals):
            batch[key] = np.stack(vals)
        elif isinstance(first, (int, np.integer, float)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals  # strings, ragged arrays, sentence lists
    return batch


class RefDataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, num_workers: int = 4,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        if self.process_count > 1:
            per = -(-n // self.process_count)  # ceil
            padded = np.concatenate([order, order[: per * self.process_count - n]])
            order = padded[self.process_index :: self.process_count]
        return order

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _sample_rng(self, index: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.seed * 1_000_003 + self.epoch * 7_368_787 + int(index))
            % (2**31))

    def _load_batch(self, idxs: np.ndarray) -> Dict[str, Any]:
        rngs = [self._sample_rng(int(i)) for i in idxs]
        samples = self.dataset.get_batch(idxs, rngs)
        valid = np.ones(self.batch_size, bool)
        if len(samples) < self.batch_size:
            valid[len(samples) :] = False
            samples += [samples[-1]] * (self.batch_size - len(samples))
        batch = _collate(samples)
        batch["valid"] = valid
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self._indices()
        batches = [order[i * self.batch_size : (i + 1) * self.batch_size]
                   for i in range(len(self))]

        if self.num_workers <= 1:
            for idxs in batches:
                yield self._load_batch(idxs)
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_abort(item) -> bool:
            """A bounded put that keeps watching the stop event, so an
            abandoned iterator cannot park the producer on a full queue
            (and leak its thread pool)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            window = self.num_workers + self.prefetch
            with ThreadPoolExecutor(self.num_workers) as pool:
                pending = deque()
                try:
                    for b in batches[:window]:
                        pending.append(pool.submit(self._load_batch, b))
                    next_idx = min(window, len(batches))
                    while pending and not stop.is_set():
                        if not put_or_abort(pending.popleft().result()):
                            return
                        if next_idx < len(batches):
                            pending.append(
                                pool.submit(self._load_batch, batches[next_idx]))
                            next_idx += 1
                except Exception as e:  # surfaced to the consumer
                    put_or_abort(e)
                    return
                finally:
                    for fut in pending:
                        fut.cancel()
            put_or_abort(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
