"""Asynchronous batched data loader: a thread pool and a bounded queue.

The counterpart of ``yolo_quantization_tpu/data/loader.py``: pool threads
decode and augment samples while the device trains on the previous batch;
the bounded queue gives backpressure.  With ``pin_memory`` (a CUDA trainer)
the feeder hands over page-locked host tensors, so the copy to the card is
asynchronous.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from yolo_quantization_tpu_torch.data.voc import DetectionDataset


class BatchLoader:
    """Prefetching batch iterator over a DetectionDataset.

    ``next()`` returns (images (B,H,W,3) float32, truths (B,MAX_BOXES,5)
    float32): numpy arrays, or pinned CPU tensors with ``pin_memory``.
    Samples are drawn at random with replacement; each sample's augmentation
    draws from its own generator seeded from the loader's, so batches depend
    only on the seed, not on thread scheduling.
    """

    def __init__(self, dataset: DetectionDataset, batch_size: int, workers: int = 8,
                 prefetch: int = 2, seed: int = 0, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pin_memory = pin_memory
        self.rng = np.random.default_rng(seed)
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._feeder.start()

    def _make_batch(self):
        idxs = self.rng.integers(0, len(self.dataset), self.batch_size)
        seeds = self.rng.integers(0, 2**63 - 1, self.batch_size)
        samples = list(self._pool.map(
            lambda t: self.dataset.sample(t[0], np.random.default_rng(t[1])), zip(idxs, seeds)))
        images = np.stack([s[0] for s in samples])
        truths = np.stack([s[1] for s in samples])
        if self.pin_memory:
            return torch.from_numpy(images).pin_memory(), torch.from_numpy(truths).pin_memory()
        return images, truths

    def _feed(self):
        while not self._stop.is_set():
            try:
                batch = self._make_batch()
            except RuntimeError:
                # close() shut the pool down while a batch was in flight
                if self._stop.is_set():
                    return
                raise
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.25)
                    break
                except queue.Full:
                    continue

    def next(self):
        return self._q.get()

    def __iter__(self):
        while True:
            yield self.next()

    def close(self):
        """Stop the pipeline: the feeder exits before the pool shuts down (a
        batch in flight must not submit to a dead pool); it may be blocked in
        ``put``, so the queue is drained while joining."""
        self._stop.set()
        while self._feeder.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._feeder.join(timeout=0.05)
        self._pool.shutdown(wait=True)
