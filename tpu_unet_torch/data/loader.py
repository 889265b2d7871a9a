"""Batching loader of the port (counterpart of ``tpu_unet/data/loader.py``),
single process: the epoch permutation of ``np.random.RandomState((seed +
epoch) mod 2³¹)``, samples decoded by a thread pool (PIL and cv2 release
the GIL), at most ``prefetch`` batches read ahead; batches are NHWC numpy
``{"image": uint8, "label": int32}``.  Sharding across processes waits for
the multi-GPU work (ROADMAP §1 item 10).
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
from queue import Queue
from typing import Iterator

import numpy as np


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 11, drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """reference: train.py:495 (DistributedSampler.set_epoch)."""
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _epoch_order(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState((self.seed + self.epoch) % (2**31)).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[dict]:
        order = self._epoch_order()
        epoch = self.epoch
        pool = cf.ThreadPoolExecutor(self.num_workers)
        pending: Queue = Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def submit_all():
            for b in range(len(self)):
                if abandoned.is_set():
                    break
                sl = order[b * self.batch_size:(b + 1) * self.batch_size]
                # blocks while `prefetch` batches are queued
                pending.put([pool.submit(self.dataset.__getitem__, int(i), epoch=epoch)
                             for i in sl])
            pending.put(stop)

        producer = threading.Thread(target=submit_all, daemon=True)
        producer.start()
        try:
            while True:
                futs = pending.get()
                if futs is stop:
                    break
                samples = [f.result() for f in futs]
                yield {"image": np.stack([s[0] for s in samples]).astype(np.uint8),
                       "label": np.stack([s[1] for s in samples]).astype(np.int32)}
        finally:
            abandoned.set()
            while not pending.empty():  # unblock a producer waiting on a full queue
                try:
                    pending.get_nowait()
                except Exception:
                    break
            producer.join(timeout=30)
            pool.shutdown(wait=False, cancel_futures=True)
