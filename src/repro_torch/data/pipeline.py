"""Host data pipeline: sharded, deterministic, prefetching.

The port of ``repro.data.pipeline``.  Each host materializes only its
slice of the global batch; a background thread keeps ``prefetch`` batches
ready so the device step never waits on the generator.  Generators are
pure functions of (seed, step), so any host can reproduce any step after a
restart: resuming needs no data-state file.  The reference's
``sharding=`` (a ``device_put`` per key) becomes ``device=``: each array
is copied to that device from pinned host memory without blocking.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch


class ShardedBatchIterator:
    """Wraps batch_fn(seed, step) -> {name: array} (the global batch);
    yields (step, this host's slice), prefetched: numpy arrays, or tensors
    on ``device`` when one is given."""

    def __init__(
        self,
        batch_fn: Callable[[int, int], dict],
        *,
        seed: int = 0,
        start_step: int = 0,
        host_index: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
        device=None,
    ):
        self.batch_fn = batch_fn
        self.seed = seed
        self.step = start_step
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _slice_host(self, batch: dict) -> dict:
        def sl(x):
            per = x.shape[0] // self.num_hosts
            lo = self.host_index * per
            return x[lo: lo + per]

        return {k: sl(v) for k, v in batch.items()}

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._slice_host(self.batch_fn(self.seed, step))
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def _to_device(self, x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        if self.device is not None:
            batch = {k: self._to_device(v) for k, v in batch.items()}
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
